"""Compiled decoding artifact: the flat tables the frame step reads.

Counterpart of `juicer_tpu/decoder/artifact.py` (`DecoderArtifact`):

  - the HMM-arc subset (arcs with non-eps input labels) is the key space
    of the decoder's frontier;
  - the recursive eps/tee traversal of the reference's `propagateToken`
    is precomputed into per-arc expansion tables (all HMM arcs reachable
    from an arc's destination through eps arcs and tee hops, with the
    (score, lm, ac) weight deltas and the interned sequence of output
    labels crossed, the arc's own label first), plus final-state reaches;
  - a virtual start source (index n_hmm_arcs) holds the initial
    propagation from the network's start state.

The tables are bit-identical to the JAX package's, label-sequence ids
included, and `save_npz`/`load_npz` use its file format, so an artifact
built by either package loads in the other. The build differs in form
only: the per-state closure comes from the native library and is
replicated per arc with numpy gathers (the JAX build walks every entry in
Python), and sequences are interned in the same first-occurrence order
by a vectorised key. The traceback's per-label remainders are the JAX
package's lazy pure-Python DFS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..am.models import AcousticModelSet
from .network import DecoderNetwork

LOG_ZERO = -1e30


@dataclass
class Expansion:
    """CSR expansion tables keyed by source (n_hmm_arcs + 1 virtual start)."""

    row_ptr: np.ndarray  # (n_src+1,) int64
    arc: np.ndarray  # (n_entries,) int32: target hmm-arc index
    w_score: np.ndarray  # (n_entries,) f64: score delta (lm + acoustic)
    w_lm: np.ndarray  # (n_entries,) f64
    w_ac: np.ndarray  # (n_entries,) f64
    seq: np.ndarray  # (n_entries,) int32: label-sequence id

    frow_ptr: np.ndarray  # (n_src+1,) int64: final-entry CSR
    f_score: np.ndarray  # score delta incl. final weight
    f_lm: np.ndarray
    f_ac: np.ndarray
    f_seq: np.ndarray


def _ranges(lo: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Concatenation of arange(lo[i], lo[i] + cnt[i]) over i."""
    total = int(cnt.sum())
    starts = np.cumsum(cnt) - cnt
    return np.repeat(lo - starts, cnt) + np.arange(total, dtype=np.int64)


def _label_rows(own, off, ln, labels, width):
    """(n, width) int64 rows holding each entry's label sequence (the
    source arc's own label, when non-zero, then the closure's labels),
    zero-padded. Labels are positive, so a row determines its tuple."""
    n = len(own)
    rows = np.zeros((n, width), np.int64)
    rows[:, 0] = own
    shift = (own != 0).astype(np.int64)
    idx = np.arange(n)
    for j in range(width - 1):
        m = j < ln
        if not m.any():
            break
        rows[idx[m], j + shift[m]] = labels[off[m] + j]
    return rows


def _row_keys(rows: np.ndarray) -> np.ndarray:
    """One int64 key per row, equal iff the rows are; the all-zero row
    (the empty sequence) gets key 0."""
    base = int(rows.max(initial=0)) + 1
    width = rows.shape[1]
    if base ** width < (1 << 62):
        key = np.zeros(len(rows), np.int64)
        for j in range(width):
            key = key * base + rows[:, j]
        return key
    _, inv = np.unique(rows, axis=0, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    zero = np.flatnonzero(~rows.any(axis=1))
    # shift so the empty row keys to 0 and every other row above it
    return np.where(inv == (inv[zero[0]] if len(zero) else -1), 0, inv + 1)


class DecoderArtifact:
    def __init__(
        self,
        network: DecoderNetwork,
        models: AcousticModelSet,
        max_closure_entries_per_state: int = 100000,
    ):
        self.net = network
        self.models = models
        net = network
        # ---- HMM-arc subset ------------------------------------------------
        self.hmm_arc_ids = np.nonzero(net.arc_ilabel > 0)[0].astype(np.int64)
        self.n_hmm_arcs = len(self.hmm_arc_ids)
        self._set_global_to_hmm()
        self.arc_hmm = (net.arc_ilabel[self.hmm_arc_ids] - 1).astype(np.int32)
        self.arc_weight = net.arc_weight[self.hmm_arc_ids].astype(np.float64)
        self.arc_olabel = net.arc_olabel[self.hmm_arc_ids].astype(np.int32)
        self.arc_dst = net.arc_dst[self.hmm_arc_ids].astype(np.int32)

        # ---- topology ------------------------------------------------------
        (self.trP, self.state_gmm, self.hmm_n_states, self.tee) = models.packed_topology()
        self.S = self.trP.shape[1]
        self._max_entries = max_closure_entries_per_state
        self._reset_caches()
        self.expansion, self.seqs = self._build_expansion(self._native_closure())

    def _set_global_to_hmm(self):
        self._global_to_hmm = np.full(self.net.n_arcs, -1, dtype=np.int64)
        self._global_to_hmm[self.hmm_arc_ids] = np.arange(self.n_hmm_arcs)

    def _reset_caches(self):
        self._cum_entries: dict[int, tuple] = {}
        self._remainder_cache: dict[tuple, Optional[list]] = {}
        self._fremainder_cache: dict[tuple, Optional[list]] = {}

    def _native_closure(self):
        """Per-state eps/tee closure from the native library (C++ DFS in
        the reference's depth-first arc order)."""
        from ..native import closure

        net = self.net
        max_il = int(net.arc_ilabel.max(initial=0))
        tee_tab = np.full(max(max_il, 1), LOG_ZERO, dtype=np.float64)
        n = min(self.models.n_hmms, max_il)
        tee_tab[:n] = self.tee[:n]
        return closure(
            net.n_states, net.row_ptr, net.arc_dst, net.arc_ilabel,
            net.arc_olabel, net.arc_weight, net.final_weight, tee_tab,
            self._global_to_hmm, self._max_entries,
        )

    def _build_expansion(self, nt):
        """Replicate each source's closure state rows into the per-arc CSR
        tables and intern label sequences in the JAX build's order (per
        source: its entries, then its finals; the virtual start last)."""
        n_src = self.n_hmm_arcs + 1
        src_state = np.concatenate(
            [self.arc_dst.astype(np.int64), [int(self.net.init_state)]])
        own = np.concatenate([self.arc_olabel.astype(np.int64), [0]])

        erp, frp = nt["ent_row_ptr"], nt["fin_row_ptr"]
        e_cnt = erp[src_state + 1] - erp[src_state]
        f_cnt = frp[src_state + 1] - frp[src_state]
        e_idx = _ranges(erp[src_state], e_cnt)
        f_idx = _ranges(frp[src_state], f_cnt)
        src_ids = np.arange(n_src)
        e_src = np.repeat(src_ids, e_cnt)
        f_src = np.repeat(src_ids, f_cnt)

        width = 1 + int(max(nt["ent_seq_len"].max(initial=0),
                            nt["fin_seq_len"].max(initial=0)))
        labels = nt["labels"]
        e_rows = _label_rows(own[e_src], nt["ent_seq_off"][e_idx],
                             nt["ent_seq_len"][e_idx], labels, width)
        f_rows = _label_rows(own[f_src], nt["fin_seq_off"][f_idx],
                             nt["fin_seq_len"][f_idx], labels, width)
        all_rows = np.concatenate([np.zeros((1, width), np.int64), e_rows, f_rows])
        keys = _row_keys(all_rows)

        # interning stream: the pre-interned empty sequence, then per source
        # its entries followed by its finals
        ne, nf = len(e_idx), len(f_idx)
        base = np.cumsum(e_cnt + f_cnt) - (e_cnt + f_cnt)
        e_pos = 1 + np.repeat(base, e_cnt) + (np.arange(ne) - np.repeat(np.cumsum(e_cnt) - e_cnt, e_cnt))
        f_pos = 1 + np.repeat(base + e_cnt, f_cnt) + (np.arange(nf) - np.repeat(np.cumsum(f_cnt) - f_cnt, f_cnt))
        row_of = np.zeros(1 + ne + nf, np.int64)
        row_of[e_pos] = 1 + np.arange(ne)
        row_of[f_pos] = 1 + ne + np.arange(nf)
        uniq, first, inv = np.unique(keys[row_of], return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        new_id = np.empty(len(uniq), np.int64)
        new_id[order] = np.arange(len(uniq))
        ids = new_id[inv.reshape(-1)]
        seqs = [
            tuple(int(x) for x in all_rows[row_of[first[u]]] if x != 0)
            for u in order
        ]

        w_lm, w_ac = nt["ent_wlm"][e_idx], nt["ent_wac"][e_idx]
        f_lm, f_ac = nt["fin_wlm"][f_idx], nt["fin_wac"][f_idx]
        expansion = Expansion(
            row_ptr=np.concatenate([[0], np.cumsum(e_cnt)]).astype(np.int64),
            arc=nt["ent_arc"][e_idx].astype(np.int32),
            w_score=w_lm + w_ac, w_lm=w_lm, w_ac=w_ac,
            seq=ids[e_pos].astype(np.int32),
            frow_ptr=np.concatenate([[0], np.cumsum(f_cnt)]).astype(np.int64),
            f_score=f_lm + f_ac, f_lm=f_lm, f_ac=f_ac,
            f_seq=ids[f_pos].astype(np.int32),
        )
        return expansion, seqs

    # -- binary cache (the JAX package's file format) --------------------

    def save_npz(self, path: str) -> None:
        """Write the JAX package's file format, uncompressed (`np.savez`;
        both packages' `load_npz` read either form): at the 20k-word task's
        213M entries the compressed form took minutes to write."""
        ex = self.expansion
        seq_flat = np.concatenate(
            [np.asarray(s, np.int32) for s in self.seqs if s]
            or [np.zeros(0, np.int32)]
        )
        seq_len = np.asarray([len(s) for s in self.seqs], np.int32)
        np.savez(
            path,
            hmm_arc_ids=self.hmm_arc_ids,
            arc_hmm=self.arc_hmm, arc_weight=self.arc_weight,
            arc_olabel=self.arc_olabel, arc_dst=self.arc_dst,
            trP=self.trP, state_gmm=self.state_gmm,
            hmm_n_states=self.hmm_n_states, tee=self.tee,
            row_ptr=ex.row_ptr, ent_arc=ex.arc, w_score=ex.w_score,
            w_lm=ex.w_lm, w_ac=ex.w_ac, ent_seq=ex.seq,
            frow_ptr=ex.frow_ptr, f_score=ex.f_score, f_lm=ex.f_lm,
            f_ac=ex.f_ac, f_seq=ex.f_seq,
            seq_flat=seq_flat, seq_len=seq_len,
        )

    @classmethod
    def load_npz(cls, path: str, network: DecoderNetwork,
                 models: AcousticModelSet) -> "DecoderArtifact":
        """Restore a cached artifact. `network`/`models` must be the ones
        the cache was built from (the traceback's remainder DFS walks the
        network)."""
        z = np.load(path)
        art = cls.__new__(cls)
        art.net = network
        art.models = models
        art.hmm_arc_ids = z["hmm_arc_ids"]
        art.n_hmm_arcs = len(art.hmm_arc_ids)
        art._set_global_to_hmm()
        for k in ("arc_hmm", "arc_weight", "arc_olabel", "arc_dst", "trP",
                  "state_gmm", "hmm_n_states", "tee"):
            setattr(art, k, z[k])
        art.S = art.trP.shape[1]
        seq_len = z["seq_len"]
        seq_off = np.concatenate([[0], np.cumsum(seq_len)])
        flat = z["seq_flat"].tolist()
        art.seqs = [tuple(flat[seq_off[i]:seq_off[i + 1]])
                    for i in range(len(seq_len))]
        art._max_entries = 100000
        art._reset_caches()
        art.expansion = Expansion(
            row_ptr=z["row_ptr"], arc=z["ent_arc"], w_score=z["w_score"],
            w_lm=z["w_lm"], w_ac=z["w_ac"], seq=z["ent_seq"],
            frow_ptr=z["frow_ptr"], f_score=z["f_score"], f_lm=z["f_lm"],
            f_ac=z["f_ac"], f_seq=z["f_seq"],
        )
        return art

    # -- per-label crossing remainders (traceback word decomposition) ----

    def _closure_cums(self, state: int):
        """The closure of `state` with, per emitted label, the cumulative
        (lm, ac) weight at the moment that label's arc was crossed (where
        the reference creates the word's Path record). Lazy pure Python:
        only tracebacks need it.

        Returns (entries, finals):
          entries: (hmm_arc, ws, wl, wa, seq, cums), cums a tuple of
                   (cum_lm, cum_ac) per label in seq;
          finals:  (ws(+final), wl(+final), wa, seq, cums).
        """
        cached = self._cum_entries.get(state)
        if cached is not None:
            return cached

        net = self.net
        entries: list = []
        finals: list = []

        def visit(s, w_lm, w_ac, seq, cums, on_path):
            if len(entries) > self._max_entries:
                raise RuntimeError("eps/tee closure blow-up")
            fw = net.final_weight[s]
            if fw > LOG_ZERO:
                finals.append((w_lm + w_ac + fw, w_lm + fw, w_ac, seq, cums))
            for ai in net.arcs_from(s):
                il = int(net.arc_ilabel[ai])
                w = float(net.arc_weight[ai])
                ol = int(net.arc_olabel[ai])
                dst = int(net.arc_dst[ai])
                if il == 0:
                    nseq = seq + ((ol,) if ol != 0 else ())
                    ncums = cums + (((w_lm + w, w_ac),) if ol != 0 else ())
                    if dst in on_path:
                        continue
                    visit(dst, w_lm + w, w_ac, nseq, ncums, on_path | {dst})
                else:
                    hidx = int(self._global_to_hmm[ai])
                    entries.append(
                        (hidx, w_lm + w_ac + w, w_lm + w, w_ac, seq, cums)
                    )
                    tee = float(self.tee[il - 1])
                    if tee > LOG_ZERO:
                        nseq = seq + ((ol,) if ol != 0 else ())
                        ncums = cums + (
                            ((w_lm + w, w_ac + tee),) if ol != 0 else ()
                        )
                        if dst in on_path:
                            continue
                        visit(dst, w_lm + w, w_ac + tee, nseq, ncums,
                              on_path | {dst})

        visit(state, 0.0, 0.0, (), (), frozenset([state]))
        self._cum_entries[state] = (entries, finals)
        return entries, finals

    def _src_context(self, src_row: int):
        """(closure state, own-label count) for an expansion source row:
        an hmm-arc index, or n_hmm_arcs for the virtual start."""
        if src_row < 0 or src_row >= self.n_hmm_arcs:
            return int(self.net.init_state), 0
        own = 1 if int(self.arc_olabel[src_row]) != 0 else 0
        return int(self.arc_dst[src_row]), own

    def remainders(self, src_row: int, arc_b: int, seq_id: int):
        """Per-label (score, lm, ac) remainders for a path record that
        landed on hmm-arc `arc_b` with label sequence `seq_id`, expanded
        from source `src_row`: subtracting remainder j from the record's
        landing values gives the crossing-time values of label j. None if
        no closure edge matches. Among parallel matching edges the best
        score wins, first in DFS order on ties (the engine's merge)."""
        key = (src_row, arc_b, seq_id)
        hit = self._remainder_cache.get(key)
        if hit is not None:
            return hit
        state, n_own = self._src_context(src_row)
        closure_seq = tuple(self.seqs[seq_id][n_own:])
        best = None
        for (b, ws, wl, wa, seq, cums) in self._closure_cums(state)[0]:
            if b == arc_b and seq == closure_seq and (
                best is None or ws > best[0]
            ):
                best = (ws, wl, wa, cums)
        if best is None:
            self._remainder_cache[key] = None
            return None
        ws, wl, wa, cums = best
        out = [(ws, wl, wa)] * n_own  # own label crossed at the source exit
        out += [(ws - cl - ca, wl - cl, wa - ca) for (cl, ca) in cums]
        self._remainder_cache[key] = out
        return out

    def final_remainders(self, src_row: int, f_seq_id: int):
        """`remainders` for the final-reach segment, relative to the
        best-final values (which include the final weight)."""
        key = (src_row, f_seq_id)
        hit = self._fremainder_cache.get(key)
        if hit is not None:
            return hit
        state, n_own = self._src_context(src_row)
        closure_seq = tuple(self.seqs[f_seq_id][n_own:])
        best = None
        for (ws, wl, wa, seq, cums) in self._closure_cums(state)[1]:
            if seq == closure_seq and (best is None or ws > best[0]):
                best = (ws, wl, wa, cums)
        if best is None:
            self._fremainder_cache[key] = None
            return None
        ws, wl, wa, cums = best
        out = [(ws, wl, wa)] * n_own
        out += [(ws - cl - ca, wl - cl, wa - ca) for (cl, ca) in cums]
        self._fremainder_cache[key] = out
        return out

    def anticipated_labels(self) -> np.ndarray:
        """Per HMM arc, the word that every path through it crosses next,
        for label-and-weight pushing in on-the-fly composition
        (`WFSTLabelPushingNetwork::assignOutlabsToTrans`): its own output
        label, else the one label its closure entries anticipate (each
        entry's first label, or its target arc's anticipation when it
        crosses none; final entries count their first label); 0 where
        there is none or more than one.

        The JAX package sweeps the arcs in place until nothing changes;
        here all arcs are updated at once until nothing changes. Both climb
        from "none" by a monotone update (none, then one label, then more
        than one), so both stop at its least fixpoint: the same array."""
        MULTI = -1
        ex = self.expansion
        n = self.n_hmm_arcs
        own = self.arc_olabel != 0
        lab = np.where(own, self.arc_olabel, 0).astype(np.int64)
        first = np.array([s[0] if s else 0 for s in self.seqs] or [0], np.int64)

        def entries(row_ptr, seq):
            # (source arc, first label) of the entries of arcs without a label
            src = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
            keep = (src < n)
            keep[keep] = ~own[src[keep]]
            return src[keep], first[np.asarray(seq, np.int64)[keep]], keep

        e_src, e_first, e_keep = entries(ex.row_ptr, ex.seq)
        f_src, f_first, _ = entries(ex.frow_ptr, ex.f_seq)
        dyn = e_first == 0  # crosses no label: its target arc's anticipation
        e_tgt = np.asarray(ex.arc, np.int64)[e_keep][dyn]
        fixed = e_first > 0
        fixed_src = np.concatenate([e_src[fixed], f_src[f_first > 0]])
        fixed_lab = np.concatenate([e_first[fixed], f_first[f_first > 0]])
        dyn_src = e_src[dyn]
        for _ in range(2 * n + 2):  # each arc rises at most twice
            got = lab[e_tgt]
            srcs = np.concatenate([fixed_src, dyn_src[got > 0]])
            labs = np.concatenate([fixed_lab, got[got > 0]])
            lo = np.full(n, np.iinfo(np.int64).max)
            hi = np.zeros(n, np.int64)
            np.minimum.at(lo, srcs, labs)
            np.maximum.at(hi, srcs, labs)
            multi = np.zeros(n, bool)
            multi[dyn_src[got == MULTI]] = True
            new = np.where(multi | ((hi > 0) & (lo < hi)), MULTI, np.where(hi > 0, lo, 0))
            new = np.where(own, lab, new)
            if np.array_equal(new, lab):
                break
            lab = new
        return np.where(lab > 0, lab, 0).astype(np.int32)

    def __repr__(self) -> str:
        return (
            f"DecoderArtifact(hmm_arcs={self.n_hmm_arcs}, S={self.S}, "
            f"entries={len(self.expansion.arc)}, seqs={len(self.seqs)})"
        )
