"""Decoder core: dense-frontier Viterbi beam search in PyTorch.

Counterpart of `juicer_tpu/decoder/tpu_core.py` (`TpuDecoder`) for the
static network, float32, `merge_strategy="dense"`,
`histogram_mode="binned"`, 1-best path. Other configurations (on-the-fly
composition, lattices, the sort merge, the exact histogram, float64)
raise NotImplementedError.

The frame step carries a leading batch axis: the frontier is (B, K, S)
(K active-arc slots of S padded HMM states per utterance), so one
decoder runs B utterances at once and `decode_scores` is the case B=1.
Per frame it does what `TpuDecoder._frame_step` does, op for op in
float32, so records, words and scores equal the JAX engine's:

  - within-HMM max-plus propagation with first-max argmax payloads;
  - the emit beam and the reference's integer-binned histogram threshold
    (`Histogram::calcThresh`), counted with one scatter-add per row;
  - HMM exit, the phone-end and word-end beams;
  - closure expansion through the artifact's per-arc tables
    (`_expand`, `_expand_finals`);
  - recombination: per target arc the best candidate wins, ties to the
    lowest candidate index, and lands in that arc's live slot or in the
    next free slot by candidate order (`_merge_and_insert_dense`);
  - one traceback record per landed winner that crossed output labels.

What the TPU needed and a GPU does not is gone. One-hot matmuls and
one-hot payload selects are real gathers (`torch.gather`), which select
the same values exactly. The dense (E, E) winner compare is two stable
sorts and the (E, K) slot routing is a binary search over the sorted
live arcs: the same winners and slots, found in O(E log E). The
`associative_scan` forward fill is a `cummax` over source positions.
`mode="drop"` scatters go to an extra dump column that is sliced off,
and the one winner scatter writes unique indices, so no result depends
on write order. Record ids (`t*K + slot`) and closure-table offsets are
integer tensors, so the JAX package's f32 hi/lo base split is not
needed. The frame loop is a Python loop that never reads a device value
back: overflow and best-final stay on the device until the loop ends.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from .artifact import DecoderArtifact
from .results import DecodeResult, WordHyp

NEG = -1.0e30
_F32 = torch.float32
_I64 = torch.int64

REC_FIELDS = ("rec_prev", "rec_seq", "rec_score", "rec_ac", "rec_lm",
              "rec_src", "rec_arc")
BF_FIELDS = ("score", "ac", "lm", "path", "seq", "src")
# the eight int32 words of a compact record (`fused_scan.compact_records`):
# its id t*K + slot and the seven fields, floats as their bit patterns
REC_WORDS = ("rec_id",) + REC_FIELDS


@dataclass
class TorchDecoderConfig:
    max_insts: int = 2048  # K
    expand_budget: int = 8192  # E: entry candidates per frame
    final_budget: int = 1024  # F: final-state candidates per frame
    phone_start_prune_win: float = 0.0
    emit_prune_win: float = 0.0
    phone_end_prune_win: float = 0.0
    word_prune_win: float = 0.0
    max_emit_hyps: int = 0
    histogram_mode: str = "binned"  # "exact" is not ported
    merge_strategy: str = "auto"  # "auto" = "dense"; "sort" is not ported
    dtype: str = "float32"  # "float64" is not ported
    gen_lattice: bool = False  # not ported
    # per-frame best-final snapshots (exact padded decoding) + active-inst
    # counters; off for benchmarks
    emit_diagnostics: bool = True


def _rup(x, m=128):
    return max(m, ((int(x) + m - 1) // m) * m)


def _device_tables(art: DecoderArtifact, device: torch.device) -> dict:
    """Config-independent tables, cached on the artifact per device: the
    entry tables are the bulk (17.6M entries on the 2k-word WSJ-order task)
    and every decoder built on the artifact shares them."""
    cache = art.__dict__.setdefault("_torch_tables", {})
    tabs = cache.get(str(device))
    if tabs is not None:
        return tabs
    ex = art.expansion
    # per-arc metadata rows [hmm, olabel, ent_base, ent_fan, f_base, f_fan];
    # row n_arcs = the virtual start source, n_arcs+1 = the dead sentinel
    n = art.n_hmm_arcs
    meta = np.zeros((n + 2, 6), np.int64)
    meta[:n, 0] = art.arc_hmm
    meta[:n, 1] = art.arc_olabel
    meta[: n + 1, 2] = ex.row_ptr[:-1]
    meta[: n + 1, 3] = np.diff(ex.row_ptr)
    meta[: n + 1, 4] = ex.frow_ptr[:-1]
    meta[: n + 1, 5] = np.diff(ex.frow_ptr)

    def col(a, dtype, n_min=1):
        # tables keep at least one row so clamped gathers stay in range
        a = np.asarray(a)
        if len(a) < n_min:
            a = np.zeros(n_min, a.dtype)
        return torch.as_tensor(a.astype(dtype), device=device)

    H = art.trP.shape[0]
    tabs = {
        "arc_meta": torch.as_tensor(meta, device=device),
        "ent_arc": col(ex.arc, np.int64),
        "ent_score": col(ex.w_score, np.float32),
        "ent_ac": col(ex.w_ac, np.float32),
        "ent_seq": col(ex.seq, np.int64),
        "f_score": col(ex.f_score, np.float32),
        "f_ac": col(ex.f_ac, np.float32),
        "f_seq": col(ex.f_seq, np.int64),
        "trP": torch.as_tensor(np.asarray(art.trP, np.float32), device=device),
        "emitting": torch.as_tensor(np.asarray(art.state_gmm) >= 0, device=device),
        "state_gmm": torch.as_tensor(
            np.maximum(art.state_gmm, 0).reshape(H * art.S).astype(np.int64),
            device=device),
    }
    cache[str(device)] = tabs
    return tabs


def _segment_sources(offs: torch.Tensor, fan: torch.Tensor, out_len: int):
    """For each of `out_len` output positions, the source k whose range
    [offs[k], offs[k] + fan[k]) starts last at or before it, and whether
    any does. Counterpart of `tpu_core._segment_broadcast`: a scatter of
    the source index at each range start (empty or out-of-budget ranges go
    to a dump column), then a forward fill by cummax — ranges start in
    source order, so the running max is the latest start. (B, K) -> (B, L)."""
    B, K = offs.shape
    pos = torch.where((fan > 0) & (offs < out_len), offs, out_len)
    marks = torch.full((B, out_len + 1), -1, dtype=_I64, device=offs.device)
    ks = torch.arange(K, device=offs.device).expand(B, K)
    marks.scatter_(1, pos, ks)
    src = torch.cummax(marks[:, :out_len], dim=1).values
    return src.clamp(min=0), src >= 0


def _closure_rows(fan, live, base, out_len):
    """Lay the live sources' closure-table rows end to end in a budget of
    `out_len` candidates. Returns (source index (B, L), table row (B, L),
    valid (B, L), total rows wanted (B,))."""
    fan = torch.where(live, fan, 0)
    offs = torch.cumsum(fan, dim=1) - fan
    total = offs[:, -1] + fan[:, -1]
    k, filled = _segment_sources(offs, fan, out_len)
    e_idx = torch.arange(out_len, device=fan.device)
    within = e_idx - offs.gather(1, k)
    valid = filled & (e_idx < total[:, None]) & (within < fan.gather(1, k))
    row = base.gather(1, k) + within
    return k, row, valid, total


class TorchDecoder:
    """Static-network 1-best decoder on one device (default: the card)."""

    # utterances are padded up to multiples of this many frames, as in the
    # JAX engine (whose scan compiles once per bucket); results stay exact
    # through the per-frame best-final snapshot
    T_BUCKET = 128

    def __init__(self, artifact: DecoderArtifact,
                 config: Optional[TorchDecoderConfig] = None,
                 device="cuda", g_network=None):
        cfg = config or TorchDecoderConfig()
        if g_network is not None:
            raise NotImplementedError("on-the-fly composition is not ported")
        if cfg.gen_lattice:
            raise NotImplementedError("lattice generation is not ported")
        if cfg.dtype != "float32":
            raise NotImplementedError(f"dtype {cfg.dtype!r} is not ported (float32 only)")
        if cfg.histogram_mode == "exact":
            raise NotImplementedError("histogram_mode='exact' is not ported")
        if cfg.histogram_mode != "binned":
            raise ValueError(f"unknown histogram_mode {cfg.histogram_mode!r}")
        if cfg.merge_strategy not in ("auto", "dense", "sort"):
            raise ValueError(f"unknown merge_strategy {cfg.merge_strategy!r}")
        self.art = artifact
        self.cfg = cfg
        self.device = resolve_device(device)

        # budgets never exceed the network: at most n_hmm_arcs insts are
        # live, and one frame expands each closure entry at most once
        ex = artifact.expansion
        self.K = min(cfg.max_insts, _rup(artifact.n_hmm_arcs + 1))
        self.E = min(cfg.expand_budget, _rup(len(ex.arc) + 1))
        self.F = min(cfg.final_budget, _rup(len(ex.f_score) + 1))
        # the JAX engine's "auto" picks the sort merge above E = 32768
        if cfg.merge_strategy == "sort" or self.E > 32768:
            raise NotImplementedError("merge_strategy='sort' is not ported")
        self.S = artifact.S
        self.n_arcs = artifact.n_hmm_arcs
        self.H = artifact.trP.shape[0]
        self.tab = _device_tables(artifact, self.device)

        if cfg.max_emit_hyps > 0:
            # reference histogram bounds (`WFSTDecoderLite.cpp:78-80`,
            # widened by one each side in `Histogram.cpp:28-30`)
            lo = -cfg.emit_prune_win - 800.0 if cfg.emit_prune_win > 0.0 else -1000.0
            self._hist_min = float(int(lo - 1.0))
            self._hist_max = float(int(200.0 + 1.0))
            self._n_bins = int(self._hist_max - self._hist_min) + 1

    # ------------------------------------------------------------------
    # expansion
    # ------------------------------------------------------------------

    def _expand(self, score, ac, path, base, fan, live, src_arc):
        """Fixed-budget expansion of exiting tokens (B, K) through the
        closure tables into E candidates per utterance."""
        tab = self.tab
        k, row, valid, total = _closure_rows(fan, live, base, self.E)
        ent = row.clamp(0, tab["ent_arc"].shape[0] - 1)
        s_score = score.gather(1, k)
        cand_score = torch.where(valid, s_score + tab["ent_score"][ent], NEG)
        return {
            "arc": torch.where(valid, tab["ent_arc"][ent], 0),
            "score": cand_score,
            "ac": ac.gather(1, k) + tab["ent_ac"][ent],
            "prev": path.gather(1, k),
            "seq": tab["ent_seq"][ent],
            "src": src_arc.gather(1, k),
            "valid": valid & (cand_score > NEG / 2),
            "overflow": total > self.E,
            "n_cand": total,
        }

    def _expand_finals(self, score, ac, path, base, fan, live, src_arc, norm):
        """This frame's best final-state reach per utterance (the
        bestFinalToken update) and the final-budget overflow flag."""
        tab = self.tab
        k, row, valid, total = _closure_rows(fan, live, base, self.F)
        ent = row.clamp(0, tab["f_score"].shape[0] - 1)
        sc = torch.where(valid, score.gather(1, k) + tab["f_score"][ent], NEG)
        fac = ac.gather(1, k) + tab["f_ac"][ent]
        i = sc.argmax(dim=1, keepdim=True)
        s_i = sc.gather(1, i)[:, 0]
        a_i = fac.gather(1, i)[:, 0]
        better = s_i > NEG
        best = {
            "score": torch.where(better, s_i, NEG),
            "ac": torch.where(better, a_i, NEG),
            "lm": torch.where(better, s_i - a_i + norm, NEG),
            "path": torch.where(better, path.gather(1, k.gather(1, i))[:, 0], -1),
            "seq": torch.where(better, tab["f_seq"][ent.gather(1, i)[:, 0]], 0),
            "src": torch.where(better, src_arc.gather(1, k.gather(1, i))[:, 0], -1),
        }
        return best, total > self.F

    # ------------------------------------------------------------------
    # recombination + insertion
    # ------------------------------------------------------------------

    def _merge_and_insert(self, fr, cand, t: int, norm):
        """Recombine candidates per target arc and land the winners in the
        frontier (counterpart of `_merge_and_insert_dense`).

        The winner of an arc is its best-scoring candidate, ties to the
        lowest candidate index (the reference's first-come merge). The
        frontier holds at most one live slot per arc, so a winner either
        hits that slot or takes a free one: new winners in candidate order
        take the free slots in slot order."""
        K, S, E = self.K, self.S, self.E
        dev = norm.device
        B = norm.shape[0]
        dead = self.n_arcs + 1
        live = (fr["score"][:, :, : S - 1] > NEG / 2).any(dim=2) & (
            fr["arc"] <= self.n_arcs) & (fr["arc"] >= 0)
        arc_cur = torch.where(live, fr["arc"], dead)
        n_live = live.sum(dim=1)

        valid = cand["valid"]
        ck = torch.where(valid, cand["arc"], dead)
        g_score = torch.where(valid, cand["score"], NEG)
        g_lm = g_score - cand["ac"] + norm[:, None]

        # winners: order by (arc, score descending, index) with two stable
        # sorts; the first candidate of each arc group wins
        by_score = torch.argsort(g_score, dim=1, descending=True, stable=True)
        order = by_score.gather(
            1, torch.argsort(ck.gather(1, by_score), dim=1, stable=True))
        ck_sorted = ck.gather(1, order)
        first = torch.ones_like(valid)
        first[:, 1:] = ck_sorted[:, 1:] != ck_sorted[:, :-1]
        winner = torch.zeros_like(valid).scatter_(1, order, first) & valid

        # slot routing: a binary search of each winner's arc among the live
        # arcs (unique; dead slots sort last under the sentinel)
        arc_sorted, slot_of = torch.sort(arc_cur, dim=1)
        pos = torch.searchsorted(arc_sorted, ck).clamp(max=K - 1)
        hit = winner & (arc_sorted.gather(1, pos) == ck)
        slot_hit = slot_of.gather(1, pos)
        need_new = winner & ~hit
        nn = need_new.to(_I64)
        new_rank = torch.cumsum(nn, dim=1) - nn
        n_free = (K - n_live)[:, None]
        overflow = (need_new & (new_rank >= n_free)).any(dim=1)
        free_slots = torch.argsort(live.to(torch.int8), dim=1, stable=True)
        slot_new = free_slots.gather(1, new_rank.clamp(max=K - 1))
        slot = torch.where(
            hit, slot_hit,
            torch.where(need_new & (new_rank < n_free), slot_new, -1))
        w_ok = winner & (slot >= 0) & (slot < K)

        # the one winner scatter: unique slots, losers to the dump column K
        win = torch.full((B, K + 1), -1, dtype=_I64, device=dev)
        win.scatter_(1, torch.where(w_ok, slot, K),
                     torch.arange(E, device=dev).expand(B, E))
        win = win[:, :K]
        got = win >= 0
        wi = win.clamp(min=0)
        l_arc = ck.gather(1, wi)
        l_score = g_score.gather(1, wi)
        l_ac = cand["ac"].gather(1, wi)
        l_prev = cand["prev"].gather(1, wi)
        l_seq = cand["seq"].gather(1, wi)
        has_seq = l_seq != 0
        rec_id = t * K + torch.arange(K, device=dev)
        entry_path = torch.where(has_seq, rec_id, l_prev)

        score = fr["score"]
        ac = fr["ac"]
        path = fr["path"]
        score[:, :, 0] = torch.where(got, l_score, NEG)
        ac[:, :, 0] = torch.where(got, l_ac, NEG)
        path[:, :, 0] = torch.where(got, entry_path, -1)
        fr_new = {"arc": torch.where(got, l_arc, arc_cur),
                  "score": score, "ac": ac, "path": path}

        rec_valid = got & has_seq
        rec = {
            "rec_prev": torch.where(rec_valid, l_prev, -1),
            "rec_seq": torch.where(rec_valid, l_seq, 0),
            "rec_score": torch.where(rec_valid, l_score, NEG),
            "rec_ac": torch.where(rec_valid, l_ac, NEG),
            "rec_lm": torch.where(rec_valid, g_lm.gather(1, wi), NEG),
            # source/landing arcs let the traceback recover crossing-time
            # per-label scores (artifact.remainders)
            "rec_src": torch.where(rec_valid, cand["src"].gather(1, wi), -1),
            "rec_arc": torch.where(rec_valid, l_arc, -1),
            # surviving + newly allocated insts this frame
            "n_active": (live | got).sum(dim=1),
        }
        best_new = torch.where(w_ok, g_score, NEG).amax(dim=1)
        return fr_new, rec, best_new, overflow

    # ------------------------------------------------------------------
    # per-frame step
    # ------------------------------------------------------------------

    def _histogram_thresh(self, e_score, pass_emit):
        """The reference's `Histogram::calcThresh` with binWidth 1, per
        utterance: C-round the scores, drop those below minScore, clamp
        those above maxScore, count per integer bin, and take the lowest
        bin whose top-down cumulative count reaches maxN, minus 0.5; a
        count <= maxN gives the minScore floor. One scatter-add of integer
        counts per row gives the same counts as the JAX engine's
        (N, n_bins) compare-reduce."""
        B = e_score.shape[0]
        nb = self._n_bins
        max_n = self.cfg.max_emit_hyps
        flat = torch.where(pass_emit, e_score, NEG).reshape(B, -1)
        sc = torch.trunc(torch.where(flat < 0, flat - 0.5, flat + 0.5))
        sc = torch.clamp(sc, max=self._hist_max)
        ok = (flat > NEG / 2) & (sc >= self._hist_min)
        bin_idx = torch.where(ok, sc - self._hist_min, float(nb)).to(_I64)
        counts = torch.zeros((B, nb + 1), dtype=_I64, device=flat.device)
        counts.scatter_add_(1, bin_idx, torch.ones_like(bin_idx))
        counts = counts[:, :nb]
        cum = torch.flip(torch.cumsum(torch.flip(counts, [1]), dim=1), [1])
        binding = counts.sum(dim=1) > max_n
        bins = torch.arange(nb, device=flat.device)
        idx = torch.where(cum >= max_n, bins, -1).amax(dim=1)
        return torch.where(binding, self._hist_min + idx.to(_F32) - 0.5,
                           self._hist_min - 0.5)

    def _frame_step(self, carry, gmm_t, t: int):
        cfg = self.cfg
        tab = self.tab
        K, S = self.K, self.S
        B = gmm_t.shape[0]
        fr = carry["fr"]

        best_emit = carry["best_emit"]
        normalise = torch.where(best_emit > NEG / 2, best_emit, 0.0)
        # cumulative normalization N_t: every live score is offset by it,
        # so lm = score - ac + N_t at any record point
        norm = carry["norm"] + normalise

        if cfg.max_emit_hyps > 0:
            emit_thresh = carry["kth_emit"] - normalise
            if cfg.emit_prune_win > 0.0:
                emit_thresh = torch.clamp(emit_thresh, min=-cfg.emit_prune_win)
        else:
            emit_thresh = torch.full_like(
                normalise, -cfg.emit_prune_win if cfg.emit_prune_win > 0.0 else NEG)
        if cfg.phone_start_prune_win > 0.0:
            # out of place: the carry handed in may be resumed from again
            start_thresh = carry["best_start"] - cfg.phone_start_prune_win
            pruned = fr["score"].clone()
            entry = pruned[:, :, 0]
            pruned[:, :, 0] = torch.where(entry < start_thresh[:, None], NEG, entry)
            fr = dict(fr, score=pruned)

        # ---- internal propagation ----------------------------------------
        meta = tab["arc_meta"][fr["arc"].clamp(max=self.n_arcs + 1)]  # (B, K, 6)
        hmm = meta[:, :, 0]
        arc_ol = meta[:, :, 1]
        hmm_scores = gmm_t[:, tab["state_gmm"]].reshape(B, self.H, S)
        trP = tab["trP"][hmm]  # (B, K, S, S)
        emitting = tab["emitting"][hmm]  # (B, K, S)
        outp = hmm_scores.gather(1, hmm[:, :, None].expand(B, K, S))
        trP = torch.where((fr["arc"] > self.n_arcs)[:, :, None, None], NEG, trP)

        m = fr["score"][:, :, :, None] + trP  # (B, K, i, j)
        new_score = m.amax(dim=2)
        best_i = m.argmax(dim=2)  # first max, like jnp.argmax
        new_ac = fr["ac"].gather(2, best_i) + trP.gather(2, best_i[:, :, None, :])[:, :, 0]
        new_path = fr["path"].gather(2, best_i)

        ns = new_score - normalise[:, None, None]
        pass_emit = emitting & (ns > emit_thresh[:, None, None]) & (new_score > NEG / 2)
        score2 = torch.where(pass_emit, ns + outp, NEG)
        ac2 = torch.where(pass_emit, new_ac + outp, NEG)
        path2 = torch.where(pass_emit, new_path, -1)

        best_emit = score2.reshape(B, -1).amax(dim=1)
        if cfg.max_emit_hyps > 0:
            kth_emit = self._histogram_thresh(score2, pass_emit)
        else:
            kth_emit = carry["kth_emit"]

        # exit state: the best emitting predecessor, first max on ties
        exit_w = trP[:, :, :, S - 1]
        exit_cand = score2 + exit_w
        j_best = exit_cand.argmax(dim=2, keepdim=True)
        exit_score = exit_cand.gather(2, j_best)[:, :, 0]
        exit_ok = exit_score > NEG / 2
        exit_score = torch.where(exit_ok, exit_score, NEG)
        exit_ac = torch.where(exit_ok, (ac2 + exit_w).gather(2, j_best)[:, :, 0], NEG)
        exit_path = torch.where(exit_ok, path2.gather(2, j_best)[:, :, 0], -1)
        best_end = exit_score.amax(dim=1)

        fr = {"arc": fr["arc"], "score": score2, "ac": ac2, "path": path2}

        # ---- external propagation ----------------------------------------
        end_thresh = (best_end - cfg.phone_end_prune_win
                      if cfg.phone_end_prune_win > 0.0 else torch.full_like(best_end, NEG))
        word_thresh = (best_end - cfg.word_prune_win
                       if cfg.word_prune_win > 0.0 else torch.full_like(best_end, NEG))
        thresh_k = torch.where(arc_ol == 0, end_thresh[:, None], word_thresh[:, None])
        live_exit = exit_ok & (exit_score > thresh_k) & (fr["arc"] <= self.n_arcs)

        cand = self._expand(exit_score, exit_ac, exit_path, meta[:, :, 2],
                            meta[:, :, 3], live_exit, fr["arc"])
        best_final, f_overflow = self._expand_finals(
            exit_score, exit_ac, exit_path, meta[:, :, 4], meta[:, :, 5],
            live_exit, fr["arc"], norm)
        fr, rec, best_entry, m_overflow = self._merge_and_insert(fr, cand, t, norm)

        carry_new = {
            "fr": fr,
            "best_emit": torch.maximum(best_emit, best_entry),
            "best_start": best_entry,
            "kth_emit": kth_emit,
            "best_final": best_final,
            "norm": norm,
            "overflow": carry["overflow"] | cand["overflow"] | m_overflow | f_overflow,
        }
        rec["n_cand"] = cand["n_cand"]
        return carry_new, rec

    # ------------------------------------------------------------------
    # full decode
    # ------------------------------------------------------------------

    def _init_carry(self, B: int):
        """Initial propagation from the virtual start source (row n_arcs of
        the metadata table), records encoded at t = -1."""
        K, S = self.K, self.S
        dev = self.device
        fr = {
            "arc": torch.full((B, K), self.n_arcs + 1, dtype=_I64, device=dev),
            "score": torch.full((B, K, S), NEG, dtype=_F32, device=dev),
            "ac": torch.full((B, K, S), NEG, dtype=_F32, device=dev),
            "path": torch.full((B, K, S), -1, dtype=_I64, device=dev),
        }
        src_score = torch.full((B, K), NEG, dtype=_F32, device=dev)
        src_score[:, 0] = 0.0
        src_zero = torch.zeros((B, K), dtype=_F32, device=dev)
        src_path = torch.full((B, K), -1, dtype=_I64, device=dev)
        live = torch.zeros((B, K), dtype=torch.bool, device=dev)
        live[:, 0] = True
        meta0 = self.tab["arc_meta"][self.n_arcs].expand(B, K, 6)
        src = torch.full((B, K), self.n_arcs, dtype=_I64, device=dev)
        norm0 = torch.zeros((B,), dtype=_F32, device=dev)
        cand = self._expand(src_score, src_zero, src_path, meta0[:, :, 2],
                            meta0[:, :, 3], live, src)
        best_final, f_ov = self._expand_finals(
            src_score, src_zero, src_path, meta0[:, :, 4], meta0[:, :, 5],
            live, src, norm0)
        fr, rec0, best_entry, m_ov = self._merge_and_insert(fr, cand, -1, norm0)
        # binned histogram: an empty histogram still thresholds at the
        # minScore floor on the first frame
        kth0 = self._hist_min - 0.5 if self.cfg.max_emit_hyps > 0 else NEG
        carry = {
            "fr": fr,
            # the reference updates bestEmitScore on entry-token creation,
            # including the initial propagation
            "best_emit": best_entry,
            "best_start": best_entry,
            "kth_emit": torch.full((B,), kth0, dtype=_F32, device=dev),
            "best_final": best_final,
            "norm": norm0,
            "overflow": cand["overflow"] | m_ov | f_ov,
        }
        return carry, rec0

    def run(self, gmm_scores: torch.Tensor, carry=None, t0: int = 0):
        """Decode a (B, T, n_gmms) float32 score batch on the decoder's
        device. Returns (carry, ys, rec0) as device tensors: ys holds the
        (T, B, K) traceback records and, with `cfg.emit_diagnostics`, the
        (T, B) per-frame best-final snapshots and counters.

        With `carry` (an earlier call's, left unchanged) the decode resumes
        from it at frame `t0`, which offsets the record ids `t*K + slot`:
        a decode in chunks equals the decode in one piece. `rec0`, the
        records of the initial propagation, is None for a resumed call."""
        if gmm_scores.device != self.device:
            raise ValueError(f"scores on {gmm_scores.device}, decoder on {self.device}")
        B, T = gmm_scores.shape[:2]
        t0 = int(t0)
        if t0 < 0 or (t0 + T) * self.K >= 2**31:
            raise ValueError(f"(t0+T)*K = {(t0 + T) * self.K} exceeds int32 record ids")
        scores = gmm_scores.to(_F32)
        dev = self.device
        K = self.K
        if carry is None:
            carry, rec0 = self._init_carry(B)
        else:
            rec0 = None
        int_fields = ("rec_prev", "rec_seq", "rec_src", "rec_arc")
        ys = {name: torch.empty((T, B, K), device=dev,
                                dtype=torch.int32 if name in int_fields else _F32)
              for name in REC_FIELDS}
        diag = self.cfg.emit_diagnostics
        if diag:
            for f in BF_FIELDS:
                ys["bf_" + f] = torch.empty(
                    (T, B), device=dev,
                    dtype=_F32 if f in ("score", "ac", "lm") else torch.int32)
            ys["n_active"] = torch.empty((T, B), dtype=torch.int32, device=dev)
            ys["n_cand"] = torch.empty((T, B), dtype=torch.int32, device=dev)
        for t in range(T):
            carry, rec = self._frame_step(carry, scores[:, t], t0 + t)
            for name in REC_FIELDS:
                ys[name][t] = rec[name]
            if diag:
                for f in BF_FIELDS:
                    ys["bf_" + f][t] = carry["best_final"][f]
                ys["n_active"][t] = rec["n_active"]
                ys["n_cand"][t] = rec["n_cand"]
        return carry, ys, rec0

    def _fused_single(self, sc: torch.Tensor):
        """One utterance (T, n_gmms) through the fused scan at B=1: one
        launch of the frame-step kernel. Raises where the kernel does not
        cover the decode, as `BatchDecoder(use_fused="auto")` does."""
        from .fused_scan import FusedDecodeScan, why_not_covered

        why = why_not_covered(self, int(sc.shape[0]))
        if why is not None:
            raise ValueError(
                f"decode_scores: the fused scan does not cover this decode ({why}); "
                f"TorchDecoder.run is the plain frame loop")
        fs = self.__dict__.get("_fused1")
        if fs is None:
            fs = self._fused1 = FusedDecodeScan(self, 1)
        carry, ys = fs(sc[:, None, :].contiguous())
        return carry, ys, fs.rec0

    def decode_scores(self, gmm_scores) -> DecodeResult:
        """Decode from a precomputed (T, n_gmms) log-likelihood matrix. A
        decoder on the card goes through the frame-step kernel (one launch)
        or raises; a CPU decoder runs the plain frame loop `run`."""
        if not isinstance(gmm_scores, torch.Tensor):
            gmm_scores = torch.from_numpy(np.array(gmm_scores, np.float32))
        sc = gmm_scores.to(self.device, _F32)
        T = int(sc.shape[0])
        true_T = None
        if self.cfg.emit_diagnostics:
            T_pad = max(self.T_BUCKET, -(-T // self.T_BUCKET) * self.T_BUCKET)
            if T_pad != T and T > 0:
                sc = torch.cat([sc, sc[-1:].expand(T_pad - T, -1)])
                true_T = T
        if T == 0:
            # no frame to step on either route: the result is read from the
            # initial propagation, which `run` hands back as it built it
            carry, ys, rec0 = self.run(sc[None])
        elif self.device.type == "cuda":
            carry, ys, rec0 = self._fused_single(sc)
        else:
            carry, ys, rec0 = self.run(sc[None])
        return self.traceback(host_batch(carry, ys, rec0), 0, int(sc.shape[0]),
                              true_T=true_T)

    # ------------------------------------------------------------------
    # traceback (host)
    # ------------------------------------------------------------------

    def traceback(self, host, b: int, T: int, true_T: Optional[int] = None) -> DecodeResult:
        """Words of utterance `b` from a host copy of a batch decode
        (`host_batch`), as `TpuDecoder._traceback` reads them. The records
        are the dense (T, B, K) planes of `run` or the compact records of
        the fused scan; one lookup reads a record from either."""
        carry, ys, rec0 = host
        if true_T is not None and 0 < true_T < T:
            # padded batch entry: the best-final snapshot at the true length
            bf = {f: ys["bf_" + f][true_T - 1, b] for f in BF_FIELDS}
            T = true_T
        else:
            bf = {f: carry["best_final"][f][b] for f in BF_FIELDS}
        overflow = bool(carry["overflow"][b])
        if overflow:
            import warnings

            warnings.warn(
                "TorchDecoder: expansion/frontier budget overflow; results may be pruned")
        na = ys["n_active"][:, b] if "n_active" in ys else np.zeros(1)
        nc = ys["n_cand"][:, b] if "n_cand" in ys else np.zeros(1)
        stats = dict(
            avg_active=float(na[:T].mean()) if na.size else 0.0,
            max_active=int(na[:T].max()) if na.size else 0,
            max_cand=int(nc[:T].max()) if nc.size else 0,
            overflow=overflow,
        )
        score = float(bf["score"])
        if score <= NEG / 2:
            return DecodeResult([], [], NEG, NEG, NEG, T, **stats)
        K = self.K
        seqs = self.art.seqs
        if "records" in ys:
            # this utterance's records, ascending in id
            lo, hi = ys["rec_offsets"][b], ys["rec_offsets"][b + 1]
            rows = ys["records"][lo:hi]
            rows_f = rows.view(np.float32)
            ids = rows[:, 0]

            def lookup(pid):
                i = int(np.searchsorted(ids, pid))
                if i >= len(ids) or ids[i] != pid:
                    raise RuntimeError(f"traceback: no record {pid} of utterance {b}")
                return (int(rows[i, 1]), int(rows[i, 2]), float(rows_f[i, 3]),
                        float(rows_f[i, 4]), float(rows_f[i, 5]),
                        int(rows[i, 6]), int(rows[i, 7]))
        else:
            def lookup(pid):
                at = (pid // K, b, pid % K)
                return tuple(conv(ys[name][at]) for name, conv in zip(
                    REC_FIELDS, (int, int, float, float, float, int, int)))

        def rec_fields(pid):
            if pid >= 0:
                prev, seq_id, s, a, l, src, arc_b = lookup(pid)
                return prev, seq_id, s, a, l, pid // K, src, arc_b
            # init records are encoded at t=-1 -> pid in [-K, 0); their
            # words are reported at frame 0, like the reference
            at = pid + K
            return (int(rec0["rec_prev"][b, at]), int(rec0["rec_seq"][b, at]),
                    float(rec0["rec_score"][b, at]), float(rec0["rec_ac"][b, at]),
                    float(rec0["rec_lm"][b, at]), 0,
                    int(rec0["rec_src"][b, at]), int(rec0["rec_arc"][b, at]))

        # a record stores its LANDING values; each label's crossing-time
        # values differ by a per-closure-edge constant (artifact.remainders);
        # the overall-last label carries the best-final values
        def seg_hyps(labels, frame, s, a, l, rem):
            out = []
            for j, lab in enumerate(labels):
                if rem is not None and j < len(rem):
                    rs, rl, ra = rem[j]
                    out.append(WordHyp(lab, frame, s - rs, a - ra, l - rl))
                else:
                    out.append(WordHyp(lab, frame, s, a, l))
            return out

        bf_ac, bf_lm = float(bf["ac"]), float(bf["lm"])
        segs: list[list[WordHyp]] = []  # last segment first
        fseq = seqs[int(bf["seq"])]
        if fseq:
            rem = (self.art.final_remainders(int(bf["src"]), int(bf["seq"]))
                   if int(bf["src"]) >= 0 else None)
            seg = seg_hyps(fseq, T - 1, score, bf_ac, bf_lm, rem)
            seg[-1] = WordHyp(seg[-1].word, T - 1, score, bf_ac, bf_lm)
            segs.append(seg)
        pid = int(bf["path"])
        first = not fseq
        while pid != -1:
            prev, seq_id, s, a, l, frame, src, arc_b = rec_fields(pid)
            rem = (self.art.remainders(src, arc_b, seq_id)
                   if src >= 0 and arc_b >= 0 else None)
            seg = seg_hyps(seqs[seq_id], frame, s, a, l, rem)
            if first and seg:
                seg[-1] = WordHyp(seg[-1].word, frame, score, bf_ac, bf_lm)
                first = False
            segs.append(seg)
            pid = prev
        hyps = [h for seg in reversed(segs) for h in seg]
        return DecodeResult(
            words=[h.word for h in hyps], word_hyps=hyps, score=score,
            acoustic_score=bf_ac, lm_score=bf_lm, n_frames=T, **stats,
        )


def written_records(records: torch.Tensor, n: torch.Tensor):
    """The written prefix of every utterance's record arena, end to end:
    records (B, cap, 8), n (B,) counts -> ((N, 8) rows in utterance order,
    (B + 1,) offsets, both on the records' device). Nothing beyond the
    counts is read."""
    n = n.to(torch.int64)
    offsets = torch.zeros(n.shape[0] + 1, dtype=torch.int64, device=n.device)
    offsets[1:] = torch.cumsum(n, 0)
    n_max = int(n.max()) if n.numel() else 0
    b_idx, pos = (torch.arange(n_max, device=n.device)[None] < n[:, None]).nonzero(as_tuple=True)
    return records[b_idx, pos], offsets


def host_batch(carry, ys, rec0):
    """One device-to-host copy of what the traceback reads: best-final and
    overflow from the carry, the init records, the (T, B) snapshots, and
    the records: the dense planes of `run`, or of a fused scan's compact
    `ys` the running counts and only the written prefix of each
    utterance's arena (`records` (N, 8) with `rec_offsets` (B + 1,))."""
    carry_h = {
        "best_final": {f: v.cpu().numpy() for f, v in carry["best_final"].items()},
        "overflow": carry["overflow"].cpu().numpy(),
    }
    if "records" in ys:
        rows, offsets = written_records(ys["records"], ys["rec_count"][-1])
        ys_h = {k: v.cpu().numpy() for k, v in ys.items() if k != "records"}
        ys_h["records"] = rows.cpu().numpy()
        ys_h["rec_offsets"] = offsets.cpu().numpy()
    else:
        ys_h = {k: v.cpu().numpy() for k, v in ys.items()}
    rec0_h = {k: rec0[k].cpu().numpy() for k in REC_FIELDS}
    return carry_h, ys_h, rec0_h
