"""Decoder core: dense-frontier Viterbi beam search in PyTorch.

Counterpart of `juicer_tpu/decoder/tpu_core.py` (`TpuDecoder`), in every
configuration the JAX engine decodes: float32 or float64 (`dtype`), the
binned or the exact histogram (`histogram_mode`), the dense or the sort
merge (`merge_strategy`; "auto" takes the sort merge above E = 32768, as
the JAX engine does), each with or without lattice records
(`gen_lattice`), over a static network or by on-the-fly composition
(`g_network=`, a `decoder.otf.GNetwork`: the network is CL, frontier
slots are keyed by (CL arc, G state) pairs, each crossed word is
intersected with G by match-or-backoff, finals reach a G final through
backoff, and `otf_pushing` adds the G weight of an arc's anticipated
word at entry and takes it off at exit).

The frame step carries a leading batch axis: the frontier is (B, K, S)
(K active-arc slots of S padded HMM states per utterance), so one
decoder runs B utterances at once and `decode_scores` is the case B=1.
Per frame it does what `TpuDecoder._frame_step` does, op for op in the
decoder's float dtype, so records, words and scores equal the JAX
engine's:

  - within-HMM max-plus propagation with first-max argmax payloads;
  - the emit beam and either the reference's integer-binned histogram
    threshold (`Histogram::calcThresh`), counted with one scatter-add per
    row, or the exact k-th best emitting score (`torch.topk`);
  - HMM exit, the phone-end and word-end beams;
  - closure expansion through the artifact's per-arc tables
    (`_expand`, `_final_rows`, `_best_final`);
  - with a G, the G advance of each candidate's words and of each final
    candidate's, in one call (`_intersect`), then the G state's final
    reach;
  - recombination: per target arc (per (arc, G state) pair with a G)
    the best candidate wins, ties to the lowest candidate index. The dense merge lands a winner in that arc's
    live slot or in the next free slot by candidate order
    (`_merge_and_insert_dense`); the sort merge first compacts the live
    slots to [0, n_live) in arc order and gives new winners the slots
    after them (`_merge_and_insert_sort`). The two number slots, and so
    record ids `t*K + slot`, differently; each equals its JAX strategy;
  - one traceback record per landed winner that crossed output labels;
  - with `gen_lattice`, the lattice records: an event per landed slot
    (`ev_*`), an edge per valid candidate (`lat_*`) and per valid final
    candidate (`flat_*`), each token carrying the id of its entry event.

What the TPU needed and a GPU does not is gone. One-hot matmuls and
one-hot payload selects are real gathers (`torch.gather`), which select
the same values exactly. The dense (E, E) winner compare is two stable
sorts and the (E, K) slot routing is a binary search over the sorted
live arcs: the same winners and slots, found in O(E log E). The
`associative_scan` forward fill is a `cummax` over source positions. The
(arc, G state) pair is one int64 key `arc * nG + g` in both merges' sorts
and searches. The G advance is a `searchsorted` a backoff level over G's
sorted arc keys, where the JAX engine gathers padded rows of G arcs.
`mode="drop"` scatters go to an extra dump column that is sliced off,
and the one winner scatter writes unique indices, so no result depends
on write order. Record ids (`t*K + slot`), lattice event ids and
closure-table offsets are integer tensors, so the JAX package's f32
hi/lo base split and its float32 limit T*K < 2**24 are not needed. The
frame loop is a Python loop that never reads a device value back:
overflow and best-final stay on the device until the loop ends.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..utils import trace
from .artifact import DecoderArtifact
from .results import DecodeResult, WordHyp

NEG = -1.0e30
_I64 = torch.int64
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# above this expansion budget "auto" takes the sort merge, as the JAX engine
# does (`tpu_core.py`), so that the records' slot numbering stays the same
SORT_ABOVE_E = 32768

REC_FIELDS = ("rec_prev", "rec_seq", "rec_score", "rec_ac", "rec_lm",
              "rec_src", "rec_arc")
BF_FIELDS = ("score", "ac", "lm", "path", "seq", "src")
# the eight words of a compact record (`fused_scan.compact_records`): its
# id t*K + slot and the seven fields, floats as their bit patterns; int32
# words for float32 records, int64 words for float64 records
REC_WORDS = ("rec_id",) + REC_FIELDS
# the lattice records of `run` with `gen_lattice`: per frame an edge per
# candidate (E), a final edge per final candidate (F) and an event per
# slot (K); `rec0` holds the initial propagation's edges and events
LAT_FIELDS = ("lat_from_ev", "lat_to_arc", "lat_ac", "lat_lm", "lat_seq", "lat_valid")
FLAT_FIELDS = ("flat_from_ev", "flat_ac", "flat_lm", "flat_seq", "flat_valid")
EV_FIELDS = ("ev_arc", "ev_ac", "ev_lm")
# with a G, edges and events carry the G state of their (arc, G state) key
G_LAT_FIELDS = ("lat_to_g",)
G_EV_FIELDS = ("ev_g",)


# the integer words of a float dtype's compact records
RECORD_WORDS = {torch.float32: torch.int32, torch.float64: torch.int64}


def float_view(words):
    """Compact record words (numpy or torch) viewed as the floats whose
    bits they carry: float32 from int32 words, float64 from int64 words."""
    if isinstance(words, torch.Tensor):
        return words.view(torch.float64 if words.dtype == torch.int64 else torch.float32)
    return words.view(np.float64 if words.dtype == np.int64 else np.float32)


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
    # "binned": the reference's integer-binned threshold; "exact": the
    # true k-th best emitting score
    histogram_mode: str = "binned"
    # "dense", "sort", or "auto" (the sort merge above E = 32768)
    merge_strategy: str = "auto"
    dtype: str = "float32"  # or "float64"
    gen_lattice: bool = False  # lattice records (`decode_scores_lattice`)
    # with a G: label-and-weight pushing (the G weight of an arc's
    # anticipated word added at entry, taken off at exit)
    otf_pushing: bool = False
    # per-frame best-final snapshots (exact padded decoding) + active-inst
    # counters; off for benchmarks
    emit_diagnostics: bool = True


def _rup(x, m=128):
    return max(m, ((int(x) + m - 1) // m) * m)


def _device_tables(art: DecoderArtifact, device: torch.device, dtype=torch.float32) -> dict:
    """Config-independent tables, cached on the artifact per device and
    float dtype and shared by every decoder built on it; the integer
    columns are shared by both dtypes. The entry tables are the bulk, 24
    bytes an entry in float32 (`ent_arc` and `ent_seq` int64, `ent_score`
    and `ent_ac` float32; float64 adds 8): 17.6M entries (422 MB) on the
    2k-word WSJ-order task, 213M (5.1 GB) on the 20k-word one. Each column
    is copied in the artifact's own dtype and converted on the device, so
    no converted host copy of a column is made for the card."""
    cache = art.__dict__.setdefault("_torch_tables", {})
    tabs = cache.get((str(device), dtype))
    if tabs is not None:
        return tabs
    ex = art.expansion

    def col(a, dt, n_min=1):
        # tables keep at least one row so clamped gathers stay in range
        a = np.asarray(a)
        if len(a) < n_min:
            a = np.zeros(n_min, a.dtype)
        return torch.from_numpy(a).to(device).to(dt)

    ints = cache.get(str(device))
    if ints is None:
        # per-arc metadata rows [hmm, olabel, ent_base, ent_fan, f_base,
        # f_fan]; row n_arcs = the virtual start source, n_arcs+1 = the
        # dead sentinel
        n = art.n_hmm_arcs
        meta = np.zeros((n + 2, 6), np.int64)
        meta[:n, 0] = art.arc_hmm
        meta[:n, 1] = art.arc_olabel
        meta[: n + 1, 2] = ex.row_ptr[:-1]
        meta[: n + 1, 3] = np.diff(ex.row_ptr)
        meta[: n + 1, 4] = ex.frow_ptr[:-1]
        meta[: n + 1, 5] = np.diff(ex.frow_ptr)
        H = art.trP.shape[0]
        ints = cache[str(device)] = {
            "arc_meta": torch.as_tensor(meta, device=device),
            "ent_arc": col(ex.arc, _I64),
            "ent_seq": col(ex.seq, _I64),
            "f_seq": col(ex.f_seq, _I64),
            "emitting": torch.as_tensor(np.asarray(art.state_gmm) >= 0, device=device),
            "state_gmm": torch.as_tensor(
                np.maximum(art.state_gmm, 0).reshape(H * art.S).astype(np.int64),
                device=device),
        }
    tabs = dict(ints)
    tabs.update({
        "ent_score": col(ex.w_score, dtype),
        "ent_ac": col(ex.w_ac, dtype),
        "f_score": col(ex.f_score, dtype),
        "f_ac": col(ex.f_ac, dtype),
        "trP": torch.as_tensor(np.asarray(art.trP), device=device).to(dtype),
    })
    cache[(str(device), dtype)] = tabs
    return tabs


def _g_device_tables(art: DecoderArtifact, g, device: torch.device, dtype,
                     pushing: bool) -> dict:
    """The tables of on-the-fly composition, cached like `_device_tables`:
    G's on the `GNetwork` per device and float dtype (the sorted arc keys
    `state * W + label`, their targets and weights, the backoff arc of
    each state and the final reach, weights rounded once from float64 to
    the decoder's dtype), the artifact's on the artifact per device (each
    label sequence's words, zero-padded, and with `pushing` each arc's
    anticipated word, rows n_arcs and n_arcs+1 zero)."""
    def col(a, dt):
        return torch.from_numpy(np.asarray(a)).to(device).to(dt)

    g_cache = g.__dict__.setdefault("_torch_tables", {})
    tabs = g_cache.get((str(device), dtype))
    if tabs is None:
        # the arcs end in a sentinel key above every key a search asks for,
        # so the position a search returns always indexes the tables
        tabs = g_cache[(str(device), dtype)] = {
            "g_key": col(np.append(g.arc_key, g.n_states * g.W), _I64),
            "g_dst": col(np.append(g.arc_dst, 0), _I64),
            "g_w": col(np.append(g.arc_w, 0.0), dtype),
            "g_bo_dst": col(g.bo_dst, _I64),
            "g_bo_w": col(g.bo_w, dtype),
            "g_freach": col(g.final_reach, dtype),
        }
    tabs = dict(tabs)
    a_cache = art.__dict__.setdefault("_torch_tables", {})
    seq_words = a_cache.get(("seq_words", str(device)))
    if seq_words is None:
        L = max(max((len(s) for s in art.seqs), default=1), 1)
        words = np.zeros((len(art.seqs), L), np.int64)
        for i, s in enumerate(art.seqs):
            words[i, :len(s)] = s
        seq_words = a_cache[("seq_words", str(device))] = torch.from_numpy(words).to(device)
    tabs["seq_words"] = seq_words
    if pushing:
        push = a_cache.get(("push_label", str(device)))
        if push is None:
            push = a_cache[("push_label", str(device))] = col(
                np.concatenate([art.anticipated_labels(), [0, 0]]), _I64)
        tabs["push_label"] = push
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
    """1-best decoder on one device (default: the card): of a static
    network, or with `g_network` (a `decoder.otf.GNetwork`) of the
    artifact's CL network composed on the fly with that G."""

    # utterances are padded up to multiples of this many frames, as in the
    # JAX engine (whose scan compiles once per bucket); results stay exact
    # through the per-frame best-final snapshot
    T_BUCKET = 128

    def __init__(self, artifact: DecoderArtifact,
                 config: Optional[TorchDecoderConfig] = None,
                 device="cuda", g_network=None):
        cfg = config or TorchDecoderConfig()
        if cfg.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {cfg.dtype!r}")
        if cfg.histogram_mode not in ("binned", "exact"):
            raise ValueError(f"unknown histogram_mode {cfg.histogram_mode!r}")
        if cfg.merge_strategy not in ("auto", "dense", "sort"):
            raise ValueError(f"unknown merge_strategy {cfg.merge_strategy!r}")
        self.art = artifact
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]

        # budgets never exceed the network: at most n_hmm_arcs insts are
        # live, and one frame expands each closure entry at most once. With
        # a G slots are (arc, G state) pairs, and one arc may exit from
        # several G states in a frame: K x the largest fan-out bounds E
        ex = artifact.expansion
        self.g = g_network
        self.otf = g_network is not None
        self.pushing = self.otf and cfg.otf_pushing
        # the G state count: (arc, g) pairs are keyed arc * nG + g
        self.nG = max(g_network.n_states, 1) if self.otf else 1
        if self.otf:
            self.K = min(cfg.max_insts, _rup(artifact.n_hmm_arcs * self.nG + 1))
            fan = max(int(np.diff(ex.row_ptr).max(initial=0)), 1)
            ffan = max(int(np.diff(ex.frow_ptr).max(initial=0)), 1)
            self.E = min(cfg.expand_budget, _rup(self.K * fan + 1))
            self.F = min(cfg.final_budget, _rup(self.K * ffan + 1))
        else:
            self.K = min(cfg.max_insts, _rup(artifact.n_hmm_arcs + 1))
            self.E = min(cfg.expand_budget, _rup(len(ex.arc) + 1))
            self.F = min(cfg.final_budget, _rup(len(ex.f_score) + 1))
        self.lat_fields = LAT_FIELDS + (G_LAT_FIELDS if self.otf else ())
        self.ev_fields = EV_FIELDS + (G_EV_FIELDS if self.otf else ())
        self.merge_strategy = cfg.merge_strategy
        if self.merge_strategy == "auto":
            self.merge_strategy = "sort" if self.E > SORT_ABOVE_E else "dense"
        self.S = artifact.S
        self.n_arcs = artifact.n_hmm_arcs
        self.H = artifact.trP.shape[0]
        self.tab = _device_tables(artifact, self.device, self.dtype)
        if self.otf:
            self.gtab = _g_device_tables(artifact, g_network, self.device, self.dtype,
                                         self.pushing)

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

    def _expand(self, score, ac, path, base, fan, live, src_arc, lat=None):
        """Fixed-budget expansion of exiting tokens (B, K) through the
        closure tables into E candidates per utterance. `lat`, the exiting
        tokens' entry-event ids, rides along as the candidates' `lat_from`;
        `k` is each candidate's source token (with a G, `_intersect` reads
        its G state)."""
        tab = self.tab
        k, row, valid, total = _closure_rows(fan, live, base, self.E)
        ent = row.clamp(0, tab["ent_arc"].shape[0] - 1)
        s_score = score.gather(1, k)
        cand_score = torch.where(valid, s_score + tab["ent_score"][ent], NEG)
        cand = {
            "arc": torch.where(valid, tab["ent_arc"][ent], 0),
            "score": cand_score,
            "ac": ac.gather(1, k) + tab["ent_ac"][ent],
            "prev": path.gather(1, k),
            "seq": tab["ent_seq"][ent],
            "src": src_arc.gather(1, k),
            "valid": valid & (cand_score > NEG / 2),
            "overflow": total > self.E,
            "n_cand": total,
            "k": k,
        }
        if lat is not None:
            cand["lat_from"] = lat.gather(1, k)
        return cand

    def _g_advance(self, g, words_valid, word):
        """Consume `word` from G state `g` by match-or-backoff, elementwise
        (counterpart of `TpuDecoder._g_advance`). Returns (G state, weight,
        ok); where `words_valid` is False nothing is consumed and ok holds.

        Each level searches the state's arc for the word among G's sorted
        keys `state * W + word` (a left search: the first of duplicate
        arcs), takes it if there, else follows the state's backoff arc. The
        weight adds the backoff weights in order, then the matched arc's.
        A word G cannot take leaves ok False and the state where the walk
        stopped."""
        gt = self.gtab
        W = self.g.W
        gw = torch.zeros(g.shape, dtype=self.dtype, device=g.device)
        cur = g.clamp(min=0)
        # a word outside the vocabulary gets a negative key, which no arc has
        word_key = torch.where(word < W, word, -(2 ** 40))
        pending = words_valid  # lanes still walking
        failed = torch.zeros_like(words_valid)
        for _ in range(self.g.max_backoff + 1):
            key = cur * W + word_key
            # `g_key` ends in a sentinel above every key: pos is in range
            pos = torch.searchsorted(gt["g_key"], key)
            hit = pending & (gt["g_key"][pos] == key)
            bo, bo_w = gt["g_bo_dst"][cur], gt["g_bo_w"][cur]
            cur = torch.where(hit, gt["g_dst"][pos], cur)
            gw = torch.where(hit, gw + gt["g_w"][pos], gw)
            pending = pending & ~hit
            # the backoff read before the move is that of the state that
            # did not match; a lane with neither fails where it stands
            can_bo = pending & (bo >= 0)
            gw = torch.where(can_bo, gw + bo_w, gw)
            failed = failed | (pending ^ can_bo)
            pending = can_bo
            cur = torch.where(can_bo, bo, cur)
        return cur, gw, ~(failed | pending)

    def _g_advance_seq(self, g, seq_ids):
        """Consume each label sequence's words from G in turn. Returns (G
        state, summed weight, ok)."""
        words = self.gtab["seq_words"][seq_ids]
        total = torch.zeros(g.shape, dtype=self.dtype, device=g.device)
        ok = torch.ones(g.shape, dtype=torch.bool, device=g.device)
        for li in range(words.shape[-1]):
            w = words[..., li]
            used = w != 0
            g, gw, step_ok = self._g_advance(g, used, w)
            total = torch.where(used, total + gw, total)
            ok = ok & step_ok
        return g, total, ok

    def _intersect(self, cand, g, fin=None):
        """G on the candidates, whose source tokens sit in G states `g`: the
        crossed words advance G (`cand["g"]`), their weight joins the
        score, and a candidate whose words G cannot take gets score NEG and
        is no longer valid (its other fields stay). With pushing, the G
        weight of the target arc's anticipated word is added (`cand["la"]`)
        and a candidate whose anticipated word G cannot take dies. The
        final candidates `fin` (`_final_rows`) advance in the same call;
        their (G state, weight, ok) is returned for `_best_final`."""
        k, seq = cand["k"], cand["seq"]
        if fin is not None:
            k = torch.cat([k, fin["k"]], dim=1)
            seq = torch.cat([seq, self.tab["f_seq"][fin["ent"]]], dim=1)
        g_all, gw, okg = self._g_advance_seq(g.gather(1, k), seq)
        E = cand["k"].shape[1]
        cand["g"] = g_all[:, :E]
        cand["score"] = torch.where(okg[:, :E], cand["score"] + gw[:, :E], NEG)
        cand["valid"] = cand["valid"] & okg[:, :E]
        if self.pushing:
            pl = self.gtab["push_label"][cand["arc"].clamp(max=self.n_arcs + 1)]
            _, push_w, ok_push = self._g_advance(cand["g"], pl != 0, pl)
            la = torch.where((pl != 0) & ok_push, push_w, 0.0)
            cand["valid"] = cand["valid"] & ((pl == 0) | ok_push)
            cand["score"] = torch.where(cand["valid"], cand["score"] + la, cand["score"])
            cand["la"] = la
        if fin is not None:
            return g_all[:, E:], gw[:, E:], okg[:, E:]
        return None

    def _final_rows(self, score, ac, base, fan, live):
        """The final-state candidates of exiting tokens (B, K), laid out in
        a budget of F per utterance: source token `k`, closure-table row
        `ent`, `valid`, the total wanted, and the score and acoustic score
        with the final entry applied."""
        tab = self.tab
        k, row, valid, total = _closure_rows(fan, live, base, self.F)
        ent = row.clamp(0, tab["f_score"].shape[0] - 1)
        return {"k": k, "ent": ent, "valid": valid, "total": total,
                "sc": torch.where(valid, score.gather(1, k) + tab["f_score"][ent], NEG),
                "fac": ac.gather(1, k) + tab["f_ac"][ent]}

    def _best_final(self, fin, path, src_arc, norm, lat=None, g_step=None):
        """This frame's best final-state reach per utterance (the
        bestFinalToken update) and the final-budget overflow flag; with
        `lat`, also every final candidate as a lattice final edge
        (`FLAT_FIELDS`, else None). With a G, `g_step` is the final
        candidates' G advance (`_intersect`): the G state's final reach
        and the weight of the words join score and LM before the best is
        taken, and a candidate G cannot take or that reaches no G final is
        not valid."""
        tab = self.tab
        k, ent, valid, sc, fac = fin["k"], fin["ent"], fin["valid"], fin["sc"], fin["fac"]
        floor = NEG
        flm = None
        if g_step is not None or lat is not None:
            flm = sc - fac + norm[:, None]
        if g_step is not None:
            fg, fgw, fok = g_step
            freach = self.gtab["g_freach"][fg]
            valid = valid & fok & (freach > NEG / 2)
            sc = torch.where(valid, sc + fgw + freach, NEG)
            flm = flm + fgw + freach
            floor = NEG / 2
        i = sc.argmax(dim=1, keepdim=True)
        s_i = sc.gather(1, i)[:, 0]
        a_i = fac.gather(1, i)[:, 0]
        better = s_i > floor
        ki = k.gather(1, i)
        best = {
            "score": torch.where(better, s_i, NEG),
            "ac": torch.where(better, a_i, NEG),
            "lm": torch.where(better, s_i - a_i + norm if flm is None else flm.gather(1, i)[:, 0],
                              NEG),
            "path": torch.where(better, path.gather(1, ki)[:, 0], -1),
            "seq": torch.where(better, tab["f_seq"][ent.gather(1, i)[:, 0]], 0),
            "src": torch.where(better, src_arc.gather(1, ki)[:, 0], -1),
        }
        flat = None
        if lat is not None:
            flat = {"flat_from_ev": lat.gather(1, k), "flat_ac": fac, "flat_lm": flm,
                    "flat_seq": tab["f_seq"][ent], "flat_valid": valid}
        return best, fin["total"] > self.F, flat

    # ------------------------------------------------------------------
    # recombination + insertion
    # ------------------------------------------------------------------

    def _merge_and_insert(self, fr, cand, t: int, norm):
        if self.merge_strategy == "sort":
            return self._merge_and_insert_sort(fr, cand, t, norm)
        return self._merge_and_insert_dense(fr, cand, t, norm)

    def _merge_and_insert_dense(self, fr, cand, t: int, norm):
        """Recombine candidates per target arc and land the winners in the
        frontier (counterpart of `_merge_and_insert_dense`).

        The winner of an arc (of an (arc, G state) pair with a G) is its
        best-scoring candidate, ties to the lowest candidate index (the
        reference's first-come merge). The frontier holds at most one live
        slot per key, so a winner either hits that slot or takes a free
        one: new winners in candidate order take the free slots in slot
        order."""
        K = self.K
        live = self._live(fr)
        arc_cur, key_cur = self._keys(fr["arc"], fr.get("g"), live)
        n_live = live.sum(dim=1)

        valid = cand["valid"]
        ck, key = self._keys(cand["arc"], cand.get("g"), valid)
        g_score = torch.where(valid, cand["score"], NEG)

        # winners: order by (key, score descending, index) with two stable
        # sorts; the first candidate of each key group wins
        by_score = torch.argsort(g_score, dim=1, descending=True, stable=True)
        order = by_score.gather(
            1, torch.argsort(key.gather(1, by_score), dim=1, stable=True))
        key_sorted = key.gather(1, order)
        first = torch.ones_like(valid)
        first[:, 1:] = key_sorted[:, 1:] != key_sorted[:, :-1]
        winner = torch.zeros_like(valid).scatter_(1, order, first) & valid

        # slot routing: a binary search of each winner's key among the live
        # keys (unique; dead slots sort last under the sentinel)
        key_sorted, slot_of = torch.sort(key_cur, dim=1)
        pos = torch.searchsorted(key_sorted, key).clamp(max=K - 1)
        hit = winner & (key_sorted.gather(1, pos) == key)
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
        landed = {"arc": ck, "score": g_score, "ac": cand["ac"], "prev": cand["prev"],
                  "seq": cand["seq"], "src": cand["src"]}
        landed.update({name: cand[name] for name in ("g", "la") if name in cand})
        fr_new, rec = self._land(fr, arc_cur, landed, slot, w_ok, t, norm)
        # surviving + newly allocated insts this frame
        rec["n_active"] = (live | rec.pop("got")).sum(dim=1)
        best_new = torch.where(w_ok, g_score, NEG).amax(dim=1)
        return fr_new, rec, best_new, overflow

    def _merge_and_insert_sort(self, fr, cand, t: int, norm):
        """The sort merge (counterpart of `_merge_and_insert_sort`), which
        the JAX engine takes under "auto" above E=32768, where its dense
        merge's quadratic compare matrices cost more:

          1. a restore sort compacts the live slots to [0, n_live) in key
             order (arc, or (arc, G state) with a G), their token planes
             (and lattice ids, G states and lookaheads) with them;
          2. frontier heads (kind 0) and candidates (kind 1) are co-sorted
             stably by (key, kind, -score): a key group's first candidate
             wins, and merges into the slot of the head just before it;
          3. winners without a head take slots n_live + rank.

        Its records and frontier equal the dense merge's up to slot
        numbering; the numbering here is the JAX sort strategy's. The
        port's dense merge already sorts in O(E log E), so the port keeps
        this merge for equal records and lattices with the JAX engine, not
        for speed; its cost on the card above E=32768 is not measured."""
        K, S, E = self.K, self.S, self.E
        dev = norm.device
        B = norm.shape[0]
        dead = self.n_arcs + 1

        # ---- 1. restore sort ------------------------------------------------
        live = self._live(fr)
        _, key_fr = self._keys(fr["arc"], fr.get("g"), live)
        key_r, perm = torch.sort(key_fr, dim=1, stable=True)
        arc_r = key_r // self.nG if self.otf else key_r
        is_dead = (arc_r >= dead)[:, :, None]
        perm_s = perm[:, :, None].expand(B, K, S)
        fr_r = {name: torch.where(is_dead, fill, fr[name].gather(1, perm_s))
                for name, fill in (("score", NEG), ("ac", NEG), ("path", -1), ("lat", -1))
                if name in fr}
        fr_r["arc"] = arc_r
        if self.otf:
            fr_r["g"] = key_r % self.nG  # 0 in dead slots
        if self.pushing:
            fr_r["push_la"] = torch.where(is_dead[:, :, 0], 0.0, fr["push_la"].gather(1, perm))
        n_live = live.sum(dim=1)

        # ---- 2. co-sort of frontier heads and candidates ------------------
        valid = cand["valid"]
        _, key_c = self._keys(cand["arc"], cand.get("g"), valid)
        key = torch.cat([key_r * 2, key_c * 2 + 1], dim=1)
        neg_score = torch.cat([torch.zeros((B, K), dtype=self.dtype, device=dev),
                               torch.where(valid, -cand["score"], -NEG)], dim=1)
        by_score = torch.argsort(neg_score, dim=1, stable=True)
        order = by_score.gather(1, torch.argsort(key.gather(1, by_score), dim=1, stable=True))
        key_s = key.gather(1, order)
        ck, kind = key_s // 2, key_s % 2
        same = ck[:, 1:] == ck[:, :-1]
        no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        after_head = torch.cat([no, same & (kind[:, :-1] == 0)], dim=1)
        after_same = torch.cat([no, same], dim=1)
        winner = (kind == 1) & (~after_same | after_head) & (ck < dead * self.nG)
        heads_before = torch.arange(K + E, device=dev) - (torch.cumsum(kind, dim=1) - kind)
        hit = winner & after_head
        need_new = winner & ~after_head
        alloc = n_live[:, None] + torch.cumsum(need_new.to(_I64), dim=1) - 1
        overflow = (need_new & (alloc >= K)).any(dim=1)
        slot = torch.where(hit, heads_before - 1, torch.where(need_new, alloc, -1))
        w_ok = winner & (slot >= 0) & (slot < K)

        # ---- 3. the winners land ------------------------------------------
        ci = (order - K).clamp(min=0)  # the candidate of a sorted row
        landed = {"arc": ck, "score": -neg_score.gather(1, order)}
        if self.otf:
            landed.update(arc=ck // self.nG, g=ck % self.nG)
        for name in ("ac", "prev", "seq", "src", "la"):
            if name in cand:
                landed[name] = cand[name].gather(1, ci)
        fr_new, rec = self._land(fr_r, arc_r, landed, slot, w_ok, t, norm)
        # hits land inside the live prefix and must not count twice
        fresh = rec.pop("got") & (torch.arange(K, device=dev) >= n_live[:, None])
        rec["n_active"] = n_live + fresh.sum(dim=1)
        best_new = torch.where(w_ok, landed["score"], NEG).amax(dim=1)
        return fr_new, rec, best_new, overflow

    def _keys(self, arc, g, ok):
        """(arc, key) where `ok`, else (the dead sentinel n_arcs+1, its
        key): the key is the arc itself, or with a G the pair (arc, G
        state) as the int64 `arc * nG + g` (g 0 where not `ok`), which
        orders as the pair does."""
        dead = self.n_arcs + 1
        arc = torch.where(ok, arc, dead)
        if not self.otf:
            return arc, arc
        return arc, arc * self.nG + torch.where(ok, g, 0)

    def _live(self, fr):
        """Slots holding a token in states 0..S-2 (entry and exit columns
        are empty after internal propagation) on a real arc."""
        return ((fr["score"][:, :, : self.S - 1] > NEG / 2).any(dim=2)
                & (fr["arc"] <= self.n_arcs) & (fr["arc"] >= 0))

    def _land(self, fr, arc_cur, win_rows, slot, w_ok, t, norm):
        """The one winner scatter of both merges: the rows `win_rows` whose
        `w_ok` holds land in their `slot` (unique), as entry tokens and,
        where they crossed labels, as records; with lattices each landed
        slot is an event (`EV_FIELDS`, with a G also `ev_g`) and its entry
        token carries the event id. With a G the landed slot takes the
        winner's G state, and with pushing its lookahead, which the record
        LM leaves out (it is in the score, not yet in the LM). Returns
        (frontier, records with `got`)."""
        K = self.K
        dev = norm.device
        B, n_rows = slot.shape
        win = torch.full((B, K + 1), -1, dtype=_I64, device=dev)
        win.scatter_(1, torch.where(w_ok, slot, K),
                     torch.arange(n_rows, device=dev).expand(B, n_rows))
        win = win[:, :K]
        got = win >= 0
        wi = win.clamp(min=0)
        l = {name: v.gather(1, wi) for name, v in win_rows.items()}
        l_lm = l["score"] - l["ac"] + norm[:, None]
        if self.pushing:
            l_lm = l_lm - l["la"]
        has_seq = l["seq"] != 0
        slot_id = t * K + torch.arange(K, device=dev)
        entry_path = torch.where(has_seq, slot_id, l["prev"])

        score, ac, path = fr["score"], fr["ac"], fr["path"]
        score[:, :, 0] = torch.where(got, l["score"], NEG)
        ac[:, :, 0] = torch.where(got, l["ac"], NEG)
        path[:, :, 0] = torch.where(got, entry_path, -1)
        arc_new = torch.where(got, l["arc"], arc_cur)
        fr_new = {"arc": arc_new, "score": score, "ac": ac, "path": path}
        if self.otf:
            fr_new["g"] = torch.where(got, l["g"], fr["g"])
        if self.pushing:
            fr_new["push_la"] = torch.where(got, l["la"], fr["push_la"])

        rec_valid = got & has_seq
        rec = {
            "rec_prev": torch.where(rec_valid, l["prev"], -1),
            "rec_seq": torch.where(rec_valid, l["seq"], 0),
            "rec_score": torch.where(rec_valid, l["score"], NEG),
            "rec_ac": torch.where(rec_valid, l["ac"], NEG),
            "rec_lm": torch.where(rec_valid, l_lm, NEG),
            # source/landing arcs let the traceback recover crossing-time
            # per-label scores (artifact.remainders)
            "rec_src": torch.where(rec_valid, l["src"], -1),
            "rec_arc": torch.where(rec_valid, l["arc"], -1),
            "got": got,
        }
        if "lat" in fr:
            # the landing slot is a new lattice event, numbered as records are
            lat = fr["lat"]
            lat[:, :, 0] = torch.where(got, slot_id, -1)
            fr_new["lat"] = lat
            rec["ev_arc"] = torch.where(got, arc_new, -1)
            rec["ev_ac"] = torch.where(got, l["ac"], 0.0)
            rec["ev_lm"] = torch.where(got, l_lm, 0.0)
            if self.otf:
                rec["ev_g"] = torch.where(got, fr_new["g"], 0)
        return fr_new, rec

    # ------------------------------------------------------------------
    # per-frame step
    # ------------------------------------------------------------------

    def _histogram_thresh(self, e_score, pass_emit):
        """The emit threshold of the next frame from this frame's emitting
        scores, per utterance. "exact": the k-th best score (`NEG` when it
        is not live), k clamped to K*S, as `jax.lax.top_k` gives it.
        "binned": the reference's `Histogram::calcThresh` with binWidth 1:
        C-round the scores, drop those below minScore, clamp those above
        maxScore, count per integer bin, and take the lowest bin whose
        top-down cumulative count reaches maxN, minus 0.5; a count <= maxN
        gives the minScore floor. One scatter-add of integer counts per
        row gives the same counts as the JAX engine's (N, n_bins)
        compare-reduce."""
        B = e_score.shape[0]
        max_n = self.cfg.max_emit_hyps
        flat = torch.where(pass_emit, e_score, NEG).reshape(B, -1)
        if self.cfg.histogram_mode == "exact":
            kth = torch.topk(flat, min(max_n, flat.shape[1]), dim=1).values[:, -1]
            return torch.where(kth > NEG / 2, kth, NEG)
        nb = self._n_bins
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
        return torch.where(binding, self._hist_min + idx.to(self.dtype) - 0.5,
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
        lat = cfg.gen_lattice
        if lat:
            # each token's entry event rides with it like its path
            lat2 = torch.where(pass_emit, fr["lat"].gather(2, best_i), -1)

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

        fr = dict(fr, score=score2, ac=ac2, path=path2)  # with G state and lookahead
        exit_lat = None
        if lat:
            fr["lat"] = lat2
            exit_lat = torch.where(exit_ok, lat2.gather(2, j_best)[:, :, 0], -1)

        # ---- external propagation ----------------------------------------
        end_thresh = (best_end - cfg.phone_end_prune_win
                      if cfg.phone_end_prune_win > 0.0 else torch.full_like(best_end, NEG))
        word_thresh = (best_end - cfg.word_prune_win
                       if cfg.word_prune_win > 0.0 else torch.full_like(best_end, NEG))
        thresh_k = torch.where(arc_ol == 0, end_thresh[:, None], word_thresh[:, None])
        live_exit = exit_ok & (exit_score > thresh_k) & (fr["arc"] <= self.n_arcs)
        if self.pushing:
            # the slot's lookahead comes off before the word crossing, where
            # G's own weight is added
            exit_score = torch.where(exit_ok, exit_score - fr["push_la"], exit_score)

        cand = self._expand(exit_score, exit_ac, exit_path, meta[:, :, 2],
                            meta[:, :, 3], live_exit, fr["arc"], exit_lat)
        fin = self._final_rows(exit_score, exit_ac, meta[:, :, 4], meta[:, :, 5], live_exit)
        g_fin = self._intersect(cand, fr["g"], fin) if self.otf else None
        best_final, f_overflow, flat = self._best_final(fin, exit_path, fr["arc"], norm,
                                                        exit_lat, g_fin)
        fr, rec, best_entry, m_overflow = self._merge_and_insert(fr, cand, t, norm)
        if lat:
            # every valid candidate, winner or not, is a lattice edge from
            # its source token's entry event to this frame's event of its
            # target arc (and G state); scores are cumulative
            rec.update(self._lattice_edges(cand, norm))
            rec.update(flat)

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

    def _lattice_edges(self, cand, norm):
        """The candidates as lattice edges (`LAT_FIELDS`, with a G also
        `lat_to_g`); with pushing the LM leaves the lookahead out."""
        lm = cand["score"] - cand["ac"] + norm[:, None]
        if self.pushing:
            lm = lm - cand["la"]
        edges = {"lat_from_ev": cand["lat_from"], "lat_to_arc": cand["arc"],
                 "lat_ac": cand["ac"], "lat_lm": lm, "lat_seq": cand["seq"],
                 "lat_valid": cand["valid"]}
        if self.otf:
            edges["lat_to_g"] = cand["g"]
        return edges

    # ------------------------------------------------------------------
    # full decode
    # ------------------------------------------------------------------

    def _init_carry(self, B: int):
        """Initial propagation from the virtual start source (row n_arcs of
        the metadata table), records encoded at t = -1. With a G the source
        sits in G's initial state, and no final is reached before the first
        frame."""
        K, S = self.K, self.S
        dev, dt = self.device, self.dtype
        lat = self.cfg.gen_lattice
        fr = {
            "arc": torch.full((B, K), self.n_arcs + 1, dtype=_I64, device=dev),
            "score": torch.full((B, K, S), NEG, dtype=dt, device=dev),
            "ac": torch.full((B, K, S), NEG, dtype=dt, device=dev),
            "path": torch.full((B, K, S), -1, dtype=_I64, device=dev),
        }
        src_score = torch.full((B, K), NEG, dtype=dt, device=dev)
        src_score[:, 0] = 0.0
        src_zero = torch.zeros((B, K), dtype=dt, device=dev)
        src_path = torch.full((B, K), -1, dtype=_I64, device=dev)
        # -1: the utterance start, the source of the first lattice edges
        src_lat = src_path if lat else None
        if lat:
            fr["lat"] = torch.full((B, K, S), -1, dtype=_I64, device=dev)
        src_g = None
        if self.otf:
            fr["g"] = torch.zeros((B, K), dtype=_I64, device=dev)
            src_g = torch.full((B, K), self.g.init_state, dtype=_I64, device=dev)
        if self.pushing:
            fr["push_la"] = torch.zeros((B, K), dtype=dt, device=dev)
        live = torch.zeros((B, K), dtype=torch.bool, device=dev)
        live[:, 0] = True
        meta0 = self.tab["arc_meta"][self.n_arcs].expand(B, K, 6)
        src = torch.full((B, K), self.n_arcs, dtype=_I64, device=dev)
        norm0 = torch.zeros((B,), dtype=dt, device=dev)
        cand = self._expand(src_score, src_zero, src_path, meta0[:, :, 2],
                            meta0[:, :, 3], live, src, src_lat)
        fin = self._final_rows(src_score, src_zero, meta0[:, :, 4], meta0[:, :, 5], live)
        best_final, f_ov, _ = self._best_final(fin, src_path, src, norm0)
        if self.otf:
            self._intersect(cand, src_g)
            # the empty utterance's final is not read through G
            best_final = {k: torch.full_like(v, NEG if k in ("score", "ac", "lm") else
                                             0 if k == "seq" else -1)
                          for k, v in best_final.items()}
        fr, rec0, best_entry, m_ov = self._merge_and_insert(fr, cand, -1, norm0)
        if lat:
            rec0.update(self._lattice_edges(cand, norm0))
        # binned histogram: an empty histogram still thresholds at the
        # minScore floor on the first frame; the exact one starts unbounded
        kth0 = (self._hist_min - 0.5
                if self.cfg.max_emit_hyps > 0 and self.cfg.histogram_mode == "binned" else NEG)
        carry = {
            "fr": fr,
            # the reference updates bestEmitScore on entry-token creation,
            # including the initial propagation
            "best_emit": best_entry,
            "best_start": best_entry,
            "kth_emit": torch.full((B,), kth0, dtype=dt, device=dev),
            "best_final": best_final,
            "norm": norm0,
            "overflow": cand["overflow"] | m_ov | f_ov,
        }
        return carry, rec0

    def run(self, gmm_scores: torch.Tensor, carry=None, t0: int = 0):
        """Decode a (B, T, n_gmms) score batch on the decoder's device (the
        scores are cast to the decoder's dtype). Returns (carry, ys, rec0)
        as device tensors: ys holds the (T, B, K) traceback records, with
        `cfg.emit_diagnostics` the (T, B) per-frame best-final snapshots
        and counters, and with `cfg.gen_lattice` the lattice records
        (`LAT_FIELDS` (T, B, E), `FLAT_FIELDS` (T, B, F), `EV_FIELDS`
        (T, B, K); with a G also `lat_to_g` and `ev_g`).

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
        dt = self.dtype
        scores = gmm_scores.to(dt)
        dev = self.device
        if carry is None:
            carry, rec0 = self._init_carry(B)
        else:
            rec0 = None
        widths = {name: self.K for name in REC_FIELDS}
        if self.cfg.emit_diagnostics:
            widths.update({"bf_" + f: None for f in BF_FIELDS}, n_active=None, n_cand=None)
        if self.cfg.gen_lattice:
            widths.update({f: self.E for f in self.lat_fields},
                          **{f: self.F for f in FLAT_FIELDS}, **{f: self.K for f in self.ev_fields})
        ys = {}
        for name, width in widths.items():
            kind = name.rsplit("_", 1)[-1]
            dtype = (dt if kind in ("score", "ac", "lm") else
                     torch.bool if kind == "valid" else torch.int32)
            ys[name] = torch.empty((T, B) + ((width,) if width else ()), dtype=dtype, device=dev)
        for t in range(T):
            carry, rec = self._frame_step(carry, scores[:, t], t0 + t)
            rec.update({"bf_" + f: v for f, v in carry["best_final"].items()})
            for name, plane in ys.items():
                plane[t] = rec[name]
        return carry, ys, rec0

    def _fused_single(self, sc: torch.Tensor):
        """One utterance (T, n_gmms) through the fused scan at B=1: one
        launch of the frame-step kernel. Raises where the kernel does not
        cover the decode, as `BatchDecoder(use_fused="auto")` does.
        Returns the carry, the compact `ys` and the scan."""
        from .fused_scan import FusedDecodeScan, why_not_covered

        why = why_not_covered(self, int(sc.shape[0]))
        if why is not None:
            raise ValueError(
                f"decode_scores: the fused scan does not cover this decode ({why}); "
                f"pass use_fused=False for the plain frame loop TorchDecoder.run")
        fs = self.__dict__.get("_fused1")
        if fs is None:
            fs = self._fused1 = FusedDecodeScan(self, 1)
        carry, ys = fs(sc[:, None, :].contiguous())
        return carry, ys, fs

    def stream(self, use_fused="auto"):
        """A streaming session over this decoder (`decoder/stream.py`):
        feed score chunks, get converged partial words, then `finish`.
        On the card each feed is one launch of the frame-step kernel
        (raising where it does not cover the decoder) unless
        `use_fused=False` asks for the plain frame loop."""
        from .stream import StreamingDecoder

        return StreamingDecoder(self, use_fused=use_fused)

    def scores_tensor(self, gmm_scores) -> torch.Tensor:
        """Scores (a numpy array or a tensor) on the decoder's device in its
        dtype: numpy scores are read in that dtype, as the JAX engine reads
        them, so float64 scores reach a float64 decoder whole."""
        if not isinstance(gmm_scores, torch.Tensor):
            np_dt = np.float64 if self.dtype == torch.float64 else np.float32
            gmm_scores = torch.from_numpy(np.array(gmm_scores, np_dt))
        return gmm_scores.to(self.device, self.dtype)

    def decode_scores(self, gmm_scores, use_fused="auto") -> DecodeResult:
        """Decode from a precomputed (T, n_gmms) log-likelihood matrix
        (float32 scores are cast to the decoder's dtype). A decoder on the
        card goes through the frame-step kernel (one launch) and reads the
        result back as `BatchDecoder` does (`fused_scan.assemble_results`:
        the best path walked on the card, only it copied) or raises,
        unless `use_fused=False` asks for the plain frame loop `run`; a CPU
        decoder always runs `run`, the kernel's plain version
        (`BatchDecoder`'s rule at B=1)."""
        check_use_fused(use_fused)
        sc = self.scores_tensor(gmm_scores)
        T = int(sc.shape[0])
        true_T = None
        if self.cfg.emit_diagnostics:
            T_pad = max(self.T_BUCKET, -(-T // self.T_BUCKET) * self.T_BUCKET)
            if T_pad != T and T > 0:
                sc = torch.cat([sc, sc[-1:].expand(T_pad - T, -1)])
                true_T = T
        if T > 0 and self.device.type == "cuda" and use_fused is not False:
            from .fused_scan import assemble_results

            carry, ys, fs = self._fused_single(sc)
            return assemble_results(self, fs, carry, ys, [true_T or int(sc.shape[0])])[0]
        # also at T == 0, with no frame to step on either route: the result
        # is read from the initial propagation, which `run` hands back as it
        # built it
        carry, ys, rec0 = self.run(sc[None])
        return self.traceback(host_batch(carry, ys, rec0), 0, int(sc.shape[0]),
                              true_T=true_T)

    def decode_features(self, features, scorer, use_fused="auto") -> DecodeResult:
        """Decode raw (T, D) features with a (T, D) -> (T, n_gmms) scorer
        (`ops.gmm.make_gmm_scorer`, on the card the GMM kernel)."""
        return self.decode_scores(scorer(features), use_fused=use_fused)

    def decode_scores_lattice(self, gmm_scores, use_fused="auto"):
        """Decode and assemble the word lattice (needs `gen_lattice=True`).
        Returns (DecodeResult, lattice `Fst`). The kernel writes no lattice
        records, so on the card only `use_fused=False` decodes (the plain
        frame loop); "auto" and True raise with the reason. The utterance
        is decoded unpadded, as the JAX engine does."""
        from ..fst import algos
        from .fused_scan import why_not_fused
        from .lattice import build_lattice

        check_use_fused(use_fused)
        if not self.cfg.gen_lattice:
            raise ValueError("decoder built without gen_lattice=True")
        if self.device.type == "cuda" and use_fused is not False:
            raise ValueError(
                f"decode_scores_lattice: the fused scan does not cover this decoder "
                f"({why_not_fused(self)}); pass use_fused=False for the plain frame loop "
                f"TorchDecoder.run")
        sc = self.scores_tensor(gmm_scores)
        T = int(sc.shape[0])
        host = host_batch(*self.run(sc[None]))
        res = self.traceback(host, 0, T)
        ys = {k: host[1][k][:, 0] for k in self.lat_fields + FLAT_FIELDS + self.ev_fields}
        rec0 = {k: host[2][k][0] for k in self.lat_fields + self.ev_fields}
        return res, algos.connect(build_lattice(self.art, ys, rec0, T))

    # ------------------------------------------------------------------
    # traceback (host)
    # ------------------------------------------------------------------

    def traceback(self, host, b: int, T: int, true_T: Optional[int] = None) -> DecodeResult:
        """Words of utterance `b` from a host copy of a batch decode
        (`host_batch`), as `TpuDecoder._traceback` reads them. The records
        are the dense (T, B, K) planes of `run` or the compact records of
        the fused scan; one lookup reads a record from either, and
        `path_result` builds the words from the records it finds."""
        carry, ys, rec0 = host
        if true_T is not None and 0 < true_T < T:
            # padded batch entry: the best-final snapshot at the true length
            bf = {f: ys["bf_" + f][true_T - 1, b] for f in BF_FIELDS}
            T = true_T
        else:
            bf = {f: carry["best_final"][f][b] for f in BF_FIELDS}
        overflow = bool(carry["overflow"][b])
        na = ys["n_active"][:, b] if "n_active" in ys else np.zeros(1)
        nc = ys["n_cand"][:, b] if "n_cand" in ys else np.zeros(1)
        stats = dict(
            avg_active=float(na[:T].mean()) if na.size else 0.0,
            max_active=int(na[:T].max()) if na.size else 0,
            max_cand=int(nc[:T].max()) if nc.size else 0,
            overflow=overflow,
        )
        K = self.K
        if "records" in ys:
            # this utterance's records, ascending in id
            lo, hi = ys["rec_offsets"][b], ys["rec_offsets"][b + 1]
            rows = ys["records"][lo:hi]
            rows_f = float_view(rows)
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

        def path():
            pid = int(bf["path"])
            while pid != -1:
                rec = rec_fields(pid)
                yield rec
                pid = rec[0]

        best = (float(bf["score"]), float(bf["ac"]), float(bf["lm"]), int(bf["seq"]),
                int(bf["src"]))
        return self.path_result(T, best, stats, path())

    def path_result(self, T: int, best_final, stats: dict, path) -> DecodeResult:
        """The DecodeResult of one utterance of T frames, from its best
        final `(score, ac, lm, seq, src)`, its `stats` (`avg_active`,
        `max_active`, `max_cand`, `overflow`) and `path`: the records of
        its best path from the best final's back to the first, each
        `(prev, seq, score, ac, lm, frame, src, arc)` with an init record
        at frame 0. The one word assembly of both record sources: the host
        lookup of `traceback` and the walk on the card
        (`fused_scan.assemble_results`). `path` is read only when the
        score is not empty."""
        if stats["overflow"]:
            import warnings

            warnings.warn(
                "TorchDecoder: expansion/frontier budget overflow; results may be pruned")
        score, bf_ac, bf_lm, bf_seq, bf_src = best_final
        if score <= NEG / 2:
            return DecodeResult([], [], NEG, NEG, NEG, T, **stats)
        seqs = self.art.seqs

        # a record stores its LANDING values; each label's crossing-time
        # values differ by a per-closure-edge constant (artifact.remainders);
        # the overall-last label carries the best-final values. With a G the
        # G weights interleave with the closure: landing values throughout
        def seg_hyps(labels, frame, s, a, l, rem):
            out = []
            for j, lab in enumerate(labels):
                if rem is not None and j < len(rem):
                    rs, rl, ra = rem[j]
                    out.append(WordHyp(lab, frame, s - rs, a - ra, l - rl))
                else:
                    out.append(WordHyp(lab, frame, s, a, l))
            return out

        segs: list[list[WordHyp]] = []  # last segment first
        fseq = seqs[bf_seq]
        if fseq:
            rem = (self.art.final_remainders(bf_src, bf_seq)
                   if bf_src >= 0 and not self.otf else None)
            seg = seg_hyps(fseq, T - 1, score, bf_ac, bf_lm, rem)
            seg[-1] = WordHyp(seg[-1].word, T - 1, score, bf_ac, bf_lm)
            segs.append(seg)
        first = not fseq
        for _, seq_id, s, a, l, frame, src, arc_b in path:
            rem = (self.art.remainders(src, arc_b, seq_id)
                   if src >= 0 and arc_b >= 0 and not self.otf else None)
            seg = seg_hyps(seqs[seq_id], frame, s, a, l, rem)
            if first and seg:
                seg[-1] = WordHyp(seg[-1].word, frame, score, bf_ac, bf_lm)
                first = False
            segs.append(seg)
        hyps = [h for seg in reversed(segs) for h in seg]
        return DecodeResult(
            words=[h.word for h in hyps], word_hyps=hyps, score=score,
            acoustic_score=bf_ac, lm_score=bf_lm, n_frames=T, **stats,
        )


def check_use_fused(use_fused):
    """The route switch of every entry point: "auto", True or False."""
    if use_fused not in ("auto", True, False):
        raise ValueError(f"use_fused must be 'auto', True or False, not {use_fused!r}")


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
    utterance's arena (`records` (N, 8) with `rec_offsets` (B + 1,)).
    Traced as the span `copy` (`utils.trace`)."""
    with trace.span("copy") as attrs:
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
        rec0_h = {k: v.cpu().numpy() for k, v in rec0.items()}
        if attrs is not None:
            attrs.update(copy_counts(carry_h, ys_h, rec0_h))
    return carry_h, ys_h, rec0_h


def copy_counts(carry_h, ys_h, rec0_h) -> dict:
    """The counters of the span `copy` of one `host_batch` copy: bytes
    copied, records landed, and the sums of the candidate and active-slot
    snapshots over every frame stepped where the decode wrote them."""
    arrays = [*carry_h["best_final"].values(), carry_h["overflow"], *ys_h.values(),
              *rec0_h.values()]
    out = {"dtoh_bytes": sum(a.nbytes for a in arrays)}
    if "rec_offsets" in ys_h:
        out["records"] = int(ys_h["rec_offsets"][-1])
    elif "rec_seq" in ys_h:  # the dense planes: a record landed where rec_seq != 0
        out["records"] = int(np.count_nonzero(ys_h["rec_seq"]))
    for key, snap in (("candidates", "n_cand"), ("active_slot_frames", "n_active")):
        if snap in ys_h:
            out[key] = int(ys_h[snap].sum())
    return out


def host_planes_diff(got, want, tol: float) -> float:
    """Compare two `host_batch` copies of one decode (records, snapshots,
    lattice records; then the initial propagation's), as the card is held
    to the CPU: the same fields, dtypes and shapes, integers equal, floats
    within `tol`. Raises ValueError naming the first field that differs,
    where it first differs ((frame, utterance, slot) of a plane,
    (utterance, slot) of the initial propagation's) and the two values;
    returns the largest float difference."""
    worst = 0.0
    for part_got, part_want in zip(got[1:], want[1:]):
        if set(part_got) != set(part_want):
            raise ValueError(f"different fields: {sorted(set(part_got) ^ set(part_want))}")
        for k, w in part_want.items():
            g = part_got[k]
            if g.dtype != w.dtype or g.shape != w.shape:
                raise ValueError(f"{k} is {g.dtype} {g.shape}, expected {w.dtype} {w.shape}")
            if g.dtype.kind == "f":
                diff = abs(g.astype(np.float64) - w)
                worst = max(worst, float(diff.max()) if w.size else 0.0)
                bad = ~(diff <= tol)
            else:
                bad = g != w
            if bad.any():
                at = tuple(int(i) for i in np.argwhere(bad)[0])
                raise ValueError(f"{k} differs in {int(bad.sum())} places (tolerance {tol}), "
                                 f"first at {at}: {g[at]!r} against {w[at]!r}")
    return worst
