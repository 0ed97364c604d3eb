"""The oracle decoder: the reference's token passing, on the host.

The counterpart of `juicer_tpu/decoder/ref_core.py`, a transcription of
the reference's `WFSTDecoderLite` (float64 scores, the USE_DOUBLE_SCORE
analogue), independent of both kernels and of `TorchDecoder`:

  - each frame: new frame -> thresholds (histogram and main beam) -> HMM
    internal Viterbi, GMM scores and emit pruning -> end and word
    thresholds -> propagation through the arcs with recursive epsilon and
    tee handling (`processFrame`, `WFSTDecoderLite.cpp:311-372`);
  - scores normalised each frame by the previous frame's best emitting
    score (`normaliseScore`, `:321,408`);
  - entry-state pruning against the start beam (`:914-918`);
  - a word-boundary path record each time a token crosses an arc with an
    output label (`propagateToken`, `:496-509`);
  - histogram pruning over integer-binned scores (`Histogram.cpp`).
A pruning window of 0.0 switches its beam off, as in the reference.

It is plain Python; the network's and the models' arrays are read as
Python lists (the same float64 values). It returns the port's
`decoder/results.py` types, so the CLI prints both cores alike. Scores
come from the models' float64 oracle (`features=`) or from
`score_fn(t, gmm)` (the CLI reads a host copy of the GMM kernel's
scores, one copy an utterance).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .network import DecoderNetwork
from .results import LOG_ZERO, DecodeResult, WordHyp


@dataclass
class PathRec:
    prev: int  # index into the path list, -1 none
    frame: int
    score: float
    acoustic: float
    lm: float
    label: int


@dataclass
class Token:
    score: float = LOG_ZERO
    acoustic: float = LOG_ZERO
    lm: float = LOG_ZERO
    path: int = -1

    def copy(self) -> "Token":
        return Token(self.score, self.acoustic, self.lm, self.path)


NULL_TOKEN = Token()


class _Inst:
    # "g" is the G state of the on-the-fly subclass (decoder/otf.py)
    __slots__ = ("arc", "hmm", "n_states", "states", "tee", "n_active", "g")

    def __init__(self, arc: int, hmm: int, n_states: int, tee: float):
        self.arc = arc
        self.hmm = hmm
        self.n_states = n_states
        self.states = [Token() for _ in range(n_states)]
        self.tee = tee
        self.n_active = 0


class _Histogram:
    """Integer-binned score histogram (`Histogram.cpp`, bin width 1)."""

    def __init__(self, min_score: float, max_score: float):
        # widened by one on each side (`Histogram.cpp:28-30`)
        self.min_score = int(min_score - 1.0)
        self.max_score = int(max_score + 1.0)
        self.reset()

    def reset(self) -> None:
        self.counts: dict[int, int] = {}
        self.count = 0

    def add(self, score: float) -> None:
        sc = int(score - 0.5) if score < 0.0 else int(score + 0.5)
        if sc > self.max_score:
            sc = self.max_score
        if sc < self.min_score:
            return
        self.counts[sc] = self.counts.get(sc, 0) + 1
        self.count += 1

    def calc_thresh(self, max_n: int) -> float:
        if self.count <= max_n:
            return float(self.min_score) - 0.5
        total = 0
        for sc in sorted(self.counts, reverse=True):
            total += self.counts[sc]
            if total >= max_n:
                return float(sc) - 0.5
        return float(self.min_score) - 0.5


class _NetLists:
    """A network's arrays as Python lists (values unchanged)."""

    def __init__(self, net: DecoderNetwork):
        self.arc_ilabel = net.arc_ilabel.tolist()
        self.arc_olabel = net.arc_olabel.tolist()
        self.arc_dst = net.arc_dst.tolist()
        self.arc_weight = net.arc_weight.tolist()
        self.final_weight = net.final_weight.tolist()
        self.row_ptr = net.row_ptr.tolist()
        self.init_state = int(net.init_state)

    def arcs_from(self, state: int) -> range:
        return range(self.row_ptr[state], self.row_ptr[state + 1])


class RefDecoder:
    def __init__(self, network: DecoderNetwork, models, phone_start_prune_win: float = 0.0,
                 emit_prune_win: float = 0.0, phone_end_prune_win: float = 0.0,
                 word_prune_win: float = 0.0, max_emit_hyps: int = 0):
        self.net = _NetLists(network)
        self.models = models
        self.emit_prune_win = emit_prune_win
        self.phone_start_prune_win = phone_start_prune_win
        self.phone_end_prune_win = phone_end_prune_win
        self.word_prune_win = word_prune_win
        self.max_emit_hyps = max_emit_hyps
        if max_emit_hyps > 0:
            lo = -emit_prune_win - 800.0 if emit_prune_win > 0.0 else -1000.0
            self.histogram: Optional[_Histogram] = _Histogram(lo, 200.0)
        else:
            self.histogram = None
        # per HMM: transition log probabilities as lists, predecessor
        # ranges, GMM indices, state count and tee probability
        self._hmm = [(models.get_trans_mat(h).tolist(), models.get_se_index(h),
                      [int(g) for g in models.hmm_gmm_inds[h]], models.get_num_states(h),
                      models.get_tee_log_prob(h)) for h in range(models.n_hmms)]

    # -- public ------------------------------------------------------------

    def decode(self, features: Optional[np.ndarray] = None,
               score_fn: Optional[Callable[[int, int], float]] = None,
               n_frames: Optional[int] = None) -> DecodeResult:
        """Decode one utterance: (T, D) `features` scored by the models'
        float64 oracle, or `score_fn(t, gmm) -> log-likelihood` over
        `n_frames` frames."""
        if score_fn is None:
            assert features is not None
            T = features.shape[0]
            cache: dict[tuple[int, int], float] = {}

            def score_fn(t: int, gmm: int) -> float:
                v = cache.get((t, gmm))
                if v is None:
                    v = cache[(t, gmm)] = self.models.score_gmm(gmm, features[t])
                return v
        else:
            T = n_frames
        self._score_fn = score_fn
        self._start()
        for t in range(T):
            self._process_frame(t)
        return self._finish(T)

    # -- internals ---------------------------------------------------------

    def _start(self) -> None:
        self.paths: list[PathRec] = []
        self.insts: dict = {}  # arc id (a key) -> inst (the `hook`)
        self.active: list = []  # active keys, new ones inserted at the front
        self.new_active: list = []
        self.best_final = NULL_TOKEN.copy()
        self.normalise_score = 0.0
        self.best_emit = LOG_ZERO
        self.best_start = LOG_ZERO
        self.best_end = LOG_ZERO
        self.cur_start_thresh = LOG_ZERO
        self.cur_end_thresh = LOG_ZERO
        self.cur_word_thresh = LOG_ZERO
        self.cur_emit_thresh = LOG_ZERO
        if self.histogram:
            self.histogram.reset()
        # recognitionStart() propagates with currFrame already 0
        # (`WFSTDecoderLite.cpp:141`): words crossed before the first
        # frame are reported at frame 0
        self.current_frame = 0
        self._propagate_token(Token(0.0, 0.0, 0.0, -1), None)
        self._join_new_active()

    def _join_new_active(self) -> None:
        # new insts go to the front of the active list (`joinNewActiveInstList`)
        self.active = self.new_active + self.active
        self.new_active = []

    def _process_frame(self, t: int) -> None:
        self.current_frame = t
        self.best_final = NULL_TOKEN.copy()
        # start and emit pruning thresholds
        self.normalise_score = self.best_emit if self.best_emit > LOG_ZERO else 0.0
        if self.histogram:
            self.cur_emit_thresh = self.histogram.calc_thresh(self.max_emit_hyps)
            self.cur_emit_thresh -= self.normalise_score
            if self.emit_prune_win > 0.0 and self.cur_emit_thresh < -self.emit_prune_win:
                self.cur_emit_thresh = -self.emit_prune_win
            self.histogram.reset()
        else:
            self.cur_emit_thresh = (-self.emit_prune_win if self.emit_prune_win > 0.0
                                    else LOG_ZERO)
        self.cur_start_thresh = (self.best_start - self.phone_start_prune_win
                                 if self.phone_start_prune_win > 0.0 else LOG_ZERO)
        self._do_internal()
        self.cur_end_thresh = (self.best_end - self.phone_end_prune_win
                               if self.phone_end_prune_win > 0.0 else LOG_ZERO)
        self.cur_word_thresh = (self.best_end - self.word_prune_win
                                if self.word_prune_win > 0.0 else LOG_ZERO)
        self._do_external()

    def _do_internal(self) -> None:
        self.best_emit = LOG_ZERO
        self.best_end = LOG_ZERO
        survivors = []
        for key in self.active:
            inst = self.insts[key]
            entry = inst.states[0]
            if entry.score > LOG_ZERO and entry.score < self.cur_start_thresh:
                inst.states[0] = Token()
                inst.n_active -= 1
            self._internal_one(inst)
            if inst.n_active == 0:
                del self.insts[key]  # deactivate (`returnNetInst`)
            else:
                survivors.append(key)
        self.active = survivors

    def _internal_one(self, inst: _Inst) -> None:
        trP, se, gmm_inds, _, _ = self._hmm[inst.hmm]
        N1 = inst.n_states - 1
        t = self.current_frame
        states = inst.states
        buf = [Token()] + [None] * (N1 - 1)  # the entry state stays null
        for j in range(1, N1):
            lo, hi = se[j - 1]
            res = states[lo].copy()
            res.score += trP[lo][j]
            res.acoustic += trP[lo][j]
            for i in range(lo + 1, hi):
                tmp = states[i].score + trP[i][j]
                if tmp > res.score:
                    res = states[i].copy()
                    res.score = tmp
                    res.acoustic += trP[i][j]
            res.score -= self.normalise_score
            if res.score > self.cur_emit_thresh:
                outp = self._score_fn(t, gmm_inds[j - 1])
                res.score += outp
                res.acoustic += outp
                if self.histogram:
                    self.histogram.add(res.score)
                if res.score > self.best_emit:
                    self.best_emit = res.score
            else:
                res = Token()
            buf[j] = res
        inst.n_active = 0
        for j in range(N1):
            if buf[j].score > LOG_ZERO:
                inst.n_active += 1
            states[j] = buf[j]
        # the exit state (the tee transition is not in the SE index)
        lo, hi = se[N1 - 1]
        res = states[lo].copy()
        res.score += trP[lo][N1]
        res.acoustic += trP[lo][N1]
        for i in range(lo + 1, hi):
            tmp = states[i].score + trP[i][N1]
            if tmp > res.score:
                res = states[i].copy()
                res.score = tmp
                res.acoustic += trP[i][N1]
        if res.score <= LOG_ZERO:
            states[N1] = Token()
        else:
            states[N1] = res
            if res.score > self.best_end:
                self.best_end = res.score
            inst.n_active += 1

    def _do_external(self) -> None:
        self.best_start = LOG_ZERO
        survivors = []
        olabel = self.net.arc_olabel
        for arc in self.active:
            inst = self.insts.get(arc)
            if inst is None:
                survivors.append(arc)
                continue
            exit_tok = inst.states[inst.n_states - 1]
            if exit_tok.score > LOG_ZERO:
                thresh = self.cur_end_thresh if olabel[arc] == 0 else self.cur_word_thresh
                if exit_tok.score > thresh:
                    self._propagate_token(exit_tok.copy(), arc)
                inst.states[inst.n_states - 1] = Token()
                inst.n_active -= 1
                if inst.n_active == 0:
                    del self.insts[arc]
                    continue
            survivors.append(arc)
        self.active = [a for a in survivors if a in self.insts]
        self._join_new_active()

    def _new_path(self, tok: Token, label: int) -> int:
        self.paths.append(PathRec(tok.path, self.current_frame, tok.score, tok.acoustic,
                                  tok.lm, label))
        return len(self.paths) - 1

    def _new_inst(self, arc: int, hmm: int) -> _Inst:
        _, _, _, n, tee = self._hmm[hmm]
        return _Inst(arc, hmm, n, tee)

    def _propagate_token(self, tok: Token, arc: Optional[int]) -> None:
        net = self.net
        if arc is not None:
            olabel = net.arc_olabel[arc]
            if olabel != 0:
                tok.path = self._new_path(tok, olabel)
            next_state = net.arc_dst[arc]
            fw = net.final_weight[next_state]
            if fw > LOG_ZERO and tok.score + fw > self.best_final.score:
                self.best_final = tok.copy()
                self.best_final.score += fw
                self.best_final.lm += fw
        else:
            next_state = net.init_state

        for nxt in net.arcs_from(next_state):
            ilabel = net.arc_ilabel[nxt]
            w = net.arc_weight[nxt]
            if ilabel == 0:
                tmp = tok.copy()
                tmp.score += w
                tmp.lm += w
                if tmp.score > self.cur_end_thresh:
                    self._propagate_token(tmp, nxt)
                continue
            inst = self.insts.get(nxt)
            if inst is None:
                inst = self.insts[nxt] = self._new_inst(nxt, ilabel - 1)
                self.new_active.insert(0, nxt)
            elif (inst.n_active == 0 and nxt not in self.new_active
                  and nxt not in self.active):
                self.new_active.insert(0, nxt)
            entry = inst.states[0]
            new_score = tok.score + w
            if new_score > entry.score:
                if entry.score <= LOG_ZERO:
                    inst.n_active += 1
                ntok = tok.copy()
                ntok.score = new_score
                ntok.lm += w
                inst.states[0] = ntok
                if new_score > self.best_emit:
                    self.best_emit = new_score
                if new_score > self.best_start:
                    self.best_start = new_score
            if inst.tee > LOG_ZERO:
                tee_score = new_score + inst.tee
                tmp = tok.copy()
                tmp.score = tee_score
                tmp.acoustic += inst.tee
                tmp.lm += w
                thresh = self.cur_word_thresh if net.arc_olabel[nxt] != 0 else self.cur_end_thresh
                if tee_score > thresh:
                    self._propagate_token(tmp, nxt)

    def _finish(self, T: int) -> DecodeResult:
        best = self.best_final
        if best.score <= LOG_ZERO:
            return DecodeResult([], [], LOG_ZERO, LOG_ZERO, LOG_ZERO, T)
        hyps: list[WordHyp] = []
        p = best.path
        while p >= 0:
            rec = self.paths[p]
            if not hyps:
                # the final hypothesis carries the added final-state weight
                hyps.append(WordHyp(rec.label, rec.frame, best.score, best.acoustic, best.lm))
            else:
                hyps.append(WordHyp(rec.label, rec.frame, rec.score, rec.acoustic, rec.lm))
            p = rec.prev
        hyps.reverse()
        return DecodeResult(words=[h.word for h in hyps], word_hyps=hyps, score=best.score,
                            acoustic_score=best.acoustic, lm_score=best.lm, n_frames=T)
