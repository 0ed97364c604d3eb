"""The plain reference the program's output is judged against.

It reads the task's raw files (`pb.task`) and the features the benchmark
made, and imports nothing of the program.

  - `scores_float64`: every GMM's log-likelihood of every frame, the
    direct form -1/2 sum (x - mu)^2 / var + log det + log w, log-summed
    over the components, in float64 (the models' oracle,
    `calcMixtureOutput`; its pairwise `log_add` drops a component more
    than 39 below the running sum, which changes a score by under 1e-15);
  - `scores_lower`: the same scores in the precision below the
    configuration's float32: the expanded form [x*x, x] @ [V; M] + b as
    one matrix product in TF32 (on the card with TF32 switched on; on the
    CPU with both operands rounded to TF32's 10-bit mantissa, which is
    what the card's tensor cores read), the log-sum in float32. It is the
    control of `pb.check`;
  - `Oracle`: the reference decoder's token passing on the host, a
    frozen copy of `RefDecoder` in `juicer_tpu_torch/decoder/ref_core.py`
    (commit 103de7f), the transcription of the reference's
    `WFSTDecoderLite` in float64: per frame the histogram and main-beam
    thresholds, the HMMs' internal Viterbi with emit pruning, the
    phone-end and word-end beams, and propagation through the network's
    arcs with recursive epsilon and tee handling; a path record a word
    label crossed. The copy reads the network's arrays a state at a time,
    when a token first reaches it, instead of converting every arc to
    Python lists, and counts the live HMM instances after each frame
    (`peak_active`), the quantity the program's frontier budget K bounds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .task import LOG_ZERO, Models, Network

LOG_2_PI = math.log(2.0 * math.pi)


# -- GMM scores ---------------------------------------------------------------


def scores_float64(models: Models, feats: np.ndarray, block: int = 128) -> np.ndarray:
    """(T, G) float64 log-likelihoods of (T, D) features."""
    x = np.asarray(feats, np.float64)
    inv = 1.0 / models.vars  # (G, C, D)
    const = -0.5 * (models.D * LOG_2_PI + np.log(models.vars).sum(-1)) + models.log_w
    out = np.empty((len(x), models.G))
    for lo in range(0, len(x), block):
        diff = x[lo:lo + block, None, None, :] - models.means[None]
        comp = -0.5 * np.einsum("tgcd,gcd->tgc", diff * diff, inv) + const[None]
        m = comp.max(-1)
        out[lo:lo + block] = m + np.log(np.exp(comp - m[..., None]).sum(-1))
    return out


def expanded_params(models: Models):
    """The expanded quadratic form's (2D, G*C) weights [V; M] and (G*C,)
    bias b, worked out in float64 from the models."""
    inv = 1.0 / models.vars
    V = (-0.5 * inv).reshape(models.G * models.C, models.D).T
    M = (models.means * inv).reshape(models.G * models.C, models.D).T
    det = -0.5 * (models.D * LOG_2_PI + np.log(models.vars).sum(-1))
    b = (-0.5 * (models.means ** 2 * inv).sum(-1) + det + models.log_w).reshape(-1)
    return np.concatenate([V, M]), b


def _round_tf32(t):
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to
    even), as the tensor cores read a TF32 operand."""
    import torch

    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def scores_lower(models: Models, feats: np.ndarray, device: str = "cpu") -> np.ndarray:
    """(T, G) float32 log-likelihoods with the product in TF32."""
    import torch

    W, b = expanded_params(models)
    dev = torch.device(device)
    x = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    xx = torch.cat([x * x, x], dim=1)
    Wt = torch.as_tensor(W, dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            logits = xx @ Wt
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    else:
        logits = _round_tf32(xx) @ _round_tf32(Wt)
    logits = logits + torch.as_tensor(b, dtype=torch.float32, device=dev)
    out = torch.logsumexp(logits.view(len(x), models.G, models.C), dim=-1)
    return out.cpu().numpy()


# -- the oracle decoder ---------------------------------------------------------


@dataclass
class OracleResult:
    words: list  # output labels
    end_frames: list  # each word's end frame
    score: float
    peak_active: int  # most live HMM instances after a frame

    @property
    def empty(self) -> bool:
        return self.score <= LOG_ZERO


class _Tok:
    __slots__ = ("score", "acoustic", "lm", "path")

    def __init__(self, score=LOG_ZERO, acoustic=LOG_ZERO, lm=LOG_ZERO, path=-1):
        self.score, self.acoustic, self.lm, self.path = score, acoustic, lm, path

    def copy(self):
        return _Tok(self.score, self.acoustic, self.lm, self.path)


class _Inst:
    __slots__ = ("olabel", "dst", "hmm", "n_states", "states", "tee", "n_active")

    def __init__(self, olabel, dst, hmm, n_states, tee):
        self.olabel, self.dst, self.hmm, self.n_states, self.tee = olabel, dst, hmm, n_states, tee
        self.states = [_Tok() for _ in range(n_states)]
        self.n_active = 0


class _Histogram:
    """Integer-binned score histogram (`Histogram.cpp`, bin width 1)."""

    def __init__(self, min_score, max_score):
        self.min_score = int(min_score - 1.0)
        self.max_score = int(max_score + 1.0)
        self.reset()

    def reset(self):
        self.counts = {}
        self.count = 0

    def add(self, score):
        sc = int(score - 0.5) if score < 0.0 else int(score + 0.5)
        if sc > self.max_score:
            sc = self.max_score
        if sc < self.min_score:
            return
        self.counts[sc] = self.counts.get(sc, 0) + 1
        self.count += 1

    def calc_thresh(self, max_n):
        if self.count <= max_n:
            return float(self.min_score) - 0.5
        total = 0
        for sc in sorted(self.counts, reverse=True):
            total += self.counts[sc]
            if total >= max_n:
                return float(sc) - 0.5
        return float(self.min_score) - 0.5


def _se_index(tm: np.ndarray):
    """Per-state [start, end) predecessor ranges of states 1..N-1, the tee
    transition left out (`createTrPandSEIndex`)."""
    n = tm.shape[0]
    out = []
    for j in range(1, n):
        mn = 1 if j == n - 1 else 0
        while mn < n - 1 and tm[mn, j] <= LOG_ZERO:
            mn += 1
        mx = n - 1
        while mx >= 1 and tm[mx, j] <= LOG_ZERO:
            mx -= 1
        out.append((mn, mx + 1))
    return out


class Oracle:
    """Token passing over the network of `clg.npz` with the pruning of one
    operating point; `decode(scores)` on (T, G) float64 scores."""

    def __init__(self, net: Network, models: Models, beam: float, end_beam: float,
                 maxhyps: int):
        self.net = net
        self.emit_prune_win = beam
        self.phone_end_prune_win = end_beam
        self.word_prune_win = end_beam
        self.max_emit_hyps = maxhyps
        lo = -beam - 800.0 if beam > 0.0 else -1000.0
        self.histogram = _Histogram(lo, 200.0) if maxhyps > 0 else None
        self._hmm = [(models.trans[h].tolist(), _se_index(models.trans[h]),
                      [int(g) for g in models.hmm_gmms[h]], models.n_states(h),
                      float(models.trans[h][0, -1])) for h in range(len(models.trans))]
        self._rows = {}

    def _row(self, state):
        """(arc, ilabel, olabel, dst, weight) of each arc leaving `state`,
        and the state's final weight."""
        row = self._rows.get(state)
        if row is None:
            n = self.net
            lo, hi = int(n.row_ptr[state]), int(n.row_ptr[state + 1])
            arcs = list(zip(range(lo, hi), n.arc_ilabel[lo:hi].tolist(),
                            n.arc_olabel[lo:hi].tolist(), n.arc_dst[lo:hi].tolist(),
                            n.arc_weight[lo:hi].tolist()))
            row = self._rows[state] = (arcs, float(n.final_weight[state]))
        return row

    def decode(self, scores: np.ndarray) -> OracleResult:
        self._scores = np.asarray(scores, np.float64).tolist()
        T = len(self._scores)
        self._start()
        peak = 0
        for t in range(T):
            self._process_frame(t)
            peak = max(peak, len(self.active))
        return self._finish(peak)

    # -- the reference's frame ---------------------------------------------

    def _start(self):
        self.paths = []  # (prev, frame, score, label)
        self.insts = {}
        self.active = []
        self.new_active = []
        self.best_final = _Tok()
        self.normalise_score = 0.0
        self.best_emit = self.best_start = self.best_end = LOG_ZERO
        self.cur_start_thresh = self.cur_end_thresh = LOG_ZERO
        self.cur_word_thresh = self.cur_emit_thresh = LOG_ZERO
        if self.histogram:
            self.histogram.reset()
        self.current_frame = 0
        self._propagate(_Tok(0.0, 0.0, 0.0, -1), None)
        self._join_new_active()

    def _join_new_active(self):
        self.active = self.new_active + self.active
        self.new_active = []

    def _process_frame(self, t):
        self.current_frame = t
        self.best_final = _Tok()
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
        self.cur_start_thresh = LOG_ZERO  # no phone-start beam at this point
        self._do_internal()
        self.cur_end_thresh = (self.best_end - self.phone_end_prune_win
                               if self.phone_end_prune_win > 0.0 else LOG_ZERO)
        self.cur_word_thresh = (self.best_end - self.word_prune_win
                                if self.word_prune_win > 0.0 else LOG_ZERO)
        self._do_external()

    def _do_internal(self):
        self.best_emit = LOG_ZERO
        self.best_end = LOG_ZERO
        survivors = []
        for key in self.active:
            inst = self.insts[key]
            entry = inst.states[0]
            if entry.score > LOG_ZERO and entry.score < self.cur_start_thresh:
                inst.states[0] = _Tok()
                inst.n_active -= 1
            self._internal_one(inst)
            if inst.n_active == 0:
                del self.insts[key]
            else:
                survivors.append(key)
        self.active = survivors

    def _internal_one(self, inst):
        trP, se, gmm_inds, _, _ = self._hmm[inst.hmm]
        N1 = inst.n_states - 1
        frame = self._scores[self.current_frame]
        states = inst.states
        buf = [_Tok()] + [None] * (N1 - 1)
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
                outp = frame[gmm_inds[j - 1]]
                res.score += outp
                res.acoustic += outp
                if self.histogram:
                    self.histogram.add(res.score)
                if res.score > self.best_emit:
                    self.best_emit = res.score
            else:
                res = _Tok()
            buf[j] = res
        inst.n_active = 0
        for j in range(N1):
            if buf[j].score > LOG_ZERO:
                inst.n_active += 1
            states[j] = buf[j]
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
            states[N1] = _Tok()
        else:
            states[N1] = res
            if res.score > self.best_end:
                self.best_end = res.score
            inst.n_active += 1

    def _do_external(self):
        self.best_start = LOG_ZERO
        survivors = []
        for key in self.active:
            inst = self.insts.get(key)
            if inst is None:
                survivors.append(key)
                continue
            exit_tok = inst.states[inst.n_states - 1]
            if exit_tok.score > LOG_ZERO:
                thresh = self.cur_end_thresh if inst.olabel == 0 else self.cur_word_thresh
                if exit_tok.score > thresh:
                    self._propagate(exit_tok.copy(), inst)
                inst.states[inst.n_states - 1] = _Tok()
                inst.n_active -= 1
                if inst.n_active == 0:
                    del self.insts[key]
                    continue
            survivors.append(key)
        self.active = [a for a in survivors if a in self.insts]
        self._join_new_active()

    def _propagate(self, tok, via):
        """Propagate `tok` out of the arc `via` (an instance, or an
        epsilon arc's (olabel, dst)), or from the start state (None)."""
        if via is not None:
            olabel, next_state = via.olabel, via.dst
            if olabel != 0:
                self.paths.append((tok.path, self.current_frame, tok.score, olabel))
                tok.path = len(self.paths) - 1
            arcs, fw = self._row(next_state)
            if fw > LOG_ZERO and tok.score + fw > self.best_final.score:
                self.best_final = tok.copy()
                self.best_final.score += fw
                self.best_final.lm += fw
        else:
            arcs, _ = self._row(self.net.init_state)
        for arc, ilabel, olabel, dst, w in arcs:
            if ilabel == 0:
                tmp = tok.copy()
                tmp.score += w
                tmp.lm += w
                if tmp.score > self.cur_end_thresh:
                    self._propagate(tmp, _Eps(olabel, dst))
                continue
            inst = self.insts.get(arc)
            if inst is None:
                _, _, _, n, tee = self._hmm[ilabel - 1]
                inst = self.insts[arc] = _Inst(olabel, dst, ilabel - 1, n, tee)
                self.new_active.insert(0, arc)
            elif (inst.n_active == 0 and arc not in self.new_active
                  and arc not in self.active):
                self.new_active.insert(0, arc)
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
                thresh = self.cur_word_thresh if olabel != 0 else self.cur_end_thresh
                if tee_score > thresh:
                    self._propagate(tmp, inst)

    def _finish(self, peak) -> OracleResult:
        best = self.best_final
        if best.score <= LOG_ZERO:
            return OracleResult([], [], LOG_ZERO, peak)
        words, frames = [], []
        p = best.path
        while p >= 0:
            prev, frame, _, label = self.paths[p]
            words.append(label)
            frames.append(frame)
            p = prev
        return OracleResult(words[::-1], frames[::-1], best.score, peak)


class _Eps:
    """An epsilon arc a token is propagated out of."""

    __slots__ = ("olabel", "dst")

    def __init__(self, olabel, dst):
        self.olabel, self.dst = olabel, dst
