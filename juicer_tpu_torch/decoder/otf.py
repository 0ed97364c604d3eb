"""The grammar G of on-the-fly composition, and the oracle decoder over it.

Counterpart of `GNetwork` and `RefOtfDecoder` in
`juicer_tpu/decoder/otf.py`, the rebuild of
the reference's `WFSTOnTheFlyDecoder` grammar side: the decoder searches
CL and intersects each crossed word label with G lazily, by
match-or-backoff (`binarySearchInLabel` and the eps/backoff path walk,
`WFSTNetwork.cpp:2505,2605`).

G is held as word arcs sorted by (state, input label) in CSR form, at
most one backoff (epsilon input) arc per state, final weights and
`final_reach` (the weight of the backoff walk to a final state). Weights
are decoder-internal: negated costs scaled by `lm_scale`, higher is
better. Backoff arcs are the epsilon-input arcs and, where the grammar's
symbols have one, the `#phi`-labelled arcs (`phi_label`).

The JAX class also lays the arcs out as padded (states, R) rows and dense
(D, W) word-indexed tables: a TPU gathers rows and compares lanes where a
binary search would serialise. A GPU searches: the decoder advances G
with one `torch.searchsorted` a backoff level over `arc_key`, the sorted
int64 keys `state * W + label` (`core.TorchDecoder._g_advance`). A left
search lands on the first of equal keys, which is the arc the JAX
tables' first-match rule picks among duplicate (state, label) arcs.

`RefOtfDecoder` is the oracle of on-the-fly composition: the host token
passing of `ref_core.RefDecoder` with a G state on every token, advanced
by `GNetwork.advance` on each word crossing, and HMM instances keyed by
(CL arc, G state).
"""

from __future__ import annotations

import numpy as np

from ..fst import EPSILON, Fst
from .ref_core import RefDecoder, Token

LOG_ZERO = -1e30


class GNetwork:
    """Grammar transducer in sorted-input-label CSR form with backoff arcs.

    ARPA-built machines have at most one backoff arc a state
    (`compile.gram.arpa_grammar` emits one per context); another raises.
    Backoff arcs are the epsilon-input arcs and the arcs labelled
    `phi_label` (the index of `#phi` in G's input symbols, -1 for none).
    Weights are -cost * lm_scale, rounded once in float64."""

    def __init__(self, fst: Fst, lm_scale: float = 1.0, phi_label: int = -1):
        src, dst, il, _, w = fst.arcs_numpy()
        weight = -w * lm_scale
        self.n_states = fst.num_states
        self.init_state = fst.start

        is_bo = (il == EPSILON) | ((phi_label > 0) & (il == phi_label))
        bo = np.nonzero(is_bo)[0]
        if len(np.unique(src[bo])) != len(bo):
            s = int(src[bo][np.flatnonzero(np.bincount(src[bo]) > 1)[0]])
            raise ValueError(f"G state {s} has multiple backoff arcs")
        self.bo_dst = np.full(self.n_states, -1, dtype=np.int32)
        self.bo_w = np.zeros(self.n_states, dtype=np.float64)
        self.bo_dst[src[bo]] = dst[bo]
        self.bo_w[src[bo]] = weight[bo]

        # word arcs sorted by (state, ilabel); the sort is stable, so equal
        # (state, ilabel) arcs keep the order they were added in
        keep = ~is_bo
        order = np.lexsort((il[keep], src[keep]))
        self.arc_il = il[keep][order].astype(np.int32)
        self.arc_dst = dst[keep][order].astype(np.int32)
        self.arc_w = weight[keep][order].astype(np.float64)
        self.row_ptr = np.zeros(self.n_states + 1, dtype=np.int64)
        np.add.at(self.row_ptr, src[keep].astype(np.int64) + 1, 1)
        self.row_ptr = np.cumsum(self.row_ptr)

        self.final_w = np.full(self.n_states, LOG_ZERO, dtype=np.float64)
        for s, fw in fst.finals.items():
            self.final_w[s] = -fw * lm_scale
        self.final_reach = self._final_reach()
        self.max_backoff = self._max_backoff_depth()
        self._key_arcs()

    @classmethod
    def from_arrays(cls, *, n_states, init_state, arc_il, arc_dst, arc_w, row_ptr,
                    bo_dst, bo_w, final_w, final_reach, max_backoff) -> "GNetwork":
        """A G from the arrays of a built one (`convert.g_network_from_numpy`
        hands over the JAX package's)."""
        g = cls.__new__(cls)
        g.n_states, g.init_state, g.max_backoff = int(n_states), int(init_state), int(max_backoff)
        for name, dt, a in (("arc_il", np.int32, arc_il), ("arc_dst", np.int32, arc_dst),
                            ("arc_w", np.float64, arc_w), ("row_ptr", np.int64, row_ptr),
                            ("bo_dst", np.int32, bo_dst), ("bo_w", np.float64, bo_w),
                            ("final_w", np.float64, final_w),
                            ("final_reach", np.float64, final_reach)):
            setattr(g, name, np.asarray(a, dt))
        if len(g.row_ptr) != g.n_states + 1 or g.row_ptr[-1] != len(g.arc_il):
            raise ValueError("row_ptr does not index the word arcs of n_states states")
        g._key_arcs()
        return g

    def _key_arcs(self) -> None:
        """The vocabulary width W (every word label lies below it) and the
        search keys `state * W + label`, ascending with the arcs."""
        self.W = int(self.arc_il.max(initial=0)) + 1
        arc_state = np.repeat(np.arange(self.n_states, dtype=np.int64), np.diff(self.row_ptr))
        self.arc_key = arc_state * self.W + self.arc_il

    def _final_reach(self) -> np.ndarray:
        """From every state, the backoff walk to the first final state: the
        backoff weights on the way plus its final weight, summed in the
        walk's order; LOG_ZERO where no final state is reached."""
        n = self.n_states
        reach = np.full(n, LOG_ZERO)
        acc = np.zeros(n)
        cur = np.arange(n)
        walking = np.ones(n, bool)
        for _ in range(n + 1):  # a walk longer than n states has a cycle
            fin = walking & (self.final_w[cur] > LOG_ZERO)
            reach[fin] = acc[fin] + self.final_w[cur[fin]]
            walking &= ~fin & (self.bo_dst[cur] >= 0)
            if not walking.any():
                break
            acc[walking] += self.bo_w[cur[walking]]
            cur = np.where(walking, self.bo_dst[cur], cur)
        return reach

    def _max_backoff_depth(self) -> int:
        """One more than the longest backoff chain (acyclic in ARPA
        machines): the backoff levels an advance may need, plus the match."""
        depth = np.zeros(self.n_states, dtype=np.int64)
        has_bo = self.bo_dst >= 0
        for _ in range(self.n_states + 1):
            new = np.where(has_bo, depth[np.maximum(self.bo_dst, 0)] + 1, 0)
            if np.array_equal(new, depth):
                break
            depth = new
        return int(depth.max(initial=0)) + 1

    def advance(self, g: int, word: int) -> tuple[int, float]:
        """Consume `word` from state g via match-or-backoff; returns
        (next state, accumulated weight) or (-1, LOG_ZERO)."""
        w = 0.0
        for _ in range(self.max_backoff + 1):
            lo, hi = int(self.row_ptr[g]), int(self.row_ptr[g + 1])
            i = lo + int(np.searchsorted(self.arc_il[lo:hi], word))
            if i < hi and self.arc_il[i] == word:
                return int(self.arc_dst[i]), w + float(self.arc_w[i])
            if self.bo_dst[g] < 0:
                return -1, LOG_ZERO
            w += float(self.bo_w[g])
            g = int(self.bo_dst[g])
        return -1, LOG_ZERO

    def __repr__(self) -> str:
        return (f"GNetwork(states={self.n_states}, word_arcs={len(self.arc_il)}, "
                f"W={self.W}, max_backoff={self.max_backoff})")


class RefOtfDecoder(RefDecoder):
    """Oracle on-the-fly decoder: tokens carry a G state; instances are
    keyed by (CL arc, G state)."""

    def __init__(self, cl_network, g_network: GNetwork, models, **kw):
        super().__init__(cl_network, models, **kw)
        self.g = g_network

    def _propagate_token(self, tok, arc) -> None:
        net, g_net = self.net, self.g
        if getattr(tok, "g", None) is None:
            tok.g = g_net.init_state
        if arc is not None:
            olabel = net.arc_olabel[arc]
            if olabel != 0:
                # advance G on the word crossing, its LM weight onto the token
                g2, gw = g_net.advance(tok.g, olabel)
                if g2 < 0:
                    return  # the word is not in G from this context
                tok.g = g2
                tok.score += gw
                tok.lm += gw
                tok.path = self._new_path(tok, olabel)
            next_state = net.arc_dst[arc]
            fw = net.final_weight[next_state]
            if fw > LOG_ZERO:
                gfw = g_net.final_reach[tok.g]
                if gfw > LOG_ZERO and tok.score + fw + gfw > self.best_final.score:
                    self.best_final = tok.copy()
                    self.best_final.g = tok.g
                    self.best_final.score += fw + gfw
                    self.best_final.lm += fw + gfw
        else:
            next_state = net.init_state

        for nxt in net.arcs_from(next_state):
            ilabel = net.arc_ilabel[nxt]
            w = net.arc_weight[nxt]
            if ilabel == 0:
                tmp = tok.copy()
                tmp.g = tok.g
                tmp.score += w
                tmp.lm += w
                if tmp.score > self.cur_end_thresh:
                    self._propagate_token(tmp, nxt)
                continue
            key = (nxt, tok.g)
            inst = self.insts.get(key)
            if inst is None:
                inst = self.insts[key] = self._new_inst(nxt, ilabel - 1)
                inst.g = tok.g
                self.new_active.insert(0, key)
            entry = inst.states[0]
            new_score = tok.score + w
            if new_score > entry.score:
                if entry.score <= LOG_ZERO:
                    inst.n_active += 1
                ntok = tok.copy()
                ntok.g = tok.g
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
                tmp.g = tok.g
                tmp.score = tee_score
                tmp.acoustic += inst.tee
                tmp.lm += w
                thresh = self.cur_word_thresh if net.arc_olabel[nxt] != 0 else self.cur_end_thresh
                if tee_score > thresh:
                    self._propagate_token(tmp, nxt)

    def _do_external(self) -> None:
        # as the base class's, with (arc, G state) keys
        self.best_start = LOG_ZERO
        survivors = []
        for key in self.active:
            inst = self.insts.get(key)
            if inst is None:
                continue
            exit_tok = inst.states[inst.n_states - 1]
            if exit_tok.score > LOG_ZERO:
                arc = inst.arc
                thresh = (self.cur_end_thresh if self.net.arc_olabel[arc] == 0
                          else self.cur_word_thresh)
                if exit_tok.score > thresh:
                    t2 = exit_tok.copy()
                    t2.g = inst.g
                    self._propagate_token(t2, arc)
                inst.states[inst.n_states - 1] = Token()
                inst.n_active -= 1
                if inst.n_active == 0:
                    del self.insts[key]
                    continue
            survivors.append(key)
        self.active = [k for k in survivors if k in self.insts]
        self._join_new_active()
