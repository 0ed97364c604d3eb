"""The grammar G of on-the-fly composition, in the form the decoder reads.

Counterpart of `GNetwork` in `juicer_tpu/decoder/otf.py`, the rebuild of
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
"""

from __future__ import annotations

import numpy as np

from ..fst import EPSILON, Fst

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
