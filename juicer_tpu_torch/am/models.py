"""Acoustic model set: the parts the decode path needs.

A reduced copy of `juicer_tpu/am/models.py`: the npz loader, the
matmul-expanded GMM packing (`flat_params`), the padded HMM topology
(`packed_topology`) and the accessors the utterance sampler reads. There
is no MMF parser here; model sets arrive as the npz files the JAX
package writes (`AcousticModelSet.save_npz`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

LOG_ZERO = -1e30
LOG_2_PI = math.log(2.0 * math.pi)


@dataclass
class FlatGmmParams:
    """All-GMM scoring parameters in matmul-expanded form.

    For frame x: comp_logit[g,c] = xx @ V[:,gc] + x @ M[:,gc] + b[gc]
    with xx = x*x, V = -0.5/sigma^2, M = mu/sigma^2,
    b = -0.5 sum(mu^2/sigma^2) + det + log w. GMM score =
    logsumexp_c(comp_logit) with padded components masked out.
    """

    n_gmms: int
    max_comps: int
    vec_size: int
    V: np.ndarray  # (D, G*C) f32, column g*C + c
    M: np.ndarray  # (D, G*C) f32
    b: np.ndarray  # (G*C,)   f32
    mask: np.ndarray  # (G, C) bool


class AcousticModelSet:
    """HMM/GMM store loaded from the JAX package's npz format."""

    def __init__(self):
        self.vec_size = 0
        self.hybrid_mode = False
        self.gmm_means: list[np.ndarray] = []  # (C, D)
        self.gmm_vars: list[np.ndarray] = []  # (C, D)
        self.gmm_log_weights: list[np.ndarray] = []  # (C,)
        self.trans_mats: list[np.ndarray] = []  # (n, n) log probs
        self.hmm_names: list[str] = []
        self.hmm_gmm_inds: list[np.ndarray] = []  # (n_states-2,) int
        self.hmm_trans_ind: list[int] = []
        self._hmm_index: dict[str, int] = {}

    @classmethod
    def load_npz(cls, path: str) -> "AcousticModelSet":
        z = np.load(path, allow_pickle=False)
        ms = cls()
        ms.vec_size = int(z["vec_size"])
        ms.hybrid_mode = bool(z["hybrid"])
        if ms.hybrid_mode:
            raise NotImplementedError("hybrid HMM/ANN model sets are not ported")
        ms.hmm_names = [str(s) for s in z["hmm_names"]]
        ms._hmm_index = {n: i for i, n in enumerate(ms.hmm_names)}
        ms.hmm_trans_ind = [int(x) for x in z["hmm_trans_ind"]]
        ms.trans_mats = [z[f"tm_{i}"] for i in range(int(z["n_trans"]))]
        ng = int(z["n_gmms"])
        ms.gmm_means = [z[f"gm_{i}"] for i in range(ng)]
        ms.gmm_vars = [z[f"gv_{i}"] for i in range(ng)]
        ms.gmm_log_weights = [z[f"gw_{i}"] for i in range(ng)]
        ms.hmm_gmm_inds = [z[f"gi_{i}"] for i in range(len(ms.hmm_names))]
        return ms

    # -- queries -----------------------------------------------------------

    @property
    def n_hmms(self) -> int:
        return len(self.hmm_names)

    @property
    def n_gmms(self) -> int:
        return len(self.gmm_means)

    def get_hmm_index(self, name: str) -> int:
        return self._hmm_index.get(name, -1)

    def get_num_states(self, hmm_ind: int) -> int:
        return self.trans_mats[self.hmm_trans_ind[hmm_ind]].shape[0]

    def get_trans_mat(self, hmm_ind: int) -> np.ndarray:
        return self.trans_mats[self.hmm_trans_ind[hmm_ind]]

    # -- packing -----------------------------------------------------------

    def flat_params(self, dtype=np.float32) -> FlatGmmParams:
        G = self.n_gmms
        D = self.vec_size
        C = max(m.shape[0] for m in self.gmm_means)
        V = np.zeros((D, G * C), dtype=np.float64)
        M = np.zeros((D, G * C), dtype=np.float64)
        b = np.full(G * C, LOG_ZERO, dtype=np.float64)
        mask = np.zeros((G, C), dtype=bool)
        for g in range(G):
            means = self.gmm_means[g]
            variances = self.gmm_vars[g]
            lw = self.gmm_log_weights[g]
            for c in range(means.shape[0]):
                col = g * C + c
                iv = 1.0 / variances[c]
                V[:, col] = -0.5 * iv
                M[:, col] = means[c] * iv
                det = -0.5 * (D * LOG_2_PI + float(np.sum(np.log(variances[c]))))
                b[col] = (
                    -0.5 * float(np.sum(means[c] * means[c] * iv)) + det + float(lw[c])
                )
                mask[g, c] = True
        return FlatGmmParams(
            n_gmms=G, max_comps=C, vec_size=D,
            V=V.astype(dtype), M=M.astype(dtype), b=b.astype(dtype), mask=mask,
        )

    def packed_topology(self):
        """Padded per-HMM tensors: trP (H, S, S) log f32 with the exit state
        at S-1, state->GMM map (H, S) int32 (-1 for non-emitting), state
        counts (H,) and tee log probs (H,)."""
        H = self.n_hmms
        S = max(self.get_num_states(h) for h in range(H))
        trP = np.full((H, S, S), LOG_ZERO, dtype=np.float32)
        state_gmm = np.full((H, S), -1, dtype=np.int32)
        n_states = np.zeros(H, dtype=np.int32)
        tee = np.full(H, LOG_ZERO, dtype=np.float32)
        for h in range(H):
            tm = self.get_trans_mat(h)
            n = tm.shape[0]
            n_states[h] = n
            trP[h, : n - 1, : n - 1] = tm[: n - 1, : n - 1]
            trP[h, : n - 1, S - 1] = tm[: n - 1, n - 1]
            tee[h] = tm[0, n - 1]
            trP[h, 0, S - 1] = LOG_ZERO  # tee handled by the closure
            for j in range(1, n - 1):
                state_gmm[h, j] = self.hmm_gmm_inds[h][j - 1]
        return trP, state_gmm, n_states, tee
