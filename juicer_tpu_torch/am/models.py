"""Acoustic model set: HMM topology, GMM parameters and their packing.

A reduced copy of `juicer_tpu/am/models.py` (the rebuild of `HTKModels`,
`HTKModels.{h,cpp}`):
  - built from a parsed MMF (`from_mmf` / `from_def`: shared ~s states
    are one GMM, shared ~t transition matrices one matrix), or in hybrid
    HMM/ANN mode from a phone list and priors (`hybrid`), where the
    observation score is log posterior - log prior;
  - the npz cache (`save_npz` / `load_npz`, the JAX class's format, each
    reads the other's files);
  - the float64 oracle scoring (`score_gmm`, `score_all`, `calc_output`)
    that `-doModelsIOTest` compares;
  - the matmul-expanded GMM packing (`flat_params`) the GMM kernel reads
    and the padded HMM topology (`packed_topology`) of the artifact.
Model-space MLLR (`with_mean_transform`) is not copied: `-mllrXformFile`
is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .mmf import MmfDef, parse_mmf

LOG_ZERO = -1e30
LOG_2_PI = math.log(2.0 * math.pi)


def log_add(x: float, y: float) -> float:
    if x < y:
        x, y = y, x
    d = y - x
    if d < -39.0:  # Torch3 logAdd MINUS_LOG_THRESHOLD region
        return x
    return x + math.log1p(math.exp(d))


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
    """HMM/GMM store with float64 oracle scoring and the kernel's packing."""

    def __init__(self):
        self.vec_size = 0
        self.hybrid_mode = False
        self.log_priors: Optional[np.ndarray] = None  # hybrid
        self.gmm_means: list[np.ndarray] = []  # (C, D)
        self.gmm_vars: list[np.ndarray] = []  # (C, D)
        self.gmm_log_weights: list[np.ndarray] = []  # (C,)
        self.trans_mats: list[np.ndarray] = []  # (n, n) log probs
        self._trans_names: dict[str, int] = {}
        self.hmm_names: list[str] = []
        self.hmm_gmm_inds: list[np.ndarray] = []  # (n_states-2,) int
        self.hmm_trans_ind: list[int] = []
        self._hmm_index: dict[str, int] = {}
        self._gmm_name_index: dict[str, int] = {}

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_mmf(cls, path: str) -> "AcousticModelSet":
        return cls.from_def(parse_mmf(path))

    @classmethod
    def from_def(cls, d: MmfDef) -> "AcousticModelSet":
        ms = cls()
        ms.vec_size = d.global_opts.vec_size
        for hmm in d.hmms:
            tm = d.resolve_transmat(hmm.transmat)
            probs = tm.probs.copy()
            if tm.name is not None:
                ti = ms._trans_names.get(tm.name)
                if ti is None:
                    ti = ms._add_transmat(probs)
                    ms._trans_names[tm.name] = ti
            else:
                ti = ms._add_transmat(probs)
            gmm_inds = []
            for s in hmm.states:
                if isinstance(s, str):
                    gi = ms._gmm_name_index.get(s)
                    if gi is None:
                        gi = ms._add_gmm(d.resolve_state(s).mixtures)
                        ms._gmm_name_index[s] = gi
                else:
                    gi = ms._add_gmm(s.mixtures)
                gmm_inds.append(gi)
            if ms.vec_size == 0 and ms.gmm_means:
                ms.vec_size = ms.gmm_means[0].shape[1]
            ms._hmm_index[hmm.name] = len(ms.hmm_names)
            ms.hmm_names.append(hmm.name)
            ms.hmm_gmm_inds.append(np.asarray(gmm_inds, dtype=np.int32))
            ms.hmm_trans_ind.append(ti)
        return ms

    @classmethod
    def hybrid(cls, phones: list[str], priors: np.ndarray,
               states_per_model: int) -> "AcousticModelSet":
        """Hybrid HMM/ANN: one HMM per phone over a shared left-to-right
        matrix (0->1 p=1; i->i and i->i+1 p=.5); every emitting state of
        phone p reads output p, whose score is log posterior - log prior
        (`HTKModels.cpp:75-220`, `HTKFlatModels.cpp:196-220`)."""
        if states_per_model <= 2:
            raise ValueError("states_per_model <= 2 (no emitting states)")
        ms = cls()
        ms.hybrid_mode = True
        n = states_per_model
        probs = np.zeros((n, n))
        probs[0, 1] = 1.0
        for i in range(1, n - 1):
            probs[i, i] = 0.5
            probs[i, i + 1] = 0.5
        ti = ms._add_transmat(probs)
        ms.log_priors = np.log(np.maximum(np.asarray(priors, dtype=np.float64), 1e-300))
        for pi, name in enumerate(phones):
            ms._hmm_index[name] = len(ms.hmm_names)
            ms.hmm_names.append(name)
            ms.hmm_gmm_inds.append(np.full(n - 2, pi, dtype=np.int32))
            ms.hmm_trans_ind.append(ti)
        ms.vec_size = len(phones)
        return ms

    def _add_transmat(self, probs: np.ndarray) -> int:
        with np.errstate(divide="ignore"):
            logp = np.where(probs > 0, np.log(np.maximum(probs, 1e-300)), LOG_ZERO)
        self.trans_mats.append(logp)
        return len(self.trans_mats) - 1

    def _add_gmm(self, mixtures) -> int:
        w = np.asarray([m.weight for m in mixtures], dtype=np.float64)
        self.gmm_means.append(np.stack([m.mean for m in mixtures]))
        self.gmm_vars.append(np.stack([m.var for m in mixtures]))
        with np.errstate(divide="ignore"):
            self.gmm_log_weights.append(
                np.where(w > 0, np.log(np.maximum(w, 1e-300)), LOG_ZERO))
        return len(self.gmm_means) - 1

    # -- binary cache ------------------------------------------------------

    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path,
            vec_size=self.vec_size,
            hybrid=self.hybrid_mode,
            log_priors=self.log_priors if self.log_priors is not None else np.zeros(0),
            hmm_names=np.asarray(self.hmm_names),
            hmm_trans_ind=np.asarray(self.hmm_trans_ind, dtype=np.int32),
            n_trans=len(self.trans_mats),
            n_gmms=len(self.gmm_means),
            **{f"tm_{i}": t for i, t in enumerate(self.trans_mats)},
            **{f"gm_{i}": m for i, m in enumerate(self.gmm_means)},
            **{f"gv_{i}": v for i, v in enumerate(self.gmm_vars)},
            **{f"gw_{i}": w for i, w in enumerate(self.gmm_log_weights)},
            **{f"gi_{i}": g for i, g in enumerate(self.hmm_gmm_inds)},
        )

    @classmethod
    def load_npz(cls, path: str) -> "AcousticModelSet":
        z = np.load(path, allow_pickle=False)
        ms = cls()
        ms.vec_size = int(z["vec_size"])
        ms.hybrid_mode = bool(z["hybrid"])
        lp = z["log_priors"]
        ms.log_priors = lp if lp.size else None
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
        return len(self.gmm_means) if not self.hybrid_mode else self.vec_size

    def get_hmm_index(self, name: str) -> int:
        return self._hmm_index.get(name, -1)

    def get_num_states(self, hmm_ind: int) -> int:
        return self.trans_mats[self.hmm_trans_ind[hmm_ind]].shape[0]

    def get_trans_mat(self, hmm_ind: int) -> np.ndarray:
        return self.trans_mats[self.hmm_trans_ind[hmm_ind]]

    def get_tee_log_prob(self, hmm_ind: int) -> float:
        return float(self.get_trans_mat(hmm_ind)[0, -1])

    # -- float64 oracle scoring --------------------------------------------

    def score_gmm(self, gmm_ind: int, x: np.ndarray) -> float:
        """Observation log-likelihood of one GMM (`calcMixtureOutput`,
        `HTKModels.cpp:2105-2150`)."""
        if self.hybrid_mode:
            return float(x[gmm_ind] - self.log_priors[gmm_ind])
        means = self.gmm_means[gmm_ind]
        variances = self.gmm_vars[gmm_ind]
        lw = self.gmm_log_weights[gmm_ind]
        out = LOG_ZERO
        for c in range(means.shape[0]):
            diff = x - means[c]
            s = float(np.sum(diff * diff * (-0.5 / variances[c])))
            s += -0.5 * (self.vec_size * LOG_2_PI + float(np.sum(np.log(variances[c]))))
            out = log_add(out, s + float(lw[c]))
        return out

    def score_all(self, x: np.ndarray) -> np.ndarray:
        """All GMM scores for one frame."""
        if self.hybrid_mode:
            return x - self.log_priors
        return np.array([self.score_gmm(g, x) for g in range(self.n_gmms)])

    def calc_output(self, hmm_ind: int, state_ind: int, x: np.ndarray) -> float:
        """b_j(o_t) for emitting state j (1..N-2, entry and exit excluded)."""
        return self.score_gmm(int(self.hmm_gmm_inds[hmm_ind][state_ind - 1]), x)

    # -- packing -----------------------------------------------------------

    def flat_params(self, dtype=np.float32) -> FlatGmmParams:
        if self.hybrid_mode:
            raise ValueError("hybrid mode uses posterior scoring, not GMM packing")
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
