"""Batched log-Gaussian-mixture acoustic scoring.

Counterpart of `juicer_tpu/ops/gmm.py`: every GMM is scored for every
frame, with the quadratic form expanded offline
(`AcousticModelSet.flat_params`) so that

    comp_logits = [x*x, x] @ [V; M] + b          (T, G*C)
    scores      = logsumexp_c(comp_logits)       (T, G)

`gmm_scores_dense` is the plain PyTorch version (full-f32 matmuls, the
package pins TF32 off). `make_gmm_scorer` returns a scorer that launches
the hand-written CUDA kernel (`ops/gmm_cuda.py`) for CUDA features and
uses the plain version only for CPU features.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..am.models import FlatGmmParams
from ..utils import trace
from . import gmm_cuda

NEG_INF = -1e30


def gmm_scores_dense(features: torch.Tensor, V: torch.Tensor, M: torch.Tensor,
                     b: torch.Tensor, comp_mask: torch.Tensor) -> torch.Tensor:
    """Scores for all GMMs for all frames: (T, G) float32.

    features (T, D); V, M (D, G*C); b (G*C,); comp_mask (G, C) bool."""
    T = features.shape[0]
    G, C = comp_mask.shape
    x = features.to(torch.float32)
    logits = x * x @ V + x @ M + b[None, :]
    logits = logits.reshape(T, G, C)
    logits = torch.where(comp_mask[None], logits, NEG_INF)
    m = logits.amax(dim=-1)
    # guard fully-masked rows
    safe_m = torch.where(m <= NEG_INF, 0.0, m)
    out = safe_m + torch.log(
        torch.sum(torch.exp(logits - safe_m[:, :, None]) * comp_mask[None], dim=-1)
    )
    return torch.where(m <= NEG_INF, NEG_INF, out)


class GmmScorer:
    """(T, D) features -> (T, G) GMM log-likelihoods on one device.

    Parameters live on that device: the g-major dense form for the plain
    version and, on the card, the same order padded to the kernel's tiles
    (`gmm_cuda.pack_params`). CUDA features go to the kernel (no
    fallback); CPU features to `gmm_scores_dense`."""

    def __init__(self, params: FlatGmmParams, device="cuda"):
        self.device = resolve_device(device)
        self.n_gmms = params.n_gmms
        dev = self.device
        self.V = torch.as_tensor(np.asarray(params.V, np.float32), device=dev)
        self.M = torch.as_tensor(np.asarray(params.M, np.float32), device=dev)
        self.b = torch.as_tensor(np.asarray(params.b, np.float32), device=dev)
        self.mask = torch.as_tensor(np.asarray(params.mask, bool), device=dev)
        if dev.type == "cuda":
            W, bp = gmm_cuda.pack_params(params)
            self.W = torch.as_tensor(W, device=dev)
            self.b_packed = torch.as_tensor(bp, device=dev)

    def __call__(self, features) -> torch.Tensor:
        """Traced as the span `score` (`utils.trace`)."""
        with trace.span("score"):
            if not isinstance(features, torch.Tensor):
                features = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
            if features.device != self.device:
                raise ValueError(
                    f"GmmScorer on {self.device} got features on {features.device}")
            if features.device.type == "cuda":
                x = features.to(torch.float32).contiguous()
                return gmm_cuda.gmm_logsumexp(x, self.W, self.b_packed, self.n_gmms)
            return gmm_scores_dense(features, self.V, self.M, self.b, self.mask)


def make_gmm_scorer(params: FlatGmmParams, device="cuda") -> GmmScorer:
    """Scorer with parameters resident on `device` (default: the card)."""
    return GmmScorer(params, device)
