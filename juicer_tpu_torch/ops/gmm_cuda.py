"""Wrapper of the hand-written Hopper GMM kernel `csrc/gmm_logsumexp.cu`.

The kernel replaces the Pallas TPU kernel `_kernel` of
`juicer_tpu/ops/gmm_pallas.py`. `pack_params` lays the parameters out
component-major, as `make_pallas_gmm_scorer` does (`gmm_pallas.py:79-90`),
once per model set; `gmm_logsumexp` launches the kernel on CUDA tensors
and raises on anything else. Its plain PyTorch version is
`ops.gmm.gmm_scores_dense`; `ops.gmm.GmmScorer` dispatches between them by
the device of the features.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._cuda_build import load
from ..am.models import FlatGmmParams

NEG = -1e30
G_ALIGN = 32  # the kernel's GMM tile


class _Counter:
    """Launch count of the kernel: one per launch, nowhere else."""

    def __init__(self):
        self.launches = 0


counter = _Counter()
_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = load("gmm_logsumexp")
        lib.jtpu_gmm_logsumexp.restype = ctypes.c_int
        lib.jtpu_gmm_logsumexp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.jtpu_gmm_logsumexp_max_dim.restype = ctypes.c_int
        lib.jtpu_gmm_logsumexp_max_dim.argtypes = []
        _lib = lib
    return _lib


def pack_params(params: FlatGmmParams):
    """Component-major packing: W (C, 2D, G_pad) = [V; M] per component,
    b (C, G_pad) with -1e30 in padded components and GMMs."""
    G, C, D = params.n_gmms, params.max_comps, params.vec_size
    G_pad = -(-G // G_ALIGN) * G_ALIGN

    def to_cg(a):  # (D, G*C) g-major -> (C, D, G_pad)
        a = np.asarray(a, np.float32).reshape(D, G, C).transpose(2, 0, 1)
        out = np.zeros((C, D, G_pad), np.float32)
        out[:, :, :G] = a
        return out

    W = np.concatenate([to_cg(params.V), to_cg(params.M)], axis=1)
    b = np.full((C, G_pad), NEG, np.float32)
    b[:, :G] = np.asarray(params.b, np.float32).reshape(G, C).T
    b[:, :G][~np.asarray(params.mask).T] = NEG
    return W, b


def gmm_logsumexp(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                  n_gmms: int) -> torch.Tensor:
    """(T, D) float32 CUDA features -> (T, n_gmms) log-likelihoods, by the
    kernel, on the current stream. Raises on a tensor it does not take."""
    for name, t in (("x", x), ("W", W), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"gmm_logsumexp: {name} is on {t.device}, not a CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"gmm_logsumexp: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"gmm_logsumexp: {name} is not contiguous")
        if t.device != x.device:
            raise ValueError("gmm_logsumexp: tensors on different devices")
    if x.dim() != 2 or W.dim() != 3 or b.dim() != 2:
        raise ValueError("gmm_logsumexp: expected x (T, D), W (C, 2D, G_pad), b (C, G_pad)")
    T, D = x.shape
    C, D2, G_pad = W.shape
    if D2 != 2 * D or tuple(b.shape) != (C, G_pad) or not 0 < n_gmms <= G_pad:
        raise ValueError(
            f"gmm_logsumexp: shapes x {tuple(x.shape)}, W {tuple(W.shape)}, "
            f"b {tuple(b.shape)}, n_gmms {n_gmms} do not fit")
    if T >= 2**31 // max(n_gmms, D):
        raise ValueError("gmm_logsumexp: too many frames for one launch")
    lib = _get_lib()
    if D > lib.jtpu_gmm_logsumexp_max_dim():
        raise ValueError(f"gmm_logsumexp: feature size {D} exceeds the kernel's shared-memory tile")
    out = torch.empty((T, n_gmms), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.jtpu_gmm_logsumexp(x.data_ptr(), W.data_ptr(), b.data_ptr(),
                                out.data_ptr(), T, D, n_gmms, G_pad, C, stream)
    if rc != 0:
        raise RuntimeError(f"gmm_logsumexp: launch failed (cudaError {rc})")
    counter.launches += 1
    return out
