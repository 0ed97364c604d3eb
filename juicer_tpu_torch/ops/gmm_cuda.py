"""Wrapper of the hand-written Hopper GMM kernel `csrc/gmm_logsumexp.cu`.

The kernel replaces the Pallas TPU kernel `_kernel` of
`juicer_tpu/ops/gmm_pallas.py`. `pack_params` keeps the plain scorer's
g-major column order (a GMM's components side by side) and only pads it,
once per model set: W (2D, G_pad * C_pad) = [V; M], b (G_pad, C_pad) with
-1e30 in padded components and GMMs. `gmm_logsumexp` launches the kernel
on CUDA tensors and raises on anything else. Its plain PyTorch version is
`ops.gmm.gmm_scores_dense`; `ops.gmm.GmmScorer` dispatches between them by
the device of the features.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._cuda_build import load
from ..am.models import FlatGmmParams
from ..utils.trace import LaunchCounter

NEG = -1e30
GMM_TILE = 16    # GMMs a block scores; G pads to a multiple
COMP_CHUNK = 8   # components a thread holds; C pads to a multiple
MAX_DIM = 192    # feature sizes the kernel takes (the widest the card tests check)
MAX_COMPS = 32   # components a GMM may have (likewise)


counter = LaunchCounter()
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
        _lib = lib
    return _lib


def check_limits(D: int, C: int) -> None:
    """Raise ValueError unless the kernel takes feature size D and C
    components a GMM."""
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"gmm_logsumexp: feature size {D} is outside 1..{MAX_DIM}")
    if not 1 <= C <= MAX_COMPS:
        raise ValueError(f"gmm_logsumexp: {C} components a GMM is outside 1..{MAX_COMPS}")


def pack_params(params: FlatGmmParams):
    """W (2D, G_pad * C_pad) = [V; M] in g-major column order (column
    g * C_pad + c), zero in padded columns; b (G_pad, C_pad) with -1e30 in
    padded components and GMMs."""
    G, C, D = params.n_gmms, params.max_comps, params.vec_size
    check_limits(D, C)
    G_pad, C_pad = -(-G // GMM_TILE) * GMM_TILE, -(-C // COMP_CHUNK) * COMP_CHUNK

    def pad(a):  # (D, G*C) -> (D, G_pad * C_pad)
        out = np.zeros((D, G_pad, C_pad), np.float32)
        out[:, :G, :C] = np.asarray(a, np.float32).reshape(D, G, C)
        return out.reshape(D, G_pad * C_pad)

    W = np.concatenate([pad(params.V), pad(params.M)], axis=0)
    b = np.full((G_pad, C_pad), NEG, np.float32)
    b[:G, :C] = np.where(np.asarray(params.mask, bool),
                         np.asarray(params.b, np.float32).reshape(G, C), NEG)
    return W, b


def gmm_logsumexp(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                  n_gmms: int) -> torch.Tensor:
    """(T, D) float32 CUDA features -> (T, n_gmms) log-likelihoods, by the
    kernel, on the current stream of their device. Raises on a tensor it does not take."""
    for name, t in (("x", x), ("W", W), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"gmm_logsumexp: {name} is on {t.device}, not a CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"gmm_logsumexp: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"gmm_logsumexp: {name} is not contiguous")
        if t.device != x.device:
            raise ValueError("gmm_logsumexp: tensors on different devices")
    if x.dim() != 2 or W.dim() != 2 or b.dim() != 2:
        raise ValueError("gmm_logsumexp: expected x (T, D), W (2D, G_pad*C_pad), "
                         "b (G_pad, C_pad)")
    T, D = x.shape
    G_pad, C_pad = b.shape
    if (tuple(W.shape) != (2 * D, G_pad * C_pad) or G_pad % GMM_TILE or C_pad % COMP_CHUNK
            or not 0 < n_gmms <= G_pad):
        raise ValueError(
            f"gmm_logsumexp: shapes x {tuple(x.shape)}, W {tuple(W.shape)}, "
            f"b {tuple(b.shape)}, n_gmms {n_gmms} do not fit")
    check_limits(D, C_pad)
    if W.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("gmm_logsumexp: W and b must be 16-byte aligned")
    if T >= 2**31 // max(n_gmms, D):
        raise ValueError("gmm_logsumexp: too many frames for one launch")
    out = torch.empty((T, n_gmms), dtype=torch.float32, device=x.device)
    lib = _get_lib()
    # the kernel sets its shared-memory opt-in on the current device: make
    # that the device whose stream it is launched on
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.jtpu_gmm_logsumexp(x.data_ptr(), W.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), T, D, n_gmms, G_pad, C_pad, stream)
    if rc != 0:
        raise RuntimeError(f"gmm_logsumexp: launch failed (cudaError {rc})")
    counter.launches += 1
    return out
