"""Wrappers of the hand-written Hopper kernels `csrc/probe_patterns.cu`.

The kernels replace the nine Pallas kernel bodies of the Mosaic probe
`scripts/pallas_probe.py` (`make`, :30): `product` serves probes A, B and
C (a float32 matrix product, its output viewed 2-D or 3-D), `gather`
probes E and I (rows of a table by integer-valued float indices: what the
TPU's one-hot matmul computes) and `extract` probes D, F, G and H (a
column, or a contiguous range of rows; the entry point picks a span, a
column or a block copy from the arguments). Each public function launches
one kernel for CUDA tensors (or raises on a tensor it does not take) and
runs its plain PyTorch version, `*_plain` beside it, for CPU tensors.
Each kernel counts its launches in `counters[name].launches`, one a
launch and nowhere else. Two yardsticks lie on no path and are not
counted: `empty` launches a kernel that does nothing (the card's fixed
cost for a launch), `touch` one that reads a float and writes it (that
cost and one trip to memory).
"""

from __future__ import annotations

import ctypes

import torch

from .._cuda_build import load
from ..utils.trace import LaunchCounter

KERNELS = ("probe_product", "probe_gather", "probe_extract")
# A product block stages all of t (`jtpu_probe_product_smem_bytes` gives its
# layout's size); above 48 KB it opts in, up to the 227 KB an H100 block may
# take. Every shape the first kernel took (t and 16 rows of x within 48 KB)
# fits.
PRODUCT_SMEM_LIMIT = 227 * 1024


counters = {name: LaunchCounter() for name in KERNELS}
_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = load("probe_patterns")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jtpu_probe_product.restype = i
        lib.jtpu_probe_product.argtypes = [p, p, p, i, i, i, p]
        lib.jtpu_probe_gather.restype = i
        lib.jtpu_probe_gather.argtypes = [p, p, p, i, i, i, p]
        lib.jtpu_probe_extract.restype = i
        lib.jtpu_probe_extract.argtypes = [p, p, i, i, i, i, i, p]
        lib.jtpu_probe_empty.restype = i
        lib.jtpu_probe_empty.argtypes = [p]
        lib.jtpu_probe_touch.restype = i
        lib.jtpu_probe_touch.argtypes = [p, p, p]
        lib.jtpu_probe_product_smem_bytes.restype = ctypes.c_longlong
        lib.jtpu_probe_product_smem_bytes.argtypes = [i, i]
        _lib = lib
    return _lib


def _check(kernel, **tensors):
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not a CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{kernel}: tensors on different devices")
        dev = t.device


def _call(kernel, device, fn, *args):
    """Call the library's entry point on the current stream of `device`."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: launch failed (cudaError {rc})")


def _launch(kernel, device, fn, *args):
    """`_call`, and count the launch."""
    _call(kernel, device, fn, *args)
    counters[kernel].launches += 1


def empty(device) -> None:
    """Launch the kernel that does nothing on the current stream of `device`
    (a CUDA device): the floor under every probe's device time. Not counted,
    like `touch`: they lie on no path."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"probe_empty: {device} is not a CUDA device")
    _call("probe_empty", device, _get_lib().jtpu_probe_empty)


def touch(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Launch the kernel that reads `src`'s first float and writes it to
    `dst`'s first: the floor plus one trip to memory and its write-back,
    the height of the shortest chain a probe kernel can have."""
    _check("probe_touch", src=src, dst=dst)
    if not (src.numel() and dst.numel()):
        raise ValueError("probe_touch: an empty tensor")
    _call("probe_touch", src.device, _get_lib().jtpu_probe_touch, src.data_ptr(),
          dst.data_ptr())


# ---- product: probes A, B, C ------------------------------------------------


def product_plain(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, Kd) x (Kd, N) -> (R, N): the products summed over k."""
    return (x[:, :, None] * t[None, :, :]).sum(dim=1)


def product(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, Kd) @ (Kd, N) in float32: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if x.device.type == "cpu":
        return product_plain(x, t)
    _check("probe_product", x=x, t=t)
    if x.dim() != 2 or t.dim() != 2 or x.shape[1] != t.shape[0]:
        raise ValueError(f"probe_product: shapes {tuple(x.shape)} x {tuple(t.shape)} do not "
                         f"multiply")
    (R, Kd), N = x.shape, t.shape[1]
    lib = _get_lib()
    if lib.jtpu_probe_product_smem_bytes(Kd, N) > PRODUCT_SMEM_LIMIT:
        raise ValueError(f"probe_product: t ({Kd}, {N}) does not fit a block's shared memory")
    out = torch.empty((R, N), dtype=torch.float32, device=x.device)
    _launch("probe_product", x.device, lib.jtpu_probe_product, x.data_ptr(), t.data_ptr(),
            out.data_ptr(), R, Kd, N)
    return out


# ---- gather: probes E, I ----------------------------------------------------


def gather_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """(R,) float indices into (n_rows, W) -> (R, W): row int(idx[r]) where
    idx[r] is an integer in [0, n_rows), else zeros."""
    ok = (idx >= 0) & (idx < tab.shape[0]) & (idx == torch.floor(idx))
    rows = tab[torch.where(ok, idx, 0.0).to(torch.int64)]
    return torch.where(ok[:, None], rows, 0.0)


def gather(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Rows of `tab` by the float indices `idx`: the kernel for CUDA
    tensors, the plain version for CPU ones."""
    if idx.device.type == "cpu":
        return gather_plain(idx, tab)
    _check("probe_gather", idx=idx, tab=tab)
    if idx.dim() != 1 or tab.dim() != 2:
        raise ValueError(f"probe_gather: expected idx (R,) and tab (n_rows, W), got "
                         f"{tuple(idx.shape)} and {tuple(tab.shape)}")
    out = torch.empty((idx.shape[0], tab.shape[1]), dtype=torch.float32, device=idx.device)
    _launch("probe_gather", idx.device, _get_lib().jtpu_probe_gather, idx.data_ptr(),
            tab.data_ptr(), out.data_ptr(), idx.shape[0], tab.shape[0], tab.shape[1])
    return out


# ---- extract: probes D, F, G, H ---------------------------------------------


def extract_plain(x: torch.Tensor, row0: int, n_rows: int, col0: int,
                  n_cols: int) -> torch.Tensor:
    """Rows row0..row0+n_rows and columns col0..col0+n_cols of the 2-D `x`,
    as a new (n_rows, n_cols) tensor."""
    return x[row0:row0 + n_rows, col0:col0 + n_cols].clone()


def extract(x: torch.Tensor, row0: int, n_rows: int, col0: int, n_cols: int) -> torch.Tensor:
    """A block of rows and columns of the 2-D `x`: one launch for CUDA
    tensors, the plain version for CPU ones. The C entry point picks the
    kernel: a contiguous span (whole rows, or one row) by float4 where the
    source and output are 16-byte aligned and by floats otherwise, a column
    (n_cols == 1) a row a thread, any other block a row a warp."""
    if x.device.type == "cpu":
        return extract_plain(x, row0, n_rows, col0, n_cols)
    _check("probe_extract", x=x)
    if (x.dim() != 2 or min(row0, col0) < 0 or min(n_rows, n_cols) <= 0
            or row0 + n_rows > x.shape[0] or col0 + n_cols > x.shape[1]):
        raise ValueError(f"probe_extract: rows {row0}+{n_rows}, columns {col0}+{n_cols} are "
                         f"not inside {tuple(x.shape)}")
    out = torch.empty((n_rows, n_cols), dtype=torch.float32, device=x.device)
    _launch("probe_extract", x.device, _get_lib().jtpu_probe_extract, x.data_ptr(),
            out.data_ptr(), n_rows, row0, x.shape[1], col0, n_cols)
    return out
