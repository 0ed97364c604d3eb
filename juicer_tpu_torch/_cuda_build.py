"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source compiles on first use, with nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), into a shared library with a
plain C interface under the package's `_build/` directory, and is loaded
with ctypes. Nothing here runs at import time: there is no nvcc where the
CPU tests run. `build_all` compiles every source at once, one nvcc each,
in parallel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("gmm_logsumexp", "frame_step", "probe_patterns")
# frame_step is held bit for bit to its plain version: no contraction of a
# multiply and an add into one rounding, should a later edit bring a multiply
EXTRA_FLAGS = {"frame_step": ["-fmad=false"]}
# libraries built from another library's source with more flags; not in
# SOURCES, so only the caller that asks for one builds it.
# frame_step_clocks: the frame-step kernel with a cycle counter at each
# phase of the frame (harness/profile_decode.py --fused --clocks)
VARIANTS = {"frame_step_clocks": ("frame_step", ["-DJTPU_FS_CLOCKS"])}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _source(name: str) -> tuple[str, list[str]]:
    """The source file of library `name` and the flags of its own."""
    src, flags = VARIANTS.get(name, (name, []))
    return os.path.join(CSRC, f"{src}.cu"), [*EXTRA_FLAGS.get(src, ()), *flags]


def _cmd(src: str, flags: list[str], out: str) -> list[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            *flags, "-o", out, src]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(
        _source(name)[0])


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every stale source, all nvcc processes started together.
    Returns each source's ptxas report (registers, shared memory, spills)."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        if _stale(name):
            tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
            procs[name] = (tmp, subprocess.Popen(
                _cmd(*_source(name), tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    reports = {}
    failed = []
    for name, (tmp, p) in procs.items():
        out, _ = p.communicate(timeout=600)
        reports[name] = out
        if p.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all((name,))
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
