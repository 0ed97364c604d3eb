"""ctypes binding for the native host library: the AT&T text FSM parser
and the eps/tee closure.

Counterpart of `get_lib`, `parse_fsm` and `closure` in
`juicer_tpu/native.py`. It compiles the repository's shared C++ source
`native/jtpu_native.cpp` with g++ into this package's own build
directory (`_native_build/`, rebuilt when the source is newer) and
exposes the two entries the decode path needs: `parse_fsm` for
`fst.read_fsm` and `closure` for the artifact build. Without a C++
toolchain it raises: the port keeps no pure-Python closure, and its
Python FSM parser is reached only by `read_fsm(use_native=False)`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "jtpu_native.cpp")
_LIB_DIR = os.path.join(_PKG, "_native_build")
_LIB = os.path.join(_LIB_DIR, "libjtpu_native.so")

_lock = threading.Lock()
_lib = None


class _FsmResult(ctypes.Structure):
    _fields_ = [
        ("n_arcs", ctypes.c_int64),
        ("n_finals", ctypes.c_int64),
        ("init_state", ctypes.c_int32),
        ("max_state", ctypes.c_int32),
        ("src", ctypes.POINTER(ctypes.c_int32)),
        ("dst", ctypes.POINTER(ctypes.c_int32)),
        ("ilab", ctypes.POINTER(ctypes.c_int32)),
        ("olab", ctypes.POINTER(ctypes.c_int32)),
        ("weight", ctypes.POINTER(ctypes.c_double)),
        ("final_state", ctypes.POINTER(ctypes.c_int32)),
        ("final_weight", ctypes.POINTER(ctypes.c_double)),
    ]


class _ClosureResult(ctypes.Structure):
    _fields_ = [
        ("n_entries", ctypes.c_int64),
        ("ent_row_ptr", ctypes.POINTER(ctypes.c_int64)),
        ("ent_arc", ctypes.POINTER(ctypes.c_int32)),
        ("ent_wlm", ctypes.POINTER(ctypes.c_double)),
        ("ent_wac", ctypes.POINTER(ctypes.c_double)),
        ("ent_seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("ent_seq_len", ctypes.POINTER(ctypes.c_int32)),
        ("n_finals", ctypes.c_int64),
        ("fin_row_ptr", ctypes.POINTER(ctypes.c_int64)),
        ("fin_wlm", ctypes.POINTER(ctypes.c_double)),
        ("fin_wac", ctypes.POINTER(ctypes.c_double)),
        ("fin_seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("fin_seq_len", ctypes.POINTER(ctypes.c_int32)),
        ("n_labels", ctypes.c_int64),
        ("labels", ctypes.POINTER(ctypes.c_int32)),
    ]


def get_lib() -> ctypes.CDLL:
    """Build (if stale) and load the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SRC):
            raise RuntimeError(f"native source missing: {_SRC}")
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            os.makedirs(_LIB_DIR, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=300,
            )
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        lib.jtpu_parse_fsm.restype = ctypes.POINTER(_FsmResult)
        lib.jtpu_parse_fsm.argtypes = [ctypes.c_char_p]
        lib.jtpu_free_fsm.argtypes = [ctypes.POINTER(_FsmResult)]
        lib.jtpu_closure.restype = ctypes.POINTER(_ClosureResult)
        lib.jtpu_closure.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
            np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int64),
            ctypes.c_int64,
        ]
        lib.jtpu_free_closure.argtypes = [ctypes.POINTER(_ClosureResult)]
        _lib = lib
        return _lib


def _copy(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def parse_fsm(path: str):
    """Native AT&T text FSM parse: (src, dst, ilabel, olabel, weight,
    final states, final weights, initial state), numpy arrays and an int.
    The initial state is the first arc line's source (-1 without arcs);
    lines that do not parse are skipped."""
    lib = get_lib()
    rp = lib.jtpu_parse_fsm(os.fsencode(path))
    if not rp:
        raise OSError(f"jtpu_parse_fsm could not read {path}")
    r = rp.contents
    out = (
        _copy(r.src, r.n_arcs, np.int32),
        _copy(r.dst, r.n_arcs, np.int32),
        _copy(r.ilab, r.n_arcs, np.int32),
        _copy(r.olab, r.n_arcs, np.int32),
        _copy(r.weight, r.n_arcs, np.float64),
        _copy(r.final_state, r.n_finals, np.int32),
        _copy(r.final_weight, r.n_finals, np.float64),
        int(r.init_state),
    )
    lib.jtpu_free_fsm(rp)
    return out


def closure(n_states, row_ptr, arc_dst, arc_il, arc_ol, arc_w, final_w, tee,
            hmm_arc_index, max_entries_per_state=1_000_000):
    """Native eps/tee closure of every state: per-state CSR tables of
    reachable HMM-arc entries and final-state reaches, with (lm, ac)
    weights and the output labels crossed. Raises RuntimeError on an
    entry blow-up."""
    lib = get_lib()
    rp = lib.jtpu_closure(
        int(n_states),
        np.ascontiguousarray(row_ptr, np.int64),
        np.ascontiguousarray(arc_dst, np.int32),
        np.ascontiguousarray(arc_il, np.int32),
        np.ascontiguousarray(arc_ol, np.int32),
        np.ascontiguousarray(arc_w, np.float64),
        np.ascontiguousarray(final_w, np.float64),
        np.ascontiguousarray(tee, np.float64),
        np.ascontiguousarray(hmm_arc_index, np.int64),
        int(max_entries_per_state),
    )
    if not rp:
        raise RuntimeError("jtpu_closure failed (entry blow-up?)")
    r = rp.contents
    out = {
        "ent_row_ptr": _copy(r.ent_row_ptr, n_states + 1, np.int64),
        "ent_arc": _copy(r.ent_arc, r.n_entries, np.int32),
        "ent_wlm": _copy(r.ent_wlm, r.n_entries, np.float64),
        "ent_wac": _copy(r.ent_wac, r.n_entries, np.float64),
        "ent_seq_off": _copy(r.ent_seq_off, r.n_entries, np.int64),
        "ent_seq_len": _copy(r.ent_seq_len, r.n_entries, np.int32),
        "fin_row_ptr": _copy(r.fin_row_ptr, n_states + 1, np.int64),
        "fin_wlm": _copy(r.fin_wlm, r.n_finals, np.float64),
        "fin_wac": _copy(r.fin_wac, r.n_finals, np.float64),
        "fin_seq_off": _copy(r.fin_seq_off, r.n_finals, np.int64),
        "fin_seq_len": _copy(r.fin_seq_len, r.n_finals, np.int32),
        "labels": _copy(r.labels, r.n_labels, np.int32),
    }
    lib.jtpu_free_closure(rp)
    return out
