"""ctypes binding for the native host library: the AT&T text FSM parser,
the eps/tee closure and weighted determinization.

Counterpart of `get_lib`, `parse_fsm`, `closure` and `determinize` in
`juicer_tpu/native.py`. It compiles the repository's shared C++ source
`native/jtpu_native.cpp` with g++ into this package's own build
directory (`_native_build/`, rebuilt when the source is newer) and
exposes three entries: `parse_fsm` for `fst.read_fsm`, `closure` for the
artifact build and `determinize` for `fst.algos.determinize`. Without a
C++ toolchain each raises: the port takes no pure-Python path on its
own. Its Python FSM parser is reached only by `read_fsm(use_native=
False)`, its Python subset construction only by
`algos.determinize_plain`, the plain version the tests hold the native
one to.
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
# `jtpu_determinize` gives up (error set) past this many output states.
DETERMINIZE_MAX_SUBSETS = 50_000_000

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


class _DetResult(ctypes.Structure):
    _fields_ = [
        ("n_states", ctypes.c_int64),
        ("n_arcs", ctypes.c_int64),
        ("arc_src", ctypes.POINTER(ctypes.c_int32)),
        ("arc_dst", ctypes.POINTER(ctypes.c_int32)),
        ("arc_il", ctypes.POINTER(ctypes.c_int32)),
        ("arc_ostr", ctypes.POINTER(ctypes.c_int32)),
        ("arc_w", ctypes.POINTER(ctypes.c_double)),
        ("n_finals", ctypes.c_int64),
        ("fin_sid", ctypes.POINTER(ctypes.c_int32)),
        ("fin_ostr", ctypes.POINTER(ctypes.c_int32)),
        ("fin_w", ctypes.POINTER(ctypes.c_double)),
        ("n_strs", ctypes.c_int64),
        ("str_off", ctypes.POINTER(ctypes.c_int64)),
        ("str_len", ctypes.POINTER(ctypes.c_int32)),
        ("str_labels", ctypes.POINTER(ctypes.c_int32)),
        ("n_labels", ctypes.c_int64),
        ("error", ctypes.c_int32),
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
        lib.jtpu_determinize.restype = ctypes.POINTER(_DetResult)
        lib.jtpu_determinize.argtypes = [
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
            ctypes.c_int32, ctypes.c_int64,
        ]
        lib.jtpu_free_determinize.argtypes = [ctypes.POINTER(_DetResult)]
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


def determinize(n_states, start, row_ptr, arc_dst, arc_il, arc_ol, arc_w, final_w,
                semiring: str):
    """Native weighted determinization (subset construction with output-
    string residuals) of a machine in CSR form: a dict of numpy arrays,
    the arcs and finals with interned output-string ids and the string
    table. Raises RuntimeError on a subset blow-up."""
    lib = get_lib()
    sr = {"tropical": 0, "log": 1}[semiring]
    rp = lib.jtpu_determinize(
        int(n_states), int(start),
        np.ascontiguousarray(row_ptr, np.int64),
        np.ascontiguousarray(arc_dst, np.int32),
        np.ascontiguousarray(arc_il, np.int32),
        np.ascontiguousarray(arc_ol, np.int32),
        np.ascontiguousarray(arc_w, np.float64),
        np.ascontiguousarray(final_w, np.float64),
        sr, DETERMINIZE_MAX_SUBSETS,
    )
    if not rp:
        raise RuntimeError("jtpu_determinize failed")
    r = rp.contents
    if r.error:
        lib.jtpu_free_determinize(rp)
        raise RuntimeError("determinize: subset blow-up (not determinizable?)")
    out = {
        "n_states": int(r.n_states),
        "arc_src": _copy(r.arc_src, r.n_arcs, np.int32),
        "arc_dst": _copy(r.arc_dst, r.n_arcs, np.int32),
        "arc_il": _copy(r.arc_il, r.n_arcs, np.int32),
        "arc_ostr": _copy(r.arc_ostr, r.n_arcs, np.int32),
        "arc_w": _copy(r.arc_w, r.n_arcs, np.float64),
        "fin_sid": _copy(r.fin_sid, r.n_finals, np.int32),
        "fin_ostr": _copy(r.fin_ostr, r.n_finals, np.int32),
        "fin_w": _copy(r.fin_w, r.n_finals, np.float64),
        "str_off": _copy(r.str_off, r.n_strs, np.int64),
        "str_len": _copy(r.str_len, r.n_strs, np.int32),
        "str_labels": _copy(r.str_labels, r.n_labels, np.int32),
    }
    lib.jtpu_free_determinize(rp)
    return out
