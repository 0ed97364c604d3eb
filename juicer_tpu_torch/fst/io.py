"""AT&T-format text FSM and symbol-table IO, as `juicer_tpu/fst/io.py`
reads and writes them.

Per the reference writers: arc lines "from to in out [weight]", final
lines "state [weight]", symbol lines "%-25s %d"; the initial state is the
source state of the first arc line, so the start state's arcs go first.
Lines that do not parse are skipped, as the reference loader does.

`read_fsm` parses with the native library (`native.parse_fsm`) unless
`use_native=False` asks for the Python parser; the native machine keeps
its arcs as the parser's numpy arrays (a 7.87M-arc network would take
minutes as Python lists), so it is read-only: `add_arc` needs lists.
"""

from __future__ import annotations

from typing import Optional, TextIO, Union

from .fst import Fst, SymbolTable
from .semiring import LOG, Semiring


def _open(path_or_file, mode):
    """(file object, whether to close it)."""
    if isinstance(path_or_file, str):
        return open(path_or_file, mode), True
    return path_or_file, False


def read_fsm(path_or_file: Union[str, TextIO], semiring: Semiring = LOG,
             isyms: Optional[SymbolTable] = None, osyms: Optional[SymbolTable] = None,
             use_native: bool = True) -> Fst:
    if isinstance(path_or_file, str) and use_native:
        return _read_fsm_native(path_or_file, semiring, isyms, osyms)
    fd, close = _open(path_or_file, "r")
    try:
        f = Fst(semiring)
        f.isyms, f.osyms = isyms, osyms
        for line in fd:
            parts = line.split()
            if not parts:
                continue
            try:
                if len(parts) >= 4:
                    src, dst, il, ol = (int(x) for x in parts[:4])
                    w = float(parts[4]) if len(parts) >= 5 else 0.0
                    if f.start < 0:
                        f.set_start(src)
                    f.add_arc(src, dst, il, ol, w)
                elif len(parts) == 1:
                    f.set_final(int(parts[0]), 0.0)
                else:
                    f.set_final(int(parts[0]), float(parts[1]))
            except ValueError:
                continue  # invalid line: skip, like the reference loader
        return f
    finally:
        if close:
            fd.close()


def _read_fsm_native(path: str, semiring, isyms, osyms) -> Fst:
    from ..native import parse_fsm

    src, dst, il, ol, w, fs, fw, init_state = parse_fsm(path)
    f = Fst(semiring)
    f.isyms, f.osyms = isyms, osyms
    f.arc_src, f.arc_dst, f.arc_ilabel, f.arc_olabel, f.arc_weight = src, dst, il, ol, w
    n = int(max(src.max(), dst.max())) + 1 if len(src) else 0
    if len(fs):
        n = max(n, int(fs.max()) + 1)
    f.num_states = n
    f.start = init_state
    f.finals = dict(zip(fs.tolist(), fw.tolist()))
    return f


def write_fsm(f: Fst, path_or_file: Union[str, TextIO]) -> None:
    fd, close = _open(path_or_file, "w")
    try:
        n = f.num_arcs
        # the first line's source must be the initial state: where
        # insertion order does not start there, the start state's arcs are
        # stable-sorted to the front
        order = list(range(n))
        if f.start >= 0 and n > 0 and f.arc_src[0] != f.start:
            order.sort(key=lambda i: (f.arc_src[i] != f.start,))
        for i in order:
            w = f.arc_weight[i]
            if w == 0.0:
                fd.write(f"{f.arc_src[i]} {f.arc_dst[i]} {f.arc_ilabel[i]} {f.arc_olabel[i]}\n")
            else:
                fd.write(f"{f.arc_src[i]} {f.arc_dst[i]} {f.arc_ilabel[i]} "
                         f"{f.arc_olabel[i]} {w:.3f}\n")
        for s in sorted(f.finals):
            w = f.finals[s]
            if w == 0.0:
                fd.write(f"{s}\n")
            else:
                fd.write(f"{s} {w:f}\n")
    finally:
        if close:
            fd.close()


def read_symbols(path_or_file: Union[str, TextIO]) -> SymbolTable:
    fd, close = _open(path_or_file, "r")
    try:
        t = SymbolTable()
        for line in fd:
            parts = line.split()
            if len(parts) != 2:
                continue
            sym, idx = parts[0], int(parts[1])
            if t.find(sym) == idx:
                continue  # exact duplicate
            if 0 <= idx < len(t) and t[idx] is not None:
                # the one tolerated conflict: the "#sil 0 / #sp 1" trailer
                # the reference's lexgen writes into output-symbol files
                # (`WFSTLexGen.cpp:566`)
                if sym in ("#sil", "#sp"):
                    continue
                raise ValueError(f"symbol file conflict: {sym!r} -> {idx} but id {idx} "
                                 f"is already {t[idx]!r}")
            if t.find(sym) >= 0:
                raise ValueError(f"symbol file conflict: {sym!r} bound to both "
                                 f"{t.find(sym)} and {idx}")
            t.add_with_index(sym, idx)
        return t
    finally:
        if close:
            fd.close()


def write_symbols(t: SymbolTable, path_or_file: Union[str, TextIO]) -> None:
    fd, close = _open(path_or_file, "w")
    try:
        for i, s in enumerate(t):
            if s is not None:
                fd.write(f"{s:<25} {i}\n")
    finally:
        if close:
            fd.close()
