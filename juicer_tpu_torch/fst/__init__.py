"""Weighted finite-state transducers: a copy of `juicer_tpu/fst/` (the
port imports nothing of it).

The mutable `Fst` container and `SymbolTable`, the LOG and TROPICAL
semirings, every algorithm of the offline toolchain and of the decode
path's lattices (`algos`: compose, determinize, minimize, push, ...),
and the AT&T text readers and writers (`read_fsm`, `write_fsm`,
`read_symbols`, `write_symbols`). Weights are costs (negative natural-log
probabilities), as on disk.
"""

from . import algos
from .fst import EPSILON, Fst, SymbolTable
from .io import read_fsm, read_symbols, write_fsm, write_symbols
from .semiring import INF, LOG, TROPICAL, Semiring

__all__ = ["EPSILON", "Fst", "INF", "LOG", "Semiring", "SymbolTable", "TROPICAL", "algos",
           "read_fsm", "read_symbols", "write_fsm", "write_symbols"]
