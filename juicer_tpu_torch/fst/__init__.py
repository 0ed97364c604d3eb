"""The FST utilities the decoder and its CLI need.

A reduced copy of `juicer_tpu/fst/` (the port imports nothing of it): the
mutable `Fst` container and `SymbolTable`, the LOG and TROPICAL
semirings, `algos.connect`, `algos.project`, `algos.shortest_path` and
`algos.generate_sequences`, and the AT&T text readers and writers
(`read_fsm`, `write_fsm`, `read_symbols`, `write_symbols`). The compile
toolchain (compose, determinize, minimize, ...) is not here: the decoder
reads a network that was compiled before.
"""

from . import algos
from .fst import EPSILON, Fst, SymbolTable
from .io import read_fsm, read_symbols, write_fsm, write_symbols
from .semiring import INF, LOG, TROPICAL, Semiring

__all__ = ["EPSILON", "Fst", "INF", "LOG", "Semiring", "SymbolTable", "TROPICAL", "algos",
           "read_fsm", "read_symbols", "write_fsm", "write_symbols"]
