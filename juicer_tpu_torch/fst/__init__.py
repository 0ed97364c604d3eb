"""The FST utilities the decoder's lattices need.

A reduced copy of `juicer_tpu/fst/` (the port imports nothing of it): the
mutable `Fst` container, the LOG and TROPICAL semirings, `algos.connect`,
`algos.project`, `algos.shortest_path` and the AT&T text writer
`write_fsm`. The compile toolchain (compose, determinize, minimize, ...)
is not here: the decoder reads its network from the artifact.
"""

from . import algos
from .fst import EPSILON, Fst
from .io import write_fsm
from .semiring import INF, LOG, TROPICAL, Semiring

__all__ = ["EPSILON", "Fst", "INF", "LOG", "Semiring", "TROPICAL", "algos", "write_fsm"]
