"""Semirings over float costs (negative log probabilities), as in
`juicer_tpu/fst/semiring.py`.

TROPICAL: (min, +) — Viterbi / shortest path.
LOG:      (-log(e^-a + e^-b), +) — path-sum; lattices are built in it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

INF = float("inf")


def _log_plus(a: float, b: float) -> float:
    """Cost-domain log-add: -log(e^-a + e^-b), numerically stable."""
    if a == INF:
        return b
    if b == INF:
        return a
    lo, hi = (a, b) if a <= b else (b, a)
    return lo - math.log1p(math.exp(lo - hi))


@dataclass(frozen=True)
class Semiring:
    name: str

    @property
    def zero(self) -> float:
        return INF

    @property
    def one(self) -> float:
        return 0.0

    def plus(self, a: float, b: float) -> float:
        if self.name == "tropical":
            return a if a <= b else b
        return _log_plus(a, b)

    def times(self, a: float, b: float) -> float:
        if a == INF or b == INF:
            return INF
        return a + b

    def divide(self, a: float, b: float) -> float:
        """a ⊘ b (inverse of times); undefined if b is zero."""
        if a == INF:
            return INF
        return a - b

    def approx_equal(self, a: float, b: float, delta: float) -> bool:
        if a == INF or b == INF:
            return a == b
        return abs(a - b) <= delta


TROPICAL = Semiring("tropical")
LOG = Semiring("log")
