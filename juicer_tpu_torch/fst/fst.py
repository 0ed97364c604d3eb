"""The mutable FST container and symbol tables, as in
`juicer_tpu/fst/fst.py`.

States are dense ints, arcs (src, dst, ilabel, olabel, weight) live in
parallel Python lists, final states carry weights, label 0 is epsilon.
Weights are costs (negative log probabilities). A machine read from a
file may carry its symbol tables (`isyms`, `osyms`).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np

from .semiring import INF, LOG, Semiring

EPSILON = 0
EPSILON_STR = "<eps>"
PHI_STR = "#phi"


class SymbolTable:
    """Label <-> index map. Auxiliary symbols start with '#' (homophone
    disambiguation); the decoder replaces them by epsilon at load."""

    def __init__(self, symbols: Optional[Iterable[str]] = None):
        self._syms: list[Optional[str]] = []
        self._index: dict[str, int] = {}
        for s in symbols or ():
            self.add(s)

    @classmethod
    def with_epsilon(cls) -> "SymbolTable":
        t = cls()
        t.add(EPSILON_STR)
        return t

    def add(self, sym: str) -> int:
        idx = self._index.get(sym)
        if idx is None:
            idx = len(self._syms)
            self._index[sym] = idx
            self._syms.append(sym)
        return idx

    def add_with_index(self, sym: str, idx: int) -> None:
        if idx < len(self._syms):
            if self._syms[idx] not in (None, sym):
                raise ValueError(f"symbol index {idx} already bound to {self._syms[idx]!r}")
        else:
            self._syms.extend([None] * (idx + 1 - len(self._syms)))
        self._syms[idx] = sym
        self._index[sym] = idx

    def find(self, sym: str) -> int:
        """Index for symbol, -1 if absent."""
        return self._index.get(sym, -1)

    def __contains__(self, sym: str) -> bool:
        return sym in self._index

    def __getitem__(self, idx: int) -> Optional[str]:
        return self._syms[idx]

    def __len__(self) -> int:
        return len(self._syms)

    def __iter__(self) -> Iterator[Optional[str]]:
        return iter(self._syms)

    def is_auxiliary(self, idx: int) -> bool:
        s = self._syms[idx]
        return s is not None and s.startswith("#")

    @property
    def num_aux(self) -> int:
        return sum(1 for s in self._syms if s is not None and s.startswith("#"))

    def copy(self) -> "SymbolTable":
        t = SymbolTable()
        t._syms = list(self._syms)
        t._index = dict(self._index)
        return t


class Fst:
    __slots__ = ("start", "num_states", "arc_src", "arc_dst", "arc_ilabel",
                 "arc_olabel", "arc_weight", "finals", "isyms", "osyms", "semiring")

    def __init__(self, semiring: Semiring = LOG):
        self.start: int = -1
        self.num_states: int = 0
        self.arc_src: list[int] = []
        self.arc_dst: list[int] = []
        self.arc_ilabel: list[int] = []
        self.arc_olabel: list[int] = []
        self.arc_weight: list[float] = []
        self.finals: dict[int, float] = {}
        self.isyms: Optional[SymbolTable] = None
        self.osyms: Optional[SymbolTable] = None
        self.semiring = semiring

    def add_state(self) -> int:
        s = self.num_states
        self.num_states += 1
        return s

    def add_states(self, n: int) -> int:
        """Add n states; return the index of the first."""
        s = self.num_states
        self.num_states += n
        return s

    def ensure_state(self, s: int) -> int:
        if s >= self.num_states:
            self.num_states = s + 1
        return s

    def set_start(self, s: int) -> None:
        self.start = self.ensure_state(s)

    def add_arc(self, src: int, dst: int, ilabel: int, olabel: int, weight: float = 0.0) -> None:
        self.ensure_state(src)
        self.ensure_state(dst)
        self.arc_src.append(src)
        self.arc_dst.append(dst)
        self.arc_ilabel.append(ilabel)
        self.arc_olabel.append(olabel)
        self.arc_weight.append(weight)

    def set_final(self, s: int, weight: float = 0.0) -> None:
        self.ensure_state(s)
        self.finals[s] = weight

    def is_final(self, s: int) -> bool:
        return s in self.finals

    def final_weight(self, s: int) -> float:
        return self.finals.get(s, INF)

    @property
    def num_arcs(self) -> int:
        return len(self.arc_src)

    def arcs_numpy(self):
        """(src, dst, ilabel, olabel, weight) as numpy arrays."""
        return (np.asarray(self.arc_src, dtype=np.int32),
                np.asarray(self.arc_dst, dtype=np.int32),
                np.asarray(self.arc_ilabel, dtype=np.int32),
                np.asarray(self.arc_olabel, dtype=np.int32),
                np.asarray(self.arc_weight, dtype=np.float64))

    def out_arcs(self) -> list[list[int]]:
        """Per-state list of arc indices (adjacency)."""
        adj: list[list[int]] = [[] for _ in range(self.num_states)]
        for i, s in enumerate(self.arc_src):
            adj[s].append(i)
        return adj

    def csr(self, sort_by: str = "none"):
        """Arcs packed as CSR (row_ptr over src, arc arrays sorted by src).

        sort_by: 'none' keeps each state's insertion order, 'ilabel' or
        'olabel' sorts a state's arcs by that label."""
        src, dst, il, ol, w = self.arcs_numpy()
        if sort_by == "ilabel":
            order = np.lexsort((il, src))
        elif sort_by == "olabel":
            order = np.lexsort((ol, src))
        else:
            order = np.argsort(src, kind="stable")
        src, dst, il, ol, w = src[order], dst[order], il[order], ol[order], w[order]
        row_ptr = np.zeros(self.num_states + 1, dtype=np.int64)
        np.add.at(row_ptr, src + 1, 1)
        row_ptr = np.cumsum(row_ptr)
        return row_ptr, dst, il, ol, w

    def copy(self) -> "Fst":
        f = Fst(self.semiring)
        f.start = self.start
        f.num_states = self.num_states
        f.arc_src = list(self.arc_src)
        f.arc_dst = list(self.arc_dst)
        f.arc_ilabel = list(self.arc_ilabel)
        f.arc_olabel = list(self.arc_olabel)
        f.arc_weight = list(self.arc_weight)
        f.finals = dict(self.finals)
        f.isyms = self.isyms
        f.osyms = self.osyms
        return f

    def relabel(self, ilabel_map=None, olabel_map=None) -> None:
        """Relabel in place by callables or dicts (missing keys unchanged)."""

        def as_fn(m):
            if m is None or callable(m):
                return m
            return lambda x: m.get(x, x)

        fi, fo = as_fn(ilabel_map), as_fn(olabel_map)
        if fi is not None:
            self.arc_ilabel = [fi(x) for x in self.arc_ilabel]
        if fo is not None:
            self.arc_olabel = [fo(x) for x in self.arc_olabel]

    def __repr__(self) -> str:
        return (f"Fst(states={self.num_states}, arcs={self.num_arcs}, "
                f"finals={len(self.finals)}, start={self.start}, {self.semiring.name})")
