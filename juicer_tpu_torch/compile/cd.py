"""Context-dependency transducer (C) generation.

A copy of `juicer_tpu/compile/cd.py`, the rebuild of `WFSTCDGen` +
`PhoneLookup` (`WFSTCDGen.{h,cpp}`, `MonophoneLookup.{h,cpp}`):

  - `CDPhoneLookup`: maps CD phone names ("a-b+c" with sep chars "-+") to
    tied model indices via an HTK tied list (1- or 2-column lines; the
    second column is the physical model, `MonophoneLookup.cpp:505-535`),
    with model indices bound from the acoustic model set's HMM names
    (`addModelInd`).
  - monophone C: single state, one self-loop per monophone mapping model
    index -> monophone (`writeFSMMonophone`, `WFSTCDGen.cpp:449-480`).
  - cross-word triphone C with deterministic inverse: states are
    (left, center) monophone pairs, CI silence mandatory, CI pause (sp)
    optional (`writeFSMXWordTriphoneDetInv`, `WFSTCDGen.cpp:719-1100`).
    Auxiliary symbols are passed through as self-loops on every state
    (the compiled default `#define AUXLOOP`, `WFSTCDGen.cpp:19,371-372`).

Input label m+1 = model (HMM) index m; aux input k at n_models+k+1.
Output label p+1 = monophone p; aux output k at n_monophones+k+1.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

from ..fst import EPSILON, Fst, LOG, SymbolTable
from ..fst.fst import EPSILON_STR
from ..lexicon import PhoneSet


class CDType(Enum):
    MONOPHONE = "monophone"
    MONOPHONE_ANN = "monophone-ann"
    XWORD_TRIPHONE = "xwrdtri"
    XWORD_TRIPHONE_NDI = "xwrdtrindi"


class CDPhoneLookup:
    """CD phone name -> tied model index."""

    def __init__(self, phone_set: PhoneSet, sep_chars: str = "-+"):
        self.phone_set = phone_set
        self.sep_chars = sep_chars
        # logical phone name -> physical phone name (tied list)
        self.logical_to_physical: dict[str, str] = {}
        # physical phone name -> model index
        self.model_inds: dict[str, int] = {}
        self._logical_order: list[str] = []

    def add_tied_list(self, path: str) -> None:
        with open(path, "r", errors="replace") as fd:
            for line in fd:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) == 1:
                    self._add_logical(parts[0], parts[0])
                else:
                    self._add_logical(parts[1], parts[1])
                    self._add_logical(parts[0], parts[1])

    def add_phones(self, names: list[str]) -> None:
        """Register phones without tying (each is its own physical model)."""
        for n in names:
            self._add_logical(n, n)

    def _add_logical(self, logical: str, physical: str) -> None:
        if logical not in self.logical_to_physical:
            self.logical_to_physical[logical] = physical
            self._logical_order.append(logical)

    def bind_models(self, hmm_names: list[str]) -> None:
        """Bind physical phone names to model indices (juicer's addModelInd
        loop over the model set)."""
        for i, name in enumerate(hmm_names):
            self.model_inds[name] = i

    def verify_all_models(self) -> None:
        missing = [
            p for p in set(self.logical_to_physical.values()) if p not in self.model_inds
        ]
        if missing:
            raise ValueError(f"models missing for physical phones: {sorted(missing)[:10]}")

    def get_model_ind(self, phone_str: str) -> int:
        phys = self.logical_to_physical.get(phone_str)
        if phys is None:
            return -1
        return self.model_inds.get(phys, -1)

    def parse_cd(self, name: str) -> tuple[int, int, int]:
        """Parse 'l-c+r' (or 'c+r', 'l-c', 'c') to monophone indices
        (left, center, right), -1 for absent context."""
        left = right = -1
        rest = name
        lsep, rsep = self.sep_chars[0], self.sep_chars[1]
        if lsep in rest:
            l, _, rest = rest.partition(lsep)
            left = self.phone_set.get_index(l)
            if left < 0:
                raise ValueError(f"unknown left monophone in {name!r}")
        if rsep in rest:
            rest, _, r = rest.partition(rsep)
            right = self.phone_set.get_index(r)
            if right < 0:
                raise ValueError(f"unknown right monophone in {name!r}")
        center = self.phone_set.get_index(rest)
        if center < 0:
            raise ValueError(f"unknown center monophone in {name!r}")
        return left, center, right

    def all_model_info(self) -> list[tuple[tuple[int, int, int], int]]:
        """[( (l,c,r) monophone inds (-1 absent), model index )] per logical
        CD phone (`PhoneLookup::getAllModelInfo`)."""
        out = []
        for logical in self._logical_order:
            mi = self.get_model_ind(logical)
            out.append((self.parse_cd(logical), mi))
        return out

    def have_ci_silence(self) -> bool:
        ps = self.phone_set
        return ps.sil_index >= 0 and self.get_model_ind(ps[ps.sil_index]) >= 0

    def have_ci_pause(self) -> bool:
        ps = self.phone_set
        return ps.pause_index >= 0 and self.get_model_ind(ps[ps.pause_index]) >= 0


class CDGen:
    def __init__(
        self,
        cd_type: CDType,
        phone_lookup: CDPhoneLookup,
        model_names: list[str],
        n_aux_syms: int = 0,
        aux_names: Optional[list[str]] = None,
    ):
        self.cd_type = cd_type
        self.lookup = phone_lookup
        self.model_names = model_names
        self.n_aux = n_aux_syms
        self.aux_names = aux_names or [f"#{i}" for i in range(n_aux_syms)]
        self.in_aux_base = len(model_names)
        self.out_aux_base = len(phone_lookup.phone_set)

    def build(self, ci_pause: Optional[bool] = None) -> Fst:
        if self.cd_type in (CDType.MONOPHONE, CDType.MONOPHONE_ANN):
            f = self._build_monophone()
        elif self.cd_type == CDType.XWORD_TRIPHONE:
            if ci_pause is None:
                ci_pause = self.lookup.have_ci_pause()
            f = self._build_xword_triphone_detinv(ci_pause)
        elif self.cd_type == CDType.XWORD_TRIPHONE_NDI:
            if ci_pause is None:
                ci_pause = self.lookup.have_ci_pause()
            f = self._build_xword_triphone_ndi(self.lookup.have_ci_silence(), ci_pause)
        else:
            raise ValueError("invalid CD type")
        # AUXLOOP: aux self-loops on every state
        for k in range(self.n_aux):
            for s in range(f.num_states):
                f.add_arc(s, s, self.in_aux_base + k + 1, self.out_aux_base + k + 1, 0.0)
        f.isyms = self.input_symbols()
        f.osyms = self.output_symbols()
        return f

    def input_symbols(self) -> SymbolTable:
        t = SymbolTable()
        t.add_with_index(EPSILON_STR, EPSILON)
        for i, n in enumerate(self.model_names):
            t.add_with_index(n, i + 1)
        for k, n in enumerate(self.aux_names):
            t.add_with_index(n, self.in_aux_base + k + 1)
        return t

    def output_symbols(self) -> SymbolTable:
        t = SymbolTable()
        t.add_with_index(EPSILON_STR, EPSILON)
        for i, p in enumerate(self.lookup.phone_set.phones):
            t.add_with_index(p, i + 1)
        for k, n in enumerate(self.aux_names):
            t.add_with_index(n, self.out_aux_base + k + 1)
        return t

    # -- monophone ---------------------------------------------------------

    def _build_monophone(self) -> Fst:
        f = Fst(LOG)
        s = f.add_state()
        f.set_start(s)
        ps = self.lookup.phone_set
        for i in range(len(ps)):
            mi = self.lookup.get_model_ind(ps[i])
            if mi < 0:
                raise ValueError(f"no model for monophone {ps[i]!r}")
            f.add_arc(s, s, mi + 1, i + 1, 0.0)
        f.set_final(s, 0.0)
        return f

    # -- cross-word triphone, NON-deterministic inverse --------------------

    def _build_xword_triphone_ndi(self, ci_sil: bool, ci_pause: bool) -> Fst:
        """`writeFSMXWordTriphoneNonDetInv` (`WFSTCDGen.cpp:1100+`): states
        are (center, right) lookahead pairs, output = CENTER phone; requires
        ph2+ph3 and ph1-ph2 biphones in the tied list for word starts/ends."""
        ps = self.lookup.phone_set
        sil = ps.sil_index
        sil_model = self.lookup.get_model_ind(ps[sil]) if sil >= 0 else -1
        if ci_sil and (sil < 0 or sil_model < 0):
            raise ValueError("ci_sil requires a CI silence model")
        sp = ps.pause_index
        sp_model = self.lookup.get_model_ind(ps[sp]) if sp >= 0 else -1
        if ci_pause and (sp < 0 or sp_model < 0):
            raise ValueError("ci_pause requires a CI pause model")

        f = Fst(LOG)
        states: dict[tuple, int] = {}

        def st(key: tuple, create: bool = True) -> int:
            s = states.get(key)
            if s is None:
                if not create:
                    return -1
                s = f.add_state()
                states[key] = s
            return s

        eps_st = st(("E",))
        f.set_start(eps_st)

        if ci_sil:
            # (8a/8b) sil from (eps,eps) -> (sil,eps) and self-loop
            sil_end = st((sil, -1))
            f.add_arc(eps_st, sil_end, sil_model + 1, sil + 1, 0.0)
            f.add_arc(sil_end, sil_end, sil_model + 1, sil + 1, 0.0)

        for (l, c, r), model in self.lookup.all_model_info():
            if c < 0:
                raise ValueError("CD phone with no center")
            if l < 0 and r < 0:
                if (ci_sil and c == sil) or (ci_pause and c == sp):
                    continue
                raise ValueError(f"invalid monophone in tied list: {ps[c]}")
            if l < 0:
                # (1/9) ph2+ph3: (eps,eps) -> (ph2,ph3) with model/ph2
                f.add_arc(eps_st, st((c, r)), model + 1, c + 1, 0.0)
            elif r < 0:
                if ci_sil and l == sil:
                    # (10) sil-ph2: (sil,eps) -> (ph2,eps)
                    f.add_arc(st((sil, -1)), st((c, -1)), model + 1, c + 1, 0.0)
                else:
                    # (3) ph1-ph2: (ph1,ph2) -> (ph2,eps)
                    f.add_arc(st((l, c)), st((c, -1)), model + 1, c + 1, 0.0)
            else:
                if ci_sil and l == sil:
                    # (7) sil-ph2+ph3: (sil,eps) -> (ph2,ph3)
                    f.add_arc(st((sil, -1)), st((c, r)), model + 1, c + 1, 0.0)
                else:
                    # (4/6) ph1-ph2+ph3: (ph1,ph2) -> (ph2,ph3)
                    f.add_arc(st((l, c)), st((c, r)), model + 1, c + 1, 0.0)

        if ci_sil:
            # (8c) sil from every existing (x,sil) to (sil,eps)
            to = st((sil, -1), create=False)
            if to < 0:
                raise ValueError("(sil,eps) state missing")
            for i in range(len(ps)):
                if i == sil or (ci_pause and i == sp):
                    continue
                frm = st((i, sil), create=False)
                if frm >= 0:
                    f.add_arc(frm, to, sil_model + 1, sil + 1, 0.0)

        if ci_pause:
            # (5) sp self-loop on every state
            for s in range(f.num_states):
                f.add_arc(s, s, sp_model + 1, sp + 1, 0.0)

        # finals: every existing (x,eps)
        for i in range(len(ps)):
            if ci_pause and i == sp:
                continue
            s = st((i, -1), create=False)
            if s >= 0:
                f.set_final(s, 0.0)
        return f

    # -- cross-word triphone, deterministic inverse ------------------------

    def _build_xword_triphone_detinv(self, ci_pause: bool) -> Fst:
        ps = self.lookup.phone_set
        sil = ps.sil_index
        sil_model = self.lookup.get_model_ind(ps[sil]) if sil >= 0 else -1
        if sil < 0 or sil_model < 0:
            raise ValueError("xwrdtri requires a CI silence model")
        sp = ps.pause_index
        sp_model = self.lookup.get_model_ind(ps[sp]) if sp >= 0 else -1
        if ci_pause and (sp < 0 or sp_model < 0):
            raise ValueError("ci_pause requires a CI pause model")

        f = Fst(LOG)
        states: dict[tuple, int] = {}

        def st(key: tuple, create: bool = True) -> int:
            s = states.get(key)
            if s is None:
                if not create:
                    return -1
                s = f.add_state()
                states[key] = s
            return s

        eps_st = st(("E",))
        f.set_start(eps_st)

        # (5a) (eps,eps) -> (eps,sil) with eps/sil
        eps_sil = st((-1, sil))
        f.add_arc(eps_st, eps_sil, EPSILON, sil + 1, 0.0)

        infos = self.lookup.all_model_info()
        for (l, c, r), model in infos:
            if c < 0:
                raise ValueError("CD phone with no center")
            if l < 0:
                if r < 0:
                    # monophone: only sil (and sp when CI pause) are valid
                    if c == sil or (ci_pause and c == sp):
                        continue
                    raise ValueError(f"invalid monophone in tied list: {ps[c]}")
                raise ValueError("invalid c+r biphone in tied list")
            if r < 0:
                raise ValueError("invalid l-c biphone in tied list")
            if c == sil:
                raise ValueError("l-sil+r triphone invalid with CI silence")
            if r == sil:
                # (2a) (l,c) -> (eps,sil) with l-c+sil / sil
                f.add_arc(st((l, c)), eps_sil, model + 1, sil + 1, 0.0)
                if ci_pause:
                    # (2b) (l,c,sp) -> (sil,sp,sil)
                    f.add_arc(
                        st((l, c, sp)), st((sil, sp, sil)), model + 1, sil + 1, 0.0
                    )
            else:
                # (1a) (l,c) -> (c,r) with l-c+r / r
                f.add_arc(st((l, c)), st((c, r)), model + 1, r + 1, 0.0)
                if ci_pause:
                    # (1b) (l,c,sp) -> (c,sp,r)
                    f.add_arc(st((l, c, sp)), st((c, sp, r)), model + 1, r + 1, 0.0)

        # (3a) sil self-loop at (eps,sil)
        f.add_arc(eps_sil, eps_sil, sil_model + 1, sil + 1, 0.0)
        # (3d) (eps,sil) -> (sil,eps) with sil/eps ; final
        sil_eps = st((sil, -1))
        f.add_arc(eps_sil, sil_eps, sil_model + 1, EPSILON, 0.0)
        f.set_final(sil_eps, 0.0)

        # (3b)/(3c) sil into each existing (sil,x)
        for i in range(len(ps)):
            if i == sil or (ci_pause and i == sp):
                continue
            to = st((sil, i), create=False)
            if to < 0:
                continue
            f.add_arc(eps_sil, to, sil_model + 1, i + 1, 0.0)
            if ci_pause:
                f.add_arc(
                    st((-1, sil, sp)), st((sil, sp, i)), sil_model + 1, i + 1, 0.0
                )

        if ci_pause:
            # (3e) (eps,sil,sp) -> (sil,sp,sil) with sil/sil
            f.add_arc(st((-1, sil, sp)), st((sil, sp, sil)), sil_model + 1, sil + 1, 0.0)
            # (5c) (eps,sil) -> (eps,sil,sp) with eps/sp
            f.add_arc(eps_sil, st((-1, sil, sp)), EPSILON, sp + 1, 0.0)
            # (4b) (sil,sp,sil) -> (eps,sil) with sp/eps
            f.add_arc(st((sil, sp, sil)), eps_sil, sp_model + 1, EPSILON, 0.0)
            # (4a)/(5b) for all existing pairs (x,y)
            for i in range(len(ps)):
                if i == sp:
                    continue
                for j in range(len(ps)):
                    if j == sp or (i == sil and j == sil):
                        continue
                    to = st((i, j), create=False)
                    if to < 0:
                        continue
                    frm = st((i, sp, j), create=False)
                    if frm >= 0:
                        # (4a) (x,sp,y) -> (x,y) with sp/eps
                        f.add_arc(frm, to, sp_model + 1, EPSILON, 0.0)
                    tosp = st((i, j, sp), create=False)
                    if tosp >= 0:
                        # (5b) (x,y) -> (x,y,sp) with eps/sp
                        f.add_arc(to, tosp, EPSILON, sp + 1, 0.0)
        return f
