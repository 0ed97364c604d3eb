"""HTK MMF (master macro file) parser and writer.

A copy of `juicer_tpu/am/mmf.py`, the rebuild of the reference's
flex/bison grammar (`htkparse.l.lpp` / `htkparse.y.ypp`) and its `HTKDef`
struct tree (`htkparse.h:78-158`), and `untie_models` (the `untie`
tool's tied-to-physical expansion). Grammar coverage: ~o global options
(HMMSETID, STREAMINFO, VECSIZE, covariance/duration kinds, parm kind),
~v variance-floor macros, ~t shared transition matrices, ~s shared states,
~m shared mixtures (incl. tied-mixture pools), ~h HMMs; per-state
NUMMIXES/MIXTURE/MEAN/VARIANCE/GCONST and <TMix> tied-mixture states.

GCONST values in the file are parsed but recomputed from the variances at
model build time, matching `HTKModels::addVarVec`
(`HTKModels.cpp:854-866`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np


class MMFParseError(ValueError):
    pass


@dataclass
class MmfMixture:
    weight: float
    mean: np.ndarray
    var: np.ndarray
    gconst: Optional[float] = None


@dataclass
class MmfState:
    name: Optional[str] = None  # macro name if shared (~s)
    mixtures: list[MmfMixture] = field(default_factory=list)
    # tied-mixture (<TMix>) states: pool name + per-state weight vector;
    # `mixtures` is still materialized (pool components with these
    # weights) so downstream consumers need no special casing
    tmix_pool: Optional[str] = None
    tmix_weights: Optional[np.ndarray] = None


@dataclass
class MmfTransMat:
    name: Optional[str]
    n_states: int
    probs: np.ndarray  # (n, n) linear probabilities


@dataclass
class MmfHmm:
    name: str
    n_states: int
    states: list[Union[MmfState, str]] = field(default_factory=list)  # str = ~s ref
    transmat: Union[MmfTransMat, str, None] = None  # str = ~t ref


@dataclass
class MmfGlobalOpts:
    hmm_set_id: Optional[str] = None
    n_streams: int = 1
    stream_widths: list[int] = field(default_factory=list)
    vec_size: int = 0
    cov_kind: str = "DIAGC"
    dur_kind: str = "NULLD"
    parm_kind: Optional[str] = None


@dataclass
class MmfDef:
    global_opts: MmfGlobalOpts = field(default_factory=MmfGlobalOpts)
    var_floors: dict[str, np.ndarray] = field(default_factory=dict)
    sh_transmats: dict[str, MmfTransMat] = field(default_factory=dict)
    sh_states: dict[str, MmfState] = field(default_factory=dict)
    sh_mixtures: dict[str, MmfMixture] = field(default_factory=dict)
    # tied-mixture pools: every ~m macro whose name ends in digits joins
    # the pool named by the non-digit prefix, in id order (the reference
    # treats ALL ~m macros this way: `htkparse.y.ypp:147-205` splits the
    # macro string at the first digit and requires id == pool size + 1)
    mix_pools: dict[str, list[MmfMixture]] = field(default_factory=dict)
    hmms: list[MmfHmm] = field(default_factory=list)

    def resolve_state(self, s: Union[MmfState, str]) -> MmfState:
        if isinstance(s, str):
            try:
                return self.sh_states[s]
            except KeyError:
                raise MMFParseError(f"shared state {s!r} not found")
        return s

    def resolve_transmat(self, t: Union[MmfTransMat, str, None]) -> MmfTransMat:
        if isinstance(t, str):
            try:
                return self.sh_transmats[t]
            except KeyError:
                raise MMFParseError(f"shared transmat {t!r} not found")
        if t is None:
            raise MMFParseError("HMM without transition matrix")
        return t


_COV_KINDS = {"DIAGC", "INVDIAGC", "FULLC", "LLTC", "XFORMC"}
_DUR_KINDS = {"NULLD", "POISSOND", "GAMMAD", "GEND"}

_TOKEN_RE = re.compile(
    r"""
    <[^>]*>            # <KEYWORD>
  | "[^"]*"            # quoted string
  | ~[a-zA-Z]          # macro marker
  | [^\s<>"~]+         # bare token (number, name)
    """,
    re.VERBOSE,
)


class _Tokens:
    def __init__(self, text: str):
        self.toks = _TOKEN_RE.findall(text)
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise MMFParseError("unexpected end of MMF")
        self.pos += 1
        return t

    def expect_kw(self, *names: str) -> str:
        t = self.next()
        if not t.startswith("<"):
            raise MMFParseError(f"expected keyword {names}, got {t!r}")
        kw = t.strip("<>").upper()
        if names and kw not in names:
            raise MMFParseError(f"expected keyword {names}, got <{kw}>")
        return kw

    def peek_kw(self) -> Optional[str]:
        t = self.peek()
        if t is not None and t.startswith("<"):
            return t.strip("<>").upper()
        return None

    def next_int(self) -> int:
        return int(self.next())

    def next_float(self) -> float:
        return float(self.next())

    def next_floats(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        for i in range(n):
            out[i] = float(self.next())
        return out

    def next_str(self) -> str:
        t = self.next()
        if t.startswith('"'):
            return t.strip('"')
        return t


def parse_mmf(path: str) -> MmfDef:
    with open(path, "r", errors="replace") as fd:
        text = fd.read()
    tk = _Tokens(text)
    d = MmfDef()

    while tk.peek() is not None:
        t = tk.next()
        if t == "~o":
            _parse_global_opts(tk, d.global_opts)
        elif t == "~v":
            name = tk.next_str()
            tk.expect_kw("VARIANCE")
            n = tk.next_int()
            d.var_floors[name] = tk.next_floats(n)
        elif t == "~t":
            name = tk.next_str()
            d.sh_transmats[name] = _parse_transmat(tk, name)
        elif t == "~s":
            name = tk.next_str()
            d.sh_states[name] = _parse_state(tk, d, name)
        elif t == "~m":
            name = tk.next_str()
            mix = _parse_mixture_body(tk, d)
            d.sh_mixtures[name] = mix
            # pool membership: name = <pool><id> (reference MMACRO rule,
            # `htkparse.y.ypp:155-205`); ids must arrive in order
            prefix = name.rstrip("0123456789")
            if prefix != name and prefix:
                pool = d.mix_pools.setdefault(prefix, [])
                mix_id = int(name[len(prefix):])
                if mix_id != len(pool) + 1:
                    raise MMFParseError(
                        f"shared mixture {name!r}: id {mix_id} does not "
                        f"match pool {prefix!r} size {len(pool)}"
                    )
                pool.append(mix)
        elif t == "~h":
            name = tk.next_str()
            d.hmms.append(_parse_hmm(tk, d, name))
        elif t.startswith("<"):
            # a bare global-options keyword outside ~o (HTK allows this at
            # the start of the file)
            tk.pos -= 1
            _parse_global_opts(tk, d.global_opts)
        else:
            raise MMFParseError(f"unexpected token at top level: {t!r}")
    return d


def _parse_global_opts(tk: _Tokens, g: MmfGlobalOpts) -> None:
    while True:
        kw = tk.peek_kw()
        if kw is None:
            return
        if kw == "HMMSETID":
            tk.next()
            g.hmm_set_id = tk.next_str()
        elif kw == "STREAMINFO":
            tk.next()
            g.n_streams = tk.next_int()
            g.stream_widths = [tk.next_int() for _ in range(g.n_streams)]
        elif kw == "VECSIZE":
            tk.next()
            g.vec_size = tk.next_int()
        elif kw in _COV_KINDS:
            tk.next()
            g.cov_kind = kw
        elif kw in _DUR_KINDS:
            tk.next()
            g.dur_kind = kw
        elif kw in ("BEGINHMM", "NUMSTATES", "STATE", "TRANSP", "VARIANCE", "MEAN",
                    "NUMMIXES", "MIXTURE", "GCONST", "ENDHMM"):
            return
        else:
            # treat as parm kind (e.g. <MFCC_D_A_Z>)
            tk.next()
            g.parm_kind = kw


def _parse_transmat(tk: _Tokens, name: Optional[str]) -> MmfTransMat:
    tk.expect_kw("TRANSP")
    n = tk.next_int()
    probs = tk.next_floats(n * n).reshape(n, n)
    return MmfTransMat(name, n, probs)


def _parse_mixture_body(tk: _Tokens, d: MmfDef, weight: float = 1.0) -> MmfMixture:
    tk.expect_kw("MEAN")
    n = tk.next_int()
    mean = tk.next_floats(n)
    tk.expect_kw("VARIANCE")
    n2 = tk.next_int()
    var = tk.next_floats(n2)
    gconst = None
    if tk.peek_kw() == "GCONST":
        tk.next()
        gconst = tk.next_float()
    return MmfMixture(weight, mean, var, gconst)


def _parse_state(tk: _Tokens, d: MmfDef, name: Optional[str] = None) -> MmfState:
    st = MmfState(name=name)
    n_mixes = 1
    if tk.peek_kw() == "NUMMIXES":
        tk.next()
        n_mixes = tk.next_int()
    if tk.peek_kw() == "TMIX":
        # <TMix> pool w1 .. wn: the state shares the pool's component
        # densities with a per-state weight vector
        # (`htkparse.y.ypp:516-544`; weight count must equal pool size)
        tk.next()
        pool_name = tk.next_str()
        pool = d.mix_pools.get(pool_name)
        if pool is None:
            raise MMFParseError(
                f"<TMix> pool {pool_name!r} not found (no ~m "
                f'"{pool_name}<n>" macros seen)'
            )
        weights = tk.next_floats(len(pool))
        st.tmix_pool = pool_name
        st.tmix_weights = weights
        st.mixtures = [
            MmfMixture(float(w), m.mean, m.var, m.gconst)
            for w, m in zip(weights, pool)
        ]
        return st
    if tk.peek_kw() == "MIXTURE":
        while tk.peek_kw() == "MIXTURE":
            tk.next()
            _ix = tk.next_int()
            w = tk.next_float()
            if tk.peek() == "~m":
                tk.next()
                ref = tk.next_str()
                base = d.sh_mixtures.get(ref)
                if base is None:
                    raise MMFParseError(f"shared mixture {ref!r} not found")
                st.mixtures.append(MmfMixture(w, base.mean, base.var, base.gconst))
            else:
                st.mixtures.append(_parse_mixture_body(tk, d, w))
    elif tk.peek() == "~m":
        tk.next()
        ref = tk.next_str()
        base = d.sh_mixtures.get(ref)
        if base is None:
            raise MMFParseError(f"shared mixture {ref!r} not found")
        st.mixtures.append(MmfMixture(1.0, base.mean, base.var, base.gconst))
    else:
        st.mixtures.append(_parse_mixture_body(tk, d, 1.0))
    if len(st.mixtures) != n_mixes:
        # HTK permits defunct mixtures to be omitted; tolerate fewer
        if len(st.mixtures) > n_mixes:
            raise MMFParseError("more mixtures than NUMMIXES")
    return st


def _parse_hmm(tk: _Tokens, d: MmfDef, name: str) -> MmfHmm:
    tk.expect_kw("BEGINHMM")
    tk.expect_kw("NUMSTATES")
    n_states = tk.next_int()
    hmm = MmfHmm(name, n_states, states=[None] * (n_states - 2))
    while True:
        kw = tk.peek_kw()
        if kw == "STATE":
            tk.next()
            idx = tk.next_int()  # HTK state numbering: 2..N-1 are emitting
            if idx < 2 or idx > n_states - 1:
                raise MMFParseError(f"state index {idx} out of range in {name}")
            if tk.peek() == "~s":
                tk.next()
                hmm.states[idx - 2] = tk.next_str()
            else:
                hmm.states[idx - 2] = _parse_state(tk, d)
        elif kw == "TRANSP":
            hmm.transmat = _parse_transmat(tk, None)
        elif tk.peek() == "~t":
            tk.next()
            hmm.transmat = tk.next_str()
        elif kw == "ENDHMM":
            tk.next()
            break
        else:
            raise MMFParseError(f"unexpected token in HMM {name}: {tk.peek()!r}")
    for i, s in enumerate(hmm.states):
        if s is None:
            raise MMFParseError(f"HMM {name}: emitting state {i + 2} missing")
    if hmm.transmat is None:
        raise MMFParseError(f"HMM {name}: no transition matrix")
    return hmm


# ---------------------------------------------------------------------------
# Writer (text MMF): for round-trip tests and model export
# ---------------------------------------------------------------------------


def _fmt_vec(v: np.ndarray) -> str:
    return " ".join(f"{x:.6e}" for x in v)


def write_mmf(d: MmfDef, path) -> None:
    with open(path, "w") as fd:
        g = d.global_opts
        fd.write("~o")
        if g.hmm_set_id:
            fd.write(f' <HMMSETID> "{g.hmm_set_id}"')
        fd.write(f" <STREAMINFO> {g.n_streams} {' '.join(str(w) for w in (g.stream_widths or [g.vec_size]))}")
        fd.write(f" <VECSIZE> {g.vec_size} <{g.dur_kind}>")
        if g.parm_kind:
            fd.write(f"<{g.parm_kind}>")
        fd.write(f"<{g.cov_kind}>\n")
        for name, v in d.var_floors.items():
            fd.write(f'~v "{name}"\n<VARIANCE> {len(v)}\n {_fmt_vec(v)}\n')
        for name, t in d.sh_transmats.items():
            fd.write(f'~t "{name}"\n')
            _write_transmat(fd, t)
        for name, m in d.sh_mixtures.items():
            fd.write(f'~m "{name}"\n')
            _write_mixture_body(fd, m)
        for name, s in d.sh_states.items():
            fd.write(f'~s "{name}"\n')
            _write_state(fd, s)
        for h in d.hmms:
            fd.write(f'~h "{h.name}"\n<BEGINHMM>\n<NUMSTATES> {h.n_states}\n')
            for i, s in enumerate(h.states):
                fd.write(f"<STATE> {i + 2}\n")
                if isinstance(s, str):
                    fd.write(f'~s "{s}"\n')
                else:
                    _write_state(fd, s)
            if isinstance(h.transmat, str):
                fd.write(f'~t "{h.transmat}"\n')
            else:
                _write_transmat(fd, h.transmat)
            fd.write("<ENDHMM>\n")


def _write_transmat(fd, t: MmfTransMat) -> None:
    fd.write(f"<TRANSP> {t.n_states}\n")
    for row in t.probs:
        fd.write(f" {_fmt_vec(row)}\n")


def _write_mixture_body(fd, m: MmfMixture) -> None:
    fd.write(f"<MEAN> {len(m.mean)}\n {_fmt_vec(m.mean)}\n")
    fd.write(f"<VARIANCE> {len(m.var)}\n {_fmt_vec(m.var)}\n")


def untie_models(d: MmfDef, tied_list_path: str) -> MmfDef:
    """Tied-to-physical model expansion, the reference's
    `logical2physical.pl` + `untieModels.sh`.

    The tied list has one logical model a line, optionally followed by
    the physical model it is tied to. The output MMF has one ~h macro a
    logical name, whose body is its physical model's (shared states and
    transition matrices referenced, not copied), sorted
    byte-lexicographically (`untieModels.sh` sorts with LC_ALL=C, so the
    macro order matches the input symbols of a context-dependency FSM)."""
    index = {h.name: h for h in d.hmms}
    entries: list[tuple[str, str]] = []
    with open(tied_list_path) as fd:
        for line in fd:
            parts = line.split()
            if parts:
                entries.append((parts[0], parts[1] if len(parts) > 1 else parts[0]))
    out = MmfDef(global_opts=d.global_opts, var_floors=dict(d.var_floors),
                 sh_transmats=dict(d.sh_transmats), sh_states=dict(d.sh_states),
                 sh_mixtures=dict(d.sh_mixtures), mix_pools=dict(d.mix_pools))
    for logical, physical in sorted(entries, key=lambda e: e[0].encode()):
        phys = index.get(physical)
        if phys is None:
            raise KeyError(f"untie_models: physical model {physical!r} (for logical "
                           f"{logical!r}) not in the MMF")
        out.hmms.append(MmfHmm(logical, phys.n_states, phys.states, phys.transmat))
    return out


def _write_state(fd, s: MmfState) -> None:
    if s.tmix_pool is not None:
        fd.write(f"<NUMMIXES> {len(s.tmix_weights)}\n")
        fd.write(f"<TMIX> {s.tmix_pool} {_fmt_vec(np.asarray(s.tmix_weights))}\n")
        return
    if len(s.mixtures) > 1:
        fd.write(f"<NUMMIXES> {len(s.mixtures)}\n")
        for i, m in enumerate(s.mixtures):
            fd.write(f"<MIXTURE> {i + 1} {m.weight:.6e}\n")
            _write_mixture_body(fd, m)
    else:
        _write_mixture_body(fd, s.mixtures[0])
