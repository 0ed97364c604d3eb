"""CLG composition pipeline.

A copy of `juicer_tpu/compile/pipeline.py`, the Python rebuild of the
reference's `bin/build-wfst-openfst:99-180` (log semiring throughout),
with no external FST toolkit:

  G:   arcsort, determinize
  L:   arcsort, closure
  C:   arcsort, connect, invert, determinize, encode-minimize-decode, invert
  LG:  compose(L', G'), epsnormalize, determinize, encode-minimize-decode,
       arcsort, then (default) map auxiliary input symbols to epsilon
       (`bin/aux2eps.pl`)
  CLG: compose(C', LG), push weights -> final.fsm (+ C insyms / G outsyms)
"""

from __future__ import annotations

from dataclasses import dataclass
from ..fst import EPSILON, Fst, SymbolTable, algos


def aux_to_eps(f: Fst, isyms: SymbolTable) -> Fst:
    """Replace auxiliary ('#...') input labels with epsilon
    (`bin/aux2eps.pl:1-80`)."""
    g = f.copy()
    g.arc_ilabel = [
        EPSILON if (il > 0 and il < len(isyms) and isyms.is_auxiliary(il)) else il
        for il in g.arc_ilabel
    ]
    return g


@dataclass
class CLGResult:
    clg: Fst
    lg: Fst
    in_syms: SymbolTable  # model (HMM) symbols, from C
    out_syms: SymbolTable  # word symbols, from G


def build_clg(
    g_fst: Fst,
    l_fst: Fst,
    c_fst: Fst,
    optimize_final: bool = False,
    remove_aux: bool = True,
    verbose: bool = False,
) -> CLGResult:
    import time as _time

    _t = [_time.time()]

    def _log(stage, f):
        if verbose:
            now = _time.time()
            print(f"[build_clg] {stage}: {f.num_states} states "
                  f"{f.num_arcs} arcs ({now - _t[0]:.1f}s)", flush=True)
            _t[0] = now

    # Prepare G: determinize (eps/backoff labels treated as regular symbols)
    g = algos.determinize(algos.arcsort(g_fst))
    _log("det(G)", g)
    # Prepare L: closure
    l = algos.closure(algos.arcsort(l_fst))
    # Prepare C: connect, invert, determinize, minimize (encoded), invert
    c = algos.arcsort(c_fst)
    c = algos.connect(c)
    c = algos.invert(c)
    c = algos.determinize(c)
    c = algos.minimize(c)
    c = algos.invert(c)
    _log("prep(L,C)", c)

    # LG
    lg = algos.compose(l, g)
    _log("L.G", lg)
    lg = algos.epsnormalize_input(lg)
    _log("epsnorm", lg)
    lg = algos.determinize(lg)
    _log("det(L.G)", lg)
    lg = algos.minimize(lg)
    _log("min", lg)
    lg = algos.arcsort(lg)
    if not optimize_final and remove_aux and l_fst.isyms is not None:
        lg = aux_to_eps(lg, l_fst.isyms)

    # CLG
    clg = algos.compose(c, lg)
    _log("C.LG", clg)
    if optimize_final:
        clg = algos.epsnormalize_input(clg)
        clg = algos.determinize(clg)
        clg = algos.minimize(clg)
    clg = algos.push_weights(clg)
    _log("push", clg)
    clg.isyms = c_fst.isyms
    clg.osyms = g_fst.osyms
    return CLGResult(clg=clg, lg=lg, in_syms=c_fst.isyms, out_syms=g_fst.osyms)
