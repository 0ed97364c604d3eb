"""build-wfst CLI of the port: the final CLG network from G, L and C FSM
files.

The counterpart of `juicer_tpu/cli/build_wfst.py` (`jtpu-build-wfst`),
the reference's tcsh pipeline (`bin/build-wfst-openfst`) over the
built-in FST algorithms: it writes lg.fsm, final.fsm, final.insyms and
final.outsyms beside the grammar FSM (or into -outDir); -of optimises the
final transducer; -cl writes cl.fsm (C o closure(L)) and its symbol files
for on-the-fly composition against a separate G. It runs on the host.
"""

import argparse
import os
import sys

from ..compile.pipeline import build_clg
from ..fst import algos, read_fsm, read_symbols, write_fsm, write_symbols


def _load(prefix_fsm):
    prefix = prefix_fsm[:-4] if prefix_fsm.endswith(".fsm") else prefix_fsm
    f = read_fsm(prefix + ".fsm")
    # the native parser gives numpy arrays; the algorithms append to lists
    for k in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight"):
        setattr(f, k, getattr(f, k).tolist())
    f.isyms = read_symbols(prefix + ".insyms")
    f.osyms = read_symbols(prefix + ".outsyms")
    return f


def make_parser():
    p = argparse.ArgumentParser(prog="jtpu-build-wfst-torch", description=__doc__)
    p.add_argument("-of", action="store_true", help="optimise final transducer")
    p.add_argument("-cl", action="store_true",
                   help="build cl.fsm (C ∘ closure(L)) for on-the-fly composition "
                        "against a separate G")
    p.add_argument("gram_fsm")
    p.add_argument("lex_fsm")
    p.add_argument("cd_fsm")
    p.add_argument("-outDir", default=None)
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    G = _load(args.gram_fsm)
    L = _load(args.lex_fsm)
    C = _load(args.cd_fsm)
    out_dir = args.outDir or os.path.dirname(os.path.abspath(args.gram_fsm))
    if args.cl:
        cl = algos.compose(C, algos.closure(algos.arcsort(L)))
        write_fsm(cl, os.path.join(out_dir, "cl.fsm"))
        write_symbols(C.isyms, os.path.join(out_dir, "cl.insyms"))
        write_symbols(L.osyms, os.path.join(out_dir, "cl.outsyms"))
        print(
            f"build-wfst: CL {cl.num_states} states, {cl.num_arcs} arcs "
            f"-> {os.path.join(out_dir, 'cl.fsm')}"
        )
        return 0
    result = build_clg(G, L, C, optimize_final=args.of)
    write_fsm(result.lg, os.path.join(out_dir, "lg.fsm"))
    write_fsm(result.clg, os.path.join(out_dir, "final.fsm"))
    write_symbols(result.in_syms, os.path.join(out_dir, "final.insyms"))
    write_symbols(result.out_syms, os.path.join(out_dir, "final.outsyms"))
    print(
        f"build-wfst: CLG {result.clg.num_states} states, "
        f"{result.clg.num_arcs} arcs -> {os.path.join(out_dir, 'final.fsm')}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
