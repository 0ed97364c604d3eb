"""hmmgen CLI of the port: HMM-level (H) transducer generation.

The counterpart of `juicer_tpu/cli/hmmgen.py` (`jtpu-hmmgen`), with the
same flags (the reference's `hmmgen.cpp`), files and stdout line. It runs
on the host.
"""

import argparse
import sys

from ..am.mmf import parse_mmf
from ..compile.hmm2fst import HmmGen
from ..fst import write_fsm, write_symbols


def make_parser():
    p = argparse.ArgumentParser(prog="jtpu-hmmgen-torch", description=__doc__)
    p.add_argument("-htkModelsFName", required=True)
    p.add_argument("-fsmFName", required=True)
    p.add_argument("-inSymsFName", required=True)
    p.add_argument("-outSymsFName", required=True)
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    h = HmmGen(parse_mmf(args.htkModelsFName)).build()
    write_fsm(h, args.fsmFName)
    write_symbols(h.isyms, args.inSymsFName)
    write_symbols(h.osyms, args.outSymsFName)
    print(f"hmmgen: {h.num_states} states, {h.num_arcs} arcs -> {args.fsmFName}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
