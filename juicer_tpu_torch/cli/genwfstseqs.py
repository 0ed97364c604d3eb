"""genwfstseqs CLI of the port: random label sequences an FSM accepts.

The counterpart of `juicer_tpu/cli/genwfstseqs.py` (`jtpu-genwfstseqs`),
the reference's `genwfstseqs.cpp` over `WFSTNetwork::generateSequences`:
the same flags and output for the same -seed. It runs on the host.
"""

import argparse
import sys

from ..fst import algos, read_fsm, read_symbols


def make_parser():
    p = argparse.ArgumentParser(prog="jtpu-genwfstseqs-torch", description=__doc__)
    p.add_argument("-fsmFName", required=True)
    p.add_argument("-inSymsFName", default=None)
    p.add_argument("-outSymsFName", default=None)
    p.add_argument("-nSeqs", type=int, default=10)
    p.add_argument("-seed", type=int, default=0)
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    f = read_fsm(args.fsmFName)
    isyms = read_symbols(args.inSymsFName) if args.inSymsFName else None
    osyms = read_symbols(args.outSymsFName) if args.outSymsFName else None
    for il, ol, cost in algos.generate_sequences(f, args.nSeqs, seed=args.seed):
        ins = " ".join(isyms[i] if isyms else str(i) for i in il)
        outs = " ".join(osyms[o] if osyms else str(o) for o in ol)
        print(f"{ins} : {outs} ({cost:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
