"""lexgen CLI of the port: lexicon (L) transducer generation.

The counterpart of `juicer_tpu/cli/lexgen.py` (`jtpu-lexgen`), with the
same flags, files and stdout line (the reference's `lexgen.cpp`). It runs
on the host: the toolchain has no device work.
"""

import argparse
import math
import sys

from ..compile.lex import LexGen
from ..fst import write_fsm, write_symbols
from ..lexicon import Lexicon

LOG_ZERO = -1e30


def make_parser():
    p = argparse.ArgumentParser(prog="jtpu-lexgen-torch", description=__doc__)
    p.add_argument("-monoListFName", required=True)
    p.add_argument("-silMonophone", default=None)
    p.add_argument("-pauseMonophone", default=None)
    p.add_argument("-lexFName", required=True)
    p.add_argument("-sentStartWord", default=None)
    p.add_argument("-sentEndWord", default=None)
    p.add_argument("-silWord", default=None)
    p.add_argument("-fsmFName", required=True)
    p.add_argument("-inSymsFName", required=True)
    p.add_argument("-outSymsFName", required=True)
    p.add_argument("-addPronunsWithEndSil", action="store_true")
    p.add_argument("-addPronunsWithEndPause", action="store_true")
    p.add_argument("-addPronunsWithStartSil", action="store_true")
    p.add_argument("-addPronunsWithStartPause", action="store_true")
    p.add_argument("-pauseTeeTransProb", type=float, default=0.0)
    p.add_argument("-outputAuxPhones", action="store_true")
    p.add_argument("-addPhiLoop", action="store_true")
    p.add_argument("-normalise", action="store_true", help="normalize pronun priors")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    lex = Lexicon.load(
        args.monoListFName,
        args.lexFName,
        sil_phone=args.silMonophone,
        pause_phone=args.pauseMonophone,
        sent_start_word=args.sentStartWord,
        sent_end_word=args.sentEndWord,
        sil_word=args.silWord,
    )
    if args.normalise:
        lex.normalise_pronuns()
    tee = math.log(args.pauseTeeTransProb) if args.pauseTeeTransProb > 0 else LOG_ZERO
    gen = LexGen(
        lex,
        add_pronun_with_end_sil=args.addPronunsWithEndSil,
        add_pronun_with_end_pause=args.addPronunsWithEndPause,
        add_pronun_with_start_sil=args.addPronunsWithStartSil,
        add_pronun_with_start_pause=args.addPronunsWithStartPause,
        pause_tee_trans_log_prob=tee,
    )
    l = gen.build(output_aux_phones=args.outputAuxPhones, add_phi_loop=args.addPhiLoop)
    write_fsm(l, args.fsmFName)
    write_symbols(l.isyms, args.inSymsFName)
    write_symbols(l.osyms, args.outSymsFName)
    if not args.addPhiLoop:
        # the reference unconditionally appends #sil/#sp at
        # phiWordLabel+1/+2 to the output symbols (`WFSTLexGen.cpp:566`,
        # the `#if 1` block); with no phi loop that's ids 0 and 1 — a
        # harmless quirk reproduced for byte-identical outputs (with a
        # phi loop the ids are real and live in the symbol table proper)
        with open(args.outSymsFName, "a") as fd:
            fd.write(f"{'#sil':<25} 0\n{'#sp':<25} 1\n")
    print(f"lexgen: {l.num_states} states, {l.num_arcs} arcs, {gen.n_aux} aux -> {args.fsmFName}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
