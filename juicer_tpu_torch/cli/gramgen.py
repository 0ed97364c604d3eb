"""gramgen CLI of the port: grammar (G) transducer generation.

The counterpart of `juicer_tpu/cli/gramgen.py` (`jtpu-gramgen`), with
the same flags and files (the reference's `gramgen.cpp`): a word loop,
sil-wordloop-sil, an ARPA n-gram LM (gzip input, `<unk>`, `#phi` backoff
labels, sil/sp self-loops, `-normalise`, the LM scale and the word
insertion penalty) or a BBN word-pair grammar, written as an AT&T FSM
and its input and output symbol files; `-genTestSeqs` prints ten random
word sequences the grammar accepts; `-writeBinaryFiles` caches the parsed
ARPA LM as `<lm>.npz` beside it (each package reads the other's). It
runs on the host: grammar generation has no device work.
"""

from __future__ import annotations

import argparse
import sys

from ..compile.gram import GramGen, GramType
from ..fst import algos, write_fsm, write_symbols
from ..lexicon import Vocabulary

_TYPES = {t.value: t for t in GramType}


def make_parser():
    p = argparse.ArgumentParser(prog="jtpu-gramgen-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-lexFName", required=True, help="pronunciation lexicon")
    p.add_argument("-sentStartWord", default=None)
    p.add_argument("-sentEndWord", default=None)
    p.add_argument("-silWord", default=None)
    p.add_argument("-gramType", required=True, choices=sorted(_TYPES))
    p.add_argument("-lmFName", default=None, help="ARPA LM or word-pair grammar file")
    p.add_argument("-lmScaleFactor", type=float, default=1.0)
    p.add_argument("-wordInsPen", type=float, default=0.0)
    p.add_argument("-unkWord", default=None)
    p.add_argument("-fsmFName", required=True)
    p.add_argument("-inSymsFName", required=True)
    p.add_argument("-outSymsFName", required=True)
    p.add_argument("-phiBackoff", action="store_true", help="#phi backoff labels")
    p.add_argument("-addSilenceArcs", action="store_true")
    p.add_argument("-normalise", action="store_true", help="renormalise the LM's backoffs")
    p.add_argument("-genTestSeqs", action="store_true")
    p.add_argument("-writeBinaryFiles", action="store_true",
                   help="cache the parsed ARPA LM as .npz next to it")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    vocab = Vocabulary(args.lexFName, "!", args.sentStartWord, args.sentEndWord, args.silWord)
    gen = GramGen(vocab, _TYPES[args.gramType], lm_scale=args.lmScaleFactor,
                  word_ins_pen=args.wordInsPen, lm_fname=args.lmFName, unk_word=args.unkWord,
                  write_binary=args.writeBinaryFiles)
    g = gen.build(add_sil=args.addSilenceArcs, phi_bo_trans=args.phiBackoff,
                  normalise=args.normalise)
    write_fsm(g, args.fsmFName)
    write_symbols(g.isyms, args.inSymsFName)
    write_symbols(g.osyms, args.outSymsFName)
    print(f"gramgen: {g.num_states} states, {g.num_arcs} arcs -> {args.fsmFName}")
    if args.genTestSeqs:
        for il, ol, cost in algos.generate_sequences(g, 10, seed=0):
            print(" ".join(g.osyms[o] for o in ol), f"({cost:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
