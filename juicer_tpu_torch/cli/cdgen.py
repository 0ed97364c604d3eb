"""cdgen CLI of the port: context-dependency (C) transducer generation.

The counterpart of `juicer_tpu/cli/cdgen.py` (`jtpu-cdgen`), with the
same flags (the reference's `cdgen.cpp`, its `-cdType` spellings
included), files and stdout lines. It runs on the host.
"""

import argparse
import sys

import numpy as np

from ..am import AcousticModelSet
from ..compile.cd import CDGen, CDPhoneLookup, CDType
from ..fst import read_symbols, write_fsm, write_symbols, algos
from ..lexicon import PhoneSet

_TYPES = {
    # reference spellings (`cdgen.cpp:100-112`)
    "mono": CDType.MONOPHONE,
    "monoann": CDType.MONOPHONE_ANN,
    "xwrdtri": CDType.XWORD_TRIPHONE,
    # jtpu aliases
    "monophone": CDType.MONOPHONE,
    "monophoneann": CDType.MONOPHONE_ANN,
    "xwrdtrindi": CDType.XWORD_TRIPHONE_NDI,
}


def make_parser():
    p = argparse.ArgumentParser(prog="jtpu-cdgen-torch", description=__doc__)
    p.add_argument("-cdType", required=True, choices=sorted(_TYPES))
    p.add_argument("-cdSepChars", default="-+")
    p.add_argument("-htkModelsFName", default=None)
    p.add_argument("-priorsFName", default=None)
    p.add_argument("-statesPerModel", type=int, default=0)
    p.add_argument("-monoListFName", required=True)
    p.add_argument("-silMonophone", default=None)
    p.add_argument("-pauseMonophone", default=None)
    p.add_argument("-tiedListFName", default=None)
    p.add_argument("-lexInSymsFName", default=None, help="L insyms (for aux symbols)")
    p.add_argument("-fsmFName", required=True)
    p.add_argument("-inSymsFName", required=True)
    p.add_argument("-outSymsFName", required=True)
    p.add_argument("-genTestSeqs", action="store_true")
    p.add_argument("-ndixt", action="store_true",
                   help="non-deterministic-inverse x-word triphone C "
                        "(reference spelling for cdType xwrdtrindi; ignored "
                        "unless cdType is xwrdtri)")
    return p


def _write_mono_ref_layout(c, path, n_aux):
    """Monophone C in the reference's exact emission order: phone
    self-loops, the final-state line MID-FILE, then the aux self-loops
    TWICE (`writeFSMMonophone` emits them and `writeFSM` calls
    `writeFSMAuxTrans` right after — WFSTCDGen.cpp:351-372)."""
    n_phone_arcs = c.num_arcs - n_aux  # build() emits aux loops once, last
    with open(path, "w") as fd:
        for i in range(n_phone_arcs):
            fd.write(f"0 0 {c.arc_ilabel[i]} {c.arc_olabel[i]}\n")
        fd.write("0\n")
        for _ in range(2):
            for i in range(n_phone_arcs, c.num_arcs):
                fd.write(f"0 0 {c.arc_ilabel[i]} {c.arc_olabel[i]}\n")


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.ndixt and args.cdType == "xwrdtri":
        args.cdType = "xwrdtrindi"
    phone_set = PhoneSet(args.monoListFName, args.silMonophone, args.pauseMonophone)

    if args.htkModelsFName:
        models = AcousticModelSet.from_mmf(args.htkModelsFName)
        model_names = models.hmm_names
    elif args.priorsFName:
        priors = np.loadtxt(args.priorsFName).reshape(-1)
        models = AcousticModelSet.hybrid(list(phone_set.phones), priors, args.statesPerModel)
        model_names = models.hmm_names
    else:
        model_names = list(phone_set.phones)

    lookup = CDPhoneLookup(phone_set, args.cdSepChars)
    if args.tiedListFName:
        lookup.add_tied_list(args.tiedListFName)
    else:
        lookup.add_phones(model_names)
    lookup.bind_models(model_names)
    lookup.verify_all_models()

    n_aux = 0
    aux_names = None
    if args.lexInSymsFName:
        lex_syms = read_symbols(args.lexInSymsFName)
        aux_names = [lex_syms[i] for i in range(len(lex_syms)) if lex_syms.is_auxiliary(i)]
        n_aux = len(aux_names)

    gen = CDGen(_TYPES[args.cdType], lookup, model_names, n_aux, aux_names)
    c = gen.build()
    if _TYPES[args.cdType] == CDType.MONOPHONE:
        _write_mono_ref_layout(c, args.fsmFName, n_aux)
    else:
        write_fsm(c, args.fsmFName)
    write_symbols(c.isyms, args.inSymsFName)
    write_symbols(c.osyms, args.outSymsFName)
    print(f"cdgen: {c.num_states} states, {c.num_arcs} arcs -> {args.fsmFName}")
    if args.genTestSeqs:
        for il, ol, cost in algos.generate_sequences(c, 10, seed=0, max_len=30):
            print(" ".join(c.isyms[i] for i in il), "->", " ".join(c.osyms[o] for o in ol))
    return 0


if __name__ == "__main__":
    sys.exit(main())
