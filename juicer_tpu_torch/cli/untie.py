"""untie CLI of the port (`jtpu-untie-torch`): tied (logical) -> physical
model expansion, the counterpart of `juicer_tpu/cli/untie.py`.

The `bin/untieModels.sh` + `bin/logical2physical.pl` equivalent: emits
an MMF with one ~h macro per tied-list logical name (body duplicated
from its physical model) in C-locale sorted order, plus the matching
sorted model list — the pair feeds cdgen/juicer with insyms-consistent
macro ordering. No HHEd dependency: the structured writer already emits
macros in list order.
"""

from __future__ import annotations

import argparse
import sys

from ..am.mmf import parse_mmf, untie_models, write_mmf


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="jtpu-untie-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-htkModelsFName", required=True, help="input ascii MMF")
    p.add_argument("-tiedListFName", required=True,
                   help="tied list: 'logical [physical]' per line")
    p.add_argument("-outModelsFName", required=True, help="output MMF")
    p.add_argument("-outListFName", default=None,
                   help="write the sorted physical model list here")
    args = p.parse_args(argv)

    d = parse_mmf(args.htkModelsFName)
    out = untie_models(d, args.tiedListFName)
    write_mmf(out, args.outModelsFName)
    if args.outListFName:
        with open(args.outListFName, "w") as fd:
            for h in out.hmms:
                fd.write(h.name + "\n")
    print(f"untie: {len(d.hmms)} physical -> {len(out.hmms)} logical models")
    return 0


if __name__ == "__main__":
    sys.exit(main())
