"""AT&T-format text FSM output, as `juicer_tpu/fst/io.py` writes it.

Per the reference writers: arc lines "from to in out [weight]", final
lines "state [weight]"; the initial state is the source state of the
first arc line, so the start state's arcs go first.
"""

from __future__ import annotations

from typing import TextIO, Union

from .fst import Fst


def write_fsm(f: Fst, path_or_file: Union[str, TextIO]) -> None:
    close = isinstance(path_or_file, str)
    fd = open(path_or_file, "w") if close else path_or_file
    try:
        n = f.num_arcs
        # the first line's source must be the initial state: where
        # insertion order does not start there, the start state's arcs are
        # stable-sorted to the front
        order = list(range(n))
        if f.start >= 0 and n > 0 and f.arc_src[0] != f.start:
            order.sort(key=lambda i: (f.arc_src[i] != f.start,))
        for i in order:
            w = f.arc_weight[i]
            if w == 0.0:
                fd.write(f"{f.arc_src[i]} {f.arc_dst[i]} {f.arc_ilabel[i]} {f.arc_olabel[i]}\n")
            else:
                fd.write(f"{f.arc_src[i]} {f.arc_dst[i]} {f.arc_ilabel[i]} "
                         f"{f.arc_olabel[i]} {w:.3f}\n")
        for s in sorted(f.finals):
            w = f.finals[s]
            if w == 0.0:
                fd.write(f"{s}\n")
            else:
                fd.write(f"{s} {w:f}\n")
    finally:
        if close:
            fd.close()
