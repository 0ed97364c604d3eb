"""idle_unattributed_share: the share of the traced window's wall time
(first wave's start to last wave's end) in which no kernel, copy or set
ran on the card and no span of the program (`score`, `entry`, `copy`,
`traceback`; `pb.program_trace`) was open, in %: the idle time that the
program's spans leave unexplained. Nothing where the program records no
spans or the trace holds no device activity."""

from pb import intervals, program_trace


def read(run):
    pt = program_trace.of(run)
    tr = run.trace
    if pt is None or not tr.device:
        return None
    lo, hi = tr.window
    idle = intervals.gaps(tr.device_intervals(), lo, hi)
    spans = intervals.union(intervals.clip(pt.intervals(), lo, hi))
    unattributed = sum(e - s for s, e in idle) - program_trace.overlap(idle, spans)
    return 100.0 * unattributed / (hi - lo)
