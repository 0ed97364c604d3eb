"""traceback_ms: the time of the program's `traceback` spans (the host
traceback loop of each share), summed per traced wave that entered the
program (an `entry` span), as a mean over those waves, in ms. Nothing
where the program records no spans."""

from pb import program_trace


def read(run):
    pt = program_trace.of(run)
    if pt is None:
        return None
    entered = pt.by_wave("entry")
    if not entered:
        return None
    tracebacks = pt.by_wave("traceback")
    total = sum(sp.end - sp.start for i in entered for sp in tracebacks.get(i, []))
    return 1e3 * total / len(entered)
