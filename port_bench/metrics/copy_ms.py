"""copy_ms: for each traced wave, the time the program's `copy` spans
(on the fused route `decoder.fused_scan.assemble_results`: the best paths'
walk on the card and their pinned copy; on the other routes
`decoder.core.host_batch`; mapped onto the profiler's clock by
`pb.program_trace`) stay open after the wave's last `frame_step` kernel
ends, as a mean over the waves, in ms: the copy's own cost, without the
wait for the kernel that its first read includes. Nothing where the
program records no spans or the trace holds no such kernel."""

from pb import program_trace


def read(run):
    pt = program_trace.of(run)
    if pt is None:
        return None
    waves = run.trace.waves
    kernels = run.trace.device_intervals("frame_step")
    tails = []
    for i, copies in sorted(pt.by_wave("copy").items()):
        ws, we = waves[i]
        ends = [e for s, e in kernels if ws <= s < we]
        if ends:
            last = max(ends)
            tails.append(sum(max(0.0, sp.end - max(sp.start, last)) for sp in copies))
    return 1e3 * sum(tails) / len(tails) if tails else None
