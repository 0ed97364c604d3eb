"""tri_frame_step_us: `frame_step_us` (metrics/frame_step_us.py) read in
the triphone cell: device time of the kernels whose name holds
`frame_step` over the traced window, per padded frame step, in
microseconds; there the kernel reads its HMM tables in place, unstaged.
Nothing where the trace holds no such kernel."""

from pb import spec


def read(run):
    return spec.reader(spec.BENCH, "frame_step_us")(run)
