"""tri_frame_step_roofline: `frame_step_roofline`
(metrics/frame_step_roofline.py) read in the triphone cell: the least time
the card could take for the window's waves (`pb.stepcount`, from the
fused `entry` spans and their `copy` counters) over the device time of the
kernels whose name holds `frame_step`, in %; there the kernel keeps its
search state in a workspace of device memory and reads its HMM tables in
place. Nothing where the program records no spans or counters, the trace
holds no such kernel, or the card has no peak in the table."""

from pb import spec


def read(run):
    return spec.reader(spec.BENCH, "frame_step_roofline")(run)
