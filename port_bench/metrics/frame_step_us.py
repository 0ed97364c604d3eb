"""frame_step_us: device time of the kernels whose name holds
`frame_step` over the traced window, per padded frame step (the sum over
the waves of T_pad), in microseconds. Nothing where the trace holds no
such kernel."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.device_time("frame_step")
    steps = sum(w.t_pad for w in run.waves)
    return 1e6 * busy / steps if busy > 0 and steps else None
