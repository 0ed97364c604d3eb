"""idle_share: the share of the traced window's wall time (first wave's
start to last wave's end) in which no kernel, copy or set ran on the
card: 1 - the union of the device intervals over the window, in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    lo, hi = tr.window
    return 100.0 * (1.0 - tr.busy_s() / (hi - lo))
