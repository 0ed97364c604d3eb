"""gmm_roofline: the GMM kernel's share of its roofline over the traced
window: the least time the card could take for the window's scorer calls
(one a wave, of batch x T_pad frames; `pb.opcount`) over the device time
of the kernels whose name holds `gmm_logsumexp`, in %. Nothing where the
trace holds no such kernel or the card has no peak in the table."""

from pb.opcount import gmm_bound_s


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    busy = run.trace.device_time("gmm_logsumexp")
    if busy <= 0:
        return None
    m = run.model
    bound = sum(gmm_bound_s(w.batch * w.t_pad, m["components"], m["G"], m["D"], run.peaks)
                for w in run.waves)
    return 100.0 * bound / busy
