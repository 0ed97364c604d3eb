"""tri_gmm_roofline: `gmm_roofline` (metrics/gmm_roofline.py) read in the
triphone cell: the least time the card could take for the window's scorer
calls, counted from the real Gaussian components (`run.model`), over the
device time of the kernels whose name holds `gmm_logsumexp`, in %. Nothing
where the trace holds no such kernel or the card has no peak in the
table."""

from pb import spec


def read(run):
    return spec.reader(spec.BENCH, "gmm_roofline")(run)
