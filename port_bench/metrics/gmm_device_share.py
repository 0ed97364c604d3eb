"""gmm_device_share: the device time of the kernels whose name holds
`gmm_logsumexp` over the device time of every kernel (copies and sets
left out), both clipped to the traced window, in %: the GMM scoring's
share of the card's work. Nothing where the trace holds no kernel."""

from pb import intervals

COPIES = ("Memcpy", "Memset")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.window

    def busy(name_ok):
        spans = [(s, e) for n, s, e in tr.device if name_ok(n)]
        return sum(e - s for s, e in intervals.clip(spans, lo, hi))

    kernels = busy(lambda n: not n.startswith(COPIES))
    gmm = busy(lambda n: "gmm_logsumexp" in n)
    return 100.0 * gmm / kernels if kernels > 0 and gmm > 0 else None
