"""host_tail_ms: for each traced wave, the time from the end of its last
device interval (kernel, copy or set) to the return of the entry point
(the end of the benchmark's "decode" span), as a mean over the waves, in
ms: the host's copy and traceback that the card waits out."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    decodes = [(s, e) for n, s, e in tr.spans if n == "decode"]
    dev = tr.device_intervals()
    tails, j = [], 0
    for (ws, we), (_, de) in zip(tr.waves, decodes):
        last = None
        while j < len(dev) and dev[j][0] < we:
            if dev[j][0] >= ws:
                last = dev[j][1] if last is None else max(last, dev[j][1])
            j += 1
        if last is not None:
            tails.append(max(0.0, de - last))
    return 1e3 * sum(tails) / len(tails) if tails else None
