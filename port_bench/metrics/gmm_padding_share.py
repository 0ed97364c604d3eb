"""gmm_padding_share: of the columns the GMM scoring computes in the
traced window (the program's `score` spans: `columns` a frame, every GMM
padded to the largest mixture, times `frames`), the share that are
padding and no real Gaussian component (`components` a frame), in %.
Nothing where the program records no spans or its `score` spans carry no
such counters."""

from pb import program_trace


def read(run):
    pt = program_trace.of(run)
    if pt is None:
        return None
    cols = real = 0
    for sp in pt.spans:
        a = sp.attrs
        if sp.name == "score" and all(k in a for k in ("frames", "columns", "components")):
            cols += a["frames"] * a["columns"]
            real += a["frames"] * a["components"]
    return 100.0 * (cols - real) / cols if cols > 0 else None
