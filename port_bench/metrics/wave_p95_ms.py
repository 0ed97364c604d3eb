"""wave_p95_ms: the 95th percentile over every wave of the window of the
time from handing the wave's padded host features to the program until
its words are on the host (host clock; numpy's linear interpolation)."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile([w.end - w.start for w in run.waves], 95))
