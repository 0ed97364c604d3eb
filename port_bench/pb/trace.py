"""The traced window: `torch.profiler` (CPU and CUDA activities) over the
whole window, held in memory, reduced to what the metric readers read.

The benchmark's own host spans are `torch.profiler.record_function`
ranges named "pb.wave", "pb.score" and "pb.decode", so that they share the
profiler's clock with the device's intervals. Every device activity that
is not such a range counts as device work: kernels, copies and sets.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field

from . import intervals

SPAN_PREFIX = "pb."


def span_factory(profiling: bool):
    """span(name): the host span of one call into the program; a profiler
    range when the window is traced, else nothing."""
    if not profiling:
        return lambda name: nullcontext()
    from torch.profiler import record_function

    return lambda name: record_function(SPAN_PREFIX + name)


@dataclass
class Trace:
    """Times in seconds on the profiler's clock."""

    device: list = field(default_factory=list)  # (name, start, end), by start
    spans: list = field(default_factory=list)  # (name without prefix, start, end)

    @property
    def waves(self):
        return [(s, e) for n, s, e in self.spans if n == "wave"]

    @property
    def window(self):
        w = self.waves
        return (w[0][0], w[-1][1]) if w else (0.0, 0.0)

    def device_intervals(self, contains: str = ""):
        return [(s, e) for n, s, e in self.device if contains in n]

    def busy_s(self) -> float:
        lo, hi = self.window
        return intervals.covered(self.device_intervals(), lo, hi)

    def device_time(self, contains: str) -> float:
        return sum(e - s for s, e in self.device_intervals(contains))

    def open_span(self, t: float) -> str:
        """The innermost benchmark span open at time t."""
        best = None
        for n, s, e in self.spans:
            if s <= t <= e and n != "wave" and (best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else "between waves"


def from_profile(prof) -> Trace:
    from torch.autograd import DeviceType

    tr = Trace()
    for e in prof.events():
        name = e.name
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if name.startswith(SPAN_PREFIX):
            if e.device_type == DeviceType.CPU:
                tr.spans.append((name[len(SPAN_PREFIX):], s, t))
        elif e.device_type == DeviceType.CUDA:
            tr.device.append((name, s, t))
    tr.device.sort(key=lambda x: x[1])
    tr.spans.sort(key=lambda x: x[1])
    return tr


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took the most time, by name, and the
    longest idle gaps, each named by the benchmark span open then."""
    by_name = {}
    for name, s, e in tr.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    lo, hi = tr.window
    gaps = sorted(intervals.gaps(tr.device_intervals(), lo, hi), key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[name[:160], secs] for name, secs in ops],
            "idle_gaps": [[tr.open_span((s + e) / 2), e - s] for s, e in gaps]}
