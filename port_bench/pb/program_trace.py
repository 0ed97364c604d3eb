"""The program's own spans of a traced window, on the profiler's clock.

The port records its spans (`juicer_tpu_torch.utils.trace`: `score`,
`entry`, `copy`, `traceback`, with their attributes and counters) while a
`torch.profiler` session is active, on the host clock of
`time.perf_counter`, the clock of the benchmark's `Wave` times, and never
as profiler ranges. Here they are mapped onto the profiler's clock: the
offset is the median, over the window's waves, of the distance from each
wave's start on the host clock (`run.waves[i].start`) to the start of its
"pb.wave" range (`run.trace.waves[i]`); the spread of those distances
(third quartile less first, `statistics.quantiles`) says how well one
offset fits the waves. A wave whose range opens late (the window's first,
the first range of its name in the process, by 0.17-0.25 ms on the card's
host) moves the median by nothing and the spread by little.

Spans outside the window's waves (the profiled wave before the window)
are left out; each kept span carries the index of the wave it starts in.
A program that records no spans of its own gives None, as a run without
a trace does. Besides `pb.program`, the one module of the benchmark that
reads the program.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from dataclasses import dataclass
from typing import NamedTuple

NAMES = ("score", "entry", "copy", "traceback")
_CACHE = "_program_trace"


class PSpan(NamedTuple):
    name: str
    start: float  # seconds, profiler's clock
    end: float
    attrs: dict
    wave: int  # index into run.waves and run.trace.waves
    id: int
    parent: int


@dataclass
class ProgramTrace:
    spans: list  # PSpan, by start
    offset: float  # profiler's clock less the host clock, seconds
    spread: float  # quartile distance of the per-wave offsets, seconds
    offsets: list  # each wave's, in order

    def summary(self) -> str:
        """The first wave's offset, the largest and smallest, and the drift
        (the last tenth's median less the first tenth's), in us from the
        median."""
        us = [1e6 * (o - self.offset) for o in self.offsets]
        tenth = max(1, len(us) // 10)
        drift = statistics.median(us[-tenth:]) - statistics.median(us[:tenth])
        return (f"first wave {us[0]:.3f} us, largest {max(us):.3f} us (wave "
                f"{us.index(max(us))}), smallest {min(us):.3f} us, drift {drift:.3f} us")

    def by_wave(self, name: str) -> dict:
        """{wave index: [PSpan named `name`]}."""
        out = {}
        for sp in self.spans:
            if sp.name == name:
                out.setdefault(sp.wave, []).append(sp)
        return out

    def intervals(self):
        return [(sp.start, sp.end) for sp in self.spans]


def mapped(run, records):
    """The ProgramTrace of `records` (the port's `Span`s: name, id, parent,
    start_ns, end_ns, attrs) in the traced window of `run`, or None."""
    tr = run.trace
    if tr is None or not run.waves or len(tr.waves) != len(run.waves):
        return None
    offsets = [t[0] - w.start for t, w in zip(tr.waves, run.waves)]
    offset = statistics.median(offsets)
    q = statistics.quantiles(offsets, n=4) if len(offsets) > 1 else [offset] * 3
    starts = [w.start for w in run.waves]
    lo, hi = run.waves[0].start, run.waves[-1].end
    spans = []
    for r in records:
        s, e = r.start_ns / 1e9, r.end_ns / 1e9
        if r.name in NAMES and lo <= s and e <= hi:
            spans.append(PSpan(r.name, s + offset, e + offset, r.attrs,
                               bisect.bisect_right(starts, s) - 1, r.id, r.parent))
    if not spans:
        return None
    spans.sort(key=lambda sp: sp.start)
    return ProgramTrace(spans, offset, q[2] - q[0], offsets)


def of(run, records=None):
    """The ProgramTrace of `run`, worked out once a run: from `records`
    where given, else from the spans the port holds (none where the
    program has no `utils.trace`)."""
    if _CACHE in run.__dict__:
        return run.__dict__[_CACHE]
    pt = None
    if run.trace is not None:
        if records is None:
            try:
                from juicer_tpu_torch.utils import trace as port_trace
            except ImportError:
                port_trace = None
            records = port_trace.spans() if port_trace is not None else []
        pt = mapped(run, records)
    if pt is not None:
        print(f"program spans: {len(pt.spans)} in the window's {len(pt.offsets)} waves; clock "
              f"offset {pt.offset:.6f} s, its spread (quartiles) over the waves {1e6 * pt.spread:.3f} "
              f"us; "
              f"{pt.summary()}", file=sys.stderr, flush=True)
    run.__dict__[_CACHE] = pt
    return pt


def overlap(a, b) -> float:
    """Time that two sorted lists of disjoint (start, end) share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out
