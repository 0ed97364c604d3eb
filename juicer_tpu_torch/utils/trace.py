"""The port's own spans and counters.

A span is one timed region of the host: its name, its id and its
parent's (the innermost span open on the same thread when it opened, 0
for none), its start and end on the host clock (`time.perf_counter_ns`,
the clock of `time.perf_counter`), and a dict of attributes and counters
that the code inside it fills. The hot path opens four:

  - `score`: one `ops.gmm.GmmScorer` call;
  - `entry`: one `parallel.mesh.BatchDecoder.decode_scores_batch` call,
    with `B`, `T` (padded frames), `K` and `S` of the first share's
    decoder and `route` ("fused" or "plain");
  - `copy`: one read-back of a decode to the host, with `dtoh_bytes`
    (the bytes copied), `records` (the records that landed), and, where
    the decode wrote its per-frame snapshots, `candidates` and
    `active_slot_frames` (their sums over every frame stepped, padded
    ones too). On the fused route it is `decoder.fused_scan.
    assemble_results`' walk of the best paths on the card and their copy,
    and adds `path_records` (the path rows walked and copied); elsewhere
    it is `decoder.core.host_batch`'s copy of everything the traceback
    reads;
  - `traceback`: the traceback loop of one batch, with `utterances`.

Spans are recorded only while a `torch.profiler` session is active (the
flag PyTorch keeps for fast Python checks), and at no other time: there
is no other switch. Off, `span` returns one shared context that does
nothing, and its `with` target is None, so the caller computes no
counter. They are kept in memory, the newest `MAX_SPANS`, and nothing is
written or printed; `spans()` reads them, `clear()` empties the buffer.

They are not profiler ranges, nor NVTX ranges, nor anything else the
profiler records: a range that encloses work on the card gets a twin on
the card's timeline in the profiler's trace, which a reader of that trace
would take for work of the card. A reader maps them onto the profiler's
clock itself.

`LaunchCounter` is the launch count of one kernel, kept by its wrapper.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

from torch.autograd import profiler as _profiler

MAX_SPANS = 65536

_records: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_OFF = nullcontext()


class LaunchCounter:
    """Launch count of one kernel: its wrapper adds one a launch, and
    nowhere else."""

    def __init__(self):
        self.launches = 0


@dataclass
class Span:
    name: str
    id: int
    parent: int  # 0: no span was open
    start_ns: int  # time.perf_counter_ns()
    end_ns: int = 0
    attrs: dict = field(default_factory=dict)


class _Recording:
    __slots__ = ("name", "sp")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> dict:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        sp = self.sp = Span(self.name, next(_ids), stack[-1].id if stack else 0,
                            time.perf_counter_ns())
        stack.append(sp)
        return sp.attrs

    def __exit__(self, *exc) -> bool:
        sp = self.sp
        sp.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        _records.append(sp)
        return False


def span(name: str):
    """`with span(name) as attrs:` times the block as one span; `attrs` is
    the span's dict of attributes and counters, or None when nothing is
    recorded."""
    return _Recording(name) if _profiler._is_profiler_enabled else _OFF


def spans() -> list[Span]:
    """The spans recorded, oldest first by their end."""
    return list(_records)


def clear() -> None:
    _records.clear()
