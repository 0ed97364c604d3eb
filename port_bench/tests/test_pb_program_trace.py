"""The program's own spans on the profiler's clock (`pb.program_trace`),
the frame step's work (`pb.stepcount`), and the five readers of them on a
hand-made run; then a traced run of the tiny cell on the CPU."""

import dataclasses
import json
import os
import random
import statistics
import sys
import time
from types import SimpleNamespace

import pytest

from pb import cell as cell_run, opcount, program_trace, spec
from pb.cell import Run, Wave
from pb.stepcount import frame_step_work
from pb.trace import Trace

from conftest import BENCH, REPO

PEAKS = opcount.PEAKS["NVIDIA H100 80GB HBM3"]
HOST0 = 5000.0  # the host clock at the profiler's zero
JITTER = (1e-6, 4e-6)  # each wave's "pb.wave" range opens this late
NEW = ("copy_ms", "copy_mb", "traceback_ms", "idle_unattributed_share", "frame_step_roofline")


def read(name, run):
    return spec.reader(BENCH, name)(run)


def rec(name, id_, parent, start, end, **attrs):
    """A span of the port's on the host clock, from profiler-clock times."""
    return SimpleNamespace(name=name, id=id_, parent=parent, start_ns=round((HOST0 + start) * 1e9),
                           end_ns=round((HOST0 + end) * 1e9), attrs=attrs)


def hand_run():
    """`test_pb_metrics.hand_run`'s two waves, on the host clock HOST0
    later than the profiler's, each "pb.wave" range a few us late: wave 1
    over [0, 10] with a frame-step kernel [3, 6] and a copy [6.5, 7] on
    the card; wave 2 over [10, 20] with the kernel [12, 16]. The port's
    spans: wave 1 score [0, 2], entry [2, 9] holding copy [4, 7] and
    traceback [7, 8.5]; wave 2 score [10, 11], entry [11, 18] holding
    copy [13, 16.5] and traceback [16.5, 17.5]."""
    waves = [Wave(HOST0 + 0.0, HOST0 + 10.0, t_pad=100, frames=150, batch=2),
             Wave(HOST0 + 10.0, HOST0 + 20.0, t_pad=50, frames=90, batch=2)]
    tr = Trace(
        device=[("gmm_logsumexp_kernel", 1.0, 2.0), ("Memcpy HtoD", 1.5, 3.0),
                ("frame_step_kernel<5>", 3.0, 6.0), ("Memcpy DtoH", 6.5, 7.0),
                ("gmm_logsumexp_kernel", 10.0, 11.0), ("frame_step_kernel<5>", 12.0, 16.0)],
        spans=[("wave", 0.0 + JITTER[0], 10.0), ("score", 0.0, 2.0), ("decode", 2.0, 9.0),
               ("wave", 10.0 + JITTER[1], 20.0), ("score", 10.0, 11.0), ("decode", 11.0, 18.0)])
    model = {"G": 141, "D": 39, "components": 1128}
    records = [
        rec("entry", 1, 0, -9.0, -8.0, B=2, T=100, K=64, S=5, route="fused"),  # before the window
        rec("score", 2, 0, 0.0, 2.0),
        rec("copy", 4, 3, 4.0, 7.0, dtoh_bytes=3_000_000, records=50, candidates=1000,
            active_slot_frames=800),
        rec("traceback", 5, 3, 7.0, 8.5, utterances=2),
        rec("entry", 3, 0, 2.0, 9.0, B=2, T=100, K=64, S=5, route="fused"),
        rec("score", 6, 0, 10.0, 11.0),
        rec("copy", 8, 7, 13.0, 16.5, dtoh_bytes=5_000_000, records=30, candidates=600,
            active_slot_frames=500),
        rec("traceback", 9, 7, 16.5, 17.5, utterances=2),
        rec("entry", 7, 0, 11.0, 18.0, B=2, T=50, K=64, S=5, route="fused"),
        rec("other", 10, 0, 18.0, 19.0),
    ]
    return Run(waves, 20.0, 33.0, {}, model, PEAKS, tr), records


def traced_hand_run():
    run, records = hand_run()
    program_trace.of(run, records)
    return run


def test_clock_offset_is_the_median_and_its_spread_the_quartiles():
    rng = random.Random(7)
    starts = [100.0 + 0.031 * i for i in range(41)]
    jitter = [rng.uniform(0.0, 20e-6) for _ in starts]
    jitter[0] = 250e-6  # the first range of its name opens late
    waves = [Wave(s, s + 0.03, 10, 10, 1) for s in starts]
    tr = Trace(spans=[("wave", s - 1234.5 + j, s - 1234.5 + 0.03) for s, j in zip(starts, jitter)])
    run = Run(waves, 1.3, 1.0, {}, {}, None, tr)
    pt = program_trace.mapped(run, [rec("copy", 1, 0, 100.0 - HOST0, 100.01 - HOST0)])
    assert pt.offset == pytest.approx(-1234.5 + sorted(jitter)[20], abs=1e-9)
    q = statistics.quantiles(jitter, n=4)
    assert pt.spread == pytest.approx(q[2] - q[0], abs=1e-9) and pt.spread < 20e-6
    (sp,) = pt.spans
    assert sp.wave == 0 and sp.start == pytest.approx(100.0 + pt.offset, abs=1e-9)


def test_spans_outside_the_window_or_unnamed_are_left_out():
    run = traced_hand_run()
    pt = program_trace.of(run)
    assert [sp.name for sp in pt.spans] == ["score", "entry", "copy", "traceback",
                                            "score", "entry", "copy", "traceback"]
    assert [sp.wave for sp in pt.spans] == [0] * 4 + [1] * 4
    assert pt.offset == pytest.approx(-HOST0 + sum(JITTER) / 2, abs=1e-9)
    assert pt.spread == pytest.approx(1.5 * (JITTER[1] - JITTER[0]), abs=1e-9)
    assert program_trace.of(run) is pt  # worked out once a run


def test_copy_is_timed_after_the_last_frame_step():
    # wave 1: 7 - 6 = 1 s; wave 2: 16.5 - 16 = 0.5 s
    assert read("copy_ms", traced_hand_run()) == pytest.approx(1e3 * 0.75, abs=1e-2)


def test_copy_bytes_and_traceback_per_wave():
    run = traced_hand_run()
    assert read("copy_mb", run) == pytest.approx(4.0)
    assert read("traceback_ms", run) == pytest.approx(1e3 * (1.5 + 1.0) / 2, abs=1e-2)


def test_idle_unattributed_is_idle_outside_every_span():
    # idle [0,1] [6,6.5] [7,10] [11,12] [16,20] = 9.5 s; spans cover [0,9] and
    # [10,18], so [9,10] and [18,20] are left: 3 s of 20
    assert read("idle_unattributed_share", traced_hand_run()) == pytest.approx(15.0, abs=1e-3)


def test_frame_step_roofline_is_the_bound_over_the_kernels_time():
    def bound(T, cand, active, n_rec):
        carry = 2 * (64 * (8 + 5 * 16) + 17)
        nbytes = (4.0 * T * 2 * 141 + 2 * carry + 24.0 * cand + 32.0 * active + 32.0 * n_rec
                  + 4.0 * T * 2 * 9)
        ops = active * (2 * 25 + 60) + 20.0 * cand
        return max(ops / PEAKS["f32_flops"], nbytes / PEAKS["bytes_per_s"])

    assert frame_step_work(2, 100, 64, 5, 141, 1000, 800, 50)[0] == 800 * 110 + 20000
    want = 100 * (bound(100, 1000, 800, 50) + bound(50, 600, 500, 30)) / 7.0
    assert read("frame_step_roofline", traced_hand_run()) == pytest.approx(want)


def test_nothing_read_without_the_programs_spans():
    run, _ = hand_run()
    program_trace.of(run, [])
    untraced, records = hand_run()
    untraced.trace = None
    program_trace.of(untraced, records)
    for r in (run, untraced):
        for name in NEW:
            assert read(name, r) is None, name


def test_nothing_read_from_a_program_without_spans_of_its_own(monkeypatch):
    # an older checkout of the program: no module `utils.trace`
    monkeypatch.setitem(sys.modules, "juicer_tpu_torch.utils.trace", None)
    run, _ = hand_run()
    assert program_trace.of(run) is None
    assert all(read(name, run) is None for name in NEW)


def test_a_traced_cpu_run_reads_the_programs_copy_and_traceback(tiny_root):
    """The tiny cell traced on the CPU: the program's spans are there, the
    card's are not, so only the readers that need no kernel read."""
    cell = spec.load_cell("wsj2k.tiny", True, repo=tiny_root,
                          bench=os.path.join(tiny_root, "port_bench"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fd:
        per_layer = json.load(fd)["per_layer"]
    # the new metrics, which list the 20k cell only
    cell = dataclasses.replace(cell, metrics=[m for m in per_layer if m["name"] in NEW])
    out = cell_run.run(cell, 2**31 + 11, 0.5, True, "cpu", time.perf_counter())
    got = out["metrics"]
    assert got["copy_mb"]["value"] > 0 and got["traceback_ms"]["value"] > 0
    for name in ("copy_ms", "idle_unattributed_share", "frame_step_roofline"):
        assert name not in got
