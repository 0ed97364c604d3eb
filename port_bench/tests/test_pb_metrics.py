"""Each metric reader on a small hand-made run and trace."""

import numpy as np
import pytest

from pb import intervals, opcount, spec
from pb.cell import Run, Wave
from pb.trace import Trace, breakdown

from conftest import BENCH

PEAKS = opcount.PEAKS["NVIDIA H100 80GB HBM3"]


def read(name, run):
    return spec.reader(BENCH, name)(run)


def hand_run():
    """Two waves on the host clock and their trace: wave 1 over [0, 10]
    (score [0, 2], decode [2, 9]) with a GMM kernel [1, 2], a copy [1.5,
    3] overlapping it, the frame-step kernel [3, 6] and a copy [6.5, 7];
    wave 2 over [10, 20] (score [10, 11], decode [11, 18]) with a GMM
    kernel [10, 11] and the frame-step kernel [12, 16]."""
    waves = [Wave(0.0, 10.0, t_pad=100, frames=150, batch=2),
             Wave(10.0, 20.0, t_pad=50, frames=90, batch=2)]
    tr = Trace(
        device=[("gmm_logsumexp_kernel", 1.0, 2.0), ("Memcpy HtoD", 1.5, 3.0),
                ("frame_step_kernel<5>", 3.0, 6.0), ("Memcpy DtoH", 6.5, 7.0),
                ("gmm_logsumexp_kernel", 10.0, 11.0), ("frame_step_kernel<5>", 12.0, 16.0)],
        spans=[("wave", 0.0, 10.0), ("score", 0.0, 2.0), ("decode", 2.0, 9.0),
               ("wave", 10.0, 20.0), ("score", 10.0, 11.0), ("decode", 11.0, 18.0)])
    model = {"G": 141, "D": 39, "components": 1128}
    return Run(waves, 20.0, 33.0, {"artifact_build_s": 4.5}, model, PEAKS, tr)


def test_intervals_union_gaps_and_cover():
    iv = [(1.0, 2.0), (1.5, 3.0), (3.0, 6.0), (6.5, 7.0)]
    assert intervals.union(iv) == [(1.0, 6.0), (6.5, 7.0)]
    assert intervals.covered(iv, 0.0, 10.0) == pytest.approx(5.5)
    assert intervals.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (6.0, 6.5), (7.0, 10.0)]
    assert intervals.covered(iv, 2.5, 6.75) == pytest.approx(3.75)


def test_idle_share_counts_overlap_once_and_copies_as_busy():
    # busy: [1, 6] + [6.5, 7] + [10, 11] + [12, 16] = 5 + 0.5 + 1 + 4 = 10.5 of 20
    assert read("idle_share", hand_run()) == pytest.approx(100 * (1 - 10.5 / 20))


def test_host_tail_is_decode_end_after_the_last_device_interval():
    # wave 1: 9 - 7 = 2; wave 2: 18 - 16 = 2... with a later copy in wave 2
    run = hand_run()
    run.trace.device.append(("Memcpy DtoH", 16.0, 17.0))
    run.trace.device.sort(key=lambda x: x[1])
    assert read("host_tail_ms", run) == pytest.approx(1e3 * (2.0 + 1.0) / 2)


def test_gmm_roofline_is_the_bound_over_the_kernels_time():
    run = hand_run()
    bound = sum(max(4.0 * n * 1128 * 39 / PEAKS["f32_flops"],
                    4.0 * (n * 39 + 2 * 39 * 1128 + 1128 + n * 141) / PEAKS["bytes_per_s"])
                for n in (200, 100))
    assert read("gmm_roofline", run) == pytest.approx(100 * bound / 2.0)


def test_frame_step_per_padded_frame_step():
    assert read("frame_step_us", hand_run()) == pytest.approx(1e6 * 7.0 / 150)


def test_end_to_end_readers():
    run = hand_run()
    assert read("frames_per_s", run) == pytest.approx(240 / 20.0)
    assert read("setup_s", run) == 33.0
    assert read("artifact_build_s", run) == 4.5
    flops = 4.0 * 240 * 1128 * 39
    assert read("decode_mfu", run) == pytest.approx(100 * flops / (20.0 * PEAKS["f32_flops"]))


def test_p95_is_over_every_wave():
    lat = np.arange(1, 201) / 1e3  # 200 waves of 1..200 ms
    waves = [Wave(0.0, float(x), 10, 10, 1) for x in lat]
    run = Run(waves, 1.0, 1.0, {}, {}, None)
    assert read("wave_p95_ms", run) == pytest.approx(np.percentile(np.arange(1, 201), 95))


def test_readers_find_nothing_without_a_trace_or_a_peak():
    run = hand_run()
    run.trace, run.peaks = None, None
    for name in ("gmm_roofline", "frame_step_us", "host_tail_ms", "idle_share", "decode_mfu"):
        assert read(name, run) is None


def test_breakdown_names_ops_and_labels_gaps():
    b = breakdown(hand_run().trace)
    assert b["device_ops"][0] == ["frame_step_kernel<5>", 7.0]
    # the longest gap, [16, 20], opens in wave 2's decode span
    assert b["idle_gaps"][0] == ["decode", pytest.approx(4.0)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
