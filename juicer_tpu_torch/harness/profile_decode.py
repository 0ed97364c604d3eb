"""Where a decode wave's time goes on the card.

    python -m juicer_tpu_torch.harness.profile_decode [--frames N] [--batch B]
        [--task 2k|20k|20k-tri1] [--distinct] [--otf [--budgets K E]]
        [--fused [--clocks] | --entry] [--trace]

Scores the 2k-word WSJ-order task's bench batch (8 sampled utterances
tiled to 16, `WSJ_POINT`, diagnostics off) with the GMM kernel, runs the
first frames once to warm up, then profiles N frames of the frame loop
with `torch.profiler` (CPU and CUDA activities). Prints the host time per
frame, the device kernel time per frame (sum of kernel durations), the
device idle share (1 - the time any kernel, copy or set ran, each
overlap counted once, over the wall time), kernel launches per frame,
and the ten costliest kernels; `--trace` writes the Chrome trace
to `chiprun_out/profile_decode.json` (large: tens of MB per 100 frames).
`--fused` profiles the fused route instead: one launch of the frame-step
kernel (`decoder/fused_scan.py`) over the same N frames, diagnostics as
the kernel writes them; with `--clocks` the kernel is the profiling
build (`-DJTPU_FS_CLOCKS`, a library beside the one every other caller
loads), in which thread 0 of each block counts the cycles of each phase
of the frame (top, A propagation, B exit scan, C candidates, D winners
scan, E slots, F insertion, G records), printed per frame and as the
share of each; its times are not the kernel's own. `--entry`
profiles one whole `BatchDecoder.decode_scores_batch` call on N frames
(the fused route, as a user calls it): its wall time, the device's busy
time and idle share, and the port's own spans of the profiled call
(`utils.trace`): the entry with its attributes (`B`, `T`, `K`, `S`, `H`,
`route`, and the kernel's `staged` and `smem`), its copy to the host (the
walk of the best paths and their copy, `fused_scan.assemble_results`; the
span opens before the scan ends, so it includes the wait for the card)
with its counters (bytes, records, candidates, active slot-frames, path
rows) and the traceback of its utterances, and the `score` span's
attributes of the wave's scoring (`frames`, `G`, `components`,
`columns`; recorded in a profiler session of its own before the
profiled call, which holds no scoring). `--batch B` tiles the
8 sampled utterances to B (132 = one block on every SM); `--distinct`
samples B different utterances instead (seed 11), so that no two blocks
read the same closure-table rows; `--task 20k` decodes the 20k-word task
and `--task 20k-tri1` its cross-word triphone system (the artifact read
from, or built into, the package's `_cache/`; the tied-state task at
`wsj_task.TRI_POINT`, its sentences drawn from their triphones). The
fused route also prints the candidates and active slots a frame and
utterance of the wave. `--otf` decodes the task by on-the-fly
composition instead (`wsj_task.load_otf_task`, `OTF_POINT`'s beams, K
and E from `--budgets`, by default the point's tuner start): the plain
loop, or with `--entry` a `BatchDecoder(use_fused=False)` call; the
kernel does not search a G, so `--fused` is refused.

`profile_run` (warm-up, one run under the profiler, one on the host
clock alone, over the same frames) and `plain_loop_profile` (frames of
the plain loop resumed from a carry) are the measurement; `chip_smoke.py`
calls the latter for its static and on-the-fly plain-loop lines.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..decoder.core import TorchDecoder
from ..decoder import fused_scan
from ..decoder.fused_scan import FusedDecodeScan
from ..parallel.mesh import BatchDecoder
from ..ops.gmm import make_gmm_scorer
from ..utils import trace
from . import card_line, wsj_task

# the marks of the profiling build of csrc/frame_step.cu, in its order
PHASES = ("top", "A", "B_scan", "B_rest", "C", "D_scan", "D_rest", "E", "F",
          "G_records", "G_rest")


def profile_run(run, n_frames: int, attempts: int = 3):
    """Profile `run()`, a call that decodes `n_frames` frames on the card:
    once to warm up, once under `torch.profiler` (CPU and CUDA
    activities), then once on the host clock alone, since the profiler
    slows the host. Both timed runs decode the same frames. A profiler
    session now and then records no device activity at all: the profiled
    run is then repeated, `attempts` sessions in all, before this raises.
    Returns the numbers a frame step (`wall_ms` without the profiler,
    `profiled_wall_ms`, `kernel_ms` of device kernel time,
    `launches_per_frame`, and `idle`, the device's idle share: 1 - the
    union of its kernel, copy and set intervals over the wall time) and
    the profile."""
    run()
    torch.cuda.synchronize()
    for _ in range(attempts):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
        # device-side events only (an aten op and its kernel both carry the
        # kernel's time in key_averages)
        device = device_intervals(prof)
        kernel_us = sum(e - s for s, e in device)
        if kernel_us > 0:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no device time in {attempts} sessions")
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    return dict(wall_ms=wall / n_frames * 1e3,
                profiled_wall_ms=profiled_wall / n_frames * 1e3,
                kernel_ms=kernel_us / n_frames / 1e3,
                launches_per_frame=launches / n_frames,
                idle=1.0 - busy_us(device) / 1e6 / wall), prof


def device_intervals(prof) -> list[tuple[float, float]]:
    """(start, end) in us of every kernel, copy and set the profiler saw on
    the card; a range's twin on the card's timeline is not work."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def busy_us(intervals) -> float:
    """Time covered by at least one of `intervals`: their union, each
    overlap counted once."""
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def entry_spans(records) -> dict:
    """The last `entry` span of `records` (`utils.trace.spans()`): its
    time and its children's in ms, and their counters summed."""
    entry = [r for r in records if r.name == "entry"][-1]
    out = {"entry_ms": (entry.end_ns - entry.start_ns) / 1e6, "copy_ms": 0.0,
           "traceback_ms": 0.0, **{f"entry_{k}": v for k, v in entry.attrs.items()}}
    for r in records:
        if r.parent == entry.id and r.name in ("copy", "traceback"):
            out[f"{r.name}_ms"] += (r.end_ns - r.start_ns) / 1e6
            for k, v in r.attrs.items():
                out[k] = out.get(k, 0) + v
    return out


def plain_loop_profile(dec, scores, n: int = 20) -> dict:
    """`profile_run` of frames n..2n of the plain frame loop `run` on
    (B, T, G) scores, resumed from the carry of the first n frames (so no
    initial propagation is counted)."""
    carry, _, _ = dec.run(scores[:, :n])
    return profile_run(lambda: dec.run(scores[:, n:2 * n], carry=carry, t0=n), n)[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--fused", action="store_true",
                    help="profile the fused frame-step kernel, not the plain loop")
    ap.add_argument("--clocks", action="store_true",
                    help="with --fused: the profiling build, cycles of each phase")
    ap.add_argument("--entry", action="store_true",
                    help="profile one whole BatchDecoder.decode_scores_batch call")
    ap.add_argument("--batch", type=int, default=0, help="utterances a wave (default: 16, or 8 with --otf)")
    ap.add_argument("--task", default="2k", choices=("2k", "20k", "20k-tri1"))
    ap.add_argument("--distinct", action="store_true",
                    help="B different sampled utterances instead of 8 tiled to B")
    ap.add_argument("--otf", action="store_true",
                    help="on-the-fly composition (CL searched, G intersected) at OTF_POINT")
    ap.add_argument("--budgets", type=int, nargs=2, metavar=("K", "E"),
                    help="with --otf: frontier and expansion budgets")
    ap.add_argument("--trace", action="store_true",
                    help="write the Chrome trace to chiprun_out/")
    args = ap.parse_args()
    if args.otf and args.fused:
        ap.error("--fused: the frame-step kernel searches a static network, not a G")
    if args.budgets and not args.otf:
        ap.error("--budgets needs --otf")
    card = card_line()
    if args.otf:
        task = wsj_task.load_otf_task(args.task)
        p = wsj_task.OTF_POINT
        if args.budgets:
            p = dict(p, K=args.budgets[0], E=args.budgets[1])
        B = args.batch or p["n_utts"]
    else:
        task = wsj_task.load_task(args.task)
        p = wsj_task.TRI_POINT if args.task in wsj_task.TRI_TASKS else wsj_task.WSJ_POINT
        B = args.batch or p["batch"]
    utts = wsj_task.sample_utterances(task.cache, task.models,
                                      B if args.distinct else p["n_utts"],
                                      p["frames"], seed=11)
    T = args.frames
    scorer = make_gmm_scorer(task.models.flat_params(), device="cuda")
    # the first T frames of each utterance, edge-padded where it is shorter
    feats = torch.stack([
        torch.as_tensor(f).index_select(0, torch.arange(T).clamp(max=f.shape[0] - 1))
        for f in (utts[i % len(utts)][1] for i in range(B))])
    scores = scorer(feats.cuda().reshape(B * T, -1)).view(B, T, -1)
    dec = TorchDecoder(task.artifact, wsj_task.decoder_config(p, emit_diagnostics=False),
                       g_network=task.g if args.otf else None)
    stages = {}
    score_attrs = {}
    if args.entry:
        bd = BatchDecoder(dec, use_fused=not args.otf)
        with profile(activities=[ProfilerActivity.CPU]):
            scorer(feats.cuda().reshape(B * T, -1))
        score_attrs = {f"score_{k}": v for k, v in
                       [r for r in trace.spans() if r.name == "score"][-1].attrs.items()}

        def run():
            return bd.decode_scores_batch(scores)
    elif args.fused:
        if args.clocks:
            fused_scan.LIB_NAME = "frame_step_clocks"
        fs = FusedDecodeScan(dec, B)
        scores_tbg = scores.transpose(0, 1).contiguous()

        def run():
            return fs(scores_tbg)
        ys = run()[1]
        stages = {"cand_per_frame_utt": ys["n_cand"].double().mean().item(),
                  "active_per_frame_utt": ys["n_active"].double().mean().item()}
        del ys
    else:
        def run():
            return dec.run(scores)
    # the warm-up run also covers the kernel build, allocator and
    # cuBLAS/cub workspaces; the port records its spans in the profiled run
    trace.clear()
    numbers, prof = profile_run(run, T)
    if args.entry:
        stages = dict(entry_spans(trace.spans()), **score_attrs)
        if "records" in stages:
            stages["records_per_frame_utt"] = stages["records"] / (T * B)
    if args.fused and args.clocks:
        # of the last launch: the run timed without the profiler
        n = min(B, 1024)
        buf = (ctypes.c_longlong * (n * len(PHASES)))()
        lib = fused_scan._get_lib()
        lib.jtpu_frame_step_read_clocks.restype = ctypes.c_int
        lib.jtpu_frame_step_read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if lib.jtpu_frame_step_read_clocks(ctypes.addressof(buf), n) != len(PHASES):
            raise RuntimeError("the profiling build's cycle counts could not be read")
        clocks = torch.tensor(list(buf), dtype=torch.float64).view(n, len(PHASES)).mean(dim=0)
        stages.update(cycles_per_frame=dict(zip(PHASES, (clocks / T).tolist())),
                      share=dict(zip(PHASES, (clocks / clocks.sum()).tolist())))
    route = "entry" if args.entry else "fused" if args.fused else "plain"
    out = {
        "card": card, "task": args.task, "otf": args.otf, "route": route,
        "clocks": args.clocks, "batch": B, "distinct": args.distinct, "frames": T,
        "K": dec.K, "E": dec.E,
        "wall_ms_per_frame": numbers["wall_ms"],
        "profiled_wall_ms_per_frame": numbers["profiled_wall_ms"],
        "kernel_ms_per_frame": numbers["kernel_ms"],
        "device_idle_share": numbers["idle"],
        "launches_per_frame": numbers["launches_per_frame"],
        **stages,
    }
    print(json.dumps(out))
    by_name: dict[str, list] = {}
    for e in (e for e in prof.events() if e.device_type == DeviceType.CUDA):
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {us / T:8.1f} us/frame  {n / T:6.1f}/frame  {name[:100]}")
    if args.trace:
        os.makedirs("chiprun_out", exist_ok=True)
        prof.export_chrome_trace(os.path.join("chiprun_out", "profile_decode.json"))


if __name__ == "__main__":
    main()
