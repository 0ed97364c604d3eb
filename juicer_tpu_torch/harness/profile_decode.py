"""Where a decode wave's time goes on the card.

    python -m juicer_tpu_torch.harness.profile_decode [--frames N] [--batch B]
        [--fused [--clocks] | --entry] [--trace]

Scores the 2k-word WSJ-order task's bench batch (8 sampled utterances
tiled to 16, `WSJ_POINT`, diagnostics off) with the GMM kernel, runs the
first frames once to warm up, then profiles N frames of the frame loop
with `torch.profiler` (CPU and CUDA activities). Prints the host time per
frame, the device kernel time per frame (sum of kernel durations), the
device idle share (1 - kernel time / wall time), kernel launches per
frame, and the ten costliest kernels; `--trace` writes the Chrome trace
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
time and idle share, and beside it the same work stage by stage with a
synchronise after each: the scan, the copy to the host (`host_batch`,
with its bytes) and the traceback of B utterances. `--batch B` tiles the
8 sampled utterances to B (132 = one block on every SM).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..decoder.core import TorchDecoder, host_batch
from ..decoder import fused_scan
from ..decoder.fused_scan import FusedDecodeScan
from ..parallel.batch import BatchDecoder
from ..ops.gmm import make_gmm_scorer
from . import wsj_task

# the marks of the profiling build of csrc/frame_step.cu, in its order
PHASES = ("top", "A", "B_scan", "B_rest", "C", "D_scan", "D_rest", "E", "F",
          "G_records", "G_rest")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--fused", action="store_true",
                    help="profile the fused frame-step kernel, not the plain loop")
    ap.add_argument("--clocks", action="store_true",
                    help="with --fused: the profiling build, cycles of each phase")
    ap.add_argument("--entry", action="store_true",
                    help="profile one whole BatchDecoder.decode_scores_batch call")
    ap.add_argument("--batch", type=int, default=0, help="utterances a wave (default 16)")
    ap.add_argument("--trace", action="store_true",
                    help="write the Chrome trace to chiprun_out/")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    task = wsj_task.load_task("2k")
    p = wsj_task.WSJ_POINT
    utts = wsj_task.sample_utterances(task.cache, task.models, p["n_utts"],
                                      p["frames"], seed=11)
    B = args.batch or p["batch"]
    T = args.frames
    scorer = make_gmm_scorer(task.models.flat_params(), device="cuda")
    # the first T frames of each utterance, edge-padded where it is shorter
    feats = torch.stack([
        torch.as_tensor(f).index_select(0, torch.arange(T).clamp(max=f.shape[0] - 1))
        for f in (utts[i % len(utts)][1] for i in range(B))])
    scores = scorer(feats.cuda().reshape(B * T, -1)).view(B, T, -1)
    dec = TorchDecoder(task.artifact, wsj_task.decoder_config(p, emit_diagnostics=False))
    stages = {}
    if args.entry:
        bd = BatchDecoder(dec)

        def run():
            return bd.decode_scores_batch(scores)
    elif args.fused:
        if args.clocks:
            fused_scan.LIB_NAME = "frame_step_clocks"
        fs = FusedDecodeScan(dec, B)
        scores_tbg = scores.transpose(0, 1).contiguous()

        def run():
            return fs(scores_tbg)
    else:
        def run():
            return dec.run(scores)
    run()  # warm-up: the kernel build, allocator, cuBLAS/cub workspaces
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device-side events only (an aten op and its kernel both carry the
    # kernel's time in key_averages)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels)
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    # the profiler slows the host; time the same run without it too
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t1
    if args.entry:
        # the same call stage by stage, a synchronise after each
        fs = bd._fs[B]
        clock = time.perf_counter
        t = [clock()]
        carry, ys = fs(scores.transpose(0, 1).contiguous())
        torch.cuda.synchronize()
        t.append(clock())
        host = host_batch(carry, ys, fs.rec0)
        t.append(clock())
        results = [dec.traceback(host, b, T) for b in range(B)]
        t.append(clock())
        n_rec = ys["rec_count"][-1].sum().item()
        stages = {
            "scan_ms": (t[1] - t[0]) * 1e3, "copy_to_host_ms": (t[2] - t[1]) * 1e3,
            "traceback_ms": (t[3] - t[2]) * 1e3,
            "bytes_to_host": sum(v.nbytes for v in host[1].values()),
            "records": n_rec, "records_per_frame_utt": n_rec / (T * B),
            "words": sum(len(r.words) for r in results),
        }
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
        stages = {"cycles_per_frame": dict(zip(PHASES, (clocks / T).tolist())),
                  "share": dict(zip(PHASES, (clocks / clocks.sum()).tolist()))}
    route = "entry" if args.entry else "fused" if args.fused else "plain"
    out = {
        "card": card, "route": route, "clocks": args.clocks,
        "batch": B, "frames": T,
        "wall_ms_per_frame": plain_wall / T * 1e3,
        "profiled_wall_ms_per_frame": wall / T * 1e3,
        "kernel_ms_per_frame": kernel_us / T / 1e3,
        "device_idle_share": 1.0 - kernel_us / 1e6 / plain_wall,
        "launches_per_frame": launches / T,
        **stages,
    }
    print(json.dumps(out))
    by_name: dict[str, list] = {}
    for e in kernels:
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
