"""Where a decode wave's time goes on the card.

    python -m juicer_tpu_torch.harness.profile_decode [--frames N] [--fused] [--trace]

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
the kernel writes them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..decoder.core import TorchDecoder
from ..decoder.fused_scan import FusedDecodeScan
from ..ops.gmm import make_gmm_scorer
from . import wsj_task


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--fused", action="store_true",
                    help="profile the fused frame-step kernel, not the plain loop")
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
    B = p["batch"]
    T = args.frames
    scorer = make_gmm_scorer(task.models.flat_params(), device="cuda")
    # the first T frames of each utterance, edge-padded where it is shorter
    feats = torch.stack([
        torch.as_tensor(f).index_select(0, torch.arange(T).clamp(max=f.shape[0] - 1))
        for f in (utts[i % len(utts)][1] for i in range(B))])
    scores = scorer(feats.cuda().reshape(B * T, -1)).view(B, T, -1)
    dec = TorchDecoder(task.artifact, wsj_task.decoder_config(p, emit_diagnostics=False))
    if args.fused:
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
    out = {
        "card": card, "route": "fused" if args.fused else "plain", "batch": B, "frames": T,
        "wall_ms_per_frame": plain_wall / T * 1e3,
        "profiled_wall_ms_per_frame": wall / T * 1e3,
        "kernel_ms_per_frame": kernel_us / T / 1e3,
        "device_idle_share": 1.0 - kernel_us / 1e6 / plain_wall,
        "launches_per_frame": launches / T,
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
