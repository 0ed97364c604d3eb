"""The Mosaic vector-pattern probe's nine patterns, as kernels on the card.

The counterpart of the JAX package's `scripts/pallas_probe.py`, which
compiles nine tiny Pallas kernels (`kA`..`kI`), one pattern of the fused
decode scan each, to learn which relayouts the TPU's compiler takes. Here
each pattern runs through the hand-written kernels of
`csrc/probe_patterns.cu` (`ops/probe_cuda.py`) on the probe's own shapes
(E=256, CW=128, W=16, 8 groups; all float32; inputs from numpy seed 0):

  A_collapse_matmul_2d    product (8E, CW) x (CW, W) -> (8E, W)
  B_plus_reshape_back_3d  the same, viewed (8, E, W)
  C_batched_dot_general   (8, E, CW) x (CW, W) -> (8, E, W), one product
  D_minor_col_extract_3d  (8, E, W)[:, :, 3] -> (8, E)
  E_onehot_gather_2d      rows of a (CW, W) table by (8, E) float indices
  F_col_extract_2d        (8E, W)[:, 3:4] -> (8E, 1)
  G_col_to_8E_reshape     (8E, W)[:, 3] viewed (8, E)
  H_row_slice_2d          (8E, W)[0:E, :] -> (E, W)
  I_chunked_gather_1024   rows of a (1024, W) table (the TPU's 512-row
                          chunks are a Mosaic workaround, not carried over)

One line a probe: PASS or FAIL (the kernel against its plain PyTorch
version: exactly for D-I, within 1e-5 relative for A-C, whose sums run in
another order), the seconds of the first call (the kernel library's nvcc
build included on a cold start), device times a call (the CUDA kernels'
own time under `torch.profiler`, or, where a profiler session records no
device activity three times, CUDA events around calls queued behind a spin
kernel; the line names the timer): the kernel's, one PyTorch call's of the
same function (`LIBRARY`), and two yardsticks, the floor (a kernel that
does nothing, `probe_cuda.empty`: no kernel of the card takes less) and
one float read and written (`probe_cuda.touch`: the floor and one trip to
memory), all four in one profiler session (`device_ms_split`), since a
session's small-kernel times can read ~2.8x those of the next; the plain
version's device time in a session of its own; their time a call in a
stream of calls by CUDA events (which at these sizes is the host's time to
issue a call), and `sum` of the output. Unlike the JAX tool, it exits 1 if
any probe fails.

Run as

    python -m juicer_tpu_torch.harness.pallas_probe [prefix] [--cpu]

on the card (`prefix`: only the probes whose name starts with it; `--cpu`:
the plain versions on the CPU, no timing).
"""

from __future__ import annotations

import argparse
import sys
import time
import types

import numpy as np
import torch

from .. import resolve_device
from ..ops import probe_cuda
from . import card_line

E, CW, W, GROUPS = 256, 128, 16, 8
PRODUCT_RTOL = 1e-5
# cycles of the spin kernel that holds the stream while `queued_ms` queues
# its calls (about 10 ms at the H100's clock; 50 calls take the host ~2 ms)
SPIN_CYCLES = 20_000_000
KERNEL = types.SimpleNamespace(product=probe_cuda.product, gather=probe_cuda.gather,
                               extract=probe_cuda.extract)
PLAIN = types.SimpleNamespace(product=probe_cuda.product_plain,
                              gather=probe_cuda.gather_plain,
                              extract=probe_cuda.extract_plain)
# one PyTorch call of each function (the gather's indices cast first): timed
# beside the kernels, used nowhere else
LIBRARY = types.SimpleNamespace(
    product=torch.matmul,
    gather=lambda idx, tab: torch.index_select(tab, 0, idx.long()),
    extract=lambda x, row0, n_rows, col0, n_cols: x[row0:row0 + n_rows,
                                                    col0:col0 + n_cols].clone())


def inputs(device, seed=0) -> dict:
    """The probe's inputs as float32 tensors on `device` (numpy draws, in
    the JAX tool's shapes)."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "tab": f32(rng.random((CW, W))),
        "idx": f32(rng.integers(0, CW, (GROUPS, E))),
        "x3": f32(rng.random((GROUPS, E, CW))),
        "xd": f32(rng.random((GROUPS, E, W))),
        "xf": f32(rng.random((GROUPS * E, W))),
        "xg": f32(rng.random((GROUPS * E, W))),
        "xh": f32(rng.random((GROUPS * E, W))),
        "idx1024": f32(rng.integers(0, 1024, (GROUPS, E))),
        "tab1024": f32(rng.random((1024, W))),
    }


def _col3(x):
    """The (8E, W) view's column 3 as an (8E, 1) tensor."""
    return (x, 0, x.shape[0], 3, 1)


# name -> (which kernel, exact?, the pattern over `ops` (KERNEL or PLAIN))
PROBES = {
    "A_collapse_matmul_2d": ("probe_product", False, lambda ops, i: ops.product(
        i["x3"].reshape(GROUPS * E, CW), i["tab"])),
    "B_plus_reshape_back_3d": ("probe_product", False, lambda ops, i: ops.product(
        i["x3"].reshape(GROUPS * E, CW), i["tab"]).view(GROUPS, E, W)),
    "C_batched_dot_general": ("probe_product", False, lambda ops, i: ops.product(
        i["x3"].view(GROUPS * E, CW), i["tab"]).view(GROUPS, E, W)),
    "D_minor_col_extract_3d": ("probe_extract", True, lambda ops, i: ops.extract(
        *_col3(i["xd"].view(GROUPS * E, W))).view(GROUPS, E)),
    "E_onehot_gather_2d": ("probe_gather", True, lambda ops, i: ops.gather(
        i["idx"].reshape(-1), i["tab"])),
    "F_col_extract_2d": ("probe_extract", True, lambda ops, i: ops.extract(*_col3(i["xf"]))),
    "G_col_to_8E_reshape": ("probe_extract", True, lambda ops, i: ops.extract(
        *_col3(i["xg"])).view(GROUPS, E)),
    "H_row_slice_2d": ("probe_extract", True, lambda ops, i: ops.extract(
        i["xh"], 0, E, 0, W)),
    "I_chunked_gather_1024": ("probe_gather", True, lambda ops, i: ops.gather(
        i["idx1024"].reshape(-1), i["tab1024"])),
}


def agree(out, want, exact) -> tuple[bool, float]:
    """(whether the kernel's output matches the plain one, max |diff|)."""
    if out.shape != want.shape:
        return False, float("inf")
    err = float((out - want).abs().max())
    if exact:
        return bool(torch.equal(out, want)), err
    return bool(((out - want).abs() <= PRODUCT_RTOL * want.abs()).all()), err


def cuda_ms(fn, iters=50) -> float:
    """Mean ms a call of fn() in a stream of `iters` calls after a
    warm-up, by CUDA events (for a kernel shorter than the host's time to
    issue a call, that time)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters=50) -> float:
    """Mean ms a call of fn() on the device, by CUDA events around `iters`
    calls queued on the stream behind a spin kernel (`torch.cuda._sleep`),
    so the host's time to issue them is hidden: the device's time for the
    calls back to back, the gaps between its kernels included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The card's kernel names: the probe kernels and the yardsticks' (all from
# `csrc/probe_patterns.cu`)
PROBE_KERNEL_NAMES = ("probe_product_kernel", "probe_gather_kernel", "probe_extract_kernel")


def is_floor(name: str) -> bool:
    return "probe_empty_kernel" in name


def is_touch(name: str) -> bool:
    return "probe_touch_kernel" in name


def is_probe(name: str) -> bool:
    return any(k in name for k in PROBE_KERNEL_NAMES)


def any_kernel(name: str) -> bool:
    return True


def device_ms_split(parts: dict, iters=50, attempts=3) -> tuple[dict, str]:
    """({label: mean ms a call}, timer) of several functions timed in one
    `torch.profiler` session: `parts` is an ordered {label: (fn, owns)};
    each of `iters` rounds (after a warm-up) calls every fn in turn, and a
    CUDA kernel counts for the first label whose owns(kernel name) holds
    (the last part's owns should take any name). On the card, small
    kernels read up to ~2.8x slower in some profiler sessions than in
    others, every kernel of a session alike; so times that are compared
    with each other are taken in one session. After `attempts` sessions
    with no device activity each part is timed alone by `queued_ms`
    (timer "queued events")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def round_():
        for fn, _ in parts.values():
            fn()

    round_()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                round_()
            torch.cuda.synchronize()
        us = dict.fromkeys(parts, 0.0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                label = next(k for k, (_, owns) in parts.items() if owns(e.name))
                us[label] += e.time_range.elapsed_us()
        if sum(us.values()) > 0:
            return {k: v / iters / 1e3 for k, v in us.items()}, "profiler"
    return {k: queued_ms(fn, iters) for k, (fn, _) in parts.items()}, "queued events"


def run(device="cuda", which="all", card="") -> list[dict]:
    """Every probe (or those starting with `which`), one line each.
    Returns one record a probe: {"name", "kernel", "calls" (of the kernel's
    wrapper: one launch each on the card), "ok", "err", "first_s",
    "ms", "library_ms", "floor_ms", "one_float_ms" (device time a call,
    taken together by `device_ms_split`; the yardsticks are
    `probe_cuda.empty` and `probe_cuda.touch`), "timer" (how), "plain_ms",
    "plain_timer" (the plain version alone), "events_ms", "plain_events_ms"
    (a call in a stream of calls), "sum", "inputs"} (times None on the
    CPU)."""
    device = resolve_device(device)
    inp = inputs(device)
    records = []
    for name, (kernel, exact, fn) in PROBES.items():
        if which != "all" and not name.startswith(which):
            continue
        calls = 0

        def kernel_call(fn=fn):
            nonlocal calls
            calls += 1
            return fn(KERNEL, inp)

        t0 = time.perf_counter()
        out = kernel_call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
        ok, err = agree(out, fn(PLAIN, inp), exact)
        t = dict.fromkeys(("kernel", "library", "floor", "one float"))
        plain_ms = events_ms = plain_events_ms = timer = plain_timer = None
        if device.type == "cuda":
            src, dst = torch.zeros(1, device=device), torch.empty(1, device=device)
            t, timer = device_ms_split({
                "floor": (lambda: probe_cuda.empty(device), is_floor),
                "one float": (lambda: probe_cuda.touch(src, dst), is_touch),
                "kernel": (kernel_call, is_probe),
                "library": (lambda fn=fn: fn(LIBRARY, inp), any_kernel)})
            plain, plain_timer = device_ms_split({
                "plain": (lambda fn=fn: fn(PLAIN, inp), any_kernel)})
            plain_ms = plain["plain"]
            events_ms = cuda_ms(kernel_call)
            plain_events_ms = cuda_ms(lambda: fn(PLAIN, inp))
        rec = dict(name=name, kernel=kernel, calls=calls, ok=ok, err=err, first_s=first_s,
                   ms=t["kernel"], library_ms=t["library"], floor_ms=t["floor"],
                   one_float_ms=t["one float"], timer=timer, plain_ms=plain_ms,
                   plain_timer=plain_timer, events_ms=events_ms,
                   plain_events_ms=plain_events_ms, sum=float(out.sum()), inputs=inp)
        records.append(rec)
        timing = (f"kernel {rec['ms']:.5f} ms, library {rec['library_ms']:.5f} ms, floor "
                  f"{rec['floor_ms']:.5f} ms, one float {rec['one_float_ms']:.5f} ms on the "
                  f"device ({timer}, one session); plain {plain_ms:.5f} ms ({plain_timer}, "
                  f"alone); {events_ms:.4f} / {plain_events_ms:.4f} ms a call in a stream"
                  if timer is not None else "plain version on the CPU")
        print(f"{'PASS' if ok else 'FAIL'} {name}: {first_s:.1f}s ({kernel}, max |diff| "
              f"{err:.2e}, {'exact' if exact else f'rtol {PRODUCT_RTOL}'}), {timing}, "
              f"sum={rec['sum']:.1f} | {card}", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The Mosaic probe's patterns on the card.")
    ap.add_argument("which", nargs="?", default="all", help="probe name prefix")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    records = run(device, args.which, card_line(device))
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
