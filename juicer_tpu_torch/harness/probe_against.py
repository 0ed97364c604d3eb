"""This tree's probe kernels beside another build of `csrc/probe_patterns.cu`,
in one process on the card.

Device times of these kernels differ up to ~2.8x between profiler sessions
and between machines, so a redesign is read against the kernels it
replaces in one process, in turns. `OTHER.cu` is another tree's source with
the same C entry points (for example a parent commit's, saved by `git show
REV:juicer_tpu_torch/csrc/probe_patterns.cu` under a git-ignored
directory). It is built with the package's nvcc flags into a temporary
directory and loaded by ctypes, and its entry points are called directly;
`ops/probe_cuda.py` serves this tree's. For each probe of
`harness/pallas_probe` (or those whose name starts with `prefix`): both
builds held to the plain version, then the device time a call in turns
(other, this, this, other), each turn one `pallas_probe.device_ms_split`
session of the build's kernel beside the two yardsticks (`probe_cuda.empty`,
the floor; `probe_cuda.touch`, one float read and written). One line a
probe with the card's name and power limit; exits 1 if a build disagrees
with the plain version.

Run as

    python -m juicer_tpu_torch.harness.probe_against OTHER.cu [prefix]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import types

import torch

from .. import _cuda_build, resolve_device
from ..ops import probe_cuda
from . import card_line, pallas_probe

TURNS = ("other", "this", "this", "other")


def other_build(path: str, out_dir: str) -> types.SimpleNamespace:
    """The kernels of the source `path`, built into `out_dir`, as `product`,
    `gather` and `extract` with the wrappers' signatures (CUDA tensors the
    wrappers would take; nothing checked, nothing counted)."""
    so = os.path.join(out_dir, "libother.so")
    proc = subprocess.run(_cuda_build._cmd(os.path.abspath(path), [], so), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (("jtpu_probe_product", [p, p, p, i, i, i, p]),
                           ("jtpu_probe_gather", [p, p, p, i, i, i, p]),
                           ("jtpu_probe_extract", [p, p, i, i, i, i, i, p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = i, argtypes

    def launch(fn, out, *args):
        rc = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{path}: launch failed (cudaError {rc})")
        return out

    def product(x, t):
        out = x.new_empty((x.shape[0], t.shape[1]))
        return launch(lib.jtpu_probe_product, out, x.data_ptr(), t.data_ptr(), out.data_ptr(),
                      x.shape[0], x.shape[1], t.shape[1])

    def gather(idx, tab):
        out = tab.new_empty((idx.shape[0], tab.shape[1]))
        return launch(lib.jtpu_probe_gather, out, idx.data_ptr(), tab.data_ptr(),
                      out.data_ptr(), idx.shape[0], tab.shape[0], tab.shape[1])

    def extract(x, row0, n_rows, col0, n_cols):
        out = x.new_empty((n_rows, n_cols))
        return launch(lib.jtpu_probe_extract, out, x.data_ptr(), out.data_ptr(), n_rows, row0,
                      x.shape[1], col0, n_cols)

    return types.SimpleNamespace(product=product, gather=gather, extract=extract)


def compare(path: str, which="all", card="") -> list[dict]:
    """Every probe (or those starting with `which`) through this tree's
    kernels and those of `path`, as the module says. Returns one record a
    probe: {"name", "kernel", "ok", "timers", "this", "other" (a list of two
    turns each, {"kernel", "floor", "one float"} ms a call)}."""
    device = resolve_device("cuda")
    inp = pallas_probe.inputs(device)
    src, dst = torch.zeros(1, device=device), torch.empty(1, device=device)
    records = []
    with tempfile.TemporaryDirectory() as td:
        builds = {"this": pallas_probe.KERNEL, "other": other_build(path, td)}
        for name, (kernel, exact, fn) in pallas_probe.PROBES.items():
            if which != "all" and not name.startswith(which):
                continue
            want = fn(pallas_probe.PLAIN, inp)
            ok = all(pallas_probe.agree(fn(ops, inp), want, exact)[0] for ops in builds.values())
            rec = {"name": name, "kernel": kernel, "ok": ok, "timers": set(), "this": [],
                   "other": []}
            for who in TURNS:
                t, timer = pallas_probe.device_ms_split({
                    "floor": (lambda: probe_cuda.empty(device), pallas_probe.is_floor),
                    "one float": (lambda: probe_cuda.touch(src, dst), pallas_probe.is_touch),
                    "kernel": (lambda ops=builds[who], fn=fn: fn(ops, inp),
                               pallas_probe.any_kernel)})
                rec[who].append(t)
                rec["timers"].add(timer)
            records.append(rec)
            mean = {w: {k: sum(t[k] for t in rec[w]) / len(rec[w]) for k in rec[w][0]}
                    for w in ("this", "other")}
            above = {w: {y: mean[w]["kernel"] - mean[w][y] for y in ("floor", "one float")}
                     for w in mean}
            turns = "; ".join(f"{w} " + ", ".join(f"{t['kernel']:.5f}" for t in rec[w])
                              for w in ("this", "other"))
            print(f"{'PASS' if ok else 'FAIL'} {name} ({kernel}): device time a call, mean of "
                  f"two turns (kernel / floor / one float): this "
                  f"{mean['this']['kernel']:.5f} / {mean['this']['floor']:.5f} / "
                  f"{mean['this']['one float']:.5f} ms, other {mean['other']['kernel']:.5f} / "
                  f"{mean['other']['floor']:.5f} / {mean['other']['one float']:.5f} ms; this / "
                  f"other {mean['this']['kernel'] / mean['other']['kernel']:.3f}; above the "
                  f"floor {above['this']['floor']:.5f} / {above['other']['floor']:.5f} ms "
                  f"({above['this']['floor'] / above['other']['floor']:.3f}); above one float "
                  f"{above['this']['one float']:.5f} / {above['other']['one float']:.5f} ms; "
                  f"kernel by turn: {turns} (timers {sorted(rec['timers'])}) | {card}",
                  flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="This tree's probe kernels beside another build.")
    ap.add_argument("other", help="another tree's csrc/probe_patterns.cu")
    ap.add_argument("which", nargs="?", default="all", help="probe name prefix")
    args = ap.parse_args(argv)
    records = compare(args.other, args.which, card_line("cuda"))
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
