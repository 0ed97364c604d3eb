"""Ablation profile of the per-frame decode step at the bench config.

The counterpart of the JAX package's `scripts/profile_step.py`. It times
the batched decode of the synthetic 200-word task (40 phones, D=39, 8
components, seed 0) at K=128 / E=512 / F=128, emit 150 / phone-end 75,
diagnostics off, on B x T scores of N(0, 2^2) (seed 0): the whole wave,
then variants with one piece of `TorchDecoder`'s frame step stubbed out
at a time, to attribute the per-frame cost. Results of a stubbed decode
are wrong by design: this is a timing probe only. Each stub is put on the
decoder instance and taken off again in a `finally`:

  - no merge+insert: `_merge_and_insert` lands nothing (the co-sort and
    the slot routing of both merges skipped);
  - no entry expansion: `_expand` hands back E invalid candidates (the
    segment broadcast and the entry-table gathers skipped);
  - no final expansion: `_final_rows` and `_best_final` both stubbed (the
    two halves of the JAX engine's `_expand_finals`): F invalid final
    candidates and no best-final update.

The JAX stubs keep a `* 0` data dependency on their inputs so that XLA
cannot eliminate the work before them; eager PyTorch eliminates no dead
code, so the port's stubs need no such trick.

The ablations run the plain frame loop (`TorchDecoder.run`), the only
route where a piece of the step can be stubbed. The "full" line is printed
for both routes: the plain loop, and one launch of the frame-step kernel
(`fused_scan.device_wave`; K=128 / E=512 fits a block). The JAX script's count
of `lax.sort` calls a frame becomes a count of the port's `torch.sort`,
`torch.argsort` and `torch.topk` calls in one `_frame_step`. For the
kernel's own phase split, see `profile_decode --fused --clocks`.

Run as

    python -m juicer_tpu_torch.harness.profile_step [B] [--frames T]
        [--iters N] [--cpu]

on the card (`--cpu`: on the CPU), B=128, T=1000, 3 timed iterations
by default.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
import types

import numpy as np
import torch

from .. import resolve_device
from ..decoder import core
from ..decoder.core import NEG, TorchDecoder, TorchDecoderConfig
from ..decoder.fused_scan import device_wave, route_of
from ..utils.synth import make_synth_task
from . import card_line
from .wsj_bench import synchronize

CONFIG = dict(max_insts=128, expand_budget=512, final_budget=128, emit_diagnostics=False,
              emit_prune_win=150.0, phone_end_prune_win=75.0)
TASK = dict(n_words=200, n_phones=40, vec_size=39, n_comps=8, seed=0)
_I64 = torch.int64


def build(device="cuda", task=None):
    """The bench's decoder on `device`: the synthetic task's artifact
    (`TASK`, or `task`'s keywords) at `CONFIG`."""
    t = make_synth_task(**(task or TASK))
    return t, TorchDecoder(t.artifact, TorchDecoderConfig(**CONFIG), device=device)


def score_batch(B, T, n_gmms, seed=0):
    """(B, T, n_gmms) float32 scores of N(0, 2^2) noise."""
    rng = np.random.default_rng(seed)
    return rng.normal(scale=2.0, size=(B, T, n_gmms)).astype(np.float32)


# ---- the stubs ---------------------------------------------------------------


def _fake_merge(self, fr, cand, t, norm):
    """No winner lands: the frontier as it is, empty records."""
    B, K, dev, dt = norm.shape[0], self.K, norm.device, self.dtype

    def full(v, dtype):
        return torch.full((B, K), v, dtype=dtype, device=dev)

    rec = {"rec_prev": full(-1, _I64), "rec_seq": full(0, _I64), "rec_score": full(NEG, dt),
           "rec_ac": full(NEG, dt), "rec_lm": full(NEG, dt), "rec_src": full(-1, _I64),
           "rec_arc": full(-1, _I64),
           "n_active": torch.zeros((B,), dtype=_I64, device=dev)}
    no = torch.zeros((B,), dtype=torch.bool, device=dev)
    return fr, rec, torch.full((B,), NEG, dtype=dt, device=dev), no


def _fake_expand(self, score, ac, path, base, fan, live, src_arc, lat=None):
    """E invalid candidates."""
    B, E, dev, dt = score.shape[0], self.E, score.device, self.dtype
    zeros = torch.zeros((B, E), dtype=_I64, device=dev)
    cand = {"arc": zeros, "score": torch.full((B, E), NEG, dtype=dt, device=dev),
            "ac": torch.full((B, E), NEG, dtype=dt, device=dev),
            "prev": torch.full((B, E), -1, dtype=_I64, device=dev), "seq": zeros,
            "src": torch.full((B, E), -1, dtype=_I64, device=dev),
            "valid": torch.zeros((B, E), dtype=torch.bool, device=dev),
            "overflow": torch.zeros((B,), dtype=torch.bool, device=dev),
            "n_cand": torch.zeros((B,), dtype=_I64, device=dev), "k": zeros}
    if lat is not None:
        cand["lat_from"] = torch.full((B, E), -1, dtype=_I64, device=dev)
    return cand


def _fake_final_rows(self, score, ac, base, fan, live):
    """F invalid final candidates."""
    B, F, dev, dt = score.shape[0], self.F, score.device, self.dtype
    zeros = torch.zeros((B, F), dtype=_I64, device=dev)
    return {"k": zeros, "ent": zeros, "valid": torch.zeros((B, F), dtype=torch.bool, device=dev),
            "total": torch.zeros((B,), dtype=_I64, device=dev),
            "sc": torch.full((B, F), NEG, dtype=dt, device=dev),
            "fac": torch.full((B, F), NEG, dtype=dt, device=dev)}


def _fake_best_final(self, fin, path, src_arc, norm, lat=None, g_step=None):
    """No best-final update, no final-budget overflow."""
    B, dev, dt = norm.shape[0], norm.device, self.dtype
    best = {"score": torch.full((B,), NEG, dtype=dt, device=dev),
            "ac": torch.full((B,), NEG, dtype=dt, device=dev),
            "lm": torch.full((B,), NEG, dtype=dt, device=dev),
            "path": torch.full((B,), -1, dtype=_I64, device=dev),
            "seq": torch.zeros((B,), dtype=_I64, device=dev),
            "src": torch.full((B,), -1, dtype=_I64, device=dev)}
    return best, torch.zeros((B,), dtype=torch.bool, device=dev), None


ABLATIONS = (
    ("no merge+insert (both sorts)", {"_merge_and_insert": _fake_merge}),
    ("no entry expansion", {"_expand": _fake_expand}),
    ("no final expansion", {"_final_rows": _fake_final_rows,
                            "_best_final": _fake_best_final}),
)


@contextlib.contextmanager
def stubbed(dec: TorchDecoder, stubs: dict):
    """Methods of `dec` replaced by `stubs` ({name: function}) on the
    instance, and taken off again however the block ends."""
    try:
        for name, fn in stubs.items():
            setattr(dec, name, types.MethodType(fn, dec))
        yield dec
    finally:
        for name in stubs:
            dec.__dict__.pop(name, None)


def sorts_per_frame(dec: TorchDecoder) -> int:
    """The `torch.sort`, `torch.argsort` and `torch.topk` calls of one
    `_frame_step` (from the initial carry, one utterance of zero scores)."""
    calls = {"n": 0}
    saved = {name: getattr(torch, name) for name in ("sort", "argsort", "topk")}

    def counted(fn):
        def wrap(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return wrap

    carry, _ = dec._init_carry(1)
    gmm_t = torch.zeros((1, dec.art.models.n_gmms), dtype=dec.dtype, device=dec.device)
    try:
        for name, fn in saved.items():
            setattr(core.torch, name, counted(fn))
        dec._frame_step(carry, gmm_t, 0)
    finally:
        for name, fn in saved.items():
            setattr(core.torch, name, fn)
    return calls["n"]


def time_wave(wave, device, iters):
    """Seconds a call of `wave` after one warm-up call, the mean of
    `iters`, and the last call's best-final scores on the host."""
    wave()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = wave()
    synchronize(device)
    return (time.perf_counter() - t0) / iters, carry["best_final"]["score"].cpu().numpy()


def profile(dec: TorchDecoder, scores: torch.Tensor, iters: int, card: str = "") -> dict:
    """The full wave on both routes and each ablation on the plain loop,
    one line each. Returns {label: {"s", "best_final", "route"}} and
    "sorts"."""
    B, T = scores.shape[:2]
    out = {}

    def line(label, route, wave):
        dt, best = time_wave(wave, dec.device, iters)
        out[label] = {"s": dt, "best_final": best, "route": route}
        print(f"{label:36s} {dt * 1e3:8.1f} ms  {B * T / dt:10.0f} fps  route: {route} "
              f"| {card}", flush=True)

    plain = lambda: dec.run(scores)[0]  # noqa: E731
    line("full", "plain loop", plain)
    route, fused = route_of(dec)
    if fused:
        line("full (frame_step)", "frame_step", device_wave(dec, scores))
    else:
        print(f"{'full (frame_step)':36s} not run: {route}", flush=True)
    out["sorts"] = sorts_per_frame(dec)
    print(f"torch sort/argsort/topk calls per frame: {out['sorts']}", flush=True)
    for label, stubs in ABLATIONS:
        with stubbed(dec, stubs):
            line(label, "plain loop", plain)
    base = out["full"]["s"]
    no_merge, no_expand, no_finals = (out[label]["s"] for label, _ in ABLATIONS)
    print(f"\nattribution (of {base * 1e3:.1f} ms, plain loop; stubbed: "
          f"{', '.join(n for _, s in ABLATIONS for n in s)}):")
    print(f"  merge+insert sorts : {(base - no_merge) * 1e3:8.1f} ms")
    print(f"  entry expansion    : {(base - no_expand) * 1e3:8.1f} ms")
    print(f"  final expansion    : {(base - no_finals) * 1e3:8.1f} ms")
    print(f"  rest (internal+gmm): {(no_merge + no_expand + no_finals - 2 * base) * 1e3:8.1f} ms",
          flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Ablation profile of the frame step.")
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def run(args) -> dict:
    device = resolve_device("cpu" if args.cpu else "cuda")
    task, dec = build(device)
    scores = dec.scores_tensor(score_batch(args.batch, args.frames, task.models.n_gmms))
    print(f"[profile step] synth 200 words, K={dec.K} E={dec.E} F={dec.F}, B={args.batch} x "
          f"T={args.frames}, {args.iters} timed iterations", flush=True)
    return profile(dec, scores, args.iters, card_line(device))


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
