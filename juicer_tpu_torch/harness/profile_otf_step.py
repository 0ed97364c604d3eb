"""Ablation profile of the on-the-fly (OTF) per-frame step at reference
scale.

The counterpart of the JAX package's `scripts/profile_otf_step.py`. It
attributes the gap between on-the-fly and static decoding to its parts,
on the 20k-word CL/G pair that `wsj_otf` decodes (`wsj_otf.ensure_cl`,
`build_g`), at the certified point of the JAX round (R5.6): beam 85 /
end-beam 60 / maxHyps 800, K=2176, E=3840, F=1024, diagnostics off. Three
lines, each the best of 3 timed waves after a first wave:

  full          the decoder with the G (CL frontier x bigram G);
  no_g_advance  `_g_advance_seq` stubbed to identity on the instance
                (timing probe only: results are wrong): no G lookups for
                the candidates' words nor for the final-state reach;
  static_cl     the same artifact and budgets without a G: no G column in
                the keys, no G advance; the floor the OTF machinery adds to.

The scores are 8 utterances sampled from the task (seed 11, ~1000
frames), each scored by the GMM scorer (one kernel launch on the card),
edge-padded to the longest and tiled to B. No kernel covers a G, so all
three lines run the plain frame loop (`TorchDecoder.run`, the static line
too) and compare like with like; each prints its route, with the reason
where the kernel would not cover the decoder.
Before timing, the frames of a wave are held within
`fused_scan.max_scan_T` (record ids `t*K + slot` are int32), the guard the
JAX script skips.

Run as

    python -m juicer_tpu_torch.harness.profile_otf_step [B] [--frames T]
        [--waves N] [--cpu]

on the card (`--cpu`: on the CPU), B=8, T about 1000, 3 waves by
default.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .. import resolve_device
from ..am.models import AcousticModelSet
from ..decoder.artifact import DecoderArtifact
from ..decoder.core import TorchDecoder, TorchDecoderConfig
from ..decoder.fused_scan import max_scan_T, why_not_fused
from . import card_line, wsj_task
from .profile_step import stubbed
from .wsj_bench import default_cache, score_utterances, synchronize
from .wsj_otf import build_g, ensure_cl

# the certified R5.6 operating point of the JAX round
CONFIG = TorchDecoderConfig(
    emit_prune_win=85.0, phone_end_prune_win=60.0, word_prune_win=60.0,
    max_emit_hyps=800, max_insts=2176, expand_budget=3840, final_budget=1024,
    emit_diagnostics=False)


def load_pair(cache):
    """The task's CL artifact, G and models. Returns (art, g_net, models)."""
    models = AcousticModelSet.load_npz(os.path.join(cache, "models.npz"))
    cl_net, lexicon = ensure_cl(cache)
    g_net = build_g(cache, lexicon)
    t0 = time.perf_counter()
    art = DecoderArtifact(cl_net, models)
    print(f"[cl] {cl_net.n_arcs} arcs; G {g_net.n_states} states max_backoff="
          f"{g_net.max_backoff}; artifact {art} ({time.perf_counter() - t0:.1f}s)", flush=True)
    return art, g_net, models


def batch_scores(cache, models, B, device, frames=1000, n_utts=8, seed=11):
    """The sampled utterances' scores, edge-padded to the longest and tiled
    to (B, T, n_gmms) on `device`."""
    from ..ops.gmm import make_gmm_scorer

    utts = wsj_task.sample_utterances(cache, models, n_utts=n_utts, target_frames=frames,
                                      seed=seed)
    scores = score_utterances(make_gmm_scorer(models.flat_params(), device=device), utts,
                              device)
    Tmax = max(int(s.shape[0]) for s in scores)
    db = torch.stack([s.index_select(0, torch.arange(Tmax, device=device).clamp(
        max=s.shape[0] - 1)) for s in scores])
    return db[torch.arange(B, device=device) % len(scores)]


def bench(label, dec, db, waves=3, card=""):
    """Frames/s of the best of `waves` timed waves of `run` after a first
    wave. Returns {"fps", "best_s", "first_s", "overflow", "best_final",
    "route"}."""
    B, T = db.shape[:2]
    if T > max_scan_T(dec):
        raise ValueError(f"{T} frames at K={dec.K}: record ids t*K + slot would pass int32 "
                         f"(at most {max_scan_T(dec)} frames)")
    why = why_not_fused(dec)
    route = f"plain loop: {why}" if why else "plain loop"
    t0 = time.perf_counter()
    dec.run(db)
    synchronize(dec.device)
    first_s = time.perf_counter() - t0
    best = None
    for _ in range(waves):
        t0 = time.perf_counter()
        carry = dec.run(db)[0]
        synchronize(dec.device)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    out = {"fps": B * T / best, "best_s": best, "first_s": first_s,
           "overflow": int(carry["overflow"].sum()),
           "best_final": carry["best_final"]["score"].cpu().numpy(), "route": route}
    print(f"[{label:13s}] {out['fps']:8.0f} f/s/card  ({best / (B * T) * 1e6:6.1f} us/frame-row, "
          f"first wave {first_s:.1f}s, overflow {out['overflow']}); route: {route} | {card}",
          flush=True)
    return out


def _identity_seq(self, g, seq_ids):
    return (g, torch.zeros(g.shape, dtype=self.dtype, device=g.device),
            torch.ones(g.shape, dtype=torch.bool, device=g.device))


def profile(art, g_net, db, cfg=CONFIG, waves=3, card="") -> dict:
    """The three lines and the attribution. Returns {label: `bench`'s
    record}."""
    B = db.shape[0]
    dev = db.device
    out = {"full": bench("full", TorchDecoder(art, cfg, device=dev, g_network=g_net), db,
                         waves, card)}
    dec_ng = TorchDecoder(art, cfg, device=dev, g_network=g_net)
    with stubbed(dec_ng, {"_g_advance_seq": _identity_seq}):
        out["no_g_advance"] = bench("no_g_advance", dec_ng, db, waves, card)
    out["static_cl"] = bench("static_cl", TorchDecoder(art, cfg, device=dev), db, waves, card)
    full, no_adv, static = (out[k]["fps"] for k in ("full", "no_g_advance", "static_cl"))
    print(f"\nattribution at B={B}, K={cfg.max_insts}, E={cfg.expand_budget}:"
          f"\n  G advance (searchsorted walks):  {1e6 / full - 1e6 / no_adv:8.1f} us/frame-row "
          f"saved ({(no_adv / full - 1):+.0%} fps when removed)"
          f"\n  (arc, G state) keys + g plumbing: ({(static / no_adv - 1):+.0%} fps from "
          f"no_g_advance -> static)"
          f"\n  total OTF overhead:              ({(static / full - 1):+.0%} fps, static_cl vs "
          f"full)", flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Ablation profile of the OTF frame step.")
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--frames", type=int, default=1000, help="target frames an utterance")
    ap.add_argument("--waves", type=int, default=3, help="timed waves a line (best of)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def run(args) -> dict:
    device = resolve_device("cpu" if args.cpu else "cuda")
    cache = default_cache(20000)
    art, g_net, models = load_pair(cache)
    db = batch_scores(cache, models, args.batch, device, frames=args.frames)
    print(f"[scores] batch {args.batch} x T={db.shape[1]}", flush=True)
    return profile(art, g_net, db, waves=args.waves, card=card_line(device))


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
