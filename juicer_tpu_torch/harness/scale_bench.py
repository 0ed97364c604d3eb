"""Scale validation: a WSJ-order synthetic CLG through the artifact and a
decode on the card.

The counterpart of the JAX package's `scripts/scale_bench.py`. It builds
a random CLG-shaped network directly (`build_big_network`: states, arcs
and epsilon arcs with words in the proportions of det(C o det(L o G));
the reference's WSJ 20k machine is 1.32M states / 5.41M arcs), compiles
its artifact (the native closure), and measures the beam-pruned decode
at given budgets K and E, with histogram pruning and realistic frontier
sizes. The models are `utils.synth.make_models(2000, n_emit=3, dim=39,
n_comps=8, seed=1)`: 6,000 GMMs, the repo's only decode at the size of a
real acoustic model. The scores are T = 500 frames of N(0, 3^2) noise
(seed 2), so the search is not certified: the budgets bind by design and
the overflow is reported, not held to 0.

The route is chosen in the open (`fused_scan.route_of`): the frame-step
kernel where `why_not_fused` of the decoder is None, else the plain frame
loop with the reason. At 6,000 GMMs the kernel's shared memory holds a
frame's scores (24 KB), so K=768 / E=1024 fits a block; K=1024 / E=1408
and the script's defaults K=8192 / E=32768 do not, and the kernel keeps
their search state in device memory; past E=32768 ("auto" takes the sort
merge) the plain loop runs.

Run as

    python -m juicer_tpu_torch.harness.scale_bench [n_arcs] [K] [E]
        [--batch B] [--merge dense|sort|auto] [--maxhyps N] [--cpu]

on the card (`--cpu`: the plain PyTorch path on the CPU). Without
`--batch` one utterance is decoded twice by `decode_scores` (first call,
then steady); with `--batch B` a (B, T, 6000) wave runs through the
decoder's device route (`fused_scan.device_wave`: one kernel launch, or
the plain loop), first and steady, with its overflow count and the
frames/s of the card. The JAX script's `--unroll` has no counterpart: the
port's frame loop is not an unrolled scan.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import resolve_device
from ..decoder.artifact import DecoderArtifact
from ..decoder.core import TorchDecoder, TorchDecoderConfig
from ..decoder.fused_scan import device_wave, route_of
from ..decoder.network import DecoderNetwork
from ..fst import LOG, Fst
from ..utils.synth import make_models
from . import card_line
from .wsj_bench import first_and_steady

N_MODELS = 2000
FRAMES = 500
BEAMS = dict(emit_prune_win=150.0, phone_end_prune_win=120.0, word_prune_win=120.0)


def build_big_network(n_arcs=1_000_000, n_models=N_MODELS, n_words=20000, seed=0):
    """A random CLG-shaped network of `n_arcs` arcs over n_arcs // 4
    states: 5 % epsilon arcs, 12 % with a word, exponential weights, 50
    final states. The random numbers are drawn in the JAX script's order,
    so the network is arc for arc the JAX one."""
    rng = np.random.default_rng(seed)
    n_states = max(4, n_arcs // 4)
    src = rng.integers(0, n_states, n_arcs)
    dst = rng.integers(0, n_states, n_arcs)
    is_eps = rng.random(n_arcs) < 0.05
    il = np.where(is_eps, 0, rng.integers(1, n_models + 1, n_arcs))
    has_word = rng.random(n_arcs) < 0.12
    ol = np.where(has_word, rng.integers(1, n_words + 1, n_arcs), 0)
    w = rng.exponential(1.0, n_arcs)

    f = Fst(LOG)
    f.num_states = n_states
    f.arc_src = src.tolist()
    f.arc_dst = dst.tolist()
    f.arc_ilabel = il.tolist()
    f.arc_olabel = ol.tolist()
    f.arc_weight = w.tolist()
    f.start = 0
    for s in rng.integers(0, n_states, 50):
        f.set_final(int(s), 0.0)
    return DecoderNetwork(f)


def build(n_arcs=1_000_000, n_models=N_MODELS, n_words=20000):
    """The network, the models and the artifact, each with its seconds
    printed. Returns (net, models, artifact, {"network_s", "models_s",
    "artifact_s"})."""
    secs = {}
    t0 = time.perf_counter()
    net = build_big_network(n_arcs=n_arcs, n_models=n_models, n_words=n_words)
    secs["network_s"] = time.perf_counter() - t0
    print(f"network: {net.n_states} states, {net.n_arcs} arcs ({secs['network_s']:.1f}s)",
          flush=True)
    t0 = time.perf_counter()
    models = make_models(n_models, n_emit=3, dim=39, n_comps=8, seed=1)
    secs["models_s"] = time.perf_counter() - t0
    print(f"models: {models.n_hmms} hmms, {models.n_gmms} gmms ({secs['models_s']:.1f}s)",
          flush=True)
    t0 = time.perf_counter()
    art = DecoderArtifact(net, models)
    secs["artifact_s"] = time.perf_counter() - t0
    fan = int(np.diff(art.expansion.row_ptr).max(initial=0))
    print(f"artifact: {art}, largest fan-out {fan} ({secs['artifact_s']:.1f}s, native "
          f"closure)", flush=True)
    return net, models, art, secs


def decoder_config(K=8192, E=32768, maxhyps=8000, merge="auto",
                   emit_diagnostics=True) -> TorchDecoderConfig:
    """The script's decoder: emit 150 / phone-end 120 / word 120, F=1024."""
    return TorchDecoderConfig(max_insts=K, expand_budget=E, final_budget=1024,
                              max_emit_hyps=maxhyps, merge_strategy=merge,
                              emit_diagnostics=emit_diagnostics, **BEAMS)


def score_batch(B, n_gmms, T=FRAMES):
    """The script's scores: (B, T, n_gmms) of N(0, 3^2) from seed 2, or
    (T, n_gmms) with B=0, float32."""
    rng = np.random.default_rng(2)
    shape = (B, T, n_gmms) if B else (T, n_gmms)
    return rng.normal(scale=3.0, size=shape).astype(np.float32)


def single_stream(dec: TorchDecoder, scores) -> dict:
    """`decode_scores` of one utterance twice, on the decoder's route
    (`route_of`). Returns {"result", "first_s", "steady_s", "route"}."""
    route, fused = route_of(dec)
    sc = dec.scores_tensor(scores)
    t0 = time.perf_counter()
    dec.decode_scores(sc, use_fused=fused)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = dec.decode_scores(sc, use_fused=fused)
    return {"result": res, "first_s": first_s, "steady_s": time.perf_counter() - t0,
            "route": route}


def batch_wave(dec: TorchDecoder, scores) -> dict:
    """One (B, T, n_gmms) wave through the decoder's device route
    (`fused_scan.device_wave`), first and steady. Returns {"best_final"
    (B,) scores and "overflow" (B,) flags of the steady wave on the host,
    "first_s", "steady_s", "route"}."""
    route, _ = route_of(dec)
    sc = dec.scores_tensor(scores)
    carry, first_s, steady_s = first_and_steady(device_wave(dec, sc), dec.device)
    return {"best_final": carry["best_final"]["score"].cpu().numpy(),
            "overflow": carry["overflow"].cpu().numpy(), "first_s": first_s,
            "steady_s": steady_s, "route": route}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="WSJ-order synthetic CLG: artifact and decode.")
    ap.add_argument("sizes", nargs="*", type=int, metavar="n_arcs K E",
                    help="arcs (1000000), K (8192), E (32768)")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--merge", default="auto", choices=("auto", "dense", "sort"))
    ap.add_argument("--maxhyps", type=int, default=8000)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if len(args.sizes) > 3:
        ap.error("at most three positional sizes: n_arcs K E")
    args.n_arcs, args.K, args.E = (args.sizes + [1_000_000, 8192, 32768][len(args.sizes):])
    return args


def run(args, built=None) -> dict:
    """The script's decode on `built` = (net, models, art) or a network
    built from `args.n_arcs`. Returns {"decoder", "route", and "single"
    (`single_stream`) or "batch" (`batch_wave`)}."""
    device = resolve_device("cpu" if args.cpu else "cuda")
    card = card_line(device)
    net, models, art = built if built is not None else build(args.n_arcs)[:3]
    t0 = time.perf_counter()
    dec = TorchDecoder(art, decoder_config(args.K, args.E, args.maxhyps, args.merge),
                       device=device)
    route, _ = route_of(dec)
    print(f"decoder: K={dec.K} E={dec.E} merge={dec.merge_strategy} maxhyps={args.maxhyps} "
          f"({time.perf_counter() - t0:.1f}s); route: {route} | {card}", flush=True)
    out = {"decoder": dec, "route": route}
    B, T = args.batch, FRAMES
    if B:
        w = out["batch"] = batch_wave(dec, score_batch(B, models.n_gmms))
        print(f"decode first wave: {w['first_s']:.1f}s (overflow: {int(w['overflow'].sum())}/{B})",
              flush=True)
        dt = w["steady_s"]
        print(f"decode steady (batch {B}): {dt:.2f}s = {B * T / dt:.0f} frames/s/card "
              f"({dt / T * 1e3:.2f} ms/frame-row); route: {route} | {card}", flush=True)
        return out
    s = out["single"] = single_stream(dec, score_batch(0, models.n_gmms))
    print(f"decode first call: {s['first_s']:.1f}s, {len(s['result'].words)} words", flush=True)
    dt = s["steady_s"]
    print(f"decode steady: {dt:.2f}s = {T / dt:.0f} frames/s ({dt / T * 1e3:.2f} ms/frame); "
          f"route: {route} | {card}", flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
