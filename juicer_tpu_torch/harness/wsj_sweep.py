"""The pruning-ladder sweep of a WSJ-order task, on the card.

The counterpart of the JAX package's `scripts/wsj_sweep.py`. For each
rung `beam,end,maxhyps` of `--settings` it tunes the budgets over the
whole eval batch (`autotune_budgets`, margin 1.4), measures word accuracy
and the peak of active slots, checks the float32 engine's words against
the float64 oracle on `--parity N` held-out short utterances, and benches
a steady wave at each of `--batches` (`wsj_bench.steady_bench`, overflow
counted from the benched wave itself). `--center-scale` swaps in
confusable GMMs (`wsj_bench.ensure_models`), `--free-text` draws the
transcripts uniformly (the LM in tension with the acoustics) and
`--mismatch S` decodes with means perturbed by S * N(0, 1) while the
features come from the clean models: the regime where pruning costs
words. The network and artifact are those of the task in every case.

Each rung takes its route in the open: the tuner runs through the
frame-step kernel where the start probe is in the kernel's scope, else
the plain loop; the rung's decodes and bench through the kernel where
`why_not_fused` of the tuned decoder is None, else the plain loop. Each
row carries "route" ("frame_step" or "plain loop: <reason>"). A rung whose
tuning fails (`ProbeOutOfScope`: a doubled probe past the kernel's shared
memory; `BudgetsNotFound`: no probe without overflow; the card's memory)
or whose bench runs out of the card's memory is recorded in its row with
the error, as the JAX script records it, and the sweep goes on; any
other error, a kernel that does not launch among them, ends the run.

Run as

    python -m juicer_tpu_torch.harness.wsj_sweep [--words N] [--bigrams M]
        [--batch B] [--frames T] [--settings "beam,end,maxhyps[;...]"]
        [--batches 8,16] [--K K] [--E E] [--center-scale S] [--free-text]
        [--mismatch S] [--parity N] [--no-bench] [--seed S] [--cpu]

on the card (`--cpu`: on the CPU). One JSON row a rung with the script's
keys, "route", "dead" (utterances that reach no final state) and
"device", then the script's last line (`wsj_pruning_sweep`). The
JAX script's `--unroll` has no counterpart (the port's frame loop is not
an unrolled scan).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..decoder.autotune import (BudgetsNotFound, ProbeOutOfScope, autotune_budgets,
                                decode_each, pad_batch)
from ..decoder.core import TorchDecoder, TorchDecoderConfig
from . import card_line, wsj_task
from .wsj_bench import (accuracy, default_cache, ensure_artifact, ensure_models, ensure_task,
                        mismatch_models, oracle, route_of, score_utterances, steady_bench)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Pruning-ladder sweep of a WSJ-order task.")
    ap.add_argument("--words", type=int, default=20000)
    ap.add_argument("--bigrams", type=int, default=1_500_000)
    ap.add_argument("--batch", type=int, default=8, help="eval-set size (accuracy utterances)")
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--settings", type=str, default="100,75,1200;120,90,2500")
    ap.add_argument("--batches", type=str, default="8",
                    help="comma list of steady-bench batch sizes (utts are tiled to fill)")
    ap.add_argument("--K", type=int, default=2048,
                    help="autotune probe start (doubles on overflow)")
    ap.add_argument("--E", type=int, default=4096)
    ap.add_argument("--center-scale", type=float, default=1.2,
                    help="GMM center spread; lower = harder acoustics (task models: 1.2)")
    ap.add_argument("--free-text", action="store_true",
                    help="uniform-random transcripts instead of bigram walks")
    ap.add_argument("--mismatch", type=float, default=0.0,
                    help="decode-side GMM mean perturbation sigma (features stay generated "
                         "from the clean models)")
    ap.add_argument("--parity", type=int, default=0,
                    help="per-setting oracle parity on N held-out short utterances")
    ap.add_argument("--no-bench", action="store_true",
                    help="accuracy/certification only (skip steady bench)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def prepare(args, net, art, cache):
    """The sweep's inputs: the eval and parity utterances synthesised from
    the (centre-scaled) models and scored by the decode-side models."""
    from ..ops.gmm import make_gmm_scorer

    device = resolve_device("cpu" if args.cpu else "cuda")
    models = ensure_models(cache, args.center_scale)
    dec_models = mismatch_models(models, args.mismatch)
    print(f"[net] {net.n_arcs} arcs; artifact {art}; center_scale {args.center_scale} "
          f"mismatch {args.mismatch}", flush=True)
    utts = wsj_task.sample_utterances(cache, models, n_utts=args.batch,
                                      target_frames=args.frames, seed=args.seed,
                                      free_text=args.free_text)
    par_utts = []
    if args.parity:
        par_utts = wsj_task.sample_utterances(cache, models, n_utts=args.parity,
                                              target_frames=150, seed=args.seed + 1,
                                              free_text=args.free_text)
    scorer = make_gmm_scorer(dec_models.flat_params(), device=device)
    scores = score_utterances(scorer, utts, device)
    par_scores = score_utterances(scorer, par_utts, device)
    n_ref_words = sum(len(w) for w, _ in utts)
    print(f"[utts] {len(utts)} utterances, {n_ref_words} words, "
          f"T(mean)={np.mean([s.shape[0] for s in scores]):.0f}", flush=True)
    return dict(device=device, dec_models=dec_models, utts=utts, scores=scores,
                par_scores=par_scores, labels=wsj_task.word_labels(cache))


def rung(args, spec, net, art, inp, card) -> dict:
    """One rung of the ladder: its JSON row."""
    device, scores, utts = inp["device"], inp["scores"], inp["utts"]
    labels, markers = inp["labels"]
    beam, end, mh = (float(x) for x in spec.split(","))
    base = TorchDecoderConfig(
        emit_prune_win=beam, phone_end_prune_win=end, word_prune_win=end,
        max_emit_hyps=int(mh), max_insts=args.K, expand_budget=args.E, final_budget=1024)
    tune_route, tune_fused = route_of(TorchDecoder(art, base, device=device))
    print(f"[{spec}] autotune route from K={args.K} E={args.E}: {tune_route}", flush=True)
    t0 = time.time()
    # certify over the whole eval batch; a rung whose certification fails
    # is recorded as such, not hidden, and the sweep goes on
    try:
        tuned = autotune_budgets(art, scores, base, margin=1.4, device=device,
                                 use_fused=tune_fused, verbose=True)
    except (ProbeOutOfScope, BudgetsNotFound, torch.OutOfMemoryError) as e:
        print(f"[{spec}] autotune FAILED: {e}", flush=True)
        return {"beam": beam, "end_beam": end, "maxhyps": int(mh), "route": tune_route,
                "error": str(e)}
    print(f"[{spec}] autotune K={tuned.max_insts} E={tuned.expand_budget} "
          f"({time.time() - t0:.0f}s)", flush=True)

    dec = TorchDecoder(art, dataclasses.replace(tuned, emit_diagnostics=True), device=device)
    route, fused = route_of(dec)
    print(f"[{spec}] route: {route}", flush=True)
    results = decode_each(dec, scores, use_fused=fused)
    ed = accuracy(results, utts, labels, markers)
    peaks = [r.max_active for r in results]
    ovf = sum(int(r.overflow) for r in results)
    print(f"[{spec}] acc {ed.accuracy * 100:.2f}% peak {max(peaks)} overflow {ovf}/{len(utts)}",
          flush=True)

    parity_ok = None
    if args.parity:
        parity_ok = 0
        for sc, (r_ref, _) in zip(inp["par_scores"],
                                  oracle(net, inp["dec_models"], tuned, inp["par_scores"])):
            r_dec = dec.decode_scores(sc, use_fused=fused)
            if r_ref.words == r_dec.words:
                parity_ok += 1
            else:
                print(f"[{spec}] parity MISMATCH: engine {r_dec.words} vs oracle "
                      f"{r_ref.words}", flush=True)
        print(f"[{spec}] oracle parity {parity_ok}/{len(inp['par_scores'])}", flush=True)

    fps, bench = None, {}
    if not args.no_bench:
        try:
            bench = steady_bench(art, tuned, pad_batch(scores),
                                 [int(x) for x in args.batches.split(",")], device=device)
        except torch.OutOfMemoryError as e:
            print(f"[{spec}] bench FAILED: {e}", flush=True)
            bench = {}
        for Bs, rec in bench.items():
            print(f"[{spec}] B={Bs}: {rec['fps']:.0f} f/s (first wave {rec['compile_s']}s, "
                  f"overflow {rec['overflow']}/{Bs}, route {rec['route']}) | {card}", flush=True)
        fps_of = {Bs: rec["fps"] for Bs, rec in bench.items() if rec["overflow"] == 0}
        fps = max(fps_of.values()) if fps_of else 0.0

    return {"beam": beam, "end_beam": end, "maxhyps": int(mh),
            "K": tuned.max_insts, "E": tuned.expand_budget,
            "accuracy": round(ed.accuracy, 4),
            "errors": ed.n_ins + ed.n_del + ed.n_sub, "n_words": ed.n_ref,
            "peak_active": max(peaks), "overflow": ovf,
            "dead": sum(int(r.empty) for r in results), "parity_ok": parity_ok,
            "bench": None if args.no_bench else {str(Bs): rec for Bs, rec in bench.items()},
            "best_fps": fps, "xRT": None if fps is None else round(fps / 100, 1),
            "route": route, "device": card}


def sweep(args, net, art, cache) -> dict:
    """Every rung of `--settings` on the task (`main`'s body; the chip
    smoke calls it on a task it already holds). Returns the last line."""
    inp = prepare(args, net, art, cache)
    card = card_line(inp["device"])
    rows = []
    for spec in args.settings.split(";"):
        row = rung(args, spec, net, art, inp, card)
        rows.append(row)
        if "error" not in row:
            print(json.dumps(row), flush=True)
    return {"metric": "wsj_pruning_sweep", "center_scale": args.center_scale,
            "mismatch": args.mismatch, "free_text": args.free_text, "rows": rows}


def main(argv=None) -> int:
    args = parse_args(argv)
    cache = default_cache(args.words)
    net, task_models = ensure_task(cache, args.words, args.bigrams)
    # the artifact depends only on the network and the models' topology and
    # transitions, which no centre scale or mismatch changes
    art = ensure_artifact(cache, net, task_models)
    print(json.dumps(sweep(args, net, art, cache)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
