"""The reference-scale on-the-fly composition bench of a WSJ-order task.

The counterpart of the JAX package's `scripts/wsj_otf.py` (the
reference's fourth headline configuration): the LM G is kept apart from
the search network, which is CL = C o closure(min(det(L))), and the
decoder intersects word labels with G during the search. On the task of
`wsj_bench` (the tracked 20k task by default) it reads or builds CL
(`ensure_cl`, the port's `wsj_task.build_cl`), builds G from the task's
`lm.arpa` as a `GNetwork`, tunes the (arc, G state) budgets
(`autotune_budgets(g_network=)`), measures word accuracy against the
generating transcripts, holds the words to the oracle `RefOtfDecoder` on
`--parity N` short held-out utterances, and benches a steady wave
(`wsj_bench.steady_bench`), the number beside the static CLG's on the same
acoustics.

No kernel covers a decoder with a G (`why_not_fused` names it), so every
decode here is the plain frame loop (`use_fused=False`), and the route
line says why. The JAX script's `--pad-cap` has no counterpart: the
port's `GNetwork` keeps no padded rows. Its `--unroll` has none either
(no unrolled scan).

Run as

    python -m juicer_tpu_torch.harness.wsj_otf [--words N] [--batch B]
        [--frames T] [--beam W] [--end-beam W] [--maxhyps N] [--batches 8]
        [--K K] [--E E] [--pushing] [--parity N] [--no-bench] [--no-tune]
        [--seed S] [--cpu]

on the card (`--cpu`: on the CPU). With the bench, the last line is the
script's JSON line (`wsj_otf_frames_per_sec_chip`) with the route and the
device added.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from .. import resolve_device
from ..compile import arpa_grammar
from ..decoder.artifact import DecoderArtifact
from ..decoder.autotune import autotune_budgets, decode_each, pad_batch
from ..decoder.core import TorchDecoder, TorchDecoderConfig
from ..decoder.network import DecoderNetwork
from ..decoder.otf import GNetwork
from . import card_line, wsj_task
from .wsj_bench import (accuracy, default_cache, ensure_task, oracle, route_of,
                        score_utterances, steady_bench)


def ensure_cl(cache):
    """Read (or build) CL, the network half of the pair: C o
    closure(min(det(L))) with the aux phones removed on the input side;
    `cl.npz` of the task (or of its `wsj_task.writable_dir`), else built by
    `wsj_task.build_cl` and written there. Returns (network, lexicon)."""
    lexicon = wsj_task.task_lexicon(cache)
    out = wsj_task.writable_dir(cache)
    for d in (cache, out):
        path = os.path.join(d, "cl.npz")
        if os.path.exists(path):
            print(f"[cl] loading cached {path}", flush=True)
            return DecoderNetwork.load_npz(path), lexicon
    t0 = time.time()
    cl = wsj_task.build_cl(lexicon)
    print(f"[cl] C o closure(det(L)): {cl.num_states} states {cl.num_arcs} arcs "
          f"({time.time() - t0:.1f}s)", flush=True)
    net = DecoderNetwork(cl, cl.isyms, cl.osyms, remove_aux="input")
    os.makedirs(out, exist_ok=True)
    net.save_npz(os.path.join(out, "cl.npz"))
    return net, lexicon


def build_g(cache, lexicon):
    """G of the task's `lm.arpa` over the lexicon's vocabulary, as a
    `GNetwork`."""
    t0 = time.time()
    g_net = GNetwork(arpa_grammar(lexicon.vocab, os.path.join(cache, "lm.arpa")))
    print(f"[g] {g_net.n_states} states, {len(g_net.arc_il)} word arcs, W={g_net.W}, "
          f"max_backoff={g_net.max_backoff} ({time.time() - t0:.1f}s)", flush=True)
    return g_net


def tune(art, scores, base, g_net, device, no_tune=False):
    """The (arc, G state) budgets: `base` with --no-tune, else tuned at
    margin 1.4 over the batch. The kernel does not cover a G, so the tuner
    runs the plain loop, and says why."""
    if no_tune:
        print(f"[budgets] K={base.max_insts} E={base.expand_budget} (--no-tune)", flush=True)
        return base
    route, fused = route_of(TorchDecoder(art, base, device=device, g_network=g_net))
    print(f"[autotune] route: {route}", flush=True)
    t0 = time.time()
    tuned = autotune_budgets(art, scores, base, margin=1.4, device=device, use_fused=fused,
                             g_network=g_net, verbose=True)
    print(f"[autotune] K={tuned.max_insts} E={tuned.expand_budget} ({time.time() - t0:.1f}s)",
          flush=True)
    return tuned


def decode_batch(art, tuned, g_net, utts, scores, cache, device):
    """The batch's decodes at the tuned budgets and their accuracy.
    Returns (decoder, results, EditDistance, route)."""
    dec = TorchDecoder(art, dataclasses.replace(tuned, emit_diagnostics=True), device=device,
                       g_network=g_net)
    route, fused = route_of(dec)
    print(f"[route] {route}", flush=True)
    results = decode_each(dec, scores, use_fused=fused)
    labels, markers = wsj_task.word_labels(cache)
    ed = accuracy(results, utts, labels, markers)
    print(f"[accuracy] {ed.summary().replace(chr(10), '; ')}; peak "
          f"{max(r.max_active for r in results)}, overflow "
          f"{sum(int(r.overflow) for r in results)}/{len(utts)}", flush=True)
    return dec, results, ed, route


def parity(dec, cl_net, g_net, models, par_scores):
    """`RefOtfDecoder` against the decoder's words on each held-out
    utterance. Returns the number of exact ones."""
    _, fused = route_of(dec)
    n_ok = 0
    oracles = oracle(cl_net, models, dec.cfg, par_scores, g_network=g_net)
    for i, (sc, (r_ref, t_ref)) in enumerate(zip(par_scores, oracles)):
        r_dec = dec.decode_scores(sc, use_fused=fused)
        ok = r_ref.words == r_dec.words
        n_ok += ok
        print(f"[parity] utt {i}: {'exact' if ok else 'MISMATCH'} ({len(r_ref.words)} words, "
              f"oracle {t_ref:.1f}s)", flush=True)
        if not ok:
            print(f"  engine {r_dec.words}\n  oracle {r_ref.words}", flush=True)
    return n_ok


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="On-the-fly composition bench of a WSJ-order task.")
    ap.add_argument("--words", type=int, default=20000)
    ap.add_argument("--bigrams", type=int, default=1_500_000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--beam", type=float, default=85.0)
    ap.add_argument("--end-beam", type=float, default=60.0)
    ap.add_argument("--maxhyps", type=int, default=800)
    ap.add_argument("--batches", type=str, default="8")
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--E", type=int, default=8192)
    ap.add_argument("--pushing", action="store_true", help="label-and-weight pushing mode")
    ap.add_argument("--parity", type=int, default=2,
                    help="RefOtfDecoder parity on N held-out short utts")
    ap.add_argument("--no-bench", action="store_true")
    ap.add_argument("--no-tune", action="store_true",
                    help="use --K/--E as the exact budgets (certified elsewhere; the "
                         "accuracy loop still counts overflow)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..ops.gmm import make_gmm_scorer

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cache = default_cache(args.words)
    # the task's files and models (its static CLG is read, not decoded)
    net, models = ensure_task(cache, args.words, args.bigrams)
    cl_net, lexicon = ensure_cl(cache)
    print(f"[cl] {cl_net.n_states} states {cl_net.n_arcs} arcs (static CLG: {net.n_arcs} "
          f"arcs)", flush=True)
    g_net = build_g(cache, lexicon)
    t0 = time.time()
    art = DecoderArtifact(cl_net, models)
    print(f"[artifact] {art} ({time.time() - t0:.1f}s)", flush=True)

    utts = wsj_task.sample_utterances(cache, models, n_utts=args.batch,
                                      target_frames=args.frames, seed=args.seed)
    par_utts = wsj_task.sample_utterances(cache, models, n_utts=max(args.parity, 1),
                                          target_frames=150, seed=args.seed + 1)
    scorer = make_gmm_scorer(models.flat_params(), device=device)
    scores = score_utterances(scorer, utts, device)
    par_scores = score_utterances(scorer, par_utts[:args.parity], device)
    print(f"[utts] {len(utts)} utterances, T={[int(s.shape[0]) for s in scores]}", flush=True)

    base = TorchDecoderConfig(
        emit_prune_win=args.beam, phone_end_prune_win=args.end_beam,
        word_prune_win=args.end_beam, max_emit_hyps=args.maxhyps,
        max_insts=args.K, expand_budget=args.E, final_budget=1024, otf_pushing=args.pushing)
    tuned = tune(art, scores, base, g_net, device, args.no_tune)
    dec, _, ed, route = decode_batch(art, tuned, g_net, utts, scores, cache, device)
    if args.parity:
        parity(dec, cl_net, g_net, models, par_scores)

    if not args.no_bench:
        card = card_line(device)
        bench = steady_bench(art, tuned, pad_batch(scores),
                             [int(x) for x in args.batches.split(",")], g_network=g_net,
                             device=device)
        for Bs, rec in bench.items():
            print(f"[bench] B={Bs}: {rec['fps']:.0f} f/s = {rec['fps'] / 100:.1f}x RT (first "
                  f"wave {rec['compile_s']}s, overflow {rec['overflow']}/{Bs}) | {card}",
                  flush=True)
        best = max((r["fps"] for r in bench.values() if r["overflow"] == 0), default=0.0)
        print(json.dumps({
            "metric": "wsj_otf_frames_per_sec_chip", "value": best,
            "cl_arcs": int(cl_net.n_arcs), "g_states": int(g_net.n_states),
            "K": tuned.max_insts, "E": tuned.expand_budget,
            "accuracy": round(ed.accuracy, 4), "pushing": args.pushing,
            "xRT": round(best / 100, 1), "route": route, "device": card,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
