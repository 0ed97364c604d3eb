"""On-the-fly composition throughput on a word-loop task, on the card.

The counterpart of the JAX package's `scripts/bench_otf.py`: the synthetic
word-loop task of `utils/synth.py` (diagonal-GMM HMMs), whose CL = C o
closure(L) is searched with the word-loop G intersected during the search,
decoded with and without label-and-weight pushing. Each bench scores the
(B, T) feature batch (one GMM launch on the card) and decodes it with
diagnostics off, once, then `iters` times over the host clock; then it
certifies each distinct utterance with a diagnostics decode (no overflow,
words found).

No kernel covers a decoder with a G (`why_not_fused` names it), so the
frame loop is the plain one, and the route line says why.

Run as

    python -m juicer_tpu_torch.harness.bench_otf [--quick] [--cpu]

on the card (`--cpu`: on the CPU). `--quick`: 30 words, 16 phones,
20-dim features, B=8, T=128, 2 timed runs; else 200 words, 40 phones,
39 dims, B=128, T=1000, 5 runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..compile import CDGen, CDPhoneLookup, CDType, GramGen, GramType, LexGen
from ..decoder.artifact import DecoderArtifact
from ..decoder.core import TorchDecoder, TorchDecoderConfig
from ..decoder.fused_scan import route_of
from ..decoder.network import DecoderNetwork
from ..decoder.otf import GNetwork
from ..fst import algos
from ..utils import synth
from . import card_line
from .wsj_bench import synchronize

QUICK = dict(n_words=30, n_phones=16, vec=20, B=8, T=128, iters=2)
FULL = dict(n_words=200, n_phones=40, vec=39, B=128, T=1000, iters=5)
BEAMS = dict(emit_prune_win=150.0, phone_end_prune_win=75.0)
BUDGETS = dict(max_insts=256, expand_budget=512, final_budget=128)


def build(n_words, n_phones, vec):
    """(synth task, CL network, word-loop GNetwork)."""
    task = synth.make_synth_task(n_words=n_words, n_phones=n_phones, vec_size=vec, n_comps=8,
                                 seed=0)
    lex = task.lexicon
    G = GramGen(lex.vocab, GramType.WORDLOOP).build()
    lg = LexGen(lex)
    L = lg.build(output_aux_phones=True)
    phones = list(lex.phone_set.phones)
    lookup = CDPhoneLookup(lex.phone_set)
    lookup.add_phones(phones)
    lookup.bind_models(phones)
    C = CDGen(CDType.MONOPHONE, lookup, phones, n_aux_syms=lg.n_aux).build()
    cl = algos.compose(C, algos.closure(algos.arcsort(L)))
    cl.isyms, cl.osyms = C.isyms, L.osyms
    cl_net = DecoderNetwork(cl, C.isyms, L.osyms, remove_aux="input")
    return task, cl_net, GNetwork(G)


def features(task, n_words, B, T):
    """(the distinct utterances, (B, T, D) batch tiling them): up to four
    word sequences of max(2, T // 60) words from seed 1, each cut or
    edge-padded to T frames."""
    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(n_words)]
    distinct = []
    for _ in range(min(B, 4)):
        seq = [words[rng.integers(n_words)] for _ in range(max(2, T // 60))]
        f = task.synth_utterance(seq, rng)
        f = f[:T] if f.shape[0] >= T else np.concatenate(
            [f, np.tile(f[-1:], (T - f.shape[0], 1))])
        distinct.append(f)
    return distinct, np.stack([distinct[i % len(distinct)] for i in range(B)])


def bench(dec, name, scorer, feats, distinct, iters):
    """Frames/s of `dec` (diagnostics off) on the batch, scores included,
    and the certification of each distinct utterance. Returns (fps,
    certified, [diagnostics result of each distinct utterance])."""
    B, T, D = feats.shape
    _, fused = route_of(dec)

    def step():
        scores = scorer(feats.reshape(B * T, D)).view(B, T, -1)
        return dec.run(scores)[0]["best_final"]["score"]

    t0 = time.perf_counter()
    step()
    synchronize(dec.device)
    print(f"{name}: first run {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    synchronize(dec.device)
    dt = time.perf_counter() - t0
    fps = B * T * iters / dt
    print(f"{name}: {fps:,.0f} frames/s ({dt / iters * 1e3:.1f} ms/iter)", flush=True)
    diag = TorchDecoder(dec.art, dataclasses.replace(dec.cfg, emit_diagnostics=True),
                        device=dec.device, g_network=dec.g)
    results, certified = [], True
    for f in distinct:
        r = diag.decode_scores(scorer(torch.as_tensor(f, device=dec.device)), use_fused=fused)
        results.append(r)
        if r.overflow or not r.words:
            print(f"{name}: WARNING budget overflow/empty (peak {r.max_active}/{r.max_cand})",
                  flush=True)
            certified = False
            break
    return fps, certified, results


def run(quick=False, device="cuda") -> dict:
    """Both benches; returns {name: (fps, certified, results)} and the
    route under "route"."""
    from ..ops.gmm import make_gmm_scorer

    device = resolve_device(device)
    p = QUICK if quick else FULL
    task, cl_net, g_net = build(p["n_words"], p["n_phones"], p["vec"])
    art = DecoderArtifact(cl_net, task.models)
    scorer = make_gmm_scorer(task.models.flat_params(), device=device)
    distinct, batch = features(task, p["n_words"], p["B"], p["T"])
    feats = torch.as_tensor(batch, device=device)
    card = card_line(device)
    out = {}
    for name, pushing in (("otf          ", False), ("otf (pushing)", True)):
        cfg = TorchDecoderConfig(otf_pushing=pushing, emit_diagnostics=False, **BUDGETS,
                                 **BEAMS)
        dec = TorchDecoder(art, cfg, device=device, g_network=g_net)
        out["route"] = route_of(dec)[0]
        print(f"{name}: route {out['route']} | {card}", flush=True)
        out[name.strip()] = bench(dec, name, scorer, feats, distinct, p["iters"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-the-fly composition throughput, word loop.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    run(args.quick, "cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
