"""Entry points of the port: one step on one device, and the batch decode
over a mesh.

The counterpart of the repo root's `__graft_entry__.py`:

  entry(device)       -> (fn, example_args): the per-utterance forward
                         step on a synthetic midsize task (30 words, 16
                         phones, D=20, T=50): `fn(features)` scores the
                         features with the GMM scorer (on the card the
                         `gmm_logsumexp` kernel) and decodes them on the
                         decoder's device route (on the card one launch of
                         the `frame_step` kernel: K=256 / E=1024 fits a
                         block), and returns the best final score.
  dryrun_multichip(n) -> the full batch decode split data-parallel over a
                         mesh of n devices (`parallel.mesh.BatchDecoder`:
                         one replica of the decoder a device, the tables
                         shared per device) on synthesised utterances,
                         checked equal to the single-device decode word
                         for word on the plain and the fused route; the
                         mean of the per-utterance best final scores
                         gathered over the replicas; and a decoder at
                         WSJ-order budgets (K=2048, E=4096, maxHyps 8000:
                         past a block's shared memory, so the kernel keeps
                         its search state in device memory) split the same
                         way. It returns what it checked.

The JAX version shards with `shard_map` over `jax.sharding.Mesh`; here a
mesh is a tuple of torch devices (`make_mesh`, or any tuple with a device
repeated: on one card the replicas share it).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import resolve_device
from .decoder.core import TorchDecoder, TorchDecoderConfig
from .decoder.fused_scan import device_wave, route_of
from .ops.gmm import make_gmm_scorer
from .parallel.mesh import BatchDecoder, make_mesh, shares
from .utils.synth import make_synth_task

SCORE_TOL = 1e-3  # the JAX dryrun's own check of a score


def _build(n_words, n_phones, vec_size, K, E, device, seed=0):
    task = make_synth_task(n_words=n_words, n_phones=n_phones, vec_size=vec_size, seed=seed)
    dec = TorchDecoder(task.artifact,
                       TorchDecoderConfig(max_insts=K, expand_budget=E, final_budget=256),
                       device=device)
    return task, dec


def entry(device="cuda"):
    """(fn, example_args): `fn(features)` is the (T, 20) features' best
    final score after scoring and decoding them on `device`; the example
    is T=50 frames of zeros."""
    device = resolve_device(device)
    task, dec = _build(n_words=30, n_phones=16, vec_size=20, K=256, E=1024, device=device)
    scorer = make_gmm_scorer(task.models.flat_params(), device=device)

    def fn(features):
        return device_wave(dec, scorer(features)[None])()["best_final"]["score"][0]

    T = 50
    example = (torch.zeros((T, task.vec_size), dtype=torch.float32, device=device),)
    return fn, example


def _check(results, truth, tag):
    for i, r in enumerate(results):
        t = truth[i % len(truth)]
        if r.words != t.words:
            raise AssertionError(f"dryrun[{tag}]: utt {i} words {r.words} != single-device "
                                 f"{t.words}")
        if not abs(r.score - t.score) < SCORE_TOL:
            raise AssertionError(f"dryrun[{tag}]: utt {i} score {r.score} != {t.score}")


def _pad_to(f, T):
    """The first T frames of `f`, its last frame repeated up to T."""
    return np.concatenate([f, np.tile(f[-1:], (max(0, T - len(f)), 1))])[:T]


def dryrun_multichip(n_devices: int, device="cuda", mesh=None) -> dict:
    """The batch of 8 x n_devices utterances decoded over `mesh` (default
    `make_mesh(n_devices, device)`) and checked; raises AssertionError on
    a difference. Returns {"mesh", "features", "lengths", "truth", "plain",
    "fused", "mean_best_final", "big_K", "big_E", "big_truth", "big",
    "routes"}."""
    device = resolve_device(device)
    mesh = make_mesh(n_devices, device.type) if mesh is None else tuple(mesh)
    task, dec = _build(n_words=12, n_phones=8, vec_size=8, K=128, E=256, device=device)
    scorer = make_gmm_scorer(task.models.flat_params(), device=device)

    # ---- synthesised utterances, 4 distinct, edge-padded to T ------------
    rng = np.random.default_rng(0)
    B, T, n_distinct = 8 * n_devices, 40, 4
    words = [f"w{i}" for i in range(12)]
    distinct = []
    for _ in range(n_distinct):
        seq = [words[rng.integers(12)] for _ in range(2)]
        distinct.append(task.synth_utterance(seq, rng)[:T])
    lengths = [distinct[i % n_distinct].shape[0] for i in range(B)]
    feats = np.stack([_pad_to(distinct[i % n_distinct], T) for i in range(B)])
    scores = scorer(torch.as_tensor(feats.reshape(B * T, -1), device=device)).view(B, T, -1)

    # single-device ground truth, one distinct utterance at a time
    _, fused = route_of(dec)
    truth = [dec.decode_scores(scores[i, :lengths[i]], use_fused=fused)
             for i in range(n_distinct)]
    for r in truth:
        if not r.words:
            raise AssertionError("dryrun: single-device decode produced no words")

    # ---- 1. the plain route, 2. the fused route, over the mesh -----------
    out = {"mesh": mesh, "features": feats, "lengths": lengths, "truth": truth, "routes": {}}
    for tag, use_fused in (("plain", False), ("fused", True)):
        res = BatchDecoder(dec, mesh=mesh, use_fused=use_fused).decode_scores_batch(
            scores, lengths)
        _check(res, truth, tag)
        out[tag] = res
        out["routes"][tag] = "frame_step" if use_fused else "plain loop"

    # ---- 3. the best final scores gathered over the replicas -------------
    bd = BatchDecoder(dec, mesh=mesh, use_fused=True)
    finals = []
    for d, (lo, hi) in zip(bd.mesh, shares(B, len(bd.mesh))):
        if hi > lo:
            rep = bd.replicas[d]
            wave = device_wave(rep, rep.scores_tensor(scores[lo:hi]))
            finals.append(wave()["best_final"]["score"])
    out["mean_best_final"] = float(torch.cat([f.to(mesh[0]) for f in finals]).mean())

    # ---- 4. a decoder at WSJ-order budgets over the mesh -----------------
    task2 = make_synth_task(n_words=1500, n_phones=30, vec_size=8, seed=1)
    dec_big = TorchDecoder(task2.artifact, TorchDecoderConfig(
        max_insts=2048, expand_budget=4096, final_budget=256, max_emit_hyps=8000,
        emit_prune_win=200.0), device=device)
    if not (dec_big.K >= 2048 and dec_big.E >= 4096):
        raise AssertionError(f"dryrun: budgets clamped to K={dec_big.K} E={dec_big.E}")
    scorer2 = make_gmm_scorer(task2.models.flat_params(), device=device)
    Tb = 16
    f2 = np.stack([_pad_to(task2.synth_utterance(
        [f"w{rng.integers(400)}" for _ in range(2)], rng), Tb) for _ in range(n_devices)])
    big_scores = scorer2(torch.as_tensor(f2.reshape(n_devices * Tb, -1), device=device)
                         ).view(n_devices, Tb, -1)
    big_route, big_fused = route_of(dec_big)
    big_truth = [dec_big.decode_scores(big_scores[i], use_fused=big_fused)
                 for i in range(min(2, n_devices))]
    big = BatchDecoder(dec_big, mesh=mesh, use_fused=big_fused).decode_scores_batch(
        big_scores, [Tb] * n_devices)
    _check(big[:len(big_truth)], big_truth, "wsj-budget")
    out.update(big_K=dec_big.K, big_E=dec_big.E, big_truth=big_truth, big=big,
               big_features=f2)
    out["routes"]["wsj-budget"] = big_route
    print(f"dryrun_multichip({n_devices}): ok - {B} utts over {len(mesh)} replicas "
          f"({', '.join(str(d) for d in mesh)}), plain and fused routes equal the "
          f"single-device decode word for word; mean final score "
          f"{out['mean_best_final']:.3f}; WSJ-order budgets (K={dec_big.K}, E={dec_big.E}, "
          f"binned histogram maxHyps=8000, {big_route}) split over the mesh with per-share "
          f"result equality", flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    n = int(next((a for a in argv if a != "--cpu"), 1))
    fn, args = entry(device)
    print(f"entry: best final score {float(fn(*args)):.3f} on {device}", flush=True)
    dryrun_multichip(n, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
