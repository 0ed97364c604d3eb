"""Several processes decoding one corpus, its statistics summed by a
collective.

Counterpart of `scripts/multihost_demo.py`. The reference scaled by
manual cluster job splitting (`juicer_userman.tex:584`); here each of n
processes builds the same replicated task, decodes its round-robin share
of the corpus (utterances rank, rank + n, ...) as one `BatchDecoder` batch
on its device, prints one `WORKER_RESULT` line an utterance, and sums
[words, frames, utterances] over the ranks with `torch.distributed`'s
`all_reduce`.

The process group is `gloo` only: the collective carries three integers
a rank, `gloo` serves CPU and CUDA decoders alike, and NCCL refuses two
ranks on one device, so an NCCL path could not run on a one-card host.
On CUDA, rank i decodes on card i modulo the visible cards.

Tasks: "synth", the synthetic task of `utils.synth` (12 words, 8 phones,
8-dim features, seed 0) with a seeded corpus of two-word sentences;
"2k", the WSJ-order 2k-word task from the artifact cache
(`harness.wsj_task.load_task`) with the utterances that seed 11 samples
at `WSJ_POINT`.

Usage:   python -m juicer_tpu_torch.parallel.multihost_demo [n] [--task synth|2k]
             [--device cuda|cpu] [--timeout SECONDS]
Worker:  python -m juicer_tpu_torch.parallel.multihost_demo --worker RANK N PORT ...
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

MODULE = "juicer_tpu_torch.parallel.multihost_demo"
# the synthetic task and its decoder budgets (those of the JAX package's
# `__graft_entry__.dryrun_multichip`), and its corpus
SYNTH = dict(n_words=12, n_phones=8, vec_size=8, seed=0)
SYNTH_BUDGETS = dict(max_insts=128, expand_budget=256, final_budget=256)
SYNTH_UTTS, SYNTH_WORDS, SYNTH_SEED = 6, 2, 0


def free_port():
    """A free TCP port on the loopback interface, or None where binding
    is refused."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    except OSError:
        return None
    finally:
        s.close()


def synth_corpus(task, n_utts=SYNTH_UTTS, n_words=SYNTH_WORDS, seed=SYNTH_SEED):
    """[(word sequence, (T, D) float32 features)] sampled from the synth
    task's models with one seeded generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(task.lexicon.vocab.n_words)]
    corpus = []
    for _ in range(n_utts):
        seq = [words[rng.integers(len(words))] for _ in range(n_words)]
        corpus.append((seq, task.synth_utterance(seq, rng)))
    return corpus


def build_task(name: str, device):
    """(decoder, GMM scorer, [(words, features)]) of a task, the same in
    every process."""
    from ..decoder.core import TorchDecoder, TorchDecoderConfig
    from ..ops.gmm import GmmScorer

    if name == "synth":
        from ..utils.synth import make_synth_task

        task = make_synth_task(**SYNTH)
        dec = TorchDecoder(task.artifact, TorchDecoderConfig(**SYNTH_BUDGETS), device=device)
        return dec, GmmScorer(task.models.flat_params(), device), synth_corpus(task)
    if name == "2k":
        from ..harness import wsj_task

        task = wsj_task.load_task("2k", verbose=False)
        p = wsj_task.WSJ_POINT
        utts = wsj_task.sample_utterances(task.cache, task.models, n_utts=p["n_utts"],
                                          target_frames=p["frames"], seed=11)
        dec = TorchDecoder(task.artifact, wsj_task.decoder_config(p), device=device)
        return dec, GmmScorer(task.models.flat_params(), device), utts
    raise ValueError(f"unknown task {name!r}")


def decode_share(dec, scorer, feats):
    """DecodeResults of a list of (T, D) features, decoded as one padded
    batch (the last frame repeated) on the decoder's device."""
    import torch

    from .mesh import BatchDecoder

    lengths = [f.shape[0] for f in feats]
    T = max(lengths)
    x = torch.stack([
        torch.as_tensor(f)[torch.arange(T).clamp(max=f.shape[0] - 1)] for f in feats
    ]).to(dec.device)
    scores = scorer(x.reshape(len(feats) * T, -1)).view(len(feats), T, -1)
    return BatchDecoder(dec).decode_scores_batch(scores, lengths)


def worker(rank: int, n: int, port: int, task: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    from ..decoder import fused_scan
    from ..ops import gmm_cuda

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n)
    try:
        if device == "cuda":
            from .. import resolve_device

            resolve_device("cuda")  # raises without a card
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            dev = torch.device(device)
        dec, scorer, corpus = build_task(task, dev)
        mine = list(range(rank, len(corpus), n))
        t0 = time.perf_counter()
        results = decode_share(dec, scorer, [corpus[u][1] for u in mine]) if mine else []
        seconds = time.perf_counter() - t0
        n_words = n_frames = 0
        for u, res in zip(mine, results):
            n_words += len(res.words)
            n_frames += res.n_frames
            print("WORKER_RESULT " + json.dumps(
                {"utt": u, "words": list(res.words), "score": float(res.score),
                 "end_frames": [h.end_frame for h in res.word_hyps],
                 "n_frames": res.n_frames, "overflow": bool(res.overflow)}), flush=True)
        totals = torch.tensor([n_words, n_frames, len(mine)], dtype=torch.int64)
        dist.all_reduce(totals)
        w, f, u = (int(v) for v in totals)
        print("WORKER_AGG " + json.dumps(
            {"rank": rank, "device": str(dev), "words": w, "frames": f, "utts": u,
             "decode_s": seconds,
             "launches": {"gmm_logsumexp": gmm_cuda.counter.launches,
                          "frame_step": fused_scan.counter.launches}}), flush=True)
        if rank == 0:
            print(f"MULTIHOST OK: {n} processes, {u} utterances, {w} words, {f} frames total",
                  flush=True)
    finally:
        dist.destroy_process_group()


def launch(n: int, task: str = "synth", device: str = "cuda",
           timeout: float = 600.0) -> list[tuple[int, str, str]]:
    """Run n workers and wait for all of them: [(exit code, stdout,
    stderr)] in rank order. Each worker runs one torch thread. Raises
    TimeoutError, after killing every worker, if any runs past
    `timeout` seconds."""
    port = free_port()
    if port is None:
        raise OSError("no loopback port can be bound")
    # the workers import this package from the checkout it lies in
    path = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if os.environ.get("PYTHONPATH"):
        path += os.pathsep + os.environ["PYTHONPATH"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path)
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE, "--worker", str(i), str(n), str(port),
         "--task", task, "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(n)]
    outs = [None] * n

    def collect(i):  # every pipe is drained at once: no worker blocks on a full one
        outs[i] = procs[i].communicate()

    threads = [threading.Thread(target=collect, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        for p in procs:
            p.kill()
        for t in threads:
            t.join()
        raise TimeoutError(f"{n} workers still running after {timeout} s")
    return [(p.returncode, *outs[i]) for i, p in enumerate(procs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=MODULE, description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=2, help="processes (default 2)")
    ap.add_argument("--task", choices=("synth", "2k"), default="synth")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", nargs=3, type=int, metavar=("RANK", "N", "PORT"))
    args = ap.parse_args(argv)
    if args.worker:
        worker(*args.worker, args.task, args.device)
        return 0
    t0 = time.perf_counter()
    try:
        outs = launch(args.n, args.task, args.device, args.timeout)
    except (OSError, TimeoutError) as e:
        print(f"multihost_demo: {e}", file=sys.stderr)
        return 1
    for rc, out, err in outs:
        sys.stdout.write(out)
        sys.stderr.write(err)
    print(f"seconds: {time.perf_counter() - t0:.3f} ({args.n} processes, task "
          f"{args.task}, device {args.device})", flush=True)
    return int(any(rc != 0 for rc, _, _ in outs))


if __name__ == "__main__":
    sys.exit(main())
