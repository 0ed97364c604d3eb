"""Chip smoke of the PyTorch/CUDA port: the main decode path on one card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every CUDA kernel of `juicer_tpu_torch/csrc/`, one nvcc each,
     in parallel, with the build time and ptxas report;
  3. GMM kernel vs plain: the hand-written kernel against the plain
     PyTorch scorer `gmm_scores_dense` on the card, at the shapes of the
     decode wave below (16 utterances x the longest length, D=39, 141
     GMMs, 8 components), atol 1e-3 on scores of magnitude ~1e2; kernel,
     plain and library-call (matmul + logsumexp) times over CUDA events,
     and the kernel's bound (the larger of its float32 operations over the
     card's CUDA-core peak and its bytes over the memory rate);
  4. decode: the 2k-word WSJ-order task (`scripts/_wsj_cache_2k`, its
     artifact built on first use) at the reference bench's operating
     point (beam 70 / end-beam 50 / maxHyps 500, K=1024, E=1408), 8
     sampled utterances of ~1000 frames tiled to a batch of 16, features
     scored by the kernel and decoded on the card. Certified in-run:
     overflow 0/16, dead 0/16, and the traced-back words equal each
     utterance's generating transcript. Launch counts are zeroed just
     before this main path and read just after it. Then frames/s over one
     timed wave after a warm-up wave (diagnostics off, as the bench runs).
     Parity: a short whole sentence (300 frames, sampled with seed 12; a
     cut utterance reaches no final state) decodes on the card and with
     device="cpu" from the same scores (words, word-end frames and the
     traceback record arrays equal), and from the plain CPU scorer's
     scores (words and word-end frames equal, records reported); its
     words must equal its transcript;
  5. result: a `kernels` JSON line, the card line, and last
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores
# (no tensor cores), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
GMM_ATOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from juicer_tpu_torch import _cuda_build
        from juicer_tpu_torch.decoder.core import TorchDecoder, host_batch
        from juicer_tpu_torch.harness import wsj_task
        from juicer_tpu_torch.ops import gmm_cuda
        from juicer_tpu_torch.ops.gmm import gmm_scores_dense, make_gmm_scorer
        from juicer_tpu_torch.parallel.batch import BatchDecoder
    except ImportError as e:
        print(f"chip_smoke: the juicer_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3

    # ---- 1. card ------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind} | devices {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = _cuda_build.build_all()
    print(f"[build] {len(_cuda_build.SOURCES)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # ---- task and the main path's inputs --------------------------------
    task = wsj_task.load_task("2k")
    p = wsj_task.WSJ_POINT
    models = task.models
    params = models.flat_params()
    G, D = params.n_gmms, params.vec_size
    utts = wsj_task.sample_utterances(task.cache, models, n_utts=p["n_utts"],
                                      target_frames=p["frames"], seed=11)
    lengths_u = [f.shape[0] for _, f in utts]
    Tmax = max(lengths_u)
    B = p["batch"]
    feats = torch.stack([
        torch.as_tensor(f).index_select(
            0, torch.arange(Tmax).clamp(max=f.shape[0] - 1))
        for _, f in (utts[i % len(utts)] for i in range(B))
    ]).to(dev)  # (B, Tmax, D), edge-padded like the bench
    lengths = [lengths_u[i % len(utts)] for i in range(B)]
    print(f"[task] {len(utts)} utterances T={lengths_u}, batch {B} x {Tmax}",
          flush=True)

    # ---- 3. GMM kernel vs plain ------------------------------------------
    scorer = make_gmm_scorer(params, device="cuda")
    x = feats.reshape(B * Tmax, D).contiguous()
    T = x.shape[0]
    ker = gmm_cuda.gmm_logsumexp(x, scorer.W, scorer.b_packed, G)
    plain = gmm_scores_dense(x, scorer.V, scorer.M, scorer.b, scorer.mask)
    torch.cuda.synchronize()
    if not torch.isfinite(ker).all():
        raise RuntimeError("gmm_logsumexp produced non-finite scores")
    err = float((ker - plain).abs().max())
    mag = float(plain.abs().max())
    C = scorer.W.shape[0]
    G_pad = scorer.W.shape[2]
    W_lib = scorer.W.permute(1, 0, 2).reshape(2 * D, C * G_pad).contiguous()

    def library():
        x2 = torch.cat([x * x, x], dim=1)
        return torch.logsumexp(
            (x2 @ W_lib).view(T, C, G_pad) + scorer.b_packed[None], dim=1)

    lib_err = float((library()[:, :G] - plain).abs().max())
    print(f"[gmm] kernel vs plain max |err| {err:.3e} (atol {GMM_ATOL}, "
          f"|score| up to {mag:.1f}); library vs plain {lib_err:.3e}", flush=True)
    if not err <= GMM_ATOL:
        raise RuntimeError(f"gmm_logsumexp disagrees with gmm_scores_dense: {err}")
    n0 = gmm_cuda.counter.launches
    ms = cuda_ms(lambda: gmm_cuda.gmm_logsumexp(x, scorer.W, scorer.b_packed, G), 20)
    if gmm_cuda.counter.launches - n0 != 21:
        raise RuntimeError("gmm_logsumexp launch counter did not count its launches")
    plain_ms = cuda_ms(lambda: gmm_scores_dense(x, scorer.V, scorer.M, scorer.b, scorer.mask), 20)
    library_ms = cuda_ms(library, 20)
    flops = 2.0 * T * G * C * 2 * D
    nbytes = 4.0 * (x.numel() + scorer.W.numel() + scorer.b_packed.numel() + T * G)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"[gmm] T={T} D={D} G={G} C={C}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB) | {card}", flush=True)

    # ---- 4. decode: the main path ------------------------------------------
    art = task.artifact
    cfg = wsj_task.decoder_config(p, emit_diagnostics=True)
    dec = TorchDecoder(art, cfg, device="cuda")
    fast = TorchDecoder(art, wsj_task.decoder_config(p, emit_diagnostics=False),
                        device="cuda")
    labels, markers = wsj_task.word_labels(task.cache)
    print(f"[decode] K={dec.K} E={dec.E} F={dec.F}, beams {p['beam']}/"
          f"{p['end_beam']}/{p['maxhyps']}", flush=True)

    def wave(decoder):
        scores = scorer(x).view(B, Tmax, G)
        return decoder.run(scores)

    gmm_cuda.counter.launches = 0
    # certification wave: diagnostics on, traceback of every utterance
    t0 = time.perf_counter()
    scores = scorer(x).view(B, Tmax, G)
    results = BatchDecoder(dec).decode_scores_batch(scores, lengths)
    t_cert = time.perf_counter() - t0
    # bench waves: diagnostics off; warm-up, then one timed wave
    carry, _, _ = wave(fast)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _, _ = wave(fast)
    torch.cuda.synchronize()
    t_wave = time.perf_counter() - t0
    launches = gmm_cuda.counter.launches
    if launches == 0:
        raise RuntimeError("the main path did not launch gmm_logsumexp")

    n_ov = sum(r.overflow for r in results) + int(carry["overflow"].sum())
    dead = sum(r.empty for r in results) + int(
        (carry["best_final"]["score"] <= -0.5e30).sum())
    wrong = []
    for i, r in enumerate(results):
        hyp = [w for w in r.words if w not in markers]
        ref = [labels[w] for w in utts[i % len(utts)][0]]
        if hyp != ref:
            wrong.append(i)
    print(f"[decode] certification wave ({t_cert:.2f}s incl. traceback): "
          f"overflow {n_ov}/{2 * B}, dead {dead}/{2 * B}, transcript "
          f"mismatches {wrong}; peak active {max(r.max_active for r in results)}, "
          f"peak candidates {max(r.max_cand for r in results)}", flush=True)
    if n_ov or dead or wrong:
        raise RuntimeError("certification failed at the operating point")
    fps = B * Tmax / t_wave
    print(f"[decode] timed wave: {B} x {Tmax} frames in {t_wave:.3f}s = "
          f"{fps:.1f} frames/s (GMM kernel + frame loop, diagnostics off) | "
          f"{card}", flush=True)

    # ---- card vs CPU parity on one short utterance -----------------------
    # a whole sentence: a cut one reaches no final state and has no words
    words_s, xs = wsj_task.sample_utterances(
        task.cache, models, n_utts=2, target_frames=250, seed=12)[1]
    xs = torch.as_tensor(xs)
    sc_card = scorer(xs.to(dev))
    cpu_dec = TorchDecoder(art, cfg, device="cpu")
    cpu_scorer = make_gmm_scorer(params, device="cpu")

    def decode_records(decoder, scores):
        host = host_batch(*decoder.run(scores[None]))
        return decoder.traceback(host, 0, scores.shape[0]), host[1]

    r_card, ys_card = decode_records(dec, sc_card)
    r_cpu, ys_cpu = decode_records(cpu_dec, sc_card.cpu())
    r_plain, ys_plain = decode_records(cpu_dec, cpu_scorer(xs))

    def frames(r):
        return [h.end_frame for h in r.word_hyps]

    rec_names = ("rec_prev", "rec_seq", "rec_src", "rec_arc")
    same_rec = all((ys_card[k] == ys_cpu[k]).all() for k in rec_names)
    plain_rec = all((ys_card[k] == ys_plain[k]).all() for k in rec_names)
    transcript = [labels[w] for w in words_s]
    ok_words = [w for w in r_card.words if w not in markers] == transcript
    print(f"[parity] {xs.shape[0]} frames, {len(r_card.words)} words (transcript "
          f"{ok_words}): card vs "
          f"cpu (same scores) words {r_card.words == r_cpu.words}, frames "
          f"{frames(r_card) == frames(r_cpu)}, records {same_rec}; card vs cpu "
          f"plain scorer words {r_card.words == r_plain.words}, frames "
          f"{frames(r_card) == frames(r_plain)}, records {plain_rec}, "
          f"score diff {abs(r_card.score - r_plain.score):.2e}", flush=True)
    if not (ok_words and r_card.words == r_cpu.words
            and frames(r_card) == frames(r_cpu) and same_rec
            and r_card.words == r_plain.words
            and frames(r_card) == frames(r_plain)):
        raise RuntimeError("card and CPU decodes disagree")

    # ---- 5. result ------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "gmm_logsumexp", "route": "cuda",
        "source": "juicer_tpu_torch/csrc/gmm_logsumexp.cu",
        "replaces": "juicer_tpu/ops/gmm_pallas.py:29",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
