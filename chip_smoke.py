"""Chip smoke of the PyTorch/CUDA port: the main decode path on one card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every CUDA kernel of `juicer_tpu_torch/csrc/`, one nvcc each,
     in parallel, with the build time and ptxas report;
  3. GMM kernel vs plain: the hand-written kernel against the plain
     PyTorch scorer `gmm_scores_dense` on the card, at the shapes of both
     decode waves below (16 and 132 utterances x the longest length,
     T = 23,328 and 192,456; D=39, 141 GMMs, 8 components), atol 1e-3 on
     scores of magnitude ~1e2; at each: kernel, plain and library-call
     (one matmul of [x^2 | x] with [V; M] + logsumexp) times over CUDA
     events, the kernel's bound (the larger of its float32 operations over
     the card's CUDA-core peak and its bytes over the memory rate) and the
     share of the bound it reaches;
  4. plain decode, the reference run: the 2k-word WSJ-order task
     (`scripts/_wsj_cache_2k`, its artifact built on first use) at the
     reference bench's operating point (beam 70 / end-beam 50 / maxHyps
     500, K=1024, E=1408), 8 sampled utterances of ~1000 frames tiled to a
     batch of 16, scored by the GMM kernel and decoded by the plain frame
     loop `TorchDecoder.run` (diagnostics on, the GMM kernel's launches
     counted around it; then one timed wave with diagnostics off, as the
     bench runs, without a further warm-up).
     Certified in-run: overflow 0/16, dead 0/16, and the traced-back
     words equal each utterance's generating transcript;
  5. frame-step kernel vs plain: the fused scan on the same (T, B, G)
     scores as the plain reference wave. The kernel hands back compact
     records (only those that landed, in (frame, slot) order, and the
     running count per frame): they equal `compact_records` of the plain
     planes, `expand_records` of them equals the plain planes, and the
     eight snapshots, the carry (`norm`, overflow, frontier) and the
     traced-back words and word-end frames are equal bit for bit, at the
     full-width wave; the same with `max_emit_hyps=0` (the TPU kernel's
     scope) on a short sentence, in one launch and in two calls with the
     carried state. The first differing field, frame, utterance and slot
     are printed on failure. Also printed: records landed per frame and
     utterance (mean, peak) and the bytes a wave copies to the host;
  6. the main path through the kernels: launch counts of both kernels are
     zeroed just before and read just after `BatchDecoder(dec)` (default
     `use_fused="auto"`) decodes the batch twice (features -> GMM kernel ->
     frame-step kernel, one launch per wave -> copy to the host ->
     traceback): the first call is certified as in 4, the second is timed,
     and its frames/s stand beside the plain loop's. Then, outside the
     counted run, the device's share of a wave (both kernels, no copy to
     the host and no traceback), the frame-step kernel's time per wave
     over CUDA events and its bound (the bytes it must move, counted from
     the shapes and the wave's measured candidates and active slots, over
     the memory rate), for the compact contract and, as the earlier
     row, for dense record planes;
  6b. a card full of utterances: the same 8 utterances tiled to B=132 (one
     block on every SM), launch counts zeroed before and read after one
     certified and one timed wave through `BatchDecoder`; every
     utterance's words, word-end frames and score must equal the B=16
     wave's; the kernel's ms a wave, the device-only and the entry
     point's frames/s at B=132 beside those at B=16, and the device wave
     over CUDA events beside its parts (GMM kernel, the scores' transpose
     to (T, B, G), frame-step kernel);
  7. parity: a short whole sentence (300 frames, sampled with seed 12; a
     cut utterance reaches no final state) decodes on the card and with
     device="cpu" from the same scores (words, word-end frames and the
     traceback record arrays equal), and from the plain CPU scorer's
     scores (words and word-end frames equal, records reported); its
     words must equal its transcript; `TorchDecoder.decode_scores` on the
     card gives the same result through one launch of the kernel;
  8. result: a `kernels` JSON line (both kernels), the card line, and last
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
        from juicer_tpu_torch.decoder import fused_scan
        from juicer_tpu_torch.decoder.core import TorchDecoder, host_batch
        from juicer_tpu_torch.decoder.fused_scan import (
            REC_NAMES, FusedDecodeScan, assemble_results, compact_records,
            concat_records, expand_records, state_differences)
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
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line
            # frame_step is compiled per HMM state count and for staged or
            # unstaged HMM tables; S=5, staged, is the task's
            if name == "frame_step" and "ILi5ELb1E" not in entry:
                continue
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

    # ---- 3. GMM kernel vs plain, at both waves' shapes -----------------------
    scorer = make_gmm_scorer(params, device="cuda")
    C = params.max_comps
    x = feats.reshape(B * Tmax, D).contiguous()
    B2 = 132  # phase 6b's wave: the same utterances tiled to one block an SM
    x2 = x.view(B, Tmax, D)[torch.arange(B2, device=dev) % B].reshape(B2 * Tmax, D)
    # the library yardstick: one matmul of [x^2 | x] with [V; M] and one
    # logsumexp over the components, in component-major column order
    VM = torch.cat([scorer.V, scorer.M], dim=0).view(2 * D, G, C).transpose(1, 2)
    VM = VM.reshape(2 * D, C * G)
    b_lib = torch.where(scorer.mask, scorer.b.view(G, C), -1e30).t().contiguous()

    def gmm_phase(xx, what):
        T = xx.shape[0]
        ker = gmm_cuda.gmm_logsumexp(xx, scorer.W, scorer.b_packed, G)
        plain = gmm_scores_dense(xx, scorer.V, scorer.M, scorer.b, scorer.mask)
        torch.cuda.synchronize()
        if not torch.isfinite(ker).all():
            raise RuntimeError(f"gmm_logsumexp produced non-finite scores at {what}")

        def library():
            return torch.logsumexp(
                (torch.cat([xx * xx, xx], dim=1) @ VM).view(T, C, G) + b_lib, dim=1)

        err = float((ker - plain).abs().max())
        lib_err = float((library() - plain).abs().max())
        print(f"[gmm] {what}: kernel vs plain max |err| {err:.3e} (atol {GMM_ATOL}, "
              f"|score| up to {float(plain.abs().max()):.1f}); library vs plain "
              f"{lib_err:.3e}", flush=True)
        if not err <= GMM_ATOL:
            raise RuntimeError(f"gmm_logsumexp disagrees with gmm_scores_dense at {what}: {err}")
        del ker, plain
        n0 = gmm_cuda.counter.launches
        ms = cuda_ms(lambda: gmm_cuda.gmm_logsumexp(xx, scorer.W, scorer.b_packed, G), 20)
        if gmm_cuda.counter.launches - n0 != 21:
            raise RuntimeError("gmm_logsumexp launch counter did not count its launches")
        plain_ms = cuda_ms(
            lambda: gmm_scores_dense(xx, scorer.V, scorer.M, scorer.b, scorer.mask), 20)
        library_ms = cuda_ms(library, 20)
        # the function's own work: every real (frame, GMM, component) over
        # 2D inputs; each input byte read once, each output byte written once
        flops = 2.0 * T * G * C * 2 * D
        nbytes = 4.0 * (xx.numel() + 2 * D * G * C + G * C + T * G)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[gmm] {what}: T={T} D={D} G={G} C={C}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"{100 * bound_ms / ms:.1f} % of the bound | {card}", flush=True)
        return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    gmm16 = gmm_phase(x, f"B={B}")
    gmm132 = gmm_phase(x2, f"B={B2}")

    # ---- 4. plain decode: the reference run ----------------------------------
    art = task.artifact
    cfg = wsj_task.decoder_config(p, emit_diagnostics=True)
    dec = TorchDecoder(art, cfg, device="cuda")
    fast = TorchDecoder(art, wsj_task.decoder_config(p, emit_diagnostics=False),
                        device="cuda")
    labels, markers = wsj_task.word_labels(task.cache)
    print(f"[decode] K={dec.K} E={dec.E} F={dec.F}, beams {p['beam']}/"
          f"{p['end_beam']}/{p['maxhyps']}", flush=True)

    def certify(results, what):
        B = len(results)
        n_ov = sum(r.overflow for r in results)
        dead = sum(r.empty for r in results)
        wrong = []
        for i, r in enumerate(results):
            hyp = [w for w in r.words if w not in markers]
            ref = [labels[w] for w in utts[i % len(utts)][0]]
            if hyp != ref:
                wrong.append(i)
        print(f"[{what}] overflow {n_ov}/{B}, dead {dead}/{B}, transcript mismatches "
              f"{wrong}; peak active {max(r.max_active for r in results)}, peak "
              f"candidates {max(r.max_cand for r in results)}", flush=True)
        if n_ov or dead or wrong:
            raise RuntimeError(f"{what}: certification failed at the operating point")

    def frames_of(r):
        return [h.end_frame for h in r.word_hyps]

    def require_equal(what, got, want):
        diffs = state_differences(got, want)
        for line in diffs:
            print(f"[{what}] DIFFERS {line}", flush=True)
        if diffs:
            raise RuntimeError(f"{what}: frame_step disagrees with the plain version")

    # the plain reference wave: diagnostics on, traceback of every utterance
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    scores = scorer(x).view(B, Tmax, G)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_state = dec.run(scores)
    torch.cuda.synchronize()
    t_plain_diag = time.perf_counter() - t0
    plain_launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if plain_launches[0] == 0 or plain_launches[1] != 0:
        raise RuntimeError(f"the plain path launched gmm_logsumexp, frame_step "
                           f"{plain_launches} times; expected > 0 and 0")
    host = host_batch(*plain_state)
    plain_results = [dec.traceback(host, b, Tmax, true_T=lengths[b]) for b in range(B)]
    del host
    certify(plain_results, "plain")
    # the plain bench wave: GMM kernel + frame loop, diagnostics off (the
    # wave above was its warm-up)
    t0 = time.perf_counter()
    carry, _, _ = fast.run(scorer(x).view(B, Tmax, G))
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    if int(carry["overflow"].sum()) or int((carry["best_final"]["score"] <= -0.5e30).sum()):
        raise RuntimeError("plain bench wave overflowed or died")
    fps_plain = B * Tmax / t_plain
    print(f"[plain] reference wave (diagnostics on) {t_plain_diag:.3f}s, launches: "
          f"gmm_logsumexp {plain_launches[0]}, frame_step {plain_launches[1]}; timed wave: "
          f"{B} x {Tmax} frames in {t_plain:.3f}s = {fps_plain:.1f} frames/s (GMM "
          f"kernel + plain frame loop, diagnostics off, one wave) | {card}", flush=True)

    # ---- 5. frame-step kernel vs plain ---------------------------------------
    fs = FusedDecodeScan(dec, B)
    print(f"[fused] one block per utterance: {B} blocks of {fs.threads} threads, "
          f"{fused_scan.smem_bytes(**fs.dims)} bytes of dynamic shared memory each "
          f"(hash table of {fs.dims['HT']})", flush=True)
    scores_tbg = scores.transpose(0, 1).contiguous()
    fused_state = fs(scores_tbg)
    torch.cuda.synchronize()
    plain_compact = compact_records(plain_state[1])
    require_equal("fused", fused_state, (plain_state[0], plain_compact))
    expanded = expand_records(fused_state[1], dec.K)
    for k in REC_NAMES:
        if not torch.equal(expanded[k], plain_state[1][k]):
            raise RuntimeError(f"fused: expand_records differs from the plain plane {k}")
    float_err = max(float((expanded[k] - plain_state[1][k]).abs().max())
                    for k in ("rec_score", "rec_ac", "rec_lm", "bf_score", "bf_ac", "bf_lm"))
    del expanded, plain_compact
    fused_results = assemble_results(dec, fs, *fused_state, lengths)
    for i, (a, b) in enumerate(zip(fused_results, plain_results)):
        if a.words != b.words or frames_of(a) != frames_of(b) or a.score != b.score:
            raise RuntimeError(f"fused and plain tracebacks differ for utterance {i}")
    print(f"[fused] full-width wave {B} x {Tmax} at {p['beam']}/{p['end_beam']}/"
          f"{p['maxhyps']}: compact records, their expansion, 8 snapshots, carry, words "
          f"and word-end frames equal to the plain version (max |float diff| {float_err})",
          flush=True)
    n_cand_sum = int(fused_state[1]["n_cand"].sum())
    n_active_sum = int(fused_state[1]["n_active"].sum())
    count = fused_state[1]["rec_count"]
    n_rec_sum = int(count[-1].sum())
    per_frame = torch.diff(count, dim=0, prepend=torch.zeros_like(count[:1]))
    host = host_batch(*fused_state, fs.rec0)
    carry_h, ys_h, rec0_h = host
    host_bytes = (sum(v.nbytes for v in ys_h.values()) + sum(v.nbytes for v in rec0_h.values())
                  + sum(v.nbytes for v in carry_h["best_final"].values())
                  + carry_h["overflow"].nbytes)
    dense_bytes = 4 * Tmax * B * (7 * dec.K + 8)
    print(f"[records] {n_rec_sum} records landed in {B} x {Tmax} frames: "
          f"{n_rec_sum / (B * Tmax):.3f} a frame and utterance (peak "
          f"{int(per_frame.max())} in one frame), {32 * n_rec_sum / 1e6:.2f} MB of the "
          f"{fused_state[1]['records'].numel() * 4 / 1e6:.1f} MB arena written; a wave "
          f"copies {host_bytes / 1e6:.3f} MB to the host (dense planes: "
          f"{dense_bytes / 1e6:.1f} MB)", flush=True)
    del host, carry_h, ys_h, rec0_h, count, per_frame
    del plain_state, fused_state, fused_results

    # the TPU kernel's scope (no histogram) on a short whole sentence, in one
    # launch and in two calls with the carried state
    words_s, xs = wsj_task.sample_utterances(
        task.cache, models, n_utts=2, target_frames=250, seed=12)[1]
    xs = torch.as_tensor(xs)
    sc_card = scorer(xs.to(dev))
    Ts = sc_card.shape[0]
    dec0 = TorchDecoder(art, wsj_task.decoder_config(dict(p, maxhyps=0)), device="cuda")
    sc3 = sc_card[:, None, :].expand(-1, 3, -1).contiguous()
    fs0 = FusedDecodeScan(dec0, 3)
    whole = fs0(sc3)
    c0, y0, _ = dec0.run(sc3.transpose(0, 1))
    y0 = compact_records(y0)
    require_equal("fused maxhyps=0", whole, (c0, y0))
    half = Ts // 2
    first = fs0(sc3[:half])
    second = fs0(sc3[half:], carry=first[0], t0=half)
    joined = concat_records([first[1], second[1]])
    require_equal("fused two calls", (second[0], joined), whole)
    print(f"[fused] max_emit_hyps=0, {Ts} frames x 3: equal to the plain version whole "
          f"and in two calls of {half} and {Ts - half} frames with the carried state "
          f"(overflow {int(whole[0]['overflow'].sum())}/3)", flush=True)
    del whole, first, second, joined, c0, y0

    # ---- 6. the main path through the kernels ---------------------------------
    bd = BatchDecoder(dec)
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    t0 = time.perf_counter()
    results = bd.decode_scores_batch(scorer(x).view(B, Tmax, G), lengths)
    t_cert = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = bd.decode_scores_batch(scorer(x).view(B, Tmax, G), lengths)
    t_entry = time.perf_counter() - t0
    launches = gmm_cuda.counter.launches
    fs_launches = fused_scan.counter.launches
    if launches == 0:
        raise RuntimeError("the main path did not launch gmm_logsumexp")
    if fs_launches == 0:
        raise RuntimeError("the main path did not launch frame_step")
    certify(results, "main path")
    for i, (a, b) in enumerate(zip(again, results)):
        if a.words != b.words or a.score != b.score or a.overflow:
            raise RuntimeError(f"the timed main-path wave differs for utterance {i}")
    fps = B * Tmax / t_entry
    print(f"[main path] BatchDecoder (fused route), two waves; launches: gmm_logsumexp "
          f"{launches}, frame_step {fs_launches}; first wave {t_cert:.3f}s", flush=True)
    print(f"[main path] timed wave through BatchDecoder: {B} x {Tmax} frames in "
          f"{t_entry:.4f}s = {fps:.1f} frames/s (GMM kernel + frame-step kernel + copy "
          f"of the records to the host + traceback of {B} utterances) beside "
          f"{fps_plain:.1f} frames/s of the plain loop (no copy, no traceback) | {card}",
          flush=True)
    results16 = results
    del again

    # the device's share of that wave, outside the counted run: both kernels,
    # the records left on the card
    def device_wave():
        return fs(scorer(x).view(B, Tmax, G).transpose(0, 1).contiguous())

    device_wave()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = device_wave()
    torch.cuda.synchronize()
    t_wave = time.perf_counter() - t0
    if int(carry["overflow"].sum()) or int((carry["best_final"]["score"] <= -0.5e30).sum()):
        raise RuntimeError("fused device wave overflowed or died")
    fps_device = B * Tmax / t_wave
    print(f"[main path] device only (no copy to the host, no traceback): {B} x {Tmax} "
          f"frames in {t_wave:.4f}s = {fps_device:.1f} frames/s | {card}", flush=True)

    # the kernel alone, and its bound: every input read once (scores, the
    # carry, the 32-byte metadata row of each active slot, the four
    # entry-table columns of each candidate), every output written once
    # (the landed records, the count and the eight snapshots per frame)
    fs_ms = cuda_ms(lambda: fs(scores_tbg), 3)
    K, S = dec.K, dec.S
    carry_bytes = B * (K * (8 + S * 16) + 17)
    touched = 4.0 * scores_tbg.numel() + 2 * carry_bytes + 24.0 * n_cand_sum
    fs_bytes = touched + 32.0 * n_active_sum + 32.0 * n_rec_sum + 4.0 * Tmax * B * 9
    # the earlier contract, kept as the earlier row: int64 metadata rows,
    # seven dense (K) planes a frame
    dense_bound = (touched + 48.0 * n_active_sum + 4.0 * Tmax * B * (7 * K + 8)
                   ) / PEAK_BYTES * 1e3
    # per active slot and frame (this wave's count, as for the bytes): S*S
    # adds and compares of the propagation and a few per state after it;
    # per candidate a handful
    fs_ops = float(n_active_sum) * (2 * S * S + 12 * S) + 20.0 * n_cand_sum
    fs_t_ops, fs_t_bytes = fs_ops / PEAK_F32_FLOPS * 1e3, fs_bytes / PEAK_BYTES * 1e3
    fs_bound = max(fs_t_ops, fs_t_bytes)
    print(f"[frame_step] {B} x {Tmax} frames: kernel {fs_ms:.3f} ms a wave "
          f"({fs_ms * 1e3 / Tmax:.2f} us a frame), plain loop {t_plain_diag * 1e3:.1f} ms, "
          f"bound {fs_bound:.4f} ms ({'operations' if fs_t_ops >= fs_t_bytes else 'bytes'}: "
          f"{fs_bytes / 1e6:.1f} MB, {fs_ops / 1e9:.3f} G operations over {n_active_sum} active "
          f"slot-frames of {Tmax * B * K}; with dense record "
          f"planes the bound was {dense_bound:.4f} ms; the kernel sits at the latency of "
          f"its dependent stages with {B} of 132 SMs busy, not at this bound) | {card}",
          flush=True)

    # ---- 6b. a card full of utterances: one block on every SM ----------------
    lengths2 = [lengths[i % B] for i in range(B2)]
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    t0 = time.perf_counter()
    results2 = bd.decode_scores_batch(scorer(x2).view(B2, Tmax, G), lengths2)
    t_cert2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    again2 = bd.decode_scores_batch(scorer(x2).view(B2, Tmax, G), lengths2)
    t_entry2 = time.perf_counter() - t0
    launches2 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if launches2 != (2, 2):
        raise RuntimeError(f"B={B2}: two waves launched gmm_logsumexp, frame_step "
                           f"{launches2} times; expected one each a wave")
    certify(results2, f"B={B2}")
    for i, (a, c) in enumerate(zip(results2, again2)):
        ref = results16[i % B]
        for r in (a, c):
            if (r.words != ref.words or frames_of(r) != frames_of(ref)
                    or r.score != ref.score or r.overflow):
                raise RuntimeError(f"B={B2}: utterance {i} differs from the B={B} wave")
    del results2, again2, results16
    fs2 = bd._fs[B2]
    scores2 = scorer(x2).view(B2, Tmax, G)
    tr_ms2 = cuda_ms(lambda: scores2.transpose(0, 1).contiguous(), 3)
    scores2_tbg = scores2.transpose(0, 1).contiguous()
    fs_ms2 = cuda_ms(lambda: fs2(scores2_tbg), 3)
    del scores2, scores2_tbg

    def device_wave2():
        return fs2(scorer(x2).view(B2, Tmax, G).transpose(0, 1).contiguous())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = device_wave2()
    torch.cuda.synchronize()
    t_wave2 = time.perf_counter() - t0
    if int(carry["overflow"].sum()) or int((carry["best_final"]["score"] <= -0.5e30).sum()):
        raise RuntimeError(f"B={B2}: fused device wave overflowed or died")
    wave_ms2 = cuda_ms(device_wave2, 3)
    fps2, fps_device2 = B2 * Tmax / t_entry2, B2 * Tmax / t_wave2
    print(f"[B={B2}] {len(utts)} utterances tiled to {B2} x {Tmax} frames, one block an SM: "
          f"every utterance's words, word-end frames and score equal the B={B} wave's; "
          f"launches of two waves: gmm_logsumexp {launches2[0]}, frame_step {launches2[1]}; "
          f"first wave {t_cert2:.3f}s", flush=True)
    print(f"[B={B2}] frame_step {fs_ms2:.3f} ms a wave ({fs_ms2 * 1e3 / Tmax:.2f} us a frame "
          f"of {B2}) beside {fs_ms:.3f} ms at B={B} ({fs_ms2 / fs_ms:.2f}x the time for "
          f"{B2 / B:.2f}x the utterances) | {card}", flush=True)
    print(f"[B={B2}] entry point {fps2:.1f} frames/s (wave {t_entry2:.4f}s), device only "
          f"{fps_device2:.1f} frames/s (wave {t_wave2:.4f}s); at B={B}: entry point "
          f"{fps:.1f}, device only {fps_device:.1f} frames/s | {card}", flush=True)
    print(f"[B={B2}] device wave {wave_ms2:.4f} ms over CUDA events: gmm_logsumexp "
          f"{gmm132['ms']:.4f} + scores' transpose {tr_ms2:.4f} + frame_step {fs_ms2:.4f} = "
          f"{gmm132['ms'] + tr_ms2 + fs_ms2:.4f} ms | {card}", flush=True)
    del x2, carry

    # ---- 7. card vs CPU parity on one short utterance -----------------------
    # a whole sentence (sampled above): a cut one reaches no final state and
    # has no words
    cpu_dec = TorchDecoder(art, cfg, device="cpu")
    cpu_scorer = make_gmm_scorer(params, device="cpu")

    def decode_records(decoder, scores):
        host = host_batch(*decoder.run(scores[None]))
        return decoder.traceback(host, 0, scores.shape[0]), host[1]

    r_card, ys_card = decode_records(dec, sc_card)
    n0 = fused_scan.counter.launches
    r_entry = dec.decode_scores(sc_card)  # the card's route: the kernel at B=1
    if fused_scan.counter.launches - n0 != 1:
        raise RuntimeError("decode_scores on the card did not launch frame_step once")
    if (r_entry.words != r_card.words or frames_of(r_entry) != frames_of(r_card)
            or r_entry.score != r_card.score):
        raise RuntimeError("decode_scores through the kernel differs from the plain loop")
    r_cpu, ys_cpu = decode_records(cpu_dec, sc_card.cpu())
    r_plain, ys_plain = decode_records(cpu_dec, cpu_scorer(xs))

    rec_names = ("rec_prev", "rec_seq", "rec_src", "rec_arc")
    same_rec = all((ys_card[k] == ys_cpu[k]).all() for k in rec_names)
    plain_rec = all((ys_card[k] == ys_plain[k]).all() for k in rec_names)
    transcript = [labels[w] for w in words_s]
    ok_words = [w for w in r_card.words if w not in markers] == transcript
    print(f"[parity] {xs.shape[0]} frames, {len(r_card.words)} words (transcript "
          f"{ok_words}): card vs "
          f"cpu (same scores) words {r_card.words == r_cpu.words}, frames "
          f"{frames_of(r_card) == frames_of(r_cpu)}, records {same_rec}; card vs cpu "
          f"plain scorer words {r_card.words == r_plain.words}, frames "
          f"{frames_of(r_card) == frames_of(r_plain)}, records {plain_rec}, "
          f"score diff {abs(r_card.score - r_plain.score):.2e}", flush=True)
    if not (ok_words and r_card.words == r_cpu.words
            and frames_of(r_card) == frames_of(r_cpu) and same_rec
            and r_card.words == r_plain.words
            and frames_of(r_card) == frames_of(r_plain)):
        raise RuntimeError("card and CPU decodes disagree")

    # ---- 8. result ------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "gmm_logsumexp", "route": "cuda",
        "source": "juicer_tpu_torch/csrc/gmm_logsumexp.cu",
        "replaces": "juicer_tpu/ops/gmm_pallas.py:29",
        "launches": launches, "max_abs_err": gmm16["err"], "ms": gmm16["ms"],
        "plain_ms": gmm16["plain_ms"], "bound_ms": gmm16["bound_ms"],
        "bound_by": gmm16["bound_by"], "library_ms": gmm16["library_ms"],
        "max_abs_err_b132": gmm132["err"], "ms_b132": gmm132["ms"],
        "plain_ms_b132": gmm132["plain_ms"], "bound_ms_b132": gmm132["bound_ms"],
        "library_ms_b132": gmm132["library_ms"], "launches_b132": launches2[0],
    }, {
        "name": "frame_step", "route": "cuda",
        "source": "juicer_tpu_torch/csrc/frame_step.cu",
        "replaces": "juicer_tpu/decoder/pallas_scan.py:285",
        "launches": fs_launches, "max_abs_err": float_err, "equal_to_plain": True,
        "ms": fs_ms, "plain_ms": t_plain_diag * 1e3, "bound_ms": fs_bound,
        "bound_by": "operations" if fs_t_ops >= fs_t_bytes else "bytes",
        "library_ms": None,
        "bound_ms_dense": dense_bound, "ms_b132": fs_ms2,
        "launches_b132": launches2[1],
    }]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
