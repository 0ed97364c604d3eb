"""One run of one cell: set-up, the measured window, the comparison, the
result line.

Set-up (`setup_s`, from the process's start to the first timed wave): the
program's network, models, decode artifact, tables, scorer and entry
(`pb.program`), the pool of utterances (`pb.traffic`), and two warm-up
waves: the `batch` longest utterances, then one wave of another
permutation.

The window is a closed loop with one client: waves go back to back, each
the next `batch` utterances of the seed's order, padded on the host to the
wave's longest by repeating the last frame, until `seconds` have passed
and every sampled utterance has been decoded once (or a minute more has
passed); it holds whole waves only. With `trace`, `torch.profiler` records
the whole window. Python's garbage collector is off through the window,
with what set-up made frozen out of its reach, so that no collection of
the set-up's objects lands in a timed wave.

After the window: the card's peak memory is read, the program is freed,
and the reference judges the sampled utterances (`pb.check`). The
metrics of the cell (end-to-end, or with `trace` per-layer) are read by
their readers (`metrics/<name>.py`) from a `Run`.
"""

from __future__ import annotations

import gc
import os
import resource
import sys
import time
from dataclasses import dataclass

import numpy as np

from . import check, opcount, trace as tracing, traffic
from .editdist import align
from .spec import Cell, reader
from .task import Lexicon, Models, Network


@dataclass
class Wave:
    start: float  # host clock, seconds
    end: float
    t_pad: int
    frames: int  # true frames of the answers that did not fail
    batch: int


@dataclass
class Run:
    """What a metric reader reads."""

    waves: list
    window_s: float
    setup_s: float
    spans: dict  # set-up spans, seconds
    model: dict  # G, D, components (real Gaussian components in all)
    peaks: dict | None  # the card's (`opcount.PEAKS`), None off the table
    trace: tracing.Trace | None = None


def padded(feats: list, idx: list) -> tuple[np.ndarray, list]:
    """(B, T_pad, D) features of the utterances idx, each padded to the
    longest by repeating its last frame, and their true lengths."""
    lengths = [len(feats[i]) for i in idx]
    T = max(lengths)
    out = np.empty((len(idx), T, feats[idx[0]].shape[1]), np.float32)
    for b, i in enumerate(idx):
        n = lengths[b]
        out[b, :n] = feats[i]
        out[b, n:] = feats[i][-1]
    return out, lengths


def device_info(device: str) -> dict:
    if device.startswith("cuda"):
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, spans: dict | None = None, program_cls=None) -> dict:
    """The result of one run (the contract's last line, as a dict).
    `spans`: set-up spans the caller measured before, in seconds."""
    import torch

    if program_cls is None:
        from .program import Program as program_cls
    cfg, mix = cell.config, cell.mix
    task_dir = os.path.join(cell.repo, cfg["task_dir"])
    spans = dict(spans or {})
    program = program_cls(task_dir, cfg["point"], device, spans)

    t0 = time.perf_counter()
    models, lex = Models(os.path.join(task_dir, "models.npz")), Lexicon(task_dir)
    pool = traffic.make_pool(task_dir, models, lex, mix, cfg["network"]["context"])
    spans["pool_s"] = time.perf_counter() - t0
    B = int(mix["batch"])
    sample = check.draw_sample(pool.lengths, int(cell.limits["sample"]), seed)
    span = tracing.span_factory(trace)

    def sync():
        if device.startswith("cuda"):
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    warm = [list(np.argsort(pool.lengths)[-B:]),
            traffic.rng_of(seed, 3).permutation(len(pool))[:B].tolist()]
    for idx in warm:
        program.wave(*padded(pool.feats, idx), span)
    sync()
    spans["warmup_s"] = time.perf_counter() - t0

    waves, answers, scores = [], {u: [] for u in sample}, {}
    # (utterance, words, overflowed) -> [errors against its transcript, its
    # words, answers]
    outcomes = {}
    failed, raised = 0, []
    order = traffic.wave_order(len(pool), B, seed)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        # the profiler's first device activity starts its tracing: one wave
        # outside the window, before the first timed one
        program.wave(*padded(pool.feats, warm[1]), tracing.span_factory(False))
        sync()
    gc.collect()
    gc.freeze()
    gc.disable()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    n_flagged = n_empty = n_raised = 0
    while True:
        # past the close, wait up to a minute for each sampled utterance
        late = time.perf_counter() - t_w0 - seconds
        if late >= 0 and (all(answers[u] for u in sample) or late >= 60):
            break
        idx = next(order)
        feats, lengths = padded(pool.feats, idx)
        t0 = time.perf_counter()
        try:
            with span("wave"):
                results, sc = program.wave(feats, lengths, span)
            if len(results) != len(idx) or tuple(sc.shape[:2]) != feats.shape[:2]:
                raise ValueError(f"{len(results)} answers and scores {tuple(sc.shape)} for "
                                 f"{len(idx)} utterances of {feats.shape[1]} frames")
        except Exception as e:  # a wave that raises is B failed requests
            t1 = time.perf_counter()
            raised.append(f"{type(e).__name__}: {e}")
            failed += len(idx)
            n_raised += len(idx)
            waves.append(Wave(t0, t1, feats.shape[1], 0, len(idx)))
            continue
        t1 = time.perf_counter()
        ok_frames = 0
        for b, u in enumerate(idx):
            res = results[b]
            if res.overflow or res.empty:
                failed += 1
                n_flagged += res.overflow
                n_empty += res.empty
            else:
                ok_frames += lengths[b]
            if res.overflow and u not in answers and (
                    len(answers) < len(sample) + check.FLAGGED_COMPARED):
                answers[u] = []
            if not res.empty:
                key = (u, tuple(res.words), res.overflow)
                if key not in outcomes:
                    hyp = [w for w in res.words if w not in lex.markers]
                    outcomes[key] = [align(hyp, [lex.labels[w] for w in pool.words[u]]),
                                     len(pool.words[u]), 0]
                outcomes[key][2] += 1
            if u in answers:
                answers[u].append(check.answer_of(res))
                if u not in scores:
                    scores[u] = sc[b, :lengths[b]].float().cpu().numpy()
        waves.append(Wave(t0, t1, feats.shape[1], int(ok_frames), len(idx)))
    gc.enable()
    gc.unfreeze()
    window_s = waves[-1].end - waves[0].start
    tr = None
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)
        tr = tracing.from_profile(prof)
        del prof
    info = device_info(device)
    attempted = sum(w.batch for w in waves)
    lat = [w.end - w.start for w in waves]
    log(f"window: {len(waves)} waves, {attempted} utterances, {sum(w.frames for w in waves)} "
        f"true frames answered without failing, {sum(w.t_pad * w.batch for w in waves)} padded frames in "
        f"{window_s:.3f}s; wave latency samples {len(lat)}, median "
        f"{1e3 * float(np.median(lat)):.3f} ms; set-up {setup_s:.3f}s "
        + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    log(f"peak host RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB; "
        f"device {info}")
    log(f"failed: {failed} of {attempted} (overflowed {n_flagged}, no final state {n_empty}, "
        f"in waves that raised {n_raised})")
    for msg in raised[:3]:
        log(f"raised: {msg}")

    # the word accuracy against the generating transcripts, over the window
    for flagged in (False, True):
        got = [v for key, v in outcomes.items() if key[2] == flagged]
        n_ref = sum(n * k for _, n, k in got)
        n_err = sum(sum(e) * k for e, _, k in got)
        log(f"word accuracy against the transcripts{' (overflowed answers)' if flagged else ''}: "
            f"{100.0 * (1 - n_err / max(n_ref, 1)):.3f}% over {sum(k for *_, k in got)} "
            f"answers ({n_ref} words, {len(got)} distinct answers)")

    G, D = program.G, models.D
    K = program.K
    del program
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    net = Network(os.path.join(task_dir, "clg.npz"))
    compared = list(answers)
    refs = check.reference_answers(compared, pool.feats, models, net, cfg["point"])
    numbers = check.compare(refs, scores, answers, K)
    numbers["flagged_share"] = n_flagged / max(attempted, 1)
    correct = check.verdict(numbers, cell.limits["limits"]) and not raised
    log(f"reference: {len(compared)} utterances ({len(sample)} sampled; "
        f"{sum(pool.lengths[u] for u in compared)} frames), "
        f"{numbers['occurrences']} occurrences compared in {time.perf_counter() - t0:.3f}s; "
        f"peak live instances {[refs[u][1].peak_active for u in compared]} (K={K}); flagged "
        f"utterances (reference's peak, flagged occurrences): {numbers['flagged']}")

    run_ = Run(waves, window_s, setup_s, spans,
               {"G": G, "D": D, "components": models.real_components},
               opcount.peaks_of(info["kind"]), tr)
    metrics = {}
    for m in cell.metrics:
        value = reader(cell.bench, m["name"])(run_)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": info}
    if tr is not None:
        info["busy_s"] = tr.busy_s()
        lo, hi = tr.window
        info["window_s"] = hi - lo
        out["breakdown"] = tracing.breakdown(tr)
    limits = cell.limits["limits"]
    out["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    for line in check.lines(numbers, limits):
        log(line)
    return out
