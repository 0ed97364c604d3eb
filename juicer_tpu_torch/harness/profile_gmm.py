"""Time the GMM kernel of one checkout of the port at the decode waves' shapes.

    python juicer_tpu_torch/harness/profile_gmm.py [--root DIR] [--frames T ...]
        [--iters N] [--dims D ...] [--sgemm K]

Loads the 2k-word WSJ-order task's acoustic models (G=141 GMMs of C=8
components, D=39; `scripts/_wsj_cache_2k/models.npz`), draws T feature
frames from their components (component mean + unit-variance noise scaled
by the component's deviation, numpy seed 0), and for each T prints one
JSON line: the kernel's and the plain scorer's mean times over CUDA events
(`--iters` launches after a warm-up), the max |kernel - plain|, and the
kernel's float32 bound (operations over 67 TFLOP/s). The default T are
the main path's waves: 16 x 1458 and 132 x 1458 frames.

`--dims D ...` also times the kernel at T = the largest `--frames` on
random GMMs of the same G and C at each feature size D, and fits the time
a feature dim adds (the FMA loop's cost: 4 * T * G * C flops a dim) and
the fixed rest. `--sgemm K` times one float32 `torch.matmul` of a
(T, K) by (K, 1152) matrix as a yardstick of the card's float32 GEMM rate
(no part of the port calls it).

`--root` names the checkout whose `juicer_tpu_torch` is timed (default:
the one that holds this file), so an unpacked earlier commit can be timed
beside this one, each in its own process; only the wrapper's API that
every version has is used (`make_gmm_scorer`, `scorer.W`,
`scorer.b_packed`, `gmm_cuda.gmm_logsumexp`, `gmm_scores_dense`). Run it
as a file, not with -m. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PEAK_F32_FLOPS = 67e12


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--frames", type=int, nargs="+", default=[16 * 1458, 132 * 1458])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dims", type=int, nargs="*", default=[])
    ap.add_argument("--sgemm", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_gmm: no CUDA device available", file=sys.stderr)
        return 2
    from juicer_tpu_torch import _cuda_build
    from juicer_tpu_torch.am.models import AcousticModelSet
    from juicer_tpu_torch.convert import gmm_params_from_numpy
    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.ops.gmm import gmm_scores_dense, make_gmm_scorer

    report = _cuda_build.build_all(("gmm_logsumexp",)).get("gmm_logsumexp", "")
    regs = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    models = AcousticModelSet.load_npz(
        os.path.join(root, "scripts", "_wsj_cache_2k", "models.npz"))
    params = models.flat_params()
    G, C, D = params.n_gmms, params.max_comps, params.vec_size
    scorer = make_gmm_scorer(params, device="cuda")
    means = np.concatenate(models.gmm_means)
    sds = np.sqrt(np.concatenate(models.gmm_vars))
    rng = np.random.default_rng(0)

    def cuda_ms(fn, iters):
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

    for T in args.frames:
        pick = rng.integers(len(means), size=T)
        x = means[pick] + rng.normal(size=(T, D)) * sds[pick]
        x = torch.as_tensor(x.astype(np.float32), device="cuda")
        ker = gmm_cuda.gmm_logsumexp(x, scorer.W, scorer.b_packed, G)
        plain = gmm_scores_dense(x, scorer.V, scorer.M, scorer.b, scorer.mask)
        err = float((ker - plain).abs().max())
        del ker, plain
        ms = cuda_ms(lambda: gmm_cuda.gmm_logsumexp(x, scorer.W, scorer.b_packed, G),
                     args.iters)
        plain_ms = cuda_ms(
            lambda: gmm_scores_dense(x, scorer.V, scorer.M, scorer.b, scorer.mask), args.iters)
        bound_ms = 2.0 * T * G * C * 2 * D / PEAK_F32_FLOPS * 1e3
        print(json.dumps({"root": root, "T": T, "D": D, "G": G, "C": C, "ms": ms,
                          "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms,
                          "share_of_bound": bound_ms / ms, "ptxas": regs, "card": card}),
              flush=True)

    T = max(args.frames)
    if args.dims:
        times = []
        for D_ in args.dims:
            r = np.random.default_rng(D_)
            p_ = gmm_params_from_numpy(-r.random((D_, G * C)) - 0.5, r.normal(size=(D_, G * C)),
                                       r.normal(size=G * C), np.ones((G, C), bool))
            sc = make_gmm_scorer(p_, device="cuda")
            x = torch.randn(T, D_, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
            times.append(cuda_ms(lambda: gmm_cuda.gmm_logsumexp(x, sc.W, sc.b_packed, G),
                                 args.iters))
            del sc, x
        slope, rest = np.polyfit(np.asarray(args.dims, float), np.asarray(times), 1)
        print(json.dumps({"root": root, "T": T, "G": G, "C": C, "dims": args.dims, "ms": times,
                          "ms_a_dim": slope, "ms_fixed": rest,
                          "loop_share_of_peak": 4.0 * T * G * C / PEAK_F32_FLOPS * 1e3 / slope,
                          "card": card}), flush=True)
    if args.sgemm:
        a = torch.randn(T, args.sgemm, device="cuda")
        bm = torch.randn(args.sgemm, 1152, device="cuda")
        ms = cuda_ms(lambda: a @ bm, args.iters)
        print(json.dumps({"sgemm": [T, args.sgemm, 1152], "ms": ms,
                          "tflops": 2.0 * T * args.sgemm * 1152 / ms / 1e9,
                          "share_of_peak": 2.0 * T * args.sgemm * 1152 / ms / 1e9 / 67.0,
                          "tf32": torch.backends.cuda.matmul.allow_tf32, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
