"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in the repository's BENCHMARK.json.
The run builds the program's decoder for the cell's configuration, makes
the cell's traffic from the seed, measures the window, judges the sampled
answers against the plain reference, and prints as its last line of
standard output one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`check`, each number compared beside its limit. Progress and the
comparison's lines go to standard error.

It exits non-zero, and prints no result, without a CUDA card, or where
the process holds `jax`, `jaxlib`, `flax` or `juicer_tpu` once the window
has closed.

The host side is held steady (`steady`, and `pb.cell` for the window):
the process runs with a fixed string-hash seed, so that every run lays
out its dictionaries alike, and on a fixed set of cores, so that no
run's threads wander; two sets of six runs spread 3.1-4.9 % with this
and 6.7-9.2 % without it on the card.
"""

import os
import sys

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    # a fixed hash seed can only be set before the interpreter starts
    os.execve(sys.executable, [sys.executable] + sys.argv, dict(os.environ, PYTHONHASHSEED="0"))

import time  # noqa: E402

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402

# the program's own packages live at the checkout's root
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "juicer_tpu")
CORES = 4


def steady() -> None:
    """Pin the process to the lowest CORES of the cores it may use, before
    any thread of the program starts."""
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, allowed[:CORES])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    steady()

    import torch

    from pb import cell as cell_run, spec

    t_imports = time.perf_counter()
    cell = spec.load_cell(args.workload, bool(args.trace))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {have} visible", file=sys.stderr)
        return 2
    torch.cuda.init()
    spans = {"imports_s": t_imports - T_START, "cuda_init_s": time.perf_counter() - t_imports}
    out = cell_run.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, spans)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {bad} after the window", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
