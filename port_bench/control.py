"""The control of the comparison that decides `correct`: the reference put
in the program's place, computed in the precision below the
configuration's float32 (TF32 products for the GMM scores,
`pb.reference.scores_lower`), and judged by the same code and limits as
the program (`pb.check`). It should come out as not correct.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13 [--device cuda|cpu]

For each seed it makes the cell's pool, draws the cell's sample, and
prints each compared number of the control beside its limit and the
verdict, then one JSON line of the readings. It imports nothing of the
program. On the card the TF32 products are the card's own; `--device
cpu` rounds the operands to TF32 instead (what the tensor cores read).
"""

import argparse
import json
import os
import sys

from pb import check, reference, spec, traffic
from pb.task import Lexicon, Models, Network


def control_numbers(cell, seed: int, device: str) -> dict:
    cfg = cell.config
    task_dir = os.path.join(cell.repo, cfg["task_dir"])
    models, lex = Models(os.path.join(task_dir, "models.npz")), Lexicon(task_dir)
    pool = traffic.make_pool(task_dir, models, lex, cell.mix, cfg["network"]["context"])
    sample = check.draw_sample(pool.lengths, int(cell.limits["sample"]), seed)
    net = Network(os.path.join(task_dir, "clg.npz"))
    point = cfg["point"]
    refs = check.reference_answers(sample, pool.feats, models, net, point)
    oracle = reference.Oracle(net, models, point["beam"], point["end_beam"], point["maxhyps"])
    scores, answers = {}, {}
    for u in sample:
        scores[u] = reference.scores_lower(models, pool.feats[u], device)
        answers[u] = [check.answer_of_oracle(oracle.decode(scores[u]))]
    return check.compare(refs, scores, answers, point["K"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("control: no CUDA card", file=sys.stderr)
            return 2
    cell = spec.load_cell(args.workload, False)
    limits = cell.limits["limits"]
    readings = {}
    for seed in args.seeds:
        numbers = control_numbers(cell, seed, args.device)
        for line in check.lines(numbers, limits):
            print(f"[control {args.workload} seed {seed}] {line}", flush=True)
        print(f"[control {args.workload} seed {seed}] correct: "
              f"{check.verdict(numbers, limits)}", flush=True)
        readings[seed] = {k: numbers[k] for k in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "device": args.device, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
