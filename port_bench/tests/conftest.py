"""The benchmark's CPU tests: `python -m pytest port_bench/tests -q` from
the repository's root (`-m gpu` for the card test, on a machine with a
card). They import the benchmark's `pb` package and its metric readers
from `port_bench/`."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

# a mix small enough for the program's plain version on the CPU
TINY = {"batch": 2, "pool": 4, "frames_per_state": 3, "loop": "closed", "clients": 1,
        "corpus_seed": 5,
        "lengths": {"dist": "lognormal", "mean": 82, "sigma": 0.3, "min": 50, "max": 120}}
CELL = "wsj20k.read-b16"


def bench_copy(root):
    """A checkout at `root` with a copy of the benchmark (BENCHMARK.json and
    port_bench/) and links to the program and the tasks, plus the
    configuration `wsj2k` (the 20k configuration on the tracked 2k task,
    small enough for the CPU) and its tiny cell `wsj2k.tiny`, added as new
    files and entries only: 4 short utterances in waves of 2, all of them
    compared, under the 20k cell's limits."""
    root = str(root)
    shutil.copytree(BENCH, os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("scripts", "juicer_tpu_torch", "native"):
        os.symlink(os.path.join(REPO, name), os.path.join(root, name))
    with open(os.path.join(BENCH, "configs", "wsj20k.json")) as fd:
        config = json.load(fd)
    config["task_dir"] = "scripts/_wsj_cache_2k"
    with open(os.path.join(root, "port_bench", "configs", "wsj2k.json"), "w") as fd:
        json.dump(config, fd)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fd:
        spec = json.load(fd)
    spec["configs"].append({"name": "wsj2k", "source": "the tracked 2k task",
                            "file": "port_bench/configs/wsj2k.json", "reduced": [],
                            "why": "a CPU rehearsal"})
    spec["workloads"].append({"name": "wsj2k.tiny", "config": "wsj2k", "traffic": "tiny",
                              "chips": 1, "why": "a CPU rehearsal of the 2k cell"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fd:
        json.dump(spec, fd)
    with open(os.path.join(root, "port_bench", "traffic", "tiny.json"), "w") as fd:
        json.dump(TINY, fd)
    with open(os.path.join(BENCH, "cells", f"{CELL}.json")) as fd:
        cell = json.load(fd)
    cell["sample"] = 4  # every utterance of the pool
    with open(os.path.join(root, "port_bench", "cells", "wsj2k.tiny.json"), "w") as fd:
        json.dump(cell, fd)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("checkout"))
