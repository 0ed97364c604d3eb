"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files and entries, with no file of the benchmark edited."""

import filecmp
import json
import os

from pb import spec

from conftest import BENCH, bench_copy

NEW_METRIC = '''"""waves_n: how many waves the window held."""


def read(run):
    return len(run.waves)
'''


def test_new_config_mix_cell_and_metric_are_found_by_name(tmp_path):
    root = bench_copy(tmp_path)  # adds `wsj2k`, the mix `tiny` and the cell `wsj2k.tiny`
    bench = os.path.join(root, "port_bench")
    with open(os.path.join(bench, "configs", "wsj2k.json")) as fd:
        config = json.load(fd)
    config["point"] = dict(config["point"], beam=60.0)
    with open(os.path.join(bench, "configs", "wsj2k_b60.json"), "w") as fd:
        json.dump(config, fd)
    with open(os.path.join(bench, "metrics", "waves_n.py"), "w") as fd:
        fd.write(NEW_METRIC)
    with open(os.path.join(bench, "cells", "wsj2k.tiny.json")) as fd:
        limits = fd.read()
    with open(os.path.join(bench, "cells", "wsj2k_b60.tiny.json"), "w") as fd:
        fd.write(limits)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fd:
        b = json.load(fd)
    b["configs"].append({"name": "wsj2k_b60", "source": "the 2k task at beam 60",
                         "file": "port_bench/configs/wsj2k_b60.json", "reduced": [],
                         "why": "a narrower beam"})
    b["workloads"].append({"name": "wsj2k_b60.tiny", "config": "wsj2k_b60", "traffic": "tiny",
                           "chips": 1, "why": "the tiny mix at beam 60"})
    b["per_layer"].append({"name": "waves_n", "unit": "waves", "better": "higher",
                           "source": "host_clock", "layer": "entry point and traceback",
                           "moves": "frames_per_s", "workloads": ["wsj2k_b60.tiny"]})
    with open(path, "w") as fd:
        json.dump(b, fd)

    cell = spec.load_cell("wsj2k_b60.tiny", True, repo=root, bench=bench)
    assert cell.config["point"]["beam"] == 60.0
    assert cell.mix["batch"] == 2
    assert cell.limits["sample"] == 4
    assert "waves_n" in [m["name"] for m in cell.metrics]
    assert "waves_n" not in [m["name"] for m in spec.load_cell("wsj2k.tiny", True, root,
                                                               bench).metrics]
    assert spec.reader(bench, "waves_n")(type("R", (), {"waves": [1, 2, 3]})) == 3

    # every file the benchmark had is there, unchanged
    for dirpath, _, files in os.walk(BENCH):
        if "__pycache__" in dirpath or os.sep + "tests" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), BENCH)
            assert filecmp.cmp(os.path.join(BENCH, rel), os.path.join(bench, rel), shallow=False)
