"""Each cell of BENCHMARK.json for a few seconds on the card, through the
benchmark's command: the last line parses into the contract's keys, and
no answer failed.

    python -m pytest port_bench/tests/test_pb_card.py -m gpu -q

It skips without a card; whether there is one is asked inside the test."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as fd:
    SPEC = json.load(fd)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_the_contract_line(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", workload,
                        "--seed", str(2**31 + 99), "--seconds", "2", "--trace", str(trace)],
                       capture_output=True, text=True, cwd=REPO, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True, p.stderr[-4000:]
    # a cell's traffic fails no operation: every answer within the budgets
    assert out["attempted"] > 0 and out["failed"] == 0, p.stderr[-4000:]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0) and dev["memory_peak_bytes"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in SPEC[kind] if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "check"
