"""The port's pruning-ladder sweep (`juicer_tpu_torch/harness/wsj_sweep.py`)
against the JAX package's `scripts/wsj_sweep.py`, on the CPU.

Both run on the tracked 2k task at a small size: two free-text utterances
of ~150 frames synthesised from the confusable models of centre scale 0.8,
decoded with means perturbed by sigma 1.5, one rung that costs words, one
held-out utterance for the oracle parity and a steady bench at B=2. The
row's tuned K and E, accuracy, errors, reference words, peak of active
slots, overflow, oracle parity and the bench's overflow equal the JAX
script's row. The JAX script is given an in-memory artifact (its own
`ensure_artifact` writes under `scripts/`).
"""

import json

import pytest

from juicer_tpu_torch.decoder.autotune import ProbeOutOfScope
from juicer_tpu_torch.harness import wsj_sweep

from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)
from test_torch_wsj_bench import jax_script, run_main, task2k  # noqa: F401 (fixture)

ARGV = ["--words", "2000", "--batch", "2", "--frames", "150", "--settings", "25,15,100",
        "--K", "512", "--E", "1024", "--center-scale", "0.8", "--free-text",
        "--mismatch", "1.5", "--parity", "1", "--batches", "2", "--cpu"]
ROW_KEYS = ("beam", "end_beam", "maxhyps", "K", "E", "accuracy", "errors", "n_words",
            "peak_active", "overflow", "parity_ok")


def test_sweep_row_equals_jax(task2k, monkeypatch):  # noqa: F811 (fixture)
    jsweep = jax_script("wsj_sweep")
    monkeypatch.setattr(jsweep, "ensure_artifact", lambda cache, net, models: task2k["jart"])
    _, want = run_main(jsweep.main, ARGV)
    text, got = run_main(wsj_sweep.main, ARGV)
    assert got["metric"] == "wsj_pruning_sweep"
    for k in ("center_scale", "mismatch", "free_text"):
        assert got[k] == want[k], k
    (g,), (w,) = got["rows"], want["rows"]
    for k in ROW_KEYS:
        assert g[k] == w[k], (k, g, w)
    assert g["errors"] > 0  # the rung costs words: the comparison means something
    assert g["bench"]["2"]["overflow"] == w["bench"]["2"]["overflow"] == 0
    assert g["route"] == g["bench"]["2"]["route"] == "frame_step" and g["device"] == "cpu"
    # one JSON row a rung before the last line
    assert json.loads(text.strip().splitlines()[-2]) == g


def test_sweep_records_a_failed_rung(task2k, monkeypatch, capsys):  # noqa: F811 (fixture)
    """A rung whose tuner finds no budgets is recorded with its error and
    its route, and the sweep goes on to the next rung."""
    args = wsj_sweep.parse_args(["--words", "2000", "--batch", "1", "--frames", "150",
                                 "--settings", "100,75,1200;25,15,100", "--K", "128", "--E",
                                 "128", "--no-bench", "--cpu"])
    inp = wsj_sweep.prepare(args, task2k["net"], task2k["art"], task2k["cache"])
    real, calls = wsj_sweep.autotune_budgets, []

    def first_gets_one_round(*a, **kw):
        calls.append(1)
        return real(*a, **kw, max_rounds=1) if len(calls) == 1 else real(*a, **kw)

    monkeypatch.setattr(wsj_sweep, "autotune_budgets", first_gets_one_round)
    rows = [wsj_sweep.rung(args, spec, task2k["net"], task2k["art"], inp, "cpu")
            for spec in args.settings.split(";")]
    assert "still overflowing" in rows[0]["error"] and rows[0]["route"] == "frame_step"
    assert "error" not in rows[1] and rows[1]["overflow"] == 0
    assert "autotune FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("caught", [True, False])
def test_sweep_catches_only_the_scope_refusal(task2k, monkeypatch, caught):  # noqa: F811
    """The tuner's refusal of a probe outside the kernel's scope
    (`ProbeOutOfScope`) is recorded in the rung's row; any other
    `ValueError`, a defect, ends the run."""
    args = wsj_sweep.parse_args(["--words", "2000", "--batch", "1", "--frames", "150",
                                 "--settings", "25,15,100", "--K", "512", "--E", "1024",
                                 "--no-bench", "--cpu"])
    inp = wsj_sweep.prepare(args, task2k["net"], task2k["art"], task2k["cache"])
    exc = (ProbeOutOfScope("autotune: the probe lies outside the fused scan's scope")
           if caught else ValueError("a defect"))

    def refuse(*a, **kw):
        raise exc

    monkeypatch.setattr(wsj_sweep, "autotune_budgets", refuse)
    if caught:
        row = wsj_sweep.rung(args, "25,15,100", task2k["net"], task2k["art"], inp, "cpu")
        assert row["error"] == str(exc) and row["route"] == "frame_step"
    else:
        with pytest.raises(ValueError, match="a defect"):
            wsj_sweep.rung(args, "25,15,100", task2k["net"], task2k["art"], inp, "cpu")
