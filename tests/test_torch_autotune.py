"""Budget autotuner of the PyTorch port against the JAX package's.

The synth task of `tests/test_autotune.py` goes through
`juicer_tpu.decoder.autotune_budgets` (over the float32 `TpuDecoder`) and
through the port's `autotune_budgets` on `device="cpu"` (the plain frame
loop), with the same numpy score samples and the same start: the tuned
`max_insts`, `expand_budget` and `final_budget` must be equal.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from juicer_tpu.decoder import autotune_budgets as jax_autotune
from juicer_tpu.decoder.tpu_core import TpuDecoderConfig

from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig, autotune_budgets

from test_autotune import setup_task
from test_torch_decoder import carry_across

BUDGETS = ("max_insts", "expand_budget", "final_budget")


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    """Per seed: the JAX task, the port's artifact and the score samples."""
    out = {}
    for seed in (0, 1):
        task, samples = setup_task(seed=seed)
        _, _, part = carry_across(tmp_path_factory.mktemp(f"synth{seed}"),
                                  task.network, task.models, task.artifact)
        out[seed] = (task, part, [np.asarray(s, np.float32) for s in samples])
    return out


def _both(tasks, seed, start, **kw):
    task, part, samples = tasks[seed]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # overflowing probes warn
        want = jax_autotune(task.artifact, samples, cfg=TpuDecoderConfig(**start), **kw)
        got = autotune_budgets(part, samples, cfg=TorchDecoderConfig(**start),
                               device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("verify", [True, False])
def test_tuned_budgets_equal_jax(tasks, verify):
    start = dict(max_insts=1024, expand_budget=8192, final_budget=256)
    got, want = _both(tasks, 0, start, margin=1.5, verify=verify)
    assert [getattr(got, k) for k in BUDGETS] == [getattr(want, k) for k in BUDGETS]
    assert got.max_insts < start["max_insts"] and got.expand_budget < start["expand_budget"]
    # the tuned decode equals the generous one word for word
    _, part, samples = tasks[0]
    big = TorchDecoder(part, TorchDecoderConfig(**start), device="cpu")
    small = TorchDecoder(part, got, device="cpu")
    for s in samples:
        a, b = big.decode_scores(s), small.decode_scores(s)
        assert a.words == b.words and a.score == b.score and not b.overflow


def test_grows_out_of_overflow_like_jax(tasks):
    """A start that overflows: both tuners double to the same probe and
    shrink to the same budgets."""
    start = dict(max_insts=16, expand_budget=64, final_budget=16)
    _, part, samples = tasks[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first = TorchDecoder(part, TorchDecoderConfig(**start), device="cpu")
        assert any(first.decode_scores(s).overflow for s in samples)
    got, want = _both(tasks, 1, start, margin=1.3)
    assert [getattr(got, k) for k in BUDGETS] == [getattr(want, k) for k in BUDGETS]
    assert got.final_budget > start["final_budget"]
    dec = TorchDecoder(part, got, device="cpu")
    for s in samples:
        assert not dec.decode_scores(s).overflow


def test_default_start_equals_jax(tasks):
    """cfg=None starts from each package's defaults (K=2048, E=8192, F=1024)."""
    task, part, samples = tasks[0]
    want = jax_autotune(task.artifact, samples)
    got = autotune_budgets(part, samples, device="cpu")
    assert [getattr(got, k) for k in BUDGETS] == [getattr(want, k) for k in BUDGETS]


@pytest.mark.parametrize("use_fused", ["auto", True, False])
def test_cpu_decoder_runs_the_plain_loop(tasks, use_fused, monkeypatch):
    """On a CPU decoder every route is the plain loop: the same budgets,
    and no fused scan is built."""
    from juicer_tpu_torch.decoder import fused_scan

    _, part, samples = tasks[0]
    monkeypatch.setattr(fused_scan.FusedDecodeScan, "__init__",
                        lambda *a, **k: pytest.fail("a fused scan was built"))
    start = TorchDecoderConfig(max_insts=1024, expand_budget=8192, final_budget=256)
    got = autotune_budgets(part, samples, cfg=start, device="cpu", use_fused=use_fused)
    ref = autotune_budgets(part, samples, cfg=start, device="cpu")
    assert got == ref and got == dataclasses.replace(start, **{k: getattr(ref, k) for k in BUDGETS})


def test_unknown_route_raises(tasks):
    _, part, samples = tasks[0]
    with pytest.raises(ValueError, match="use_fused"):
        autotune_budgets(part, samples, device="cpu", use_fused="fast")
    with pytest.raises(ValueError, match="use_fused"):
        TorchDecoder(part, TorchDecoderConfig(), device="cpu").decode_scores(
            samples[0], use_fused="fast")
