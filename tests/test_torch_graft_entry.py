"""`juicer_tpu_torch/graft_entry.py` against the repo root's
`__graft_entry__.py`, on the CPU.

- `entry(device="cpu")`'s step gives the JAX `entry()` step's best final
  score on the same features (a synthesised two-word utterance, 50
  frames) within 1e-3 absolute, the tolerance of the JAX dryrun's own
  score checks (`__graft_entry__.py:96`, :157);
- `dryrun_multichip(8, device="cpu")` (8 CPU replicas) passes its own
  checks, and the words of its 4 distinct utterances equal `TpuDecoder`'s
  on the JAX scorer's scores of the same features.

The JAX `dryrun_multichip` is not called here: under a loaded machine its
8 virtual devices can abort the process (ROADMAP C).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.ops.gmm import make_gmm_scorer as jax_gmm_scorer
from juicer_tpu.utils.synth import make_synth_task as jax_make_synth_task

from juicer_tpu_torch import graft_entry
from juicer_tpu_torch.utils.synth import make_synth_task

from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3


@pytest.fixture(scope="module")
def jax_graft():
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(ROOT)
    return __graft_entry__


def test_entry_equals_the_jax_entry(jax_graft):
    fn, (example,) = graft_entry.entry(device="cpu")
    jfn, (jexample,) = jax_graft.entry()
    jfn = jax.jit(jfn)  # as the JAX package's own test runs it
    assert tuple(example.shape) == tuple(jexample.shape) == (50, 20)
    task = make_synth_task(n_words=30, n_phones=16, vec_size=20, seed=0)
    f = task.synth_utterance(["w3", "w17"], np.random.default_rng(5))
    feats = np.concatenate([f, np.tile(f[-1:], (max(0, 50 - len(f)), 1))])[:50]
    got = float(fn(torch.as_tensor(feats)))
    want = float(jfn(jnp.asarray(feats)))
    assert got > -1e29 and abs(got - want) <= TOL, (got, want)
    # the example runs too: both packages give the same best final
    got, want = float(fn(example)), float(jfn(jexample))
    assert abs(got - want) <= TOL or max(got, want) < -1e29, (got, want)


def test_dryrun_multichip_on_eight_cpu_replicas():
    out = graft_entry.dryrun_multichip(8, device="cpu")
    assert len(out["mesh"]) == 8 and len(out["plain"]) == len(out["fused"]) == 64
    assert (out["big_K"], out["big_E"]) == (2048, 4096)
    assert out["routes"]["wsj-budget"].startswith("plain loop: K=2048")
    assert np.isfinite(out["mean_best_final"])
    task = jax_make_synth_task(n_words=12, n_phones=8, vec_size=8, seed=0)
    jdec = TpuDecoder(task.artifact, TpuDecoderConfig(max_insts=128, expand_budget=256,
                                                      final_budget=256))
    scorer = jax_gmm_scorer(task.models.flat_params())
    feats, lengths = out["features"], out["lengths"]
    for i, r in enumerate(out["truth"]):
        sc = np.asarray(scorer(jnp.asarray(feats[i, :lengths[i]])))
        want = jdec.decode_scores(sc)
        assert r.words == want.words and r.words, i
        assert abs(r.score - want.score) <= TOL, i
