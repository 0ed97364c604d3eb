"""`juicer_tpu_torch/harness/profile_step.py` on the CPU at a tiny size
(a 20-word synthetic task, B=2 x T=30, one timed iteration), against the
JAX package's `TpuDecoder` on the same task and scores:

- the "full" line's best final scores, on both routes (on the CPU the
  frame-step route runs its plain version), equal the JAX `vmap` of
  `_decode_scan`'s within 1e-4 (float32 sums in another order);
- each ablation stubs its methods on the instance only while it runs: a
  decode after `profile` equals one before it bit for bit, and the
  instance holds no stub; a stubbed decode differs (the stub ran);
- the count of sort calls in one frame step is an integer >= 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.utils.synth import make_synth_task as jax_make_synth_task

from juicer_tpu_torch.harness import profile_step

from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)

TASK = dict(n_words=20, n_phones=8, vec_size=8, n_comps=2, seed=0)
B, T = 2, 30
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    task, dec = profile_step.build("cpu", task=TASK)
    scores = profile_step.score_batch(B, T, task.models.n_gmms)
    jdec = TpuDecoder(jax_make_synth_task(**TASK).artifact,
                      TpuDecoderConfig(**profile_step.CONFIG))

    def one(s):
        return jdec._decode_scan(s.astype(jdec._dt))[0]["best_final"]["score"]

    want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(scores)))
    return dec, dec.scores_tensor(scores), want


def test_profile_full_equals_tpu_decoder_and_restores_the_stubs(setup):
    dec, scores, want = setup
    before = dec.run(scores)
    out = profile_step.profile(dec, scores, iters=1)
    after = dec.run(scores)
    for label in ("full", "full (frame_step)"):
        np.testing.assert_allclose(out[label]["best_final"], want, rtol=SCORE_TOL,
                                   atol=SCORE_TOL)
    assert out["full"]["route"] == "plain loop" and out["full (frame_step)"]["route"] == (
        "frame_step")
    stubbed = {n for _, stubs in profile_step.ABLATIONS for n in stubs}
    assert stubbed == {"_merge_and_insert", "_expand", "_final_rows", "_best_final"}
    assert not stubbed & set(vars(dec))
    assert torch.equal(before[0]["best_final"]["score"], after[0]["best_final"]["score"])
    for name, plane in before[1].items():
        assert torch.equal(plane, after[1][name]), name
    for label, _ in profile_step.ABLATIONS:
        assert not np.array_equal(out[label]["best_final"], out["full"]["best_final"]), label
        assert out[label]["s"] > 0
    assert isinstance(out["sorts"], int) and out["sorts"] >= 0


def test_stubbed_restores_after_an_error(setup):
    dec = setup[0]
    with pytest.raises(RuntimeError):
        with profile_step.stubbed(dec, {"_expand": profile_step._fake_expand}):
            assert "_expand" in vars(dec)
            raise RuntimeError("inside")
    assert "_expand" not in vars(dec)
