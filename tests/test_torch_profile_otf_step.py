"""`juicer_tpu_torch/harness/profile_otf_step.py` on the CPU, on the toy
on-the-fly task of `test_torch_otf` (C o closure(L) of a three-word
lexicon with its ARPA G, float32, T=30, B=2), against the JAX package:

- "full" gives `TpuDecoder(g_network=)`'s best final scores (the `vmap`
  of `_decode_scan`, within 1e-4: float32 sums in another order) and
  overflow flags, and "static_cl" `TpuDecoder`'s without a G;
- "no_g_advance" stubs `_g_advance_seq` on its own instance only: the
  class keeps its method, and the stub changes the result (the toy G has
  weights);
- a wave longer than `max_scan_T` raises before anything is timed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig

from juicer_tpu_torch.decoder.core import TorchDecoder, TorchDecoderConfig
from juicer_tpu_torch.harness import profile_otf_step

from test_decoder import scores_matrix
from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)
from test_torch_otf import TOY_BUDGETS, toy  # noqa: F401 (fixture)

B = 2
SCORE_TOL = 1e-4
BEAMS = dict(emit_prune_win=85.0, phone_end_prune_win=60.0, word_prune_win=60.0,
             max_emit_hyps=800)


def jax_wave(jdec, scores):
    def one(s):
        carry = jdec._decode_scan(s.astype(jdec._dt))[0]
        return carry["best_final"]["score"], carry["overflow"]

    sc, ov = jax.jit(jax.vmap(one))(jnp.asarray(scores))
    return np.asarray(sc), np.asarray(ov)


def test_profile_equals_tpu_decoder(toy):  # noqa: F811 (fixture)
    case = toy[0]
    sc = scores_matrix(case.models, 30, seed=33).astype(np.float32)
    db = np.stack([sc] * B)
    cfg = TorchDecoderConfig(emit_diagnostics=False, **TOY_BUDGETS, **BEAMS)
    jcfg = TpuDecoderConfig(emit_diagnostics=False, **TOY_BUDGETS, **BEAMS)
    dec = TorchDecoder(case.part, cfg, device="cpu")
    method = TorchDecoder._g_advance_seq
    out = profile_otf_step.profile(case.part, case.g, dec.scores_tensor(db), cfg=cfg, waves=1)
    assert TorchDecoder._g_advance_seq is method
    for label, g in (("full", case.jg), ("static_cl", None)):
        want_sc, want_ov = jax_wave(TpuDecoder(case.jart, jcfg, g_network=g), db)
        assert out[label]["overflow"] == int(want_ov.sum()), label
        np.testing.assert_allclose(out[label]["best_final"], want_sc, rtol=SCORE_TOL,
                                   atol=SCORE_TOL, err_msg=label)
        assert out[label]["best_final"].max() > -1e29, label
    assert out["full"]["route"].startswith("plain loop: on-the-fly composition")
    assert not np.array_equal(out["no_g_advance"]["best_final"], out["full"]["best_final"])


def test_bench_refuses_frames_past_max_scan_t(toy, monkeypatch):  # noqa: F811 (fixture)
    case = toy[0]
    dec = TorchDecoder(case.part, TorchDecoderConfig(**TOY_BUDGETS), device="cpu",
                       g_network=case.g)
    monkeypatch.setattr(profile_otf_step, "max_scan_T", lambda d: 10)
    db = dec.scores_tensor(np.zeros((1, 11, case.models.n_gmms), np.float32))
    with pytest.raises(ValueError, match="int32"):
        profile_otf_step.bench("full", dec, db)
