"""`juicer_tpu_torch/harness/scale_bench.py` against the JAX package's
`scripts/scale_bench.py`, on the CPU, at a small size.

- `build_big_network` gives the JAX script's network arc for arc (20,000
  arcs, 50 models, 500 words; the JAX script is imported by path here,
  and only here);
- the port's `utils.synth.make_models` gives `tests/test_decoder.
  make_models`' parameters bit for bit (`flat_params` and topology);
- on a 4,000-arc network of the same kind, a single-stream decode at
  small budgets equals `TpuDecoder.decode_scores` (words exactly, score
  within 1e-4, float32 sums in another order), and a B=2 wave's best
  final scores (within 1e-4) and overflow flags (exactly) equal the JAX
  script's `vmap` of `_decode_scan`.
"""

import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig

from juicer_tpu_torch.decoder.artifact import DecoderArtifact
from juicer_tpu_torch.decoder.core import TorchDecoder
from juicer_tpu_torch.harness import scale_bench
from juicer_tpu_torch.utils.synth import make_models

from test_decoder import make_models as jax_make_models
from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-4
N_MODELS, N_WORDS = 50, 500
K, E, T = 128, 512, 100


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_scale_bench", os.path.join(ROOT, "scripts", "scale_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NET_FIELDS = ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight", "row_ptr",
              "final_weight")


def test_build_big_network_is_the_jax_scripts(jax_script):
    got = scale_bench.build_big_network(n_arcs=20_000, n_models=N_MODELS, n_words=N_WORDS)
    want = jax_script.build_big_network(n_arcs=20_000, n_models=N_MODELS, n_words=N_WORDS)
    assert (got.n_states, got.n_arcs, got.init_state) == (
        want.n_states, want.n_arcs, want.init_state)
    for name in NET_FIELDS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("args", [
    dict(n_hmms=N_MODELS, n_emit=3, dim=39, n_comps=8, seed=1),
    dict(n_hmms=4, n_emit=2, dim=4, n_comps=2, seed=3, tee_probs=[0.0, 0.3, 0.0, 0.5]),
])
def test_make_models_equals_the_test_helper(args):
    got, want = make_models(**args), jax_make_models(**args)
    gp, wp = got.flat_params(), want.flat_params()
    for name in ("V", "M", "b", "mask"):
        assert np.array_equal(np.asarray(getattr(gp, name)), np.asarray(getattr(wp, name))), name
    for a, b in zip(got.packed_topology(), want.packed_topology()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def small(jax_script):
    """A 4,000-arc network of the script's kind, the 150-GMM models, both
    packages' artifacts and decoders at small budgets."""
    net = scale_bench.build_big_network(n_arcs=4000, n_models=N_MODELS, n_words=N_WORDS)
    jnet = jax_script.build_big_network(n_arcs=4000, n_models=N_MODELS, n_words=N_WORDS)
    models = make_models(N_MODELS, n_emit=3, dim=39, n_comps=8, seed=1)
    jmodels = jax_make_models(N_MODELS, n_emit=3, dim=39, n_comps=8, seed=1)
    dec = TorchDecoder(DecoderArtifact(net, models), scale_bench.decoder_config(K, E),
                       device="cpu")
    jdec = TpuDecoder(JaxArtifact(jnet, jmodels), TpuDecoderConfig(
        max_insts=K, expand_budget=E, final_budget=1024, emit_prune_win=150.0,
        phone_end_prune_win=120.0, word_prune_win=120.0, max_emit_hyps=8000))
    return dec, jdec, models.n_gmms


def test_single_stream_equals_tpu_decoder(small):
    dec, jdec, G = small
    scores = scale_bench.score_batch(0, G, T=T)
    got = scale_bench.single_stream(dec, scores)
    want = jdec.decode_scores(scores)
    assert got["route"] == "frame_step"
    assert got["result"].words == want.words
    assert abs(got["result"].score - want.score) <= SCORE_TOL * max(1.0, abs(want.score))


def test_batch_wave_equals_the_jax_vmap(small):
    dec, jdec, G = small
    scores = scale_bench.score_batch(2, G, T=T)
    got = scale_bench.batch_wave(dec, scores)

    def one(s):
        carry, _, _ = jdec._decode_scan(s.astype(jdec._dt))
        return carry["best_final"]["score"], carry["overflow"]

    sc, ov = jax.jit(jax.vmap(one))(jnp.asarray(scores))
    want_sc, want_ov = np.asarray(sc), np.asarray(ov)
    assert np.array_equal(got["overflow"], want_ov)
    np.testing.assert_allclose(got["best_final"], want_sc, rtol=SCORE_TOL, atol=SCORE_TOL)


def test_parse_args_takes_the_scripts_positionals():
    a = scale_bench.parse_args(["2000", "768", "--batch", "8"])
    assert (a.n_arcs, a.K, a.E, a.batch, a.maxhyps, a.merge) == (2000, 768, 32768, 8, 8000,
                                                                "auto")
    with pytest.raises(SystemExit):
        scale_bench.parse_args(["1", "2", "3", "4"])
