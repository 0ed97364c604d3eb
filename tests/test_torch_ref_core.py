"""The port's oracle decoders against the JAX package's, and against the
port's own float64 `TorchDecoder`.

  - `RefDecoder` on the fuzz networks and pruning rows of
    `tests/test_fuzz_parity.py` (12 networks of 3-64 states, two rows of
    `CONFIG_ROWS` each, four score draws): words, word-end frames,
    scores and every word hypothesis's scores within TOL (1e-12) of the
    JAX `RefDecoder` on the same numpy scores (both are float64 Python
    token passing; in practice equal), and through `features=` (the
    models' float64 oracle scoring) the same;
  - the port's `RefDecoder` against the port's float64 `TorchDecoder` on
    the same networks and scores, as `test_fuzz_parity.assert_parity`
    holds the JAX pair (words; scores within 1e-6; word-end frames where
    no histogram binds);
  - `RefOtfDecoder` against the JAX one on `tests/test_otf.py`'s toy CL
    and ARPA G and on the `test_fuzz_otf` networks with a random backoff
    G, within TOL.
"""

import numpy as np
import pytest
import torch

from juicer_tpu.decoder import RefDecoder as JaxRefDecoder
from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.otf import RefOtfDecoder as JaxRefOtfDecoder

from juicer_tpu_torch.decoder import RefDecoder, RefOtfDecoder, TorchDecoder, TorchDecoderConfig

from test_decoder import scores_matrix
from test_fuzz_parity import CONFIG_ROWS, N_DRAWS, assert_parity, random_case
from test_torch_decoder import carry_across
from test_torch_otf import FUZZ_SEEDS, fuzz, toy  # noqa: F401  (module fixtures)

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(got, want, ctx):
    assert got.empty == want.empty and got.n_frames == want.n_frames, ctx
    assert got.words == want.words, (ctx, got.words, want.words)
    assert [h.end_frame for h in got.word_hyps] == [h.end_frame for h in want.word_hyps], ctx
    for a, b in ((got.score, want.score), (got.acoustic_score, want.acoustic_score),
                 (got.lm_score, want.lm_score)):
        assert abs(a - b) <= TOL, ctx
    for hg, hw in zip(got.word_hyps, want.word_hyps):
        assert hg.word == hw.word, ctx
        for a, b in ((hg.score, hw.score), (hg.acoustic, hw.acoustic), (hg.lm, hw.lm)):
            assert abs(a - b) <= TOL, ctx


def _fuzz(tmp_path, net_seed):
    max_states = 9 if net_seed < 6 else 64
    rng, models, net = random_case(net_seed, max_states=max_states)
    pnet, pmodels, part = carry_across(tmp_path, net, models, JaxArtifact(net, models))
    rows = [CONFIG_ROWS[net_seed % 6], CONFIG_ROWS[(net_seed + 3) % 6]]
    return rng, models, net, pnet, pmodels, part, rows, max_states > 9


@pytest.mark.parametrize("net_seed", range(12))
def test_ref_decoder_equals_jax_on_fuzz_networks(tmp_path, net_seed):
    rng, models, net, pnet, pmodels, _, rows, _ = _fuzz(tmp_path, net_seed)
    n_found = 0
    for prune, _ in rows:
        want_dec, got_dec = JaxRefDecoder(net, models, **prune), RefDecoder(pnet, pmodels, **prune)
        for draw in range(N_DRAWS):
            T = int(rng.integers(4, 40))
            sc = scores_matrix(models, T, seed=net_seed * 100 + draw)
            want = want_dec.decode(score_fn=lambda t, g: float(sc[t, g]), n_frames=T)
            got = got_dec.decode(score_fn=lambda t, g: float(sc[t, g]), n_frames=T)
            assert_same(got, want, (net_seed, prune, draw))
            n_found += not got.empty
        feats = np.random.default_rng(net_seed).normal(size=(12, models.vec_size))
        assert_same(got_dec.decode(features=feats), want_dec.decode(features=feats),
                    (net_seed, prune, "features"))
    assert n_found > 0


@pytest.mark.parametrize("net_seed", range(12))
def test_ref_decoder_equals_torch_decoder_float64(tmp_path, net_seed):
    rng, models, _, pnet, pmodels, part, rows, big = _fuzz(tmp_path, net_seed)
    for prune, extra in rows:
        ref = RefDecoder(pnet, pmodels, **prune)
        dec = TorchDecoder(part, TorchDecoderConfig(
            max_insts=512 if big else 128, expand_budget=4096 if big else 1024,
            final_budget=512 if big else 256, dtype="float64", **prune,
            **{k: v for k, v in extra.items() if k != "scan_unroll"}), device="cpu")
        for draw in range(N_DRAWS):
            T = int(rng.integers(4, 40))
            sc = scores_matrix(models, T, seed=net_seed * 100 + draw)
            r_ref = ref.decode(score_fn=lambda t, g: float(sc[t, g]), n_frames=T)
            r_dec = dec.decode_scores(sc)
            assert not r_dec.overflow
            assert_parity(r_ref, r_dec, (net_seed, prune, extra, draw),
                          check_frames=prune.get("max_emit_hyps", 0) == 0)


@pytest.mark.parametrize("name", ["toy"] + [f"fuzz{s}" for s in FUZZ_SEEDS])
def test_ref_otf_decoder_equals_jax(toy, fuzz, name):  # noqa: F811
    case = toy[0] if name == "toy" else fuzz[int(name[4:])]
    rng = np.random.default_rng(17)
    n_words = 0
    for prune in ({}, dict(emit_prune_win=50.0, phone_end_prune_win=40.0, word_prune_win=40.0,
                           max_emit_hyps=4)):
        want_dec = JaxRefOtfDecoder(case.cl_net, case.jg, case.models, **prune)
        got_dec = RefOtfDecoder(case.part.net, case.g, case.part.models, **prune)
        for draw in range(3):
            T = int(rng.integers(8, 40))
            sc = scores_matrix(case.models, T, seed=500 + draw)
            want = want_dec.decode(score_fn=lambda t, g: float(sc[t, g]), n_frames=T)
            got = got_dec.decode(score_fn=lambda t, g: float(sc[t, g]), n_frames=T)
            assert_same(got, want, (name, prune, draw))
            n_words += len(got.words)
    assert n_words > 0
