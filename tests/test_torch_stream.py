"""Streaming decoder of the PyTorch port against the JAX package's.

The same networks as `tests/test_stream.py` (a chain of three words and a
four-word loop) and a synth CLG go through `juicer_tpu.decoder.stream.
StreamingDecoder` over a float32 `TpuDecoder` and through the port's
`StreamingDecoder` over `TorchDecoder(device="cpu")`, whose feeds run the
plain frame loop `TorchDecoder.run(carry=, t0=)`. The same numpy score
chunks go in. Per chunk the emitted words and word-end frames must be
equal, their scores within 1e-4 (float32 on both sides; in practice equal);
`finish()` must give the JAX stream's words, frames and scores, and equal
the port's own `decode_scores` exactly. The chain and the loop also
stream in float64, configured as `tests/test_stream.py` configures them
(JAX under `jax_enable_x64`), to within 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from juicer_tpu.decoder import DecoderNetwork as JaxNetwork
from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.fst import Fst, LOG
from juicer_tpu.ops.gmm import make_gmm_scorer as jax_gmm_scorer
from juicer_tpu.utils.synth import make_synth_task

from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig
from juicer_tpu_torch.decoder.stream import StreamingDecoder

from test_decoder import make_models, scores_matrix
from test_torch_decoder import carry_across

SCORE_TOL = 1e-4


def _chain():
    models = make_models(6)
    f = Fst(LOG)
    s = f.add_state()
    f.set_start(s)
    hmm = 0
    for w in range(3):
        for p in range(2):
            t = f.add_state()
            f.add_arc(s, t, hmm + 1, (w + 1) if p == 1 else 0, 0.1 * (w + p))
            s = t
            hmm += 1
    f.set_final(s, 0.05)
    return JaxNetwork(f), models, scores_matrix(models, 20, seed=1), dict(
        max_insts=64, expand_budget=256, final_budget=64)


def _loop():
    models = make_models(4, seed=13)
    f = Fst(LOG)
    s0 = f.add_state()
    f.set_start(s0)
    for w in range(4):
        f.add_arc(s0, s0, w + 1, w + 1, 0.5)
    f.set_final(s0, 0.0)
    return JaxNetwork(f), models, scores_matrix(models, 60, seed=17), dict(
        max_insts=64, expand_budget=256, final_budget=64)


def _synth():
    task = make_synth_task(n_words=12, n_phones=8, n_comps=4, vec_size=6, seed=3)
    rng = np.random.default_rng(5)
    feats = task.synth_utterance([f"w{rng.integers(12)}" for _ in range(5)], rng)
    scores = np.asarray(jax_gmm_scorer(task.models.flat_params())(jnp.asarray(feats)))
    return task.network, task.models, scores, dict(
        max_insts=256, expand_budget=1024, final_budget=256, emit_prune_win=60.0,
        phone_end_prune_win=40.0, max_emit_hyps=40)


NETWORKS = {"chain": _chain, "loop": _loop, "synth": _synth}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Per network: the JAX decoder, the port's CPU decoder, the scores."""
    out = {}
    for name, make in NETWORKS.items():
        net, models, scores, kw = make()
        jart = JaxArtifact(net, models)
        _, _, part = carry_across(tmp_path_factory.mktemp(name), net, models, jart)
        out[name] = (TpuDecoder(jart, TpuDecoderConfig(**kw)),
                     TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu"),
                     np.asarray(scores, np.float32))
    return out


def _hyps(hyps):
    return [(h.word, h.end_frame) for h in hyps]


def _assert_scores_close(got, want, ctx):
    for g, w in zip(got, want):
        for a, b in ((g.score, w.score), (g.acoustic, w.acoustic), (g.lm, w.lm)):
            assert abs(a - b) < SCORE_TOL, ctx


@pytest.mark.parametrize("chunk", [1, 7, None])
@pytest.mark.parametrize("network", list(NETWORKS))
def test_stream_matches_jax(cases, network, chunk):
    jdec, pdec, sc = cases[network]
    step = chunk or len(sc)
    jstream, pstream = jdec.stream(), pdec.stream()
    assert isinstance(pstream, StreamingDecoder)
    emitted = []
    for i in range(0, len(sc), step):
        want, got = jstream.feed(sc[i:i + step]), pstream.feed(sc[i:i + step])
        assert _hyps(got) == _hyps(want), (network, chunk, i)
        _assert_scores_close(got, want, (network, chunk, i))
        emitted += got
    jfin, pfin = jstream.finish(), pstream.finish()
    assert pfin.words == jfin.words and _hyps(pfin.word_hyps) == _hyps(jfin.word_hyps)
    assert pfin.n_frames == jfin.n_frames == len(sc)
    for a, b in ((pfin.score, jfin.score), (pfin.acoustic_score, jfin.acoustic_score),
                 (pfin.lm_score, jfin.lm_score)):
        assert abs(a - b) < SCORE_TOL
    _assert_scores_close(pfin.word_hyps, jfin.word_hyps, (network, chunk))
    # the partial words are a prefix of the final result, and the stream's
    # result is the one-piece decode's
    assert _hyps(emitted) == _hyps(pfin.word_hyps[:len(emitted)])
    whole = pdec.decode_scores(sc)
    assert pfin.words == whole.words and pfin.word_hyps == whole.word_hyps
    assert (pfin.score, pfin.acoustic_score, pfin.lm_score) == (
        whole.score, whole.acoustic_score, whole.lm_score)
    assert pfin.words


def test_loop_emits_before_finish(cases):
    """Words of a long loop utterance converge before the stream ends; a
    decoder without diagnostics (no per-frame snapshots) streams alike."""
    _, pdec, sc = cases["loop"]
    quiet = TorchDecoder(pdec.art, dataclasses.replace(pdec.cfg, emit_diagnostics=False),
                         device="cpu")
    stream, quiet_stream = pdec.stream(), quiet.stream()
    counts = []
    for i in range(0, len(sc), 10):
        assert stream.feed(sc[i:i + 10]) == quiet_stream.feed(sc[i:i + 10])
        counts.append(len(stream._emitted))
    assert counts[-2] > 0
    final = stream.finish()
    assert counts[-1] <= len(final.words) and final == quiet_stream.finish()


def test_stream_refuses_beyond_int32_record_ids(cases):
    _, pdec, sc = cases["chain"]
    stream = pdec.stream()
    stream.feed(sc[:3])
    stream.t = (2**31 - 1) // pdec.K - 2  # as if that many frames had passed
    with pytest.raises(ValueError, match="int32 record ids"):
        stream.feed(sc[:3])
    with pytest.raises(ValueError, match="before any frame"):
        pdec.stream().finish()
    assert stream.feed(torch.zeros((0, sc.shape[1]))) == []


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("network,cuts", [("chain", (7, 13)), ("loop", (10, 20, 30, 40, 50))])
def test_float64_stream_matches_jax(tmp_path, x64, network, cuts):
    """`tests/test_stream.py`'s float64 decoders and chunks: every chunk's
    emissions and `finish()` equal the JAX stream's, scores within 1e-9; the
    session's records are int64 words that carry float64 scores."""
    net, models, sc, kw = NETWORKS[network]()
    jart = JaxArtifact(net, models)
    _, _, part = carry_across(tmp_path, net, models, jart)
    kw = dict(kw, dtype="float64")
    jdec = TpuDecoder(jart, TpuDecoderConfig(**kw))
    pdec = TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")
    jstream, pstream = jdec.stream(), pdec.stream()
    bounds = (0,) + cuts + (len(sc),)
    emitted = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        want, got = jstream.feed(sc[a:b]), pstream.feed(sc[a:b])
        assert _hyps(got) == _hyps(want), (network, a)
        for g, w in zip(got, want):
            for x, y in ((g.score, w.score), (g.acoustic, w.acoustic), (g.lm, w.lm)):
                assert abs(x - y) < 1e-9
        emitted += got
    assert all(p.dtype == np.int64 for p in pstream._pieces)
    jfin, pfin = jstream.finish(), pstream.finish()
    assert pfin.words == jfin.words and _hyps(pfin.word_hyps) == _hyps(jfin.word_hyps)
    for a, b in ((pfin.score, jfin.score), (pfin.acoustic_score, jfin.acoustic_score),
                 (pfin.lm_score, jfin.lm_score)):
        assert abs(a - b) < 1e-9
    whole = pdec.decode_scores(sc)
    assert pfin.words == whole.words and pfin.word_hyps == whole.word_hyps
    assert (pfin.score, pfin.acoustic_score, pfin.lm_score) == (
        whole.score, whole.acoustic_score, whole.lm_score)
    assert pfin.words and _hyps(emitted) == _hyps(pfin.word_hyps[:len(emitted)])
