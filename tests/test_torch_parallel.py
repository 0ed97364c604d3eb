"""Batch decoding over a mesh (`juicer_tpu_torch.parallel.mesh`) against
the JAX package's single-device decode, on the CPU.

The counterpart of `tests/test_parallel.py::TestBatchDecoder` and of the
assertions of `__graft_entry__.dryrun_multichip`. A CPU mesh is
`make_mesh(n, "cpu")`: n replicas on the CPU device, as the JAX tests'
virtual host devices are. The same numpy scores go through `TpuDecoder`
one utterance at a time and through the port's `BatchDecoder` over the
mesh: words equal, scores within 1e-4 (1e-3 on the synthetic task, as
`dryrun_multichip` holds it). Uneven and empty shares must equal the
port's decode without a mesh bit for bit.
"""

import numpy as np
import pytest
import torch

from juicer_tpu.decoder import DecoderNetwork as JaxNetwork, TpuDecoder
from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.tpu_core import TpuDecoderConfig
from juicer_tpu.fst import Fst, LOG
from juicer_tpu.harness.editdist import EditDistance as JaxEditDistance
from juicer_tpu.ops.gmm import make_gmm_scorer as jax_gmm_scorer
from juicer_tpu.utils.synth import make_synth_task as jax_make_synth_task

from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig
from juicer_tpu_torch.harness.editdist import EditDistance
from juicer_tpu_torch.parallel import BatchDecoder, make_mesh
from juicer_tpu_torch.parallel.mesh import shares
from juicer_tpu_torch.utils.synth import make_synth_task

from test_decoder import make_models, scores_matrix
from test_torch_decoder import _one_torch_thread, carry_across  # noqa: F401 (fixture)

SCORE_TOL = 1e-4
BUDGETS = dict(max_insts=64, expand_budget=256, final_budget=64)
ROUTES = [True, False]


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """`test_parallel.make_task`'s word loop: the JAX decoder and the port's
    on the CPU, over the same network, models and artifact."""
    models = make_models(6, seed=3)
    f = Fst(LOG)
    s0 = f.add_state()
    f.set_start(s0)
    for w in range(6):
        f.add_arc(s0, s0, w + 1, w + 1, 0.4)
    f.set_final(s0, 0.0)
    net = JaxNetwork(f)
    art = JaxArtifact(net, models)
    jdec = TpuDecoder(art, TpuDecoderConfig(**BUDGETS))
    _, _, part = carry_across(tmp_path_factory.mktemp("mesh"), net, models, art)
    pdec = TorchDecoder(part, TorchDecoderConfig(**BUDGETS), device="cpu")
    return models, jdec, pdec


def assert_matches_jax(results, singles, tol, ctx):
    assert len(results) == len(singles), ctx
    for b, (r, s) in enumerate(zip(results, singles)):
        assert r.words == s.words, (ctx, b, r.words, s.words)
        assert abs(r.score - s.score) < tol, (ctx, b, r.score, s.score)


@pytest.mark.parametrize("use_fused", ROUTES)
def test_sharded_batch_matches_jax(task, use_fused):
    models, jdec, pdec = task
    B, T = 8, 12
    scores = np.stack([scores_matrix(models, T, seed=s) for s in range(B)])
    bd = BatchDecoder(pdec, make_mesh(8, "cpu"), use_fused=use_fused)
    results = bd.decode_scores_batch(scores)
    assert_matches_jax(results, [jdec.decode_scores(scores[b]) for b in range(B)], SCORE_TOL,
                       f"use_fused={use_fused}")
    assert all(r.words for r in results)
    # one replica serves all eight entries of a CPU mesh: the decoder itself
    assert list(bd.replicas.values()) == [pdec]
    # one fused scan a share size; none on the plain route
    assert set(bd._fs) == ({(pdec.device, 1)} if use_fused else set())


@pytest.mark.parametrize("use_fused", ROUTES)
def test_padded_batch_over_mesh_exact_per_length(task, use_fused):
    """`test_parallel.py::test_padded_batch_exact_per_length` over a mesh of
    two: shares of 2 and 1 padded utterances, each read at its length."""
    models, jdec, pdec = task
    lengths = [7, 12, 18]
    scores = [scores_matrix(models, L, seed=10 + i) for i, L in enumerate(lengths)]
    singles = [jdec.decode_scores(s) for s in scores]
    t_max = max(lengths)
    padded = np.stack([np.pad(s, ((0, t_max - s.shape[0]), (0, 0)), mode="edge")
                       for s in scores])
    results = BatchDecoder(pdec, make_mesh(2, "cpu"), use_fused=use_fused).decode_scores_batch(
        padded, lengths)
    assert_matches_jax(results, singles, SCORE_TOL, "padded")
    for r, s in zip(results, singles):
        assert r.n_frames == s.n_frames
        assert [h.end_frame for h in r.word_hyps] == [h.end_frame for h in s.word_hyps]


@pytest.mark.parametrize("use_fused", ROUTES)
@pytest.mark.parametrize("B, n", [(5, 2), (3, 8), (16, 3)])
def test_uneven_and_empty_shares_equal_single_device(task, use_fused, B, n):
    models, _, pdec = task
    lengths = [9 + (b % 4) for b in range(B)]
    scores = np.stack([np.pad(scores_matrix(models, L, seed=20 + b), ((0, 12 - L), (0, 0)),
                              mode="edge") for b, L in enumerate(lengths)])
    want = BatchDecoder(pdec, use_fused=use_fused).decode_scores_batch(scores, lengths)
    bd = BatchDecoder(pdec, make_mesh(n, "cpu"), use_fused=use_fused)
    got = bd.decode_scores_batch(scores, lengths)
    assert got == want  # every field of every DecodeResult, floats bit for bit
    sizes = [hi - lo for lo, hi in shares(B, n)]
    assert sum(sizes) == B and max(sizes) - min(sizes) <= 1
    # empty shares are not launched
    assert set(bd._fs) == ({(pdec.device, s) for s in sizes if s} if use_fused else set())


def test_shares():
    assert shares(16, 3) == [(0, 6), (6, 11), (11, 16)]
    assert shares(3, 8) == [(0, 1), (1, 2), (2, 3)] + [(3, 3)] * 5
    assert shares(132, 2) == [(0, 66), (66, 132)]


@pytest.fixture(scope="module")
def dryrun():
    """The synthetic task of `dryrun_multichip` (12 words, K=128, E=256):
    B=16 padded utterances of 4 distinct sentences, scored by the JAX
    scorer, and the JAX single-device decode of each sentence."""
    import jax.numpy as jnp

    jtask = jax_make_synth_task(n_words=12, n_phones=8, vec_size=8, seed=0)
    cfg = dict(max_insts=128, expand_budget=256, final_budget=256)
    jdec = TpuDecoder(jtask.artifact, TpuDecoderConfig(**cfg))
    rng = np.random.default_rng(0)
    B, T, n_distinct = 16, 40, 4
    words = [f"w{i}" for i in range(12)]
    distinct = [jtask.synth_utterance([words[rng.integers(12)] for _ in range(2)], rng)[:T]
                for _ in range(n_distinct)]
    lengths = [distinct[i % n_distinct].shape[0] for i in range(B)]
    feats = np.stack([np.concatenate([f, np.tile(f[-1:], (T - len(f), 1))])
                      for f in (distinct[i % n_distinct] for i in range(B))])
    scorer = jax_gmm_scorer(jtask.models.flat_params())
    scores = np.asarray(scorer(jnp.asarray(feats.reshape(B * T, -1), jnp.float32))).reshape(
        B, T, -1)
    truth = [jdec.decode_scores(scores[i][:lengths[i]]) for i in range(n_distinct)]
    assert all(r.words for r in truth)
    ptask = make_synth_task(n_words=12, n_phones=8, vec_size=8, seed=0)
    pdec = TorchDecoder(ptask.artifact, TorchDecoderConfig(**cfg), device="cpu")
    return pdec, scores, lengths, [truth[i % n_distinct] for i in range(B)]


@pytest.mark.parametrize("use_fused", ROUTES)
def test_dryrun_multichip_task_over_mesh(dryrun, use_fused):
    pdec, scores, lengths, truth = dryrun
    results = BatchDecoder(pdec, make_mesh(8, "cpu"), use_fused=use_fused).decode_scores_batch(
        scores, lengths)
    assert_matches_jax(results, truth, 1e-3, f"dryrun use_fused={use_fused}")


def test_edit_distance_add_matches_jax():
    rng = np.random.default_rng(5)
    pairs = [([int(w) for w in rng.integers(0, 6, rng.integers(0, 7))],
              [int(w) for w in rng.integers(0, 6, rng.integers(0, 7))]) for _ in range(12)]
    shards = [(EditDistance(), JaxEditDistance()) for _ in range(3)]
    for i, (hyp, ref) in enumerate(pairs):
        for e in shards[i % 3]:
            e.distance(hyp, ref)
    total, jtotal = EditDistance(), JaxEditDistance()
    for e, je in shards:
        total.add(e)
        jtotal.add(je)
    assert vars(total) == vars(jtotal)
    assert total.summary() == jtotal.summary()
    one = EditDistance()
    for hyp, ref in pairs:
        one.distance(hyp, ref)
    assert vars(total) == vars(one)


def test_make_mesh():
    assert make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert make_mesh(device="cpu") == (torch.device("cpu"),)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices asked for"):
        make_mesh(have + 1, "cuda")
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    with pytest.raises(ValueError, match="empty mesh"):
        BatchDecoder(None, mesh=())
