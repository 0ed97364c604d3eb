"""Tests of the port that need a CUDA card (marker `gpu`).

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch; there, run it without the repository's
conftest (which configures JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from juicer_tpu_torch.convert import gmm_params_from_numpy
from juicer_tpu_torch.decoder.core import REC_FIELDS, TorchDecoder, host_batch
from juicer_tpu_torch.harness import wsj_task
from juicer_tpu_torch.ops import gmm_cuda
from juicer_tpu_torch.ops.gmm import gmm_scores_dense, make_gmm_scorer

NEG = -1e30


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _random_params(rng, D, G, C):
    """Diagonal GMMs in expanded form; every 4th GMM has one component and
    GMM 1 none (it must score -1e30)."""
    mu = rng.normal(scale=2.0, size=(G, C, D))
    var = rng.random((G, C, D)) + 0.5
    mask = np.ones((G, C), bool)
    mask[::4, 1:] = False
    mask[1] = False
    V = (-0.5 / var).reshape(G * C, D).T
    M = (mu / var).reshape(G * C, D).T
    b = (-0.5 * (mu * mu / var).sum(-1) - 0.5 * np.log(var).sum(-1)).reshape(-1)
    return gmm_params_from_numpy(V, M, b, mask), mu


@pytest.mark.gpu
@pytest.mark.parametrize("T,D,G,C", [(1, 4, 3, 2), (100, 39, 141, 8), (4099, 13, 33, 3)])
def test_kernel_matches_plain(card, T, D, G, C):
    rng = np.random.default_rng(T + D)
    params, mu = _random_params(rng, D, G, C)
    scorer = make_gmm_scorer(params, device=card)
    g = rng.integers(G, size=T)
    x = mu[g, 0] + rng.normal(size=(T, D))
    x = torch.as_tensor(x.astype(np.float32), device=card)
    n0 = gmm_cuda.counter.launches
    out = scorer(x)
    torch.cuda.synchronize()
    assert gmm_cuda.counter.launches == n0 + 1
    dense = gmm_scores_dense(x, scorer.V, scorer.M, scorer.b, scorer.mask)
    assert (out[:, 1] == NEG).all()
    np.testing.assert_allclose(out.cpu().numpy(), dense.cpu().numpy(), atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_kernel_refuses_bad_input(card):
    params, _ = _random_params(np.random.default_rng(0), 4, 5, 2)
    scorer = make_gmm_scorer(params, device=card)
    x = torch.zeros((8, 4), device=card)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_logsumexp(x.double(), scorer.W, scorer.b_packed, 5)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_logsumexp(torch.zeros((8, 5), device=card), scorer.W, scorer.b_packed, 5)
    with pytest.raises(ValueError):
        scorer(torch.zeros((8, 4)))


@pytest.mark.gpu
def test_card_decode_equals_cpu(card):
    """A short 2k-task sentence: card and CPU decode the same scores to the
    same records and words, and the words are the transcript."""
    task = wsj_task.load_task("2k", verbose=False)
    words, feats = wsj_task.sample_utterances(task.cache, task.models, 2, 250, seed=12)[1]
    scores = make_gmm_scorer(task.models.flat_params(), device=card)(
        torch.as_tensor(feats, device=card))
    cfg = wsj_task.decoder_config()
    out = []
    for device, sc in ((card, scores), ("cpu", scores.cpu())):
        dec = TorchDecoder(task.artifact, cfg, device=device)
        host = host_batch(*dec.run(sc[None]))
        out.append((dec.traceback(host, 0, sc.shape[0]), host[1]))
    (r_card, ys_card), (r_cpu, ys_cpu) = out
    for k in REC_FIELDS:
        np.testing.assert_array_equal(ys_card[k], ys_cpu[k], err_msg=k)
    assert r_card.words == r_cpu.words and r_card.score == r_cpu.score
    labels, markers = wsj_task.word_labels(task.cache)
    assert [w for w in r_card.words if w not in markers] == [labels[w] for w in words]
