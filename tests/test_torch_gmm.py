"""GMM scoring of the PyTorch port against the JAX package.

The port's plain scorer (`juicer_tpu_torch.ops.gmm.gmm_scores_dense`)
is held against `juicer_tpu.ops.gmm.gmm_scores_dense` and the Pallas
kernel in interpret mode, on the same numpy inputs. Tolerances are those
of float32 sums taken in another order: 1e-4 on the small-mean test
models; 1e-3 on the synthetic D=39 task, whose expanded quadratic terms
reach ~1e4 and cancel to scores of ~1e2 (one float32 ulp at 1e4 is
~1e-3), where the float64 oracle shows both packages equally far from
the exact score. The kernel's padded g-major packing is checked here
through a plain reading of it that merges components a chunk at a time,
as the kernel does; the CUDA kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from juicer_tpu.ops.gmm import gmm_scores_dense as jax_gmm_scores_dense
from juicer_tpu.ops.gmm_pallas import make_pallas_gmm_scorer
from juicer_tpu.utils.synth import make_synth_task

from juicer_tpu_torch.convert import gmm_params_from_numpy
from juicer_tpu_torch.ops import gmm_cuda
from juicer_tpu_torch.ops.gmm import gmm_scores_dense, make_gmm_scorer

from test_decoder import make_models

ATOL = {"make_models": 1e-4, "synth": 1e-3}
NEG = -1e30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on shared cores, beside JAX's own
    thread pools; the port's small CPU tensors gain nothing from torch's
    intra-op threads, so these tests use one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drop_components(models, every=3):
    """Leave one component in every `every`-th GMM, so the flat packing has
    padded components."""
    for g in range(0, models.n_gmms, every):
        models.gmm_means[g] = models.gmm_means[g][:1]
        models.gmm_vars[g] = models.gmm_vars[g][:1]
        models.gmm_log_weights[g] = models.gmm_log_weights[g][:1]
    return models


def _model_set(kind):
    if kind == "make_models":
        return _drop_components(make_models(5, n_emit=3, dim=4, n_comps=3, seed=4))
    return _drop_components(
        make_synth_task(n_words=8, n_phones=5, n_comps=4, vec_size=39, seed=2).models)


def _features(models, T, seed):
    rng = np.random.default_rng(seed)
    means = np.concatenate(models.gmm_means)
    pick = means[rng.integers(len(means), size=T)]
    return (pick + rng.normal(size=pick.shape)).astype(np.float32)


def _port_params(p):
    return gmm_params_from_numpy(p.V, p.M, p.b, p.mask)


def _packed_reference(x, W, b, n_gmms):
    """The function the CUDA kernel computes, read off its packed inputs:
    W (2D, G_pad * C_pad) g-major, b (G_pad, C_pad); components merged
    COMP_CHUNK at a time into a running (max, sum), as the kernel does."""
    T = x.shape[0]
    G_pad, C_pad = b.shape
    x2 = torch.cat([x * x, x], dim=1)
    logits = (x2 @ W).view(T, G_pad, C_pad) + b[None]
    m = torch.full((T, G_pad), -torch.inf)
    s = torch.zeros((T, G_pad))
    for c0 in range(0, C_pad, gmm_cuda.COMP_CHUNK):
        chunk = logits[:, :, c0:c0 + gmm_cuda.COMP_CHUNK]
        mx = chunk.amax(dim=2)
        mn = torch.maximum(m, mx)
        s = s * torch.exp(m - mn) + torch.exp(chunk - mx[..., None]).sum(2) * torch.exp(mx - mn)
        m = mn
    out = torch.where(m <= NEG / 2, NEG, m + torch.log(s))
    return out[:, :n_gmms]


def _random_params(rng, D, G, C):
    """Diagonal GMMs in expanded form; GMM g keeps 1 + g % C components
    (the rest padded) and GMM 1, where there is one, none."""
    mu = rng.normal(scale=2.0, size=(G, C, D))
    var = rng.random((G, C, D)) + 0.5
    mask = np.arange(C)[None, :] <= (np.arange(G) % C)[:, None]
    if G > 1:
        mask[1] = False
    V = (-0.5 / var).reshape(G * C, D).T
    M = (mu / var).reshape(G * C, D).T
    b = (-0.5 * (mu * mu / var).sum(-1) - 0.5 * np.log(var).sum(-1)).reshape(-1)
    return gmm_params_from_numpy(V, M, b, mask), mu


@pytest.mark.parametrize("kind", ["make_models", "synth"])
def test_dense_matches_jax_and_pallas(kind):
    models = _model_set(kind)
    p = models.flat_params()
    assert not p.mask.all()  # padded components present
    x = _features(models, 300, seed=7)
    ref = np.asarray(jax_gmm_scores_dense(
        jnp.asarray(x), jnp.asarray(p.V), jnp.asarray(p.M), jnp.asarray(p.b),
        jnp.asarray(p.mask)))
    pallas = np.asarray(make_pallas_gmm_scorer(p, interpret=True)(jnp.asarray(x)))
    pp = _port_params(p)
    out = gmm_scores_dense(torch.as_tensor(x), torch.as_tensor(pp.V),
                           torch.as_tensor(pp.M), torch.as_tensor(pp.b),
                           torch.as_tensor(pp.mask)).numpy()
    assert out.shape == (300, models.n_gmms) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL[kind], rtol=0)
    np.testing.assert_allclose(out, pallas, atol=ATOL[kind], rtol=0)
    exact = np.stack([models.score_all(f.astype(np.float64)) for f in x[:50]])
    assert np.abs(out[:50] - exact).max() <= ATOL[kind]
    # the CPU scorer is the plain version, bit for bit
    scorer = make_gmm_scorer(pp, device="cpu")
    np.testing.assert_array_equal(scorer(x).numpy(), out)


@pytest.mark.parametrize("kind", ["make_models", "synth"])
def test_kernel_packing(kind):
    """pack_params lays out exactly what gmm_scores_dense scores."""
    models = _model_set(kind)
    pp = _port_params(models.flat_params())
    W, b = gmm_cuda.pack_params(pp)
    G_pad, C_pad = b.shape
    assert W.shape == (2 * pp.vec_size, G_pad * C_pad)
    assert G_pad % gmm_cuda.GMM_TILE == 0 and 0 <= G_pad - pp.n_gmms < gmm_cuda.GMM_TILE
    assert C_pad % gmm_cuda.COMP_CHUNK == 0 and 0 <= C_pad - pp.max_comps < gmm_cuda.COMP_CHUNK
    x = torch.as_tensor(_features(models, 64, seed=3))
    dense = gmm_scores_dense(x, torch.as_tensor(pp.V), torch.as_tensor(pp.M),
                             torch.as_tensor(pp.b), torch.as_tensor(pp.mask))
    packed = _packed_reference(x, torch.as_tensor(W), torch.as_tensor(b), pp.n_gmms)
    np.testing.assert_allclose(packed.numpy(), dense.numpy(), atol=ATOL[kind], rtol=0)


@pytest.mark.parametrize("C", [1, 3, 5, 8, 13, 32])
def test_packed_layout_over_component_counts(C):
    """Padded components (and, above COMP_CHUNK, several chunks merged)
    score as gmm_scores_dense does, and as the JAX dense scorer."""
    rng = np.random.default_rng(100 + C)
    D, G, T = 7, 19, 40
    pp, mu = _random_params(rng, D, G, C)
    x = (mu[rng.integers(G, size=T), 0] + rng.normal(size=(T, D))).astype(np.float32)
    x = torch.as_tensor(x)
    dense = gmm_scores_dense(x, torch.as_tensor(pp.V), torch.as_tensor(pp.M),
                             torch.as_tensor(pp.b), torch.as_tensor(pp.mask))
    W, b = gmm_cuda.pack_params(pp)
    packed = _packed_reference(x, torch.as_tensor(W), torch.as_tensor(b), G)
    ref = np.asarray(jax_gmm_scores_dense(
        jnp.asarray(x.numpy()), jnp.asarray(pp.V), jnp.asarray(pp.M), jnp.asarray(pp.b),
        jnp.asarray(pp.mask)))
    assert (dense[:, 1] == NEG).all() and (packed[:, 1] == NEG).all()
    np.testing.assert_allclose(packed.numpy(), dense.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(packed.numpy(), ref, atol=1e-4, rtol=0)


def test_kernel_limits():
    """The wrapper's shape limits, through the check it makes before a
    launch: D up to MAX_DIM and C up to MAX_COMPS."""
    gmm_cuda.check_limits(gmm_cuda.MAX_DIM, gmm_cuda.MAX_COMPS)
    gmm_cuda.check_limits(1, 1)
    assert (gmm_cuda.MAX_DIM, gmm_cuda.MAX_COMPS) == (192, 32)
    for D, C in ((193, 8), (0, 8), (39, 33), (39, 0)):
        with pytest.raises(ValueError):
            gmm_cuda.check_limits(D, C)
    pp, _ = _random_params(np.random.default_rng(1), 193, 3, 2)
    with pytest.raises(ValueError, match="feature size 193"):
        gmm_cuda.pack_params(pp)
    pp, _ = _random_params(np.random.default_rng(1), 4, 3, 33)
    with pytest.raises(ValueError, match="33 components"):
        gmm_cuda.pack_params(pp)


def test_all_padded_gmm_scores_neg():
    rng = np.random.default_rng(0)
    D, G, C = 3, 4, 2
    mask = np.ones((G, C), bool)
    mask[2] = False
    pp = gmm_params_from_numpy(-rng.random((D, G * C)) - 0.5, rng.normal(size=(D, G * C)),
                               rng.normal(size=G * C), mask)
    x = torch.as_tensor(rng.normal(size=(5, D)).astype(np.float32))
    dense = gmm_scores_dense(x, torch.as_tensor(pp.V), torch.as_tensor(pp.M),
                             torch.as_tensor(pp.b), torch.as_tensor(pp.mask))
    W, b = gmm_cuda.pack_params(pp)
    packed = _packed_reference(x, torch.as_tensor(W), torch.as_tensor(b), G)
    assert (dense[:, 2] == NEG).all() and (packed[:, 2] == NEG).all()
    assert torch.isfinite(dense[:, [0, 1, 3]]).all()
    np.testing.assert_allclose(packed.numpy(), dense.numpy(), atol=1e-4, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    pp = _port_params(make_models(2, dim=4, n_comps=2, seed=1).flat_params())
    W, b = gmm_cuda.pack_params(pp)
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        gmm_cuda.gmm_logsumexp(x, torch.as_tensor(W), torch.as_tensor(b), pp.n_gmms)


def test_scorer_needs_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pp = _port_params(make_models(2, dim=4, n_comps=2, seed=1).flat_params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_gmm_scorer(pp)
