"""Lattice generation of the PyTorch port against the JAX package.

Following `tests/test_lattice.py`: the same numpy scores go through
`TpuDecoder.decode_scores_lattice` (float64 under `jax_enable_x64`, or
float32) and `TorchDecoder(device="cpu").decode_scores_lattice` with the
same configuration, in both merge strategies. The lattice records of the
scan (`lat_*`, `flat_*`, `ev_*`) must equal JAX's where they are valid
(an edge where `*_valid`, an event where `ev_arc >= 0`), and the lattice
`Fst` must equal JAX's arc by arc: states, start, arcs, labels, finals,
weights within 1e-9 in float64 and 1e-4 in float32 (in practice equal).
Its best path is the 1-best decode, and `contains_cost` and
`write_lattice`'s text equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from juicer_tpu.decoder import lattice as jax_lattice
from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.network import DecoderNetwork as JaxNetwork
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.fst import EPSILON as JAX_EPSILON
from juicer_tpu.fst import Fst as JaxFst
from juicer_tpu.fst import LOG as JAX_LOG
from juicer_tpu.fst import algos as jax_algos
from juicer_tpu.fst import read_fsm

from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig
from juicer_tpu_torch.decoder.core import EV_FIELDS, FLAT_FIELDS, LAT_FIELDS
from juicer_tpu_torch.decoder.lattice import (contains_cost, shortest_path,
                                              write_lattice)
from juicer_tpu_torch.fst import EPSILON, LOG, Fst, algos

from test_decoder import make_models, scores_matrix
from test_fuzz_parity import random_case
from test_torch_decoder import carry_across

TOL = {"float64": 1e-9, "float32": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _x64_one_thread():
    jax.config.update("jax_enable_x64", True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_x64", False)


def _decoders(tmp_path, net, models, **kw):
    jart = JaxArtifact(net, models)
    _, _, part = carry_across(tmp_path, net, models, jart)
    kw = dict(dict(max_insts=64, expand_budget=256, final_budget=64, dtype="float64",
                   gen_lattice=True), **kw)
    return (TpuDecoder(jart, TpuDecoderConfig(**kw)),
            TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu"))


def assert_same_fst(got, want, tol):
    assert (got.num_states, got.start, got.num_arcs) == (want.num_states, want.start,
                                                          want.num_arcs)
    for name in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel"):
        assert list(getattr(got, name)) == list(getattr(want, name)), name
    np.testing.assert_allclose(got.arc_weight, want.arc_weight, rtol=0, atol=tol)
    assert sorted(got.finals) == sorted(want.finals)
    for s, w in want.finals.items():
        assert abs(got.finals[s] - w) <= tol


def assert_same_records(pdec, jdec, sc):
    """The scan's lattice records, where valid."""
    _, jys, jrec0 = jdec._decode_jit(jnp.asarray(sc, jdec._dt))
    _, ys, rec0 = pdec.run(pdec.scores_tensor(sc)[None])
    masks = {"lat": "lat_valid", "flat": "flat_valid"}
    for k in LAT_FIELDS + FLAT_FIELDS + EV_FIELDS:
        want = np.asarray(jys[k])
        got = ys[k][:, 0].numpy()
        assert got.shape == want.shape, k
        mask = np.asarray(jys[masks[k.split("_")[0]]]) if k.split("_")[0] in masks else (
            np.asarray(jys["ev_arc"]) >= 0)
        assert mask.any(), k
        np.testing.assert_array_equal(got[mask], want[mask], err_msg=k)
    for k in LAT_FIELDS + EV_FIELDS:
        want = np.asarray(jrec0[k])
        mask = np.asarray(jrec0["lat_valid"]) if k.startswith("lat") else (
            np.asarray(jrec0["ev_arc"]) >= 0)
        np.testing.assert_array_equal(rec0[k][0].numpy()[mask], want[mask], err_msg="rec0 " + k)


@pytest.mark.parametrize("merge", ["dense", "sort"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fuzz_lattice_equals_jax(tmp_path, dtype, merge):
    """Random networks (those of `test_fuzz_parity.test_fuzz_lattice`)."""
    tol = TOL[dtype]
    for net_seed in (0, 2):
        rng, models, net = random_case(net_seed + 70)
        jdec, pdec = _decoders(tmp_path, net, models, max_insts=128, expand_budget=1024,
                               final_budget=256, dtype=dtype, merge_strategy=merge)
        assert pdec.merge_strategy == merge
        T = int(rng.integers(6, 30))
        sc = scores_matrix(models, T, seed=net_seed * 10 + 3)
        assert_same_records(pdec, jdec, sc)
        rj, lj = jdec.decode_scores_lattice(sc)
        rp, lp = pdec.decode_scores_lattice(sc)
        assert rp.words == rj.words and not rp.empty
        assert abs(rp.score - rj.score) < tol
        assert_same_fst(lp, lj, tol)
        cost, words = shortest_path(lp)
        assert words == rp.words
        assert abs(cost - (-(rp.acoustic_score + rp.lm_score))) < max(tol, 1e-6)
        assert (cost, words) == jax_lattice.shortest_path(lj)
        assert contains_cost(lp, rp.words) == jax_lattice.contains_cost(lj, rj.words)
        assert contains_cost(lp, rp.words[:1] + [999]) == np.inf  # no label 999


def _two_word_net():
    f = JaxFst(JAX_LOG)
    s0, s1, s2 = (f.add_state() for _ in range(3))
    f.set_start(s0)
    f.add_arc(s0, s1, 1, 1, 0.2)
    f.add_arc(s0, s1, 2, 2, 0.1)
    f.add_arc(s1, s2, 3, 3, 0.0)
    f.set_final(s2, 0.0)
    return JaxNetwork(f)


def test_best_path_and_alternatives(tmp_path):
    """`test_lattice.py`'s two-word network: the best path is the 1-best
    decode, both first words are in the lattice, and it equals JAX's."""
    models = make_models(6, seed=5)
    jdec, pdec = _decoders(tmp_path, _two_word_net(), models)
    sc = scores_matrix(models, 12, seed=9)
    res, lat = pdec.decode_scores_lattice(sc)
    assert not res.empty and lat.num_states > 0
    cost, il, ol = algos.shortest_path(lat)
    assert ol == res.words
    assert abs(cost - (-(res.acoustic_score + res.lm_score))) < 1e-6
    assert {1, 2, 3} <= {lat.arc_olabel[i] for i in range(lat.num_arcs)} - {EPSILON}
    assert_same_fst(lat, jdec.decode_scores_lattice(sc)[1], 1e-9)


def test_write_lattice_text_equals_jax(tmp_path):
    """A four-word loop: `write_lattice` writes JAX's text byte for byte,
    and the JAX reader reads it back to the same best path."""
    models = make_models(4, seed=13)
    f = JaxFst(JAX_LOG)
    s0 = f.add_state()
    f.set_start(s0)
    for w in range(4):
        f.add_arc(s0, s0, w + 1, w + 1, 0.5)
    f.set_final(s0, 0.0)
    jdec, pdec = _decoders(tmp_path, JaxNetwork(f), models)
    sc = scores_matrix(models, 15, seed=11)
    _, lat = pdec.decode_scores_lattice(sc)
    _, jlat = jdec.decode_scores_lattice(sc)
    ours, theirs = str(tmp_path / "port.lat"), str(tmp_path / "jax.lat")
    write_lattice(lat, ours)
    jax_lattice.write_lattice(jlat, theirs)
    with open(ours) as a, open(theirs) as b:
        text = a.read()
        assert text == b.read() and text
    back = read_fsm(ours, JAX_LOG)
    assert back.num_arcs == lat.num_arcs
    assert jax_algos.shortest_path(back)[2] == algos.shortest_path(lat)[2]


def test_lattice_needs_gen_lattice_and_an_empty_utterance(tmp_path):
    """Without `gen_lattice` the lattice entry raises; a decode of no frame
    gives the initial propagation's lattice, as JAX's does."""
    models = make_models(2, seed=1)
    f = JaxFst(JAX_LOG)
    s0, s1 = f.add_state(), f.add_state()
    f.set_start(s0)
    f.add_arc(s0, s1, 1, 1, 0.0)
    f.set_final(s1, 0.0)
    jdec, pdec = _decoders(tmp_path, JaxNetwork(f), models)
    plain = TorchDecoder(pdec.art, TorchDecoderConfig(max_insts=64, expand_budget=128,
                                                      final_budget=64, dtype="float64"),
                         device="cpu")
    sc = scores_matrix(models, 5, seed=2)
    assert plain.decode_scores(sc).words == [1]
    with pytest.raises(ValueError, match="gen_lattice"):
        plain.decode_scores_lattice(sc)
    with pytest.raises(ValueError, match="use_fused"):
        pdec.decode_scores_lattice(sc, use_fused="always")
    res, lat = pdec.decode_scores_lattice(sc[:0])
    jres, jlat = jdec.decode_scores_lattice(sc[:0])
    assert res.words == jres.words
    assert_same_fst(lat, jlat, 1e-9)


def _random_fst(rng, cls, semiring, eps):
    f = cls(semiring)
    n = 12
    for _ in range(n):
        f.add_state()
    f.set_start(0)
    for _ in range(30):
        s = int(rng.integers(n - 1))
        d = int(rng.integers(s + 1, n))  # forward only: acyclic
        ol = int(rng.integers(0, 4))
        f.add_arc(s, d, int(rng.integers(1, 5)), ol if ol else eps,
                  float(np.round(rng.normal(), 3)))
    for s in rng.choice(n, 3, replace=False):
        f.set_final(int(s), float(np.round(abs(rng.normal()), 3)))
    return f


@pytest.mark.parametrize("seed", range(3))
def test_fst_utilities_equal_jax(seed):
    """`connect`, `project` and `shortest_path` of the port's reduced FST
    copy give the JAX package's results on the same random machine."""
    ours = _random_fst(np.random.default_rng(seed), Fst, LOG, EPSILON)
    theirs = _random_fst(np.random.default_rng(seed), JaxFst, JAX_LOG, JAX_EPSILON)
    c, jc = algos.connect(ours), jax_algos.connect(theirs)
    assert_same_fst(c, jc, 0.0)
    for output in (False, True):
        assert_same_fst(algos.project(c, output), jax_algos.project(jc, output), 0.0)
    assert algos.shortest_path(c) == jax_algos.shortest_path(jc)
    assert shortest_path(c) == jax_lattice.shortest_path(jc)
    assert contains_cost(c, algos.shortest_path(c)[2]) == pytest.approx(algos.shortest_path(c)[0])
