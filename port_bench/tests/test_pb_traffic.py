"""The traffic generator: a pool is a function of its seed, and its
lengths are the mix file's."""

import os

import numpy as np
import pytest

from pb import traffic
from pb.task import Lexicon, Models

from conftest import BENCH, REPO

TASK = os.path.join(REPO, "scripts", "_wsj_cache_2k")


@pytest.fixture(scope="module")
def task():
    return Models(os.path.join(TASK, "models.npz")), Lexicon(TASK)


@pytest.fixture(scope="module")
def mix():
    m = traffic.load_mix(os.path.join(BENCH, "traffic", "read-b16.json"))
    return dict(m, pool=24)


def test_same_corpus_seed_same_pool_other_corpus_seed_other_pool(task, mix):
    models, lex = task
    a = traffic.make_pool(TASK, models, lex, dict(mix, corpus_seed=2**31 + 11))
    b = traffic.make_pool(TASK, models, lex, dict(mix, corpus_seed=2**31 + 11))
    c = traffic.make_pool(TASK, models, lex, dict(mix, corpus_seed=12))
    assert a.words == b.words
    assert all(np.array_equal(x, y) for x, y in zip(a.feats, b.feats))
    assert any(not np.array_equal(x, y) for x, y in zip(a.feats, c.feats))
    assert a.words != c.words


def test_lengths_follow_the_mix(task, mix):
    models, lex = task
    spec = mix["lengths"]
    want = traffic.pool_lengths(mix)
    assert len(want) == mix["pool"] and want.min() >= spec["min"] and want.max() <= spec["max"]
    # the quantiles of a lognormal whose mean is the mix's, to a frame
    assert abs(want.mean() - spec["mean"]) <= 1.0
    assert np.all(np.diff(want) >= 0) and want[-1] > want[0]
    for corpus_seed in (3, 4):
        pool = traffic.make_pool(TASK, models, lex, dict(mix, corpus_seed=corpus_seed))
        assert [len(f) for f in pool.feats] == want.tolist()
        assert all(f.shape[1] == models.D and f.dtype == np.float32 for f in pool.feats)
        assert all(pool.words)


@pytest.mark.parametrize("mean", [500, 779, 1000])
def test_the_pool_mean_is_the_mix_mean(mix, mean):
    spec = dict(mix["lengths"], mean=mean)
    lengths = traffic.pool_lengths(dict(mix, pool=256, lengths=spec))
    assert abs(lengths.mean() - mean) <= 1.0
    assert lengths.min() >= spec["min"] and lengths.max() <= spec["max"]


def test_waves_are_permutations_of_the_pool_pass_by_pass():
    order = traffic.wave_order(8, 4, 9)
    first = [next(order) for _ in range(4)]
    assert sorted(first[0] + first[1]) == list(range(8))
    assert sorted(first[2] + first[3]) == list(range(8))
    assert first[:2] != first[2:]
    again = traffic.wave_order(8, 4, 9)
    assert [next(again) for _ in range(4)] == first
