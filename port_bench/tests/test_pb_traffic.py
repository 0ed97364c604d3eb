"""The traffic generator: a pool is a function of its seed, and its
lengths are the mix file's; the monophone pools are frozen by digest."""

import hashlib
import os

import numpy as np
import pytest

from pb import traffic
from pb.task import Lexicon, Models

from conftest import BENCH, REPO

TASK = os.path.join(REPO, "scripts", "_wsj_cache_2k")

# SHA-256 of every utterance's words (int64) and features (float32) in
# pool order, as the generator made them before it took a context
FROZEN = {
    "wsj20k.read-b16": ("_wsj_cache_20k", None,
                        "0bb11599b6ad78e8867940608d5104d1e117aa25af928fee056a0aa18385f4ea"),
    "2k.read-b16.pool24": ("_wsj_cache_2k", 24,
                           "dde3a1682bb40fe54b3750e620d12e487718a3d95b266b8b37be0d8354528e07"),
}


def digest(pool) -> str:
    h = hashlib.sha256()
    for ws, f in zip(pool.words, pool.feats):
        h.update(np.asarray(ws, np.int64).tobytes())
        h.update(np.ascontiguousarray(f, np.float32).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def task():
    return Models(os.path.join(TASK, "models.npz")), Lexicon(TASK)


@pytest.fixture(scope="module")
def mix():
    m = traffic.load_mix(os.path.join(BENCH, "traffic", "read-b16.json"))
    return dict(m, pool=24)


def test_same_corpus_seed_same_pool_other_corpus_seed_other_pool(task, mix):
    models, lex = task
    a = traffic.make_pool(TASK, models, lex, dict(mix, corpus_seed=2**31 + 11), "monophone")
    b = traffic.make_pool(TASK, models, lex, dict(mix, corpus_seed=2**31 + 11), "monophone")
    c = traffic.make_pool(TASK, models, lex, dict(mix, corpus_seed=12), "monophone")
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
        pool = traffic.make_pool(TASK, models, lex, dict(mix, corpus_seed=corpus_seed),
                                  "monophone")
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


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_monophone_pool_is_frozen(name):
    """The 20k cell's whole pool (corpus seed 17) and the 2k fixture's mix,
    word for word and byte for byte."""
    task, pool, want = FROZEN[name]
    td = os.path.join(REPO, "scripts", task)
    mix = traffic.load_mix(os.path.join(BENCH, "traffic", "read-b16.json"))
    if pool is not None:
        mix = dict(mix, pool=pool)
    got = traffic.make_pool(td, Models(os.path.join(td, "models.npz")), Lexicon(td), mix,
                            "monophone")
    assert digest(got) == want
