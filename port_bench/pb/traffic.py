"""The one traffic generator: utterances with known transcripts, made from
a seed and a mix file (`traffic/<name>.json`).

The sentence sampler and the feature synthesis are a frozen, vectorised
copy of `_Sentences` and `sample_utterances` in
`juicer_tpu_torch/harness/wsj_task.py` (commit 103de7f), itself a copy of
`scripts/wsj_bench.py`: a sentence is a random walk of the task's bigram
from `<s>` to `</s>`, the first of up to 300 walks whose estimated frames
lie within 0.6-1.5x the target; its features are sil + the words' phones
+ sil, each emitting state held for some frames, each frame drawn from
one Gaussian component of that state's GMM. What the copy changes: the
bigram rows are read once a word and sampled by their cumulative sums;
the frames of an utterance are drawn in one call; and the utterance has
exactly its target length: each state's hold (`frames_per_state` +- 1
frame, at least 1) is scaled so that the holds sum to the target.

  - `lengths`: the pool's target lengths are the quantiles
    (i + 0.5) / pool of a lognormal of spread `sigma`, rounded and clipped
    to [`min`, `max`], whose median is solved for so that the pool's mean
    length is `mean` frames.

A mix file's other keys: `batch` (utterances a wave), `pool` (distinct
utterances), `loop` ("closed") and `clients` (1), and `corpus_seed`: the
pool (sentences and frames) is made from it, a fixed test set, the same
for every run. The run's seed orders the waves, a new permutation of the
pool at each pass, and draws the sample that is compared (`pb.check`). A
pool made anew from each run's seed changed the work from run to run
(frames/s 2-4x further apart across seeds than for one seed, on the card).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

from .task import Lexicon, Models

def load_mix(path: str) -> dict:
    with open(path) as fd:
        mix = json.load(fd)
    for key in ("batch", "pool", "lengths", "frames_per_state", "loop", "clients",
                "corpus_seed"):
        if key not in mix:
            raise ValueError(f"{path}: no {key!r}")
    if mix["lengths"].get("dist") != "lognormal":
        raise ValueError(f"{path}: lengths {mix['lengths']!r} are not lognormal")
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise ValueError(f"{path}: only a closed loop with one client is generated")
    return mix


def pool_lengths(mix: dict) -> np.ndarray:
    """The pool's target frame counts, ascending, with the mean nearest
    the mix's `mean` (bisection on the median)."""
    n = int(mix["pool"])
    spec = mix["lengths"]
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])

    def lengths(median):
        return np.clip(np.round(median * np.exp(spec["sigma"] * z)), spec["min"], spec["max"])

    lo, hi = float(spec["min"]), float(spec["max"])
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if lengths(mid).mean() < spec["mean"] else (lo, mid)
    best = min((lo, hi), key=lambda m: abs(lengths(m).mean() - spec["mean"]))
    return lengths(best).astype(np.int64)


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent generator a purpose (0 the pool, 1 the waves, 2 the
    sample compared, 3 the warm-up) for any whole-number seed."""
    return np.random.default_rng([int(seed) % 2**64, stream])


@dataclass
class Pool:
    words: list  # word ids of each utterance (its transcript)
    feats: list  # (T_i, D) float32 features of each utterance
    lengths: np.ndarray  # (n,) frames

    def __len__(self):
        return len(self.feats)


class Sentences:
    """A task's bigram, pronunciations and phone models, and its sentence
    sampler."""

    def __init__(self, task_dir: str, models: Models, lex: Lexicon):
        self.bz = np.load(os.path.join(task_dir, "bigram.npz"))
        self.rows = {}
        self.lex = lex
        self.models = models
        self.hmm_of_phone = [models.hmm_index.get(p, -1) for p in lex.phones]
        self.SB, self.SE = lex.n_words, lex.n_words + 1

    def _row(self, w: int):
        row = self.rows.get(w)
        if row is None:
            ids = self.bz[f"ids_{w}"]
            cdf = np.cumsum(10.0 ** self.bz[f"logp_{w}"])
            row = self.rows[w] = (ids, cdf / cdf[-1])
        return row

    def sentence(self, rng, frames_of):
        """ONE sentence <s> w... </s>: its words and the sum of frames_of."""
        words, w, est = [], self.SB, 0
        while True:
            ids, cdf = self._row(w)
            w = int(ids[min(int(np.searchsorted(cdf, rng.random(), side="right")), len(ids) - 1)])
            if w == self.SE:
                return words, est
            words.append(w)
            est += frames_of(w)

    def sample_close(self, rng, frames_of, target):
        """The first of up to 300 sentences within 0.6-1.5x the target
        frames, else the closest non-empty one."""
        best = None
        for _ in range(300):
            words, est = self.sentence(rng, frames_of)
            if not words:
                continue
            err = abs(est - target)
            if best is None or err < best[0]:
                best = (err, words)
            if target * 0.6 <= est <= target * 1.5:
                break
        return best[1]

    def state_gmms(self, words) -> np.ndarray:
        """The GMM of each emitting state of sil + the words + sil."""
        prons = self.lex.prons
        phones = prons["<s>"] + sum((prons[f"w{w}"] for w in words), []) + prons["</s>"]
        return np.concatenate([self.models.hmm_gmms[self.hmm_of_phone[p]] for p in phones])


def _holds(rng, n: int, fps: int, T: int):
    """Frames each of n states holds, summing to T; None where the
    sentence cannot take T frames."""
    d = np.maximum(1, fps + rng.integers(-1, 2, n))
    if n > T:
        return None
    hold = np.maximum(1, np.floor(d * (T / d.sum()))).astype(np.int64)
    diff = T - int(hold.sum())
    if diff > 0:
        hold[rng.choice(n, diff, replace=False)] += 1
    while diff < 0:
        can = np.flatnonzero(hold > 1)
        take = rng.choice(can, min(-diff, len(can)), replace=False)
        hold[take] -= 1
        diff += len(take)
    return hold


def make_pool(task_dir: str, models: Models, lex: Lexicon, mix: dict) -> Pool:
    """The pool of the mix's corpus seed: utterance i has exactly
    pool_lengths(mix)[i] frames."""
    rng = rng_of(mix["corpus_seed"], 0)
    sents = Sentences(task_dir, models, lex)
    fps = int(mix["frames_per_state"])
    per_phone = models.n_states(0) - 2

    def frames_of(w):
        return len(lex.prons[f"w{w}"]) * per_phone * fps

    sd = np.sqrt(models.vars).astype(np.float32)
    mu = models.means.astype(np.float32)
    words, feats = [], []
    lengths = pool_lengths(mix)
    for T in lengths:
        for _try in range(50):
            ws = sents.sample_close(rng, frames_of, int(T))
            gmms = sents.state_gmms(ws)
            hold = _holds(rng, len(gmms), fps, int(T))
            if hold is not None:
                break
        else:
            raise RuntimeError(f"no sentence of the task fits {T} frames")
        comps = rng.integers(models.n_comps[gmms])
        g = np.repeat(gmms, hold)
        c = np.repeat(comps, hold)
        noise = rng.standard_normal((int(T), models.D), dtype=np.float32)
        feats.append(mu[g, c] + noise * sd[g, c])
        words.append(ws)
    return Pool(words, feats, lengths)


def wave_order(n: int, batch: int, seed: int):
    """The pool indices of each wave, for ever: the next `batch` of a
    stream of permutations of range(n), a new one each pass."""
    rng = rng_of(seed, 1)
    stream = []
    while True:
        while len(stream) < batch:
            stream.extend(rng.permutation(n).tolist())
        yield stream[:batch]
        del stream[:batch]
