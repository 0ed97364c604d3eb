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

Which HMM a phone is drawn from is the configuration's context dependency,
its `network.context`:

  - "monophone": phone p is the HMM named p;
  - "xwrdtri", "xwrdtrindi" (the toolchain's two cross-word triphone C
    transducers, which build the C differently and give an utterance the
    same models): `sil` and `sp` are context-independent, each its own
    model; every other phone p takes the logical model `l-p+r`, where l
    and r are the phones beside it in the utterance, across word
    boundaries, `sil` among them (`sil-p+r`, `l-p+sil`); `sp` is
    transparent to context, so the phones on either side of it see each
    other (as the C's arcs (1b) and (2b) in
    `juicer_tpu_torch/compile/cd.py` assign them). A logical name is the
    HMM of its physical name in the task directory's tied list
    `tied.lst`, read as the toolchain reads an HTK list (a line of one
    name is a physical model; a line of two ties the first, logical, name
    to the second, physical, one; the first line of a name holds), and
    where the task has no tied list, the HMM of that name itself (an
    untied set).

A phone, logical or physical name with no model raises, naming it.

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

CONTEXTS = ("monophone", "xwrdtri", "xwrdtrindi")
SIL, SP = "sil", "sp"
TIED_LIST = "tied.lst"


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


def read_tied_list(path: str) -> dict:
    """logical name -> physical name of an HTK tied list."""
    tied = {}
    with open(path, errors="replace") as fd:
        for line in fd:
            parts = line.split()
            if parts:
                phys = parts[min(1, len(parts) - 1)]
                tied.setdefault(phys, phys)
                tied.setdefault(parts[0], phys)
    return tied


def cross_word_names(phones: list) -> list:
    """The logical model of each phone of an utterance (names, sil at both
    ends) under a cross-word triphone C."""
    ctx = [i for i, p in enumerate(phones) if p != SP]
    left = {b: phones[a] for a, b in zip(ctx, ctx[1:])}
    right = {a: phones[b] for a, b in zip(ctx, ctx[1:])}
    names = []
    for i, p in enumerate(phones):
        if p in (SIL, SP):
            names.append(p)
        elif i in left and i in right:
            names.append(f"{left[i]}-{p}+{right[i]}")
        else:
            raise ValueError(f"phone {p!r} at an edge of the utterance has no context: "
                             f"{' '.join(phones)}")
    return names


class Sentences:
    """A task's bigram, pronunciations and phone models, and its sentence
    sampler."""

    def __init__(self, task_dir: str, models: Models, lex: Lexicon, context: str):
        if context not in CONTEXTS:
            raise ValueError(f"unknown context {context!r}: the traffic draws {CONTEXTS}")
        self.bz = np.load(os.path.join(task_dir, "bigram.npz"))
        self.rows = {}
        self.lex = lex
        self.models = models
        self.context = context
        self.SB, self.SE = lex.n_words, lex.n_words + 1
        path = os.path.join(task_dir, TIED_LIST)
        self.tied = (read_tied_list(path) if context != "monophone" and os.path.exists(path)
                     else None)
        self.hmm_of_name = {}

    def _row(self, w: int):
        row = self.rows.get(w)
        if row is None:
            ids = self.bz[f"ids_{w}"]
            cdf = np.cumsum(10.0 ** self.bz[f"logp_{w}"])
            row = self.rows[w] = (ids, cdf / cdf[-1])
        return row

    def sentence(self, rng):
        """The words of ONE sentence <s> w... </s>."""
        words, w = [], self.SB
        while True:
            ids, cdf = self._row(w)
            w = int(ids[min(int(np.searchsorted(cdf, rng.random(), side="right")), len(ids) - 1)])
            if w == self.SE:
                return words
            words.append(w)

    def frames(self, words, fps: int) -> int:
        """The frames a sentence is estimated to take, by which it is chosen:
        monophone, each phone of the words at the emitting states of HMM 0
        (sil left out); otherwise the emitting states of the HMMs it uses."""
        if self.context == "monophone":
            n = sum(len(self.lex.prons[f"w{w}"]) for w in words)
            return n * (self.models.n_states(0) - 2) * fps
        return sum(self.models.n_states(h) - 2 for h in self.hmms(words)) * fps

    def sample_close(self, rng, fps: int, target):
        """The first of up to 300 sentences within 0.6-1.5x the target
        frames, else the closest non-empty one."""
        best = None
        for _ in range(300):
            words = self.sentence(rng)
            if not words:
                continue
            est = self.frames(words, fps)
            err = abs(est - target)
            if best is None or err < best[0]:
                best = (err, words)
            if target * 0.6 <= est <= target * 1.5:
                break
        return best[1]

    def hmms(self, words) -> list:
        """The HMM of each phone of sil + the words + sil."""
        prons = self.lex.prons
        phones = prons["<s>"] + sum((prons[f"w{w}"] for w in words), []) + prons["</s>"]
        names = [self.lex.phones[p] for p in phones]
        if self.context != "monophone":
            names = cross_word_names(names)
        return [self._hmm(n) for n in names]

    def _hmm(self, logical: str) -> int:
        """The HMM of a phone's model name, through the tied list if any."""
        h = self.hmm_of_name.get(logical)
        if h is None:
            if self.tied is None:
                phys = logical
            elif logical in self.tied:
                phys = self.tied[logical]
            else:
                raise ValueError(f"the logical model {logical!r} is not in {TIED_LIST}")
            if phys not in self.models.hmm_index:
                via = f" (the physical model of {logical!r})" if phys != logical else ""
                raise ValueError(f"no HMM named {phys!r}{via}")
            h = self.hmm_of_name[logical] = self.models.hmm_index[phys]
        return h

    def state_gmms(self, words) -> np.ndarray:
        """The GMM of each emitting state of sil + the words + sil."""
        return np.concatenate([self.models.hmm_gmms[h] for h in self.hmms(words)])


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


def make_pool(task_dir: str, models: Models, lex: Lexicon, mix: dict, context: str) -> Pool:
    """The pool of the mix's corpus seed under the configuration's context
    dependency: utterance i has exactly pool_lengths(mix)[i] frames."""
    rng = rng_of(mix["corpus_seed"], 0)
    sents = Sentences(task_dir, models, lex, context)
    fps = int(mix["frames_per_state"])
    sd = np.sqrt(models.vars).astype(np.float32)
    mu = models.means.astype(np.float32)
    words, feats = [], []
    lengths = pool_lengths(mix)
    for T in lengths:
        for _try in range(50):
            ws = sents.sample_close(rng, fps, int(T))
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
