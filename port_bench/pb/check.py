"""How `correct` is decided: the program's answers against the reference.

After the window closes, the reference (`pb.reference`) works out again,
from the task's raw files and the features the benchmark made, the GMM
scores (float64) and the 1-best of each sampled utterance (the oracle's
token passing over the scores). The sample is the pool's longest
utterance and `sample - 1` more drawn from the seed, and besides them the
first `FLAGGED_COMPARED` other utterances that the window answered with
the overflow flag; every time the window decoded one of them is an
occurrence, and each is compared, flagged or not:

  - `score_gap`: the largest |program - reference| GMM score over the
    sampled utterances' frames and every GMM (the program's scores of
    each utterance's first occurrence, at its true frames);
  - `word_edits`: insertions, deletions and substitutions of the
    program's words against the reference's, summed over the occurrences;
  - `end_frame_diffs`: word-end frames that differ where the words agree,
    summed;
  - `total_gap`: the largest |program - reference| total score, as a
    share of the reference's (at least 1);
  - `flag_diffs`: occurrences whose empty flag (no final state) differs
    from the reference's, plus those the program did not flag as
    overflowed where the reference's live HMM instances exceed the
    frontier budget K, plus those it flagged where they stay under K / 2
    (sentences that overflow a budget of the 20k task hold 0.9-1.3 K in
    the reference), plus sampled utterances the window never answered;
  - `flagged_share`: the share of all the window's answers that the
    program flagged as overflowed (set by the run, `pb.cell`).

An answer the program flags as overflowed (a budget bound: "results may
be pruned") is a failed request, counted in `failed` and not in the
frames decoded; its words, word-end frames and score are held to the
reference all the same, so that a flag cannot hide a wrong answer, and
`flagged_share` bounds how many answers a run may flag.

Each number is held to the limit of the cell's file `cells/<cell>.json`
(`limits`): `correct` holds where every number is at or under its limit.
`compare` takes the program's answers as plain `Answer`s, so that the
control (`control.py`: the reference in a lower precision in the
program's place) is judged by the same code.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from . import editdist, reference
from .traffic import rng_of

MISSING = 1e30
NUMBERS = ("score_gap", "word_edits", "end_frame_diffs", "total_gap", "flag_diffs",
           "flagged_share")
# utterances outside the sample compared because the window flagged them
FLAGGED_COMPARED = 2


@dataclass
class Answer:
    words: list
    end_frames: list
    score: float
    empty: bool
    overflow: bool


def answer_of(result) -> Answer:
    """An `Answer` of the program's `DecodeResult`."""
    return Answer(list(result.words), [h.end_frame for h in result.word_hyps],
                  float(result.score), bool(result.empty), bool(result.overflow))


def answer_of_oracle(r) -> Answer:
    return Answer(list(r.words), list(r.end_frames), float(r.score), r.empty, False)


def load_limits(path: str) -> dict:
    with open(path) as fd:
        cell = json.load(fd)
    limits = cell["limits"]
    missing = [k for k in NUMBERS if k not in limits]
    if missing:
        raise ValueError(f"{path}: no limit for {missing}")
    return cell


def draw_sample(lengths: np.ndarray, n: int, seed: int) -> list:
    """The pool's longest utterance and n - 1 others drawn from the seed."""
    longest = int(np.argmax(lengths))
    others = [i for i in range(len(lengths)) if i != longest]
    picked = rng_of(seed, 2).choice(len(others), min(n - 1, len(others)), replace=False)
    return [longest] + [others[int(i)] for i in picked]


def reference_answers(sample, feats, models, net, point):
    """u -> (float64 scores, oracle result) of each compared utterance."""
    oracle = reference.Oracle(net, models, point["beam"], point["end_beam"], point["maxhyps"])
    out = {}
    for u in sample:
        s64 = reference.scores_float64(models, feats[u])
        out[u] = (s64, oracle.decode(s64))
    return out


def compare(refs: dict, scores: dict, answers: dict, K: int) -> dict:
    """The numbers of the comparison. refs: u -> (float64 scores, oracle
    result); scores: u -> the program's (T_u, G) scores; answers: u ->
    [Answer] of every occurrence."""
    out = dict.fromkeys(NUMBERS, 0.0)
    n_occ = 0
    flagged = {}  # u -> [reference's peak live instances, flagged occurrences]
    for u, (s64, r) in refs.items():
        # missing scores, or scores of another shape, are as far off as a
        # score can be; a sampled utterance never answered is a flag wrong
        got = scores.get(u)
        gap = (float(np.abs(got - s64).max()) if got is not None and got.shape == s64.shape
               else MISSING)
        out["score_gap"] = max(out["score_gap"], gap)
        out["flag_diffs"] += not answers[u]
        for a in answers[u]:
            n_occ += 1
            out["flag_diffs"] += ((a.empty != r.empty) + (r.peak_active > K and not a.overflow)
                                  + (a.overflow and 2 * r.peak_active < K))
            if a.overflow:
                flagged.setdefault(u, [r.peak_active, 0])[1] += 1
            out["word_edits"] += editdist.errors(a.words, r.words)
            if a.words == r.words:
                out["end_frame_diffs"] += sum(x != y for x, y in zip(a.end_frames, r.end_frames))
            if not (a.empty or r.empty):
                gap = abs(a.score - r.score) / max(1.0, abs(r.score))
                out["total_gap"] = max(out["total_gap"], gap)
    out["occurrences"] = n_occ
    out["flagged"] = flagged
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def lines(numbers: dict, limits: dict) -> list:
    return [f"check {k}: {numbers[k]!r} (limit {limits[k]!r})" for k in NUMBERS]
