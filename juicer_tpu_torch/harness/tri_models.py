"""A seeded tied-state cross-word triphone model set and its tied list.

The widths are those of Kaldi's WSJ recipe's first context-dependent
system, tri1 (`egs/wsj/s5/run.sh`: `steps/train_deltas.sh 2000 10000` on
39-dim MFCC + deltas): 2,000 tied states and 10,000 Gaussians. The
repository holds no trained models, so the set is drawn from a seed:

  - phones: every phone of the task's list but `sil` and `sp` has three
    emitting states (HTK's 5-state left-to-right topology); `sil` has
    three emitting states of its own, and `sp` is a one-state tee model
    whose state is `sil`'s centre state;
  - tied states: `sil`'s three, and the rest spread as evenly as possible
    over the (phone, position) pairs, the pairs that take one more drawn
    from the seed;
  - tying, a seeded stand-in for a decision tree: each phone has one
    left-context and one right-context class map over the contexts (the
    phones and `sil`), each class holding at least one context; state 1's
    tied state is chosen by the left class, state 3's by the right class
    and state 2's by the pair of classes (a seeded map of the pairs onto
    state 2's tied states, each taking at least one pair);
  - physical models: one for each distinct triple of tied states, named
    after the first logical name that has it. The tied list holds `sil`,
    `sp` and every `l-p+r` a cross-word C can ask for (`sil` among the
    contexts): a line of one name for each physical model, a line of two
    names (logical, physical) for every other;
  - Gaussians: Kaldi's mixing-up rule (`GetSplitTargets`,
    `gmm/am-diag-gmm.cc`): every state starts with one, and each further
    one goes to the state with the most occupancy^power a component
    (`train_deltas.sh`'s power 0.25), ties to the lowest state, over
    seeded lognormal occupancies, until the total is reached;
  - parameters: as the monophone tasks' models were drawn
    (`wsj_bench.build_models`): a centre a phone, each component of a
    state the centre plus unit noise, variances 0.8 + |N(0, 0.5^2)|,
    equal weights, self-loops 0.6, so that features drawn from the
    models decode to their transcripts; the 5-state models share one
    transition matrix and `sp` has another (0.3 into its state, 0.7 the
    tee).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from ..am.models import AcousticModelSet

SIL, SP = "sil", "sp"

# Kaldi WSJ tri1 (`steps/train_deltas.sh 2000 10000`, `--power 0.25`), and
# the generator's own choices (`assumed` in the benchmark's configuration)
TRI1 = dict(n_states=2000, n_gauss=10000, power=0.25, occ_sigma=1.0, center_scale=1.2,
            vec_size=39, seed=7)


@dataclass
class TiedSet:
    models: AcousticModelSet
    tied_lines: list  # the tied list's lines, without newlines
    gaussians: np.ndarray  # (G,) components of each tied state
    n_physical: int  # physical triphone models (sil and sp left out)
    n_logical: int  # logical triphones listed (sil and sp left out)

    @property
    def tied_text(self) -> str:
        return "\n".join(self.tied_lines) + "\n"


def split_targets(occs: np.ndarray, total: int, power: float) -> np.ndarray:
    """Gaussians of each state (Kaldi's `GetSplitTargets`): one each, then
    each further one to the state with the largest occs**power over its
    count, ties to the lowest index, until `total`."""
    w = np.power(np.asarray(occs, np.float64), power)
    counts = np.ones(len(w), np.int64)
    heap = [(-w[i], i) for i in range(len(w))]
    heapq.heapify(heap)
    for _ in range(total - len(w)):
        _, i = heapq.heappop(heap)
        counts[i] += 1
        heapq.heappush(heap, (-w[i] / counts[i], i))
    return counts


def spread(total: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """`total` split over n as evenly as possible, the n that take one more
    drawn from `rng`."""
    counts = np.full(n, total // n, np.int64)
    counts[rng.permutation(n)[: total - int(counts.sum())]] += 1
    return counts


def class_map(n_items: int, n_classes: int, rng: np.random.Generator) -> np.ndarray:
    """A seeded map of n_items onto n_classes that leaves no class empty."""
    if n_classes > n_items:
        raise ValueError(f"{n_classes} classes over {n_items} items leave some empty")
    order = rng.permutation(n_items)
    out = np.empty(n_items, np.int64)
    out[order[:n_classes]] = np.arange(n_classes)
    out[order[n_classes:]] = rng.integers(n_classes, size=n_items - n_classes)
    return out


def make_tied_set(phones: list, n_states: int = TRI1["n_states"],
                  n_gauss: int = TRI1["n_gauss"], power: float = TRI1["power"],
                  occ_sigma: float = TRI1["occ_sigma"],
                  center_scale: float = TRI1["center_scale"],
                  vec_size: int = TRI1["vec_size"], seed: int = TRI1["seed"]) -> TiedSet:
    """The tied set over `phones` (the task's phone list; `sil` and `sp`
    are taken out and given their own models). `n_states` counts every
    tied state, `sil`'s three among them."""
    base = [p for p in phones if p not in (SIL, SP)]
    ctx = base + [SIL]
    n_pairs = 3 * len(base)
    if n_states - 3 < n_pairs or n_gauss < n_states:
        raise ValueError(f"{n_states} tied states and {n_gauss} Gaussians are too few for "
                         f"{len(base)} phones")
    rng_tie = np.random.default_rng([seed, 0])
    rng_gauss = np.random.default_rng([seed, 1])
    rng_param = np.random.default_rng([seed, 2])

    # tied states: (phone, position) pairs, phone-major, then sil's three
    per_pair = spread(n_states - 3, n_pairs, rng_tie).reshape(len(base), 3)
    first = (np.cumsum(per_pair.ravel()) - per_pair.ravel()).reshape(len(base), 3)
    sil_states = np.arange(n_states - 3, n_states)

    # Gaussians a state
    occs = np.exp(rng_gauss.normal(0.0, occ_sigma, n_states))
    gaussians = split_targets(occs, n_gauss, power)

    # tying, and the physical models of each phone in order of first use
    tied_lines = [SIL, SP]
    hmm_names, hmm_states = [], []
    n_logical = 0
    for i, p in enumerate(base):
        n1, n2, n3 = (int(x) for x in per_pair[i])
        left = class_map(len(ctx), n1, rng_tie)
        right = class_map(len(ctx), n3, rng_tie)
        middle = class_map(n1 * n3, n2, rng_tie)
        physical = {}
        for li, l in enumerate(ctx):
            for ri, r in enumerate(ctx):
                name = f"{l}-{p}+{r}"
                pair = (int(left[li]), int(right[ri]))
                n_logical += 1
                if pair not in physical:
                    physical[pair] = name
                    hmm_names.append(name)
                    hmm_states.append([first[i, 0] + pair[0],
                                       first[i, 1] + middle[pair[0] * n3 + pair[1]],
                                       first[i, 2] + pair[1]])
                    tied_lines.append(name)
                else:
                    tied_lines.append(f"{name} {physical[pair]}")
    n_physical = len(hmm_names)
    hmm_names += [SIL, SP]
    hmm_states += [list(sil_states), [sil_states[1]]]

    # parameters: a centre a phone (sil's last), then each state's components
    owner = np.empty(n_states, np.int64)
    for i in range(len(base)):
        owner[first[i, 0]: first[i, 0] + per_pair[i].sum()] = i
    owner[sil_states] = len(base)
    centres = rng_param.normal(scale=center_scale, size=(len(ctx), vec_size))
    ms = AcousticModelSet()
    ms.vec_size = vec_size
    for g in range(n_states):
        n = int(gaussians[g])
        ms.gmm_means.append(centres[owner[g]] + rng_param.normal(size=(n, vec_size)))
        ms.gmm_vars.append(np.abs(rng_param.normal(size=(n, vec_size))) * 0.5 + 0.8)
        ms.gmm_log_weights.append(np.full(n, np.log(1.0 / n)))
    five = np.zeros((5, 5))
    five[0, 1] = 1.0
    for j in (1, 2, 3):
        five[j, j], five[j, j + 1] = 0.6, 0.4
    three = np.zeros((3, 3))
    three[0, 1], three[0, 2], three[1, 1], three[1, 2] = 0.3, 0.7, 0.6, 0.4
    ms._add_transmat(five)
    ms._add_transmat(three)
    for name, states in zip(hmm_names, hmm_states):
        ms._hmm_index[name] = len(ms.hmm_names)
        ms.hmm_names.append(name)
        ms.hmm_gmm_inds.append(np.asarray(states, np.int32))
        ms.hmm_trans_ind.append(int(name == SP))
    return TiedSet(ms, tied_lines, gaussians, n_physical, n_logical)
