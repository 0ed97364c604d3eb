"""The benchmark's own reader of a task directory (`clg.npz`, `models.npz`,
`phones.lst`, `lex.dict`, `bigram.npz`).

Plain NumPy, independent of the program: the traffic generator and the
reference read the task's raw files through this module and nothing of
the program. The formats are those the task directories were written in:

  - `clg.npz`: the search network as CSR arrays sorted by source state
    (`arc_src`, `arc_dst`, `arc_ilabel` (0 = epsilon, else HMM index + 1),
    `arc_olabel` (0 = epsilon), `arc_weight` (log probabilities, higher is
    better), `row_ptr`, `final_weight` (-1e30 = not final), `init_state`);
  - `models.npz`: HMMs (`hmm_names`, `hmm_trans_ind`, `tm_<i>` log
    transition matrices) and diagonal GMMs (`gm_<g>` means, `gv_<g>`
    variances, `gw_<g>` log weights, `gi_<h>` each HMM's GMM per emitting
    state);
  - `lex.dict`: one pronunciation a word; `phones.lst`: the phone names in
    order.

`word_labels` is a frozen copy of `word_labels` in
`juicer_tpu_torch/harness/wsj_task.py` (commit 103de7f): network output
labels are the index + 1 of each word among the sorted unique words of
`lex.dict` with `<s>` and `</s>`.
"""

from __future__ import annotations

import os
import re

import numpy as np

LOG_ZERO = -1e30


class Models:
    """HMM topology and GMM parameters of `models.npz` as NumPy arrays."""

    def __init__(self, path: str):
        z = np.load(path, allow_pickle=False)
        if bool(z["hybrid"]):
            raise ValueError(f"{path}: hybrid model sets have no GMMs")
        self.D = int(z["vec_size"])
        self.hmm_names = [str(s) for s in z["hmm_names"]]
        self.hmm_index = {n: i for i, n in enumerate(self.hmm_names)}
        trans = [z[f"tm_{i}"] for i in range(int(z["n_trans"]))]
        self.trans = [trans[int(t)] for t in z["hmm_trans_ind"]]  # per HMM, (n, n) log
        self.hmm_gmms = [z[f"gi_{h}"].astype(np.int64) for h in range(len(self.hmm_names))]
        G = int(z["n_gmms"])
        means = [z[f"gm_{g}"] for g in range(G)]
        variances = [z[f"gv_{g}"] for g in range(G)]
        log_w = [z[f"gw_{g}"] for g in range(G)]
        self.G = G
        self.C = max(len(m) for m in means)
        # (G, C, D) float64; a missing component has log weight LOG_ZERO
        self.means = np.zeros((G, self.C, self.D))
        self.vars = np.ones((G, self.C, self.D))
        self.log_w = np.full((G, self.C), LOG_ZERO)
        self.n_comps = np.array([len(m) for m in means])
        for g in range(G):
            c = len(means[g])
            self.means[g, :c] = means[g]
            self.vars[g, :c] = variances[g]
            self.log_w[g, :c] = log_w[g]

    def n_states(self, h: int) -> int:
        return self.trans[h].shape[0]

    @property
    def real_components(self) -> int:
        """Components that exist, summed over the GMMs."""
        return int(self.n_comps.sum())


class Network:
    """The CSR arrays of `clg.npz`."""

    def __init__(self, path: str):
        z = np.load(path, allow_pickle=False)
        self.arc_dst = z["arc_dst"]
        self.arc_ilabel = z["arc_ilabel"]
        self.arc_olabel = z["arc_olabel"]
        self.arc_weight = z["arc_weight"]
        self.row_ptr = z["row_ptr"]
        self.final_weight = z["final_weight"]
        self.init_state = int(z["init_state"])
        self.n_arcs = len(self.arc_dst)


class Lexicon:
    """Phone names, pronunciations, and each word's network output label."""

    def __init__(self, task_dir: str):
        with open(os.path.join(task_dir, "phones.lst")) as fd:
            self.phones = [line.strip() for line in fd if line.strip()]
        phone_index = {p: i for i, p in enumerate(self.phones)}
        self.prons = {}
        with open(os.path.join(task_dir, "lex.dict")) as fd:
            for line in fd:
                parts = line.split()
                if parts:
                    self.prons[parts[0]] = [phone_index[p] for p in parts[1:]]
        self.n_words = len(self.prons) - 2  # w0..w{n-1}, then <s> and </s>
        self.labels, self.markers = word_labels(task_dir)


def word_labels(task_dir: str):
    """(label of word id w, sentence-marker labels)."""
    words = set()
    with open(os.path.join(task_dir, "lex.dict"), errors="replace") as fd:
        for line in fd:
            if line.startswith("(") or line.startswith("#"):
                continue
            parts = line.split()
            if parts:
                word = re.split(r"[(]", parts[0])[0]
                if word:
                    words.add(word)
    words.update(("<s>", "</s>"))
    index = {w: i + 1 for i, w in enumerate(sorted(words))}
    n = sum(1 for w in index if re.fullmatch(r"w\d+", w))
    return ([index[f"w{i}"] for i in range(n)],
            {index["<s>"], index["</s>"]})
