"""ARPA n-gram language model reader.

A copy of `juicer_tpu/lm/arpa.py` (`ArpaLM`), the rebuild of the
reference's `ARPALM` (`ARPALM.h:22-66`, `ARPALM.cpp:460-698`):

  - arbitrary order; log10 probabilities become natural logs; below -90
    they are log-zero;
  - n-grams with a word outside the vocabulary are dropped, as are
    sentence start at a later position and sentence end at an earlier
    one; the silence word in the LM is an error;
  - an optional `<unk>` word stands in for the vocabulary words the LM
    lacks (`unk_words`, `calcUnkWords`, `ARPALM.cpp:360-395`); without
    one, such a word is an error;
  - a missing backoff is 0.0; the highest order has none;
  - `normalise()` recomputes the backoffs so each grammar state's exit
    mass sums to one (`Normalise`, `ARPALM.cpp:747-851`);
  - gzip input (a file name ending in .gz) and an npz cache
    (`save_npz` / `load_npz`, the JAX class's format: each package reads
    the other's).
"""

from __future__ import annotations

import gzip
import math
from typing import Optional

import numpy as np

from ..lexicon import Vocabulary

LOG_ZERO = -1e30
LN10 = math.log(10.0)


class ArpaLM:
    def __init__(self, arpa_fname: Optional[str] = None, vocab: Optional[Vocabulary] = None,
                 unk_word: Optional[str] = None):
        self.vocab = vocab
        self.unk_word = unk_word
        self.unk_id = vocab.n_words if vocab is not None else -1  # one past the vocabulary
        self.order = 0
        # entries[n][tuple(word_ids)] = (log_prob, log_bo); natural log
        self.entries: list[dict[tuple[int, ...], tuple[float, float]]] = []
        self.unk_words: list[int] = []
        self._words_in_lm: set[int] = set()
        if arpa_fname is not None:
            self.read_arpa(arpa_fname)
            self.calc_unk_words()

    # -- reading -----------------------------------------------------------

    def read_arpa(self, fname: str) -> None:
        opener = gzip.open if fname.endswith(".gz") else open
        with opener(fname, "rt", errors="replace") as fd:
            self._parse(fd)

    def _parse(self, fd) -> None:
        state = "before_data"
        declared: list[int] = []
        cur_n = 0
        for line in fd:
            if not line.strip() or line[0] in " \t#":
                continue
            up = line.upper()
            if state == "before_data":
                if "\\DATA\\" in up:
                    state = "in_data"
            elif state == "in_data":
                if "NGRAM" in up:
                    lhs, _, rhs = line.split()[1].partition("=")
                    if int(lhs) != len(declared) + 1:
                        raise ValueError("unexpected order in 'ngram x=y' line")
                    declared.append(int(rhs))
                elif "-GRAMS:" in up:
                    self.order = len(declared)
                    self.entries = [dict() for _ in range(self.order)]
                    if int(up.split("-")[0].lstrip("\\")) != 1:
                        raise ValueError("expected \\1-grams: after \\data\\")
                    cur_n = 1
                    state = "in_ngrams"
                else:
                    raise ValueError(f"unexpected line in data section: {line!r}")
            elif state == "in_ngrams":
                if line.startswith("\\"):
                    if "-GRAMS:" in up:
                        cur_n = int(up.split("-")[0].lstrip("\\"))
                        continue
                    if "\\END\\" in up:
                        state = "done"
                        continue
                    raise ValueError(f"unexpected section header {line!r}")
                self._entry(line.split(), cur_n)

    def _entry(self, parts: list[str], n: int) -> None:
        v = self.vocab
        prob = float(parts[0])
        prob = LOG_ZERO if prob < -90.0 else prob * LN10
        words = parts[1:1 + n]
        if len(words) < n:
            raise ValueError(f"short n-gram line: {' '.join(parts)!r}")
        ids = []
        for i, w in enumerate(words):
            wid = v.get_index(w) if v is not None else -1
            if wid < 0:
                if self.unk_word is not None and self.unk_word in w:
                    wid = self.unk_id
                else:
                    return
            elif wid == v.sent_start_index and i > 0:
                return
            elif wid == v.sent_end_index and i < n - 1:
                return
            else:
                if wid == v.sil_index:
                    raise ValueError("silence word in LM")
                self._words_in_lm.add(wid)
            ids.append(wid)
        if n < self.order:
            rest = parts[1 + n:]
            bo = float(rest[0]) if rest else 0.0
            bo = LOG_ZERO if bo < -90.0 else bo * LN10
        else:
            bo = LOG_ZERO
        self.entries[n - 1][tuple(ids)] = (prob, bo)

    def calc_unk_words(self) -> None:
        """The vocabulary words absent from the LM (mapped to `<unk>` when
        the grammar is built)."""
        if self.vocab is None:
            return
        v = self.vocab
        self.unk_words = []
        for i in range(v.n_words):
            if i in self._words_in_lm or i in (v.sent_start_index, v.sent_end_index,
                                                v.sil_index) or v.is_special(i):
                continue
            if self.unk_word is None:
                raise ValueError(f"no unk word defined but {v.get_word(i)!r} not in LM")
            self.unk_words.append(i)

    # -- binary cache (the reference's "TOLM" cache, `ARPALM.cpp:117-357`) --

    def save_npz(self, path: str) -> None:
        arrays = {"order": np.array(self.order), "unk_id": np.array(self.unk_id),
                  "unk_words": np.asarray(self.unk_words, dtype=np.int64)}
        for n in range(1, self.order + 1):
            ents = self.entries[n - 1]
            arrays[f"ids_{n}"] = np.array([list(k) for k in ents], dtype=np.int64).reshape(-1, n)
            arrays[f"pb_{n}"] = np.array(list(ents.values()), dtype=np.float64).reshape(-1, 2)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load_npz(cls, path: str, vocab=None, unk_word=None) -> "ArpaLM":
        z = np.load(path)
        lm = cls(None, vocab, None)
        lm.unk_word = unk_word
        lm.order = int(z["order"])
        lm.unk_id = int(z["unk_id"])
        lm.unk_words = [int(x) for x in z["unk_words"]]
        lm.entries = [{tuple(int(x) for x in row): (float(p), float(b))
                       for row, (p, b) in zip(z[f"ids_{n}"], z[f"pb_{n}"])}
                      for n in range(1, lm.order + 1)]
        return lm

    # -- queries -----------------------------------------------------------

    def n_ngrams(self, n: int) -> int:
        return len(self.entries[n - 1])

    def get(self, ids: tuple[int, ...]) -> Optional[tuple[float, float]]:
        n = len(ids)
        if n < 1 or n > self.order:
            return None
        return self.entries[n - 1].get(ids)

    def score(self, ids: tuple[int, ...]) -> float:
        """The backoff-evaluated log probability of the last word given the
        context."""
        e = self.get(ids)
        if e is not None:
            return e[0]
        if len(ids) == 1:
            return LOG_ZERO
        ctx = self.get(ids[:-1])
        bo = ctx[1] if ctx is not None and ctx[1] > LOG_ZERO else 0.0
        return bo + self.score(ids[1:])

    # -- normalisation (ARPALM::Normalise) ---------------------------------

    def normalise(self) -> None:
        """Recompute the backoffs so each grammar state's exit mass sums to
        one: unigrams shifted by -log(sum); each deeper context's backoff
        := log(1 - the mass of its n-grams) (`ARPALM.cpp:834-851`, the
        non-SCALE_NGRAMS branch)."""
        # the (n)-gram entries grouped by their (n-1)-word context
        by_context: list[dict[tuple[int, ...], list[tuple[int, ...]]]] = [
            dict() for _ in range(self.order)]
        for n in range(1, self.order + 1):
            for ids in self.entries[n - 1]:
                by_context[n - 1].setdefault(ids[:-1], []).append(ids)
        probs = self.entries[0]
        total = sum(math.exp(p) for p, _ in probs.values() if p > LOG_ZERO)
        if total > 0:
            log_tot = math.log(total)
            for ids, (p, bo) in list(probs.items()):
                if p > LOG_ZERO:
                    probs[ids] = (p - log_tot, bo)
        for n in range(2, self.order + 1):
            for ctx, members in by_context[n - 1].items():
                s = sum(math.exp(self.entries[n - 1][ids][0]) for ids in members
                        if self.entries[n - 1][ids][0] > LOG_ZERO)
                s = min(s, 1.0)
                new_bo = math.log(1.0 - s) if s < 1.0 else LOG_ZERO
                ce = self.entries[n - 2].get(ctx)
                if ce is not None:
                    self.entries[n - 2][ctx] = (ce[0], new_bo)
