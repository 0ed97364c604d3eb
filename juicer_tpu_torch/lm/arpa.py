"""ARPA n-gram language model reader.

A reduced copy of `juicer_tpu/lm/arpa.py` (`ArpaLM`): the parse into
per-order entries, which is what the grammar build (`compile/gram.py`)
reads. As there (and in the reference's `ARPALM`):

  - arbitrary order; log10 probabilities become natural logs; below -90
    they are log-zero;
  - n-grams with a word outside the vocabulary are dropped, as are
    sentence start at a later position and sentence end at an earlier
    one;
  - a missing backoff is 0.0; the highest order has none.

The LM must cover every vocabulary word but the sentence markers: the
JAX class's `<unk>` word, which stands in for the rest, and its gzip
input are not copied (no task here uses either), nor its silence word.
"""

from __future__ import annotations

import math

from ..lexicon import Vocabulary

LOG_ZERO = -1e30
LN10 = math.log(10.0)


class ArpaLM:
    def __init__(self, arpa_fname: str, vocab: Vocabulary):
        self.vocab = vocab
        self.order = 0
        # entries[n][tuple(word_ids)] = (log_prob, log_bo); natural log
        self.entries: list[dict[tuple[int, ...], tuple[float, float]]] = []
        self._words_in_lm: set[int] = set()
        with open(arpa_fname, "r", errors="replace") as fd:
            self._parse(fd)
        self._check_coverage()

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
            wid = v.get_index(w)
            if wid < 0:
                return
            elif wid == v.sent_start_index and i > 0:
                return
            elif wid == v.sent_end_index and i < n - 1:
                return
            else:
                self._words_in_lm.add(wid)
            ids.append(wid)
        if n < self.order:
            rest = parts[1 + n:]
            bo = float(rest[0]) if rest else 0.0
            bo = LOG_ZERO if bo < -90.0 else bo * LN10
        else:
            bo = LOG_ZERO
        self.entries[n - 1][tuple(ids)] = (prob, bo)

    def _check_coverage(self) -> None:
        """Raise on a vocabulary word the LM lacks (the JAX class, given no
        `<unk>` word, raises alike)."""
        v = self.vocab
        for i in range(v.n_words):
            if i not in self._words_in_lm and not v.is_special(i):
                raise ValueError(f"vocabulary word {v.get_word(i)!r} not in LM")
