"""The vocabulary the grammar of on-the-fly composition is built over.

A reduced copy of `juicer_tpu/lexicon.py` (`Vocabulary`, and the part of
`Lexicon.load` that checks a pronunciation lexicon against its phone
list): the sorted unique word list of a lexicon file, per-word
pronunciation counts, and the sentence start and sentence end words.
Whether `<s>` and `</s>` have pronunciations decides whether the
grammar gets sentence-marker arcs or final weights (`compile/gram.py`).

Lexicon file format: "word(prior) ph ph ph" with the (prior) optional;
lines starting with '(' or '#' are comments. The tasks here mark no
special words by prefix (the JAX `spec_word_char=""`) and name no
silence word, so neither option is copied: the special words are the
sentence markers alone.
"""

from __future__ import annotations

import re
from typing import Optional


def _lex_lines(lex_fname: str):
    """(word, phones) of every pronunciation line of a lexicon file."""
    with open(lex_fname, "r", errors="replace") as fd:
        for line in fd:
            if line.startswith("(") or line.startswith("#"):
                continue
            parts = line.split()
            if not parts:
                continue
            word = re.split(r"[(]", parts[0])[0]
            if word:
                yield word, parts[1:]


class Vocabulary:
    """Sorted unique word list; the sentence markers are special."""

    def __init__(
        self,
        lex_fname: str,
        sent_start_word: Optional[str] = None,
        sent_end_word: Optional[str] = None,
    ):
        self.sent_start_index = -1
        self.sent_end_index = -1
        pronun_counts: dict[str, int] = {}
        for word, _ in _lex_lines(lex_fname):
            pronun_counts[word] = pronun_counts.get(word, 0) + 1
        for w in (sent_start_word, sent_end_word):
            if w:
                pronun_counts.setdefault(w, 0)

        self.words: list[str] = sorted(pronun_counts)
        self._index = {w: i for i, w in enumerate(self.words)}
        self.special = [False] * len(self.words)
        self.n_pronuns = [pronun_counts[w] for w in self.words]

        if sent_start_word:
            self.sent_start_index = self.get_index(sent_start_word)
        if sent_end_word:
            self.sent_end_index = self.get_index(sent_end_word)
        # sentence start/end words are always special
        # (`DecVocabulary.cpp:149-153`)
        for idx in (self.sent_start_index, self.sent_end_index):
            if idx >= 0:
                self.special[idx] = True

    @property
    def n_words(self) -> int:
        return len(self.words)

    def get_word(self, index: int) -> str:
        return self.words[index]

    def get_index(self, word: str) -> int:
        return self._index.get(word, -1)

    def is_special(self, index: int) -> bool:
        return self.special[index]

    def get_num_pronuns(self, index: int) -> int:
        return self.n_pronuns[index]


def load_vocabulary(phones_fname: str, lex_fname: str,
                    sent_start_word: Optional[str] = None,
                    sent_end_word: Optional[str] = None) -> Vocabulary:
    """The vocabulary of `Lexicon.load(phones_fname, lex_fname, ...)`, with
    its checks: every pronunciation has phones, each of them in the phone
    list, and a sentence marker has at most one pronunciation.
    The phone list is plain, one phone a line (the JAX `PhoneSet` also
    reads the Noway format, which no task here uses)."""
    with open(phones_fname, "r", errors="replace") as fd:
        phones = {ln.split()[0] for ln in fd if ln.strip() and not ln.startswith("#")}
    for word, prons in _lex_lines(lex_fname):
        if not prons:
            raise ValueError(f"word {word!r} had no phones")
        for ph in prons:
            if ph not in phones:
                raise ValueError(f"phone {ph!r} not found in phone list")
    vocab = Vocabulary(lex_fname, sent_start_word, sent_end_word)
    for idx in (vocab.sent_start_index, vocab.sent_end_index):
        if idx >= 0 and vocab.get_num_pronuns(idx) > 1:
            raise ValueError("cannot have >1 pronunciations of a special word")
    return vocab
