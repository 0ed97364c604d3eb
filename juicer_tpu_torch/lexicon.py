"""Lexical resources: the vocabulary and the phone list.

A reduced copy of `juicer_tpu/lexicon.py`:
  - `Vocabulary` (`DecVocabulary`): the sorted unique word list of a
    lexicon file, per-word pronunciation counts, the sentence start, end
    and silence words, and special words marked by a prefix character
    (the decoder CLI passes '!'); the sentence markers are always special.
    Whether `<s>` and `</s>` have pronunciations decides whether the
    grammar gets sentence-marker arcs or final weights (`compile/gram.py`);
  - `PhoneSet` (`DecPhoneInfo`): a monophone list, plain (one phone a
    line), Noway ("<n>" then "index phone" lines) or an HTK model list;
    hybrid model sets are built over it, and the CLI checks
    -silMonophone / -pauseMonophone against it;
  - `load_vocabulary`: the part of `Lexicon.load` that checks a
    pronunciation lexicon against its phone list.

Lexicon file format: "word(prior) ph ph ph" with the (prior) optional;
lines starting with '(' or '#' are comments.
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
    """Sorted unique word list with special-word marking."""

    def __init__(
        self,
        lex_fname: Optional[str] = None,
        spec_word_char: str = "",
        sent_start_word: Optional[str] = None,
        sent_end_word: Optional[str] = None,
        sil_word: Optional[str] = None,
    ):
        self.spec_word_char = spec_word_char
        self.sent_start_index = -1
        self.sent_end_index = -1
        self.sil_index = -1
        pronun_counts: dict[str, int] = {}
        if lex_fname is not None:
            for word, _ in _lex_lines(lex_fname):
                pronun_counts[word] = pronun_counts.get(word, 0) + 1
        for w in (sent_start_word, sent_end_word, sil_word):
            if w:
                pronun_counts.setdefault(w, 0)

        self.words: list[str] = sorted(pronun_counts)
        self._index = {w: i for i, w in enumerate(self.words)}
        self.special = [bool(spec_word_char) and w.startswith(spec_word_char)
                        for w in self.words]
        self.n_pronuns = [pronun_counts[w] for w in self.words]

        if sent_start_word:
            self.sent_start_index = self.get_index(sent_start_word)
        if sent_end_word:
            self.sent_end_index = self.get_index(sent_end_word)
        if sil_word:
            self.sil_index = self.get_index(sil_word)
        # sentence start/end words are always special, whatever the
        # special-word character (`DecVocabulary.cpp:149-153`)
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


class PhoneSet:
    """Monophone list: plain, Noway or HTK model list, the three formats
    `DecPhoneInfo` reads (`DecPhoneInfo.cpp:75-87`)."""

    def __init__(self, list_fname: str):
        self.phones: list[str] = []
        self._index: dict[str, int] = {}
        self._read(list_fname)

    def _read(self, fname: str) -> None:
        with open(fname, "r", errors="replace") as fd:
            lines = [ln.strip() for ln in fd]
        lines = [ln for ln in lines if ln and not ln.startswith("#")]
        if lines and lines[0].isdigit() and len(lines) > 1 and len(lines[0].split()) == 1:
            # Noway format: the count, then "index phone" lines
            for ln in lines[1:]:
                self.add(ln.split()[-1])
        else:
            for ln in lines:
                self.add(ln.split()[0])

    def add(self, phone: str) -> int:
        if phone not in self._index:
            self._index[phone] = len(self.phones)
            self.phones.append(phone)
        return self._index[phone]

    def get_index(self, phone: str) -> int:
        return self._index.get(phone, -1)

    def __len__(self) -> int:
        return len(self.phones)

    def __getitem__(self, i: int) -> str:
        return self.phones[i]


def load_vocabulary(phones_fname: str, lex_fname: str,
                    sent_start_word: Optional[str] = None,
                    sent_end_word: Optional[str] = None) -> Vocabulary:
    """The vocabulary of `Lexicon.load(phones_fname, lex_fname, ...)`, with
    its checks: every pronunciation has phones, each of them in the phone
    list, and a sentence marker has at most one pronunciation."""
    phones = PhoneSet(phones_fname)
    for word, prons in _lex_lines(lex_fname):
        if not prons:
            raise ValueError(f"word {word!r} had no phones")
        for ph in prons:
            if phones.get_index(ph) < 0:
                raise ValueError(f"phone {ph!r} not found in phone list")
    vocab = Vocabulary(lex_fname, "", sent_start_word, sent_end_word)
    for idx in (vocab.sent_start_index, vocab.sent_end_index):
        if idx >= 0 and vocab.get_num_pronuns(idx) > 1:
            raise ValueError("cannot have >1 pronunciations of a special word")
    return vocab
