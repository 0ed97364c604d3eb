"""Lexical resources: vocabulary, phone set, pronunciation lexicon.

A copy of `juicer_tpu/lexicon.py`:
  - `Vocabulary` (`DecVocabulary`): the sorted unique word list of a
    lexicon file, per-word pronunciation counts, the sentence start, end
    and silence words, and special words marked by a prefix character
    (the decoder CLI passes '!'); the sentence markers are always special.
    Whether `<s>` and `</s>` have pronunciations decides whether the
    grammar gets sentence-marker arcs or final weights (`compile/gram.py`);
  - `PhoneSet` (`DecPhoneInfo`): a monophone list, plain (one phone a
    line), Noway ("<n>" then "index phone" lines) or an HTK model list,
    or given as names, with its silence and pause phones;
  - `Lexicon` (`DecLexInfo`): pronunciation entries {phones, log prior,
    vocabulary index} with a word -> pronunciations map, the special
    words' entries and prior normalisation; `Lexicon.load(...).vocab` is
    the vocabulary of a lexicon checked against its phone list.

Lexicon file format: "word(prior) ph ph ph" with the (prior) optional;
lines starting with '(' or '#' are comments.
"""

from __future__ import annotations

import bisect
import math
import re
from dataclasses import dataclass, field
from typing import Optional

LOG_ZERO = -1e30


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

    def add_word(self, word: str, special: bool = False) -> int:
        """Add a word in sorted place (for vocabularies built in code)."""
        if word in self._index:
            return self._index[word]
        pos = bisect.bisect_left(self.words, word)
        self.words.insert(pos, word)
        self.special.insert(pos, special)
        self.n_pronuns.insert(pos, 0)
        self._index = {w: i for i, w in enumerate(self.words)}
        for attr in ("sent_start_index", "sent_end_index", "sil_index"):
            v = getattr(self, attr)
            if v >= pos:
                setattr(self, attr, v + 1)
        return self._index[word]


class PhoneSet:
    """Monophone list with silence and pause markers: read from a plain,
    Noway or HTK model list, the three formats `DecPhoneInfo` reads
    (`DecPhoneInfo.cpp:75-87`), or given as names."""

    def __init__(self, list_fname: Optional[str] = None, sil_name: Optional[str] = None,
                 pause_name: Optional[str] = None, phones: Optional[list[str]] = None):
        self.phones: list[str] = []
        self._index: dict[str, int] = {}
        if list_fname is not None:
            self._read(list_fname)
        elif phones is not None:
            for p in phones:
                self.add(p)
        self.sil_index = self._index.get(sil_name, -1) if sil_name else -1
        self.pause_index = self._index.get(pause_name, -1) if pause_name else -1
        if sil_name and self.sil_index < 0:
            raise ValueError(f"silence phone {sil_name!r} not in phone list")
        if pause_name and self.pause_index < 0:
            raise ValueError(f"pause phone {pause_name!r} not in phone list")

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


@dataclass
class LexEntry:
    phones: list[int]  # monophone indices
    log_prior: float
    vocab_index: int


@dataclass
class Lexicon:
    """Pronunciation table (`DecLexInfo`)."""

    phone_set: PhoneSet
    vocab: Vocabulary
    entries: list[LexEntry] = field(default_factory=list)
    vocab_to_lex: dict[int, list[int]] = field(default_factory=dict)
    sent_start_entry: int = -1
    sent_end_entry: int = -1
    sil_entry: int = -1

    @classmethod
    def load(cls, mono_list_fname: str, lex_fname: str, sil_phone: Optional[str] = None,
             pause_phone: Optional[str] = None, sent_start_word: Optional[str] = None,
             sent_end_word: Optional[str] = None, sil_word: Optional[str] = None,
             spec_word_char: str = "!") -> "Lexicon":
        """Read a lexicon file against its phone list: every word has
        phones, each of them in the list; a special word has at most one
        pronunciation."""
        phone_set = PhoneSet(mono_list_fname, sil_phone, pause_phone)
        vocab = Vocabulary(lex_fname, spec_word_char, sent_start_word, sent_end_word, sil_word)
        lex = cls(phone_set, vocab)
        with open(lex_fname, "r", errors="replace") as fd:
            for line in fd:
                if line.startswith("(") or line.startswith("#"):
                    continue
                parts = line.split()
                if not parts:
                    continue
                m = re.match(r"([^(\s]+)(?:\((\S+)\))?$", parts[0])
                if not m:
                    continue
                word, prior_s = m.group(1), m.group(2)
                prior = float(prior_s) if prior_s else 1.0
                voc_ind = vocab.get_index(word)
                if voc_ind < 0:
                    raise ValueError(f"word {word!r} not found in vocabulary")
                phones = []
                for ph in parts[1:]:
                    pi = phone_set.get_index(ph)
                    if pi < 0:
                        raise ValueError(f"phone {ph!r} not found in phone list")
                    phones.append(pi)
                if not phones:
                    raise ValueError(f"word {word!r} had no phones")
                lex.add_entry(phones, math.log(prior) if prior > 0 else LOG_ZERO, voc_ind)
        lex._register_specials()
        return lex

    def add_entry(self, phones: list[int], log_prior: float, vocab_index: int) -> int:
        idx = len(self.entries)
        self.entries.append(LexEntry(list(phones), log_prior, vocab_index))
        self.vocab_to_lex.setdefault(vocab_index, []).append(idx)
        return idx

    def _register_specials(self) -> None:
        v = self.vocab

        def first_entry(voc_ind):
            lst = self.vocab_to_lex.get(voc_ind, [])
            if len(lst) > 1:
                raise ValueError("cannot have >1 pronunciations of a special word")
            return lst[0] if lst else -1

        if v.sent_start_index >= 0:
            self.sent_start_entry = first_entry(v.sent_start_index)
        if v.sent_end_index >= 0:
            if v.sent_end_index == v.sent_start_index:
                # the start word's pronunciation again, as its own entry
                # (`DecLexInfo.cpp:200-221`)
                if self.sent_start_entry >= 0:
                    e = self.entries[self.sent_start_entry]
                    self.sent_end_entry = len(self.entries)
                    self.entries.append(LexEntry(list(e.phones), e.log_prior, e.vocab_index))
            else:
                self.sent_end_entry = first_entry(v.sent_end_index)
        if v.sil_index >= 0:
            if v.sil_index in (v.sent_start_index, v.sent_end_index):
                src = (self.sent_end_entry if v.sil_index == v.sent_end_index
                       else self.sent_start_entry)
                if src >= 0:
                    e = self.entries[src]
                    self.sil_entry = len(self.entries)
                    self.entries.append(LexEntry(list(e.phones), e.log_prior, e.vocab_index))
            else:
                self.sil_entry = first_entry(v.sil_index)

    def normalise_pronuns(self) -> None:
        """Renormalise the pronunciation priors to sum to one a word
        (`DecLexInfo::normalisePronuns`)."""
        for ents in self.vocab_to_lex.values():
            tot = sum(math.exp(self.entries[i].log_prior) for i in ents)
            if tot <= 0:
                continue
            log_tot = math.log(tot)
            for i in ents:
                self.entries[i].log_prior -= log_tot

    @property
    def n_entries(self) -> int:
        return len(self.entries)
