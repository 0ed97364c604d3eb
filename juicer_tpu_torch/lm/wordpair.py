"""BBN word-pair grammar (the RM task).

A copy of `juicer_tpu/lm/wordpair.py`, the rebuild of the reference's
`WordPairLM` (`WordPairLM.h:23-49`, `WordPairLM.cpp`): an optional
C-style comment block, then groups of lines: ">word" introduces a
predecessor word, the lines after it list its successor words.
"""

from __future__ import annotations

from ..lexicon import Vocabulary


class WordPairLM:
    def __init__(self, fname: str, vocab: Vocabulary):
        self.vocab = vocab
        if vocab.sent_start_index < 0 or vocab.sent_end_index < 0:
            raise ValueError("word-pair LM requires sentence start and end words")
        self.successors: dict[int, list[int]] = {}
        cur_prev = -1
        in_comments = False
        with open(fname, "r", errors="replace") as fd:
            for line in fd:
                if in_comments:
                    in_comments = "*/" not in line
                    continue
                if "/*" in line:
                    in_comments = "*/" not in line
                    continue
                for tok in line.split():
                    if tok.startswith(">"):
                        cur_prev = vocab.get_index(tok[1:])
                        if cur_prev < 0:
                            raise ValueError(f"word-pair LM prev word {tok[1:]!r} not in vocab")
                        self.successors.setdefault(cur_prev, [])
                    else:
                        if cur_prev < 0:
                            raise ValueError("word-pair LM: successor before any >word")
                        wid = vocab.get_index(tok)
                        if wid < 0:
                            raise ValueError(f"word-pair LM successor {tok!r} not in vocab")
                        self.successors[cur_prev].append(wid)

    def get_successors(self, word: int) -> list[int]:
        return self.successors.get(word, [])

    @property
    def n_words(self) -> int:
        return self.vocab.n_words
