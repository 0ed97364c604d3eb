"""Lexicon transducer (L) generation.

A copy of `juicer_tpu/compile/lex.py`, the rebuild of `WFSTLexGen`
(`WFSTLexGen.{h,cpp}`):
  - pronunciations grouped in a phone prefix tree so homophones (same full
    phone string) get distinct auxiliary symbols `#0..#n`
    (`WFSTLexNode`/`addPhone`, `WFSTLexGen.cpp:192-276`);
  - each pronunciation is emitted as a linear chain from the initial state
    to a common final state, word output label and -log(prior) weight on
    the FIRST arc (`outputFSMWord`, `:679-760`);
  - optional pronunciation variants with sil/sp appended at start/end, with
    the pause-tee probability split between the base and pause variants
    (`addDecLexInfoEntry`, `:283-430`);
  - optional #phi self-loop at the initial state (used with on-the-fly
    composition, `writeFSM`, `:483-491`).

Input label p+1 = monophone p; aux phone k gets input label
n_monophones+k+1. Output label w+1 = vocab word w.
"""

from __future__ import annotations

import math
from ..fst import EPSILON, Fst, LOG, SymbolTable
from ..fst.fst import EPSILON_STR, PHI_STR
from ..lexicon import Lexicon

LOG_ZERO = -1e30


class _LexNode:
    __slots__ = ("phone", "words", "word_probs", "children")

    def __init__(self, phone: int):
        self.phone = phone
        self.words: list[int] = []
        self.word_probs: list[float] = []
        self.children: dict[int, "_LexNode"] = {}


class LexGen:
    def __init__(
        self,
        lexicon: Lexicon,
        add_pronun_with_end_sil: bool = False,
        add_pronun_with_end_pause: bool = False,
        add_pronun_with_start_sil: bool = False,
        add_pronun_with_start_pause: bool = False,
        pause_tee_trans_log_prob: float = LOG_ZERO,
    ):
        self.lex = lexicon
        self.vocab = lexicon.vocab
        self.phone_set = lexicon.phone_set
        self.end_sil = add_pronun_with_end_sil
        self.end_pause = add_pronun_with_end_pause
        self.start_sil = add_pronun_with_start_sil
        self.start_pause = add_pronun_with_start_pause
        self.pause_tee = pause_tee_trans_log_prob
        if (self.end_sil or self.start_sil) and self.phone_set.sil_index < 0:
            raise ValueError("sil pronun variants requested but no sil monophone")
        if (self.end_pause or self.start_pause) and self.phone_set.pause_index < 0:
            raise ValueError("pause pronun variants requested but no pause monophone")

        self.root = _LexNode(-1)
        self.n_aux = 0
        for e in self.lex.entries:
            self._add_entry(e)

    # -- prefix tree -------------------------------------------------------

    def _add_phone(self, node: _LexNode, phone: int, word: int, log_prob: float = 0.0):
        child = node.children.get(phone)
        if child is None:
            child = _LexNode(phone)
            node.children[phone] = child
        if word >= 0:
            child.words.append(word)
            child.word_probs.append(log_prob)
            if len(child.words) > self.n_aux:
                self.n_aux = len(child.words)
        return child

    def _add_chain(self, phones: list[int], word: int, log_prob: float):
        node = self.root
        for p in phones[:-1]:
            node = self._add_phone(node, p, -1)
        return self._add_phone(node, phones[-1], word, log_prob)

    def _add_entry(self, e) -> None:
        ps = self.phone_set
        no_sil = not (self.end_sil or self.end_pause or self.start_sil or self.start_pause)
        if self.vocab.is_special(e.vocab_index) or no_sil:
            self._add_chain(e.phones, e.vocab_index, e.log_prior)
            return

        base_prob = e.log_prior
        pause_prob = e.log_prior
        sil_prob = e.log_prior
        if self.end_pause and self.pause_tee > LOG_ZERO:
            base_prob += self.pause_tee
            pause_prob += math.log(1.0 - math.exp(self.pause_tee))

        # base pronunciation: whether the "skip" (no trailing sil/sp)
        # variant carries the word depends on the sil/pause configuration
        skip_here = (
            (not self.end_pause and not self.start_pause and (self.start_sil or self.end_sil))
            or (self.end_pause and self.pause_tee > LOG_ZERO)
        )
        node = self.root
        for p in e.phones[:-1]:
            node = self._add_phone(node, p, -1)
        node = self._add_phone(
            node, e.phones[-1], e.vocab_index if skip_here else -1, base_prob
        )

        is_bare_sil = len(e.phones) == 1 and e.phones[0] == ps.sil_index
        is_bare_pause = len(e.phones) == 1 and e.phones[0] == ps.pause_index
        if self.end_sil and not is_bare_sil:
            if e.phones[-1] == ps.sil_index:
                raise ValueError("addPronunWithEndSil but entry already ends with sil")
            self._add_phone(node, ps.sil_index, e.vocab_index, sil_prob)
        if self.end_pause and not is_bare_pause:
            if e.phones[-1] == ps.pause_index:
                raise ValueError("addPronunWithEndPause but entry already ends with pause")
            self._add_phone(node, ps.pause_index, e.vocab_index, pause_prob)
        if self.start_sil and not is_bare_sil:
            if e.phones[0] == ps.sil_index:
                raise ValueError("addPronunWithStartSil but entry already starts with sil")
            self._add_chain([ps.sil_index] + list(e.phones), e.vocab_index, e.log_prior)
        if self.start_pause and not is_bare_pause:
            if e.phones[0] == ps.pause_index:
                raise ValueError("addPronunWithStartPause but entry already starts with pause")
            self._add_chain([ps.pause_index] + list(e.phones), e.vocab_index, e.log_prior)

    # -- FSM emission ------------------------------------------------------

    def build(self, output_aux_phones: bool = True, add_phi_loop: bool = False) -> Fst:
        f = Fst(LOG)
        init = f.add_state()
        f.set_start(init)
        final = f.add_state()
        f.set_final(final, 0.0)
        n_mono = len(self.phone_set)
        phi_word_label = -1
        input_phi_label = -1
        if add_phi_loop:
            phi_word_label = self.vocab.n_words + 1
            input_phi_label = n_mono + self.n_aux + 1

        def aux_label(k: int) -> int:
            return n_mono + k + 1

        def emit_word(word: int, log_prob: float, phones: list[int]) -> None:
            weight = -log_prob
            cur = init
            for j, p in enumerate(phones):
                last = j == len(phones) - 1
                nxt = final if last else f.add_state()
                f.add_arc(cur, nxt, p + 1, word + 1 if j == 0 else EPSILON,
                          weight if j == 0 else 0.0)
                cur = nxt

        def walk(node: _LexNode, prefix: list[int]) -> None:
            # the reference head-inserts new children (`addPhone`,
            # WFSTLexGen.cpp:218-224) and its writer recurses the child
            # subtree BEFORE emitting the node's own words
            # (`writeFSMNode`, :588-616) — mirror both so the emitted
            # FSM is byte-identical, state numbering included
            for phone in reversed(list(node.children)):
                child = node.children[phone]
                path = prefix + [phone]
                walk(child, path)
                for i, (w, lp) in enumerate(zip(child.words, child.word_probs)):
                    if output_aux_phones:
                        # aux phone input label appended after the last phone
                        emit_word(w, lp, [p + 0 for p in path] + [n_mono + i])
                    else:
                        emit_word(w, lp, path)

        # note: aux phones occupy monophone index range [n_mono, n_mono+n_aux)
        # so `emit_word` sees them like any phone (label = idx+1)
        walk(self.root, [])

        if add_phi_loop:
            f.add_arc(init, init, input_phi_label, phi_word_label, 0.0)

        f.isyms = self.input_symbols(output_aux_phones, input_phi_label)
        f.osyms = self.output_symbols(phi_word_label)
        return f

    def input_symbols(self, output_aux: bool = True, input_phi_label: int = -1) -> SymbolTable:
        t = SymbolTable()
        t.add_with_index(EPSILON_STR, EPSILON)
        for i, p in enumerate(self.phone_set.phones):
            t.add_with_index(p, i + 1)
        if output_aux:
            for k in range(self.n_aux):
                t.add_with_index(f"#{k}", len(self.phone_set) + k + 1)
        if input_phi_label >= 0:
            t.add_with_index(PHI_STR, input_phi_label)
        return t

    def output_symbols(self, phi_word_label: int = -1) -> SymbolTable:
        t = SymbolTable()
        t.add_with_index(EPSILON_STR, EPSILON)
        v = self.vocab
        for i in range(v.n_words):
            if v.get_num_pronuns(i) > 0:
                t.add_with_index(v.get_word(i), i + 1)
        if phi_word_label >= 0:
            t.add_with_index(PHI_STR, phi_word_label)
            t.add_with_index("#sil", phi_word_label + 1)
            t.add_with_index("#sp", phi_word_label + 2)
        return t
