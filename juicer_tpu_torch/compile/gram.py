"""Grammar transducer (G) generation.

A copy of `juicer_tpu/compile/gram.py` (`GramGen`), the rebuild of the
reference's `WFSTGramGen` (`WFSTGramGen.{h,cpp}`):
  - word loop (`writeFSMWordLoop`, `WFSTGramGen.cpp:486-520`);
  - sil-wordloop-sil (`writeFSMSilWordLoopSil`, `:522-571`);
  - ARPA n-gram -> backoff WFST, one state per n-gram context managed as
    a word trie (`WFSTNGramStateManager`, `:30-160`), epsilon- or
    `#phi`-labelled backoff arcs, the `<unk>` fan-out, default backoff
    paths for missing contexts (`addDefaultBackoffPath`, `:869-940`),
    optional sil/sp self-loops on every state (`writeFSMARPA`,
    `:573-830`), the LM scale and the word insertion penalty, and the
    LM's `normalise`;
  - BBN word-pair grammars (`writeFSMWordPair`).
States are numbered and arcs added in the JAX build's order, so state
ids, and with them the decoder's (arc, G state) keys, are the JAX
package's.

Output word label i+1 is vocabulary index i (label 0 is epsilon).
Weights are costs: -(log_prob * lm_scale + word_ins_pen).
`arpa_grammar` is the NGRAM grammar at `GramGen`'s defaults, which the
on-the-fly task loader builds.
"""

from __future__ import annotations

import math
import os
from enum import Enum
from typing import Optional

from ..fst import EPSILON, LOG, Fst, SymbolTable
from ..fst.fst import EPSILON_STR, PHI_STR
from ..lexicon import Vocabulary
from ..lm import ArpaLM, WordPairLM

LOG_ZERO = -1e30


class GramType(Enum):
    WORDLOOP = "wordloop"
    SIL_WORDLOOP_SIL = "silwordloopsil"
    NGRAM = "ngram"
    WORDPAIR = "wordpair"


class _NGramStateManager:
    """One FST state per n-gram context, managed as a word trie
    (`WFSTNGramStateManager`). State 0 is the epsilon (null-context) state."""

    def __init__(self, vocab: Vocabulary, fst: Fst):
        self.fst = fst
        self.eps_state = fst.add_state()  # state 0
        self._trie: dict[tuple[int, ...], int] = {(): self.eps_state}
        if vocab.sent_start_index >= 0:
            if vocab.get_num_pronuns(vocab.sent_start_index) > 0:
                self.init_state = fst.add_state()
            else:
                self.init_state = self.get_state((vocab.sent_start_index,))
        else:
            self.init_state = self.eps_state

    def get_state(self, words: tuple[int, ...]) -> int:
        s = self._trie.get(words)
        if s is None:
            s = self.fst.add_state()
            self._trie[words] = s
        return s

    def has_state(self, words: tuple[int, ...]) -> bool:
        return words in self._trie

    @property
    def num_states(self) -> int:
        return self.fst.num_states


class GramGen:
    def __init__(self, vocab: Vocabulary, gtype: GramType, lm_scale: float = 1.0,
                 word_ins_pen: float = 0.0, lm_fname: Optional[str] = None,
                 unk_word: Optional[str] = None, write_binary: bool = False):
        self.vocab = vocab
        self.gtype = gtype
        self.lm_scale = lm_scale
        self.word_ins_pen = word_ins_pen
        self.lm_fname = lm_fname
        self.unk_word = unk_word
        self.write_binary = write_binary
        self.phi_label = -1

    def _load_lm(self) -> ArpaLM:
        """The ARPA LM, through its npz cache `<lm>.npz` when that is newer
        (the reference's auto-written TOLM cache, `juicer.cpp:777-802`;
        like it, the cache depends on the vocabulary)."""
        cache = self.lm_fname + ".npz"
        if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(self.lm_fname):
            return ArpaLM.load_npz(cache, self.vocab, self.unk_word)
        lm = ArpaLM(self.lm_fname, self.vocab, self.unk_word)
        if self.write_binary:
            lm.save_npz(cache)
        return lm

    # -- public ------------------------------------------------------------

    def build(self, add_sil: bool = False, phi_bo_trans: bool = False,
              normalise: bool = False) -> Fst:
        if self.gtype == GramType.WORDLOOP:
            g = self._build_word_loop()
        elif self.gtype == GramType.SIL_WORDLOOP_SIL:
            g = self._build_sil_wordloop_sil()
        elif self.gtype == GramType.NGRAM:
            g = self._build_arpa(add_sil, phi_bo_trans, normalise)
        elif self.gtype == GramType.WORDPAIR:
            g = self._build_wordpair()
        else:
            raise ValueError("unsupported grammar type")
        g.isyms = self.symbols(input_side=True, add_sil=add_sil)
        g.osyms = self.symbols(input_side=False)
        return g

    def symbols(self, input_side: bool, add_sil: bool = False) -> SymbolTable:
        t = SymbolTable()
        t.add_with_index(EPSILON_STR, EPSILON)
        v = self.vocab
        for i in range(v.n_words):
            if v.get_num_pronuns(i) > 0:
                t.add_with_index(v.get_word(i), i + 1)
        if self.phi_label >= 0:
            t.add_with_index(PHI_STR, self.phi_label)
        if input_side and add_sil:
            t.add_with_index("#sil", self.phi_label + 1)
            t.add_with_index("#sp", self.phi_label + 2)
        return t

    # -- simple loops ------------------------------------------------------

    def _build_word_loop(self) -> Fst:
        g = Fst(LOG)
        v = self.vocab
        init, final = g.add_state(), g.add_state()
        g.set_start(init)
        weight = math.log(v.n_words)
        for i in range(v.n_words):
            if i == v.sil_index or v.get_num_pronuns(i) <= 0:
                continue
            g.add_arc(init, final, i + 1, i + 1, weight)
        if v.sil_index >= 0:
            g.add_arc(final, final, v.sil_index + 1, v.sil_index + 1, 0.0)
        g.add_arc(final, init, EPSILON, EPSILON, -self.word_ins_pen)
        g.set_final(final, 0.0)
        return g

    def _build_sil_wordloop_sil(self) -> Fst:
        v = self.vocab
        if v.sent_start_index < 0 or v.get_num_pronuns(v.sent_start_index) <= 0:
            raise ValueError("sil_wordloop_sil requires a sentence start word with pronun")
        if v.sent_end_index < 0 or v.get_num_pronuns(v.sent_end_index) <= 0:
            raise ValueError("sil_wordloop_sil requires a sentence end word with pronun")
        if v.sil_index >= 0:
            raise ValueError("sil_wordloop_sil: vocab must not define a silence word")
        g = Fst(LOG)
        init, ws1, ws2, final = (g.add_state() for _ in range(4))
        g.set_start(init)
        g.add_arc(init, ws1, v.sent_start_index + 1, v.sent_start_index + 1, 0.0)
        for i in range(v.n_words):
            if i in (v.sent_start_index, v.sent_end_index) or v.get_num_pronuns(i) <= 0:
                continue
            g.add_arc(ws1, ws2, i + 1, i + 1, -self.word_ins_pen)
        g.add_arc(ws2, final, v.sent_end_index + 1, v.sent_end_index + 1, -self.word_ins_pen)
        g.add_arc(ws2, ws1, EPSILON, EPSILON, 0.0)
        g.set_final(final, 0.0)
        return g

    # -- ARPA n-gram -------------------------------------------------------

    def _build_arpa(self, add_sil: bool, phi_bo_trans: bool, normalise: bool) -> Fst:
        v = self.vocab
        if phi_bo_trans:
            self.phi_label = v.n_words + 1
        lm = self._load_lm()
        if normalise:
            lm.normalise()
        g = Fst(LOG)
        sm = _NGramStateManager(v, g)
        have_final = False
        bo_label = self.phi_label if self.phi_label >= 0 else EPSILON

        if v.sent_start_index >= 0 and v.get_num_pronuns(v.sent_start_index) > 0:
            lab = v.sent_start_index + 1
            g.add_arc(sm.init_state, sm.get_state((v.sent_start_index,)), lab, lab, 0.0)

        def add_default_backoff_path(from_st: int, to_words: tuple[int, ...]) -> None:
            # from context (w1..wk): a backoff arc to (w2..wk), the chain
            # made recursively for contexts that do not exist yet
            is_new = not sm.has_state(to_words)
            to_st = sm.get_state(to_words)
            g.add_arc(from_st, to_st, bo_label, EPSILON, 0.0)
            if is_new and len(to_words) > 1:
                add_default_backoff_path(to_st, to_words[1:])

        def emit_prob_arc(n: int, ids: tuple[int, ...], log_prob: float, highest: bool):
            nonlocal have_final
            if log_prob <= LOG_ZERO:
                return
            last = ids[-1]
            if last == v.sent_end_index:
                if v.get_num_pronuns(v.sent_end_index) > 0:
                    from_st = sm.get_state(ids[:-1]) if n > 0 else sm.eps_state
                    to_st = sm.get_state((v.sent_end_index,))
                    lab = v.sent_end_index + 1
                    g.add_arc(from_st, to_st, lab, lab,
                              -(log_prob * self.lm_scale + self.word_ins_pen))
                else:
                    g.finals[sm.get_state(ids[:-1] if n > 0 else ())] = -(log_prob
                                                                           * self.lm_scale)
                have_final = True
                return
            if highest:
                # from the order-1 context (w1..wn) to (w2..wn+1)
                from_st = sm.get_state(ids[:-1])
                is_new = not sm.has_state(ids[1:])
                to_st = sm.get_state(ids[1:])
                if is_new:
                    add_default_backoff_path(to_st, ids[2:])
            else:
                from_st = sm.get_state(ids[:-1])
                to_st = sm.get_state(ids)
            prob = log_prob * self.lm_scale + self.word_ins_pen
            if last == lm.unk_id:
                for u in lm.unk_words:
                    g.add_arc(from_st, to_st, u + 1, u + 1, -prob)
            else:
                g.add_arc(from_st, to_st, last + 1, last + 1, -prob)

        # 1..(N-1)-grams: probability arcs and backoff arcs
        for n in range(lm.order - 1):
            for ids, (log_prob, log_bo) in lm.entries[n].items():
                emit_prob_arc(n, ids, log_prob, highest=False)
                if log_bo > LOG_ZERO and ids[-1] != v.sent_end_index:
                    from_st = sm.get_state(ids)
                    is_new = not sm.has_state(ids[1:])
                    to_st = sm.get_state(ids[1:])
                    if is_new:
                        add_default_backoff_path(to_st, ids[2:])
                    g.add_arc(from_st, to_st, bo_label, EPSILON, -(log_bo * self.lm_scale))
        # the highest order
        n = lm.order - 1
        for ids, (log_prob, _) in lm.entries[n].items():
            emit_prob_arc(n, ids, log_prob, highest=True)

        if add_sil:
            # sil and sp self-loops on every state (inputs #sil and #sp,
            # output epsilon); their labels follow #phi
            assert self.phi_label > 0
            for s in range(sm.num_states):
                g.add_arc(s, s, self.phi_label + 1, EPSILON, 0.0)
                g.add_arc(s, s, self.phi_label + 2, EPSILON, 0.0)
        g.set_start(sm.init_state)
        self._set_finals(g, sm, have_final)
        return g

    def _set_finals(self, g: Fst, sm: _NGramStateManager, have_final: bool) -> None:
        """Without a sentence end in the LM every state but the initial and
        the epsilon state is final (`WFSTGramGen.cpp:840-849`); else the
        sentence end's state, where the word has a pronunciation."""
        v = self.vocab
        if not have_final:
            for s in range(sm.num_states):
                if s not in (sm.eps_state, sm.init_state):
                    g.set_final(s, 0.0)
        elif v.sent_end_index >= 0 and v.get_num_pronuns(v.sent_end_index) > 0:
            g.set_final(sm.get_state((v.sent_end_index,)), 0.0)

    # -- word pair ---------------------------------------------------------

    def _build_wordpair(self) -> Fst:
        v = self.vocab
        wp = WordPairLM(self.lm_fname, v)
        g = Fst(LOG)
        sm = _NGramStateManager(v, g)
        have_final = False
        if v.sent_start_index >= 0 and v.get_num_pronuns(v.sent_start_index) > 0:
            lab = v.sent_start_index + 1
            g.add_arc(sm.init_state, sm.get_state((v.sent_start_index,)), lab, lab, 0.0)
        for i in range(v.n_words):
            sucs = wp.get_successors(i)
            if not sucs:
                continue
            log_prob = math.log(1.0 / len(sucs))
            for s in sucs:
                if s == v.sent_end_index:
                    if v.get_num_pronuns(v.sent_end_index) > 0:
                        lab = v.sent_end_index + 1
                        g.add_arc(sm.get_state((i,)), sm.get_state((v.sent_end_index,)), lab,
                                  lab, -(log_prob * self.lm_scale + self.word_ins_pen))
                    else:
                        g.finals[sm.get_state((i,))] = -(log_prob * self.lm_scale)
                    have_final = True
                else:
                    from_st = sm.get_state((i,))
                    to_st = sm.get_state((s,))
                    g.add_arc(from_st, to_st, s + 1, s + 1,
                              -(log_prob * self.lm_scale + self.word_ins_pen))
        g.set_start(sm.init_state)
        self._set_finals(g, sm, have_final)
        return g


def arpa_grammar(vocab: Vocabulary, lm_fname: str) -> Fst:
    """G of the ARPA file `lm_fname` over `vocab` at `GramGen`'s defaults
    (epsilon backoff labels, LM scale 1, no penalty, no `<unk>` word, no
    silence loops)."""
    return GramGen(vocab, GramType.NGRAM, lm_fname=lm_fname).build()
