"""The grammar transducer G of an ARPA n-gram LM.

A reduced copy of the NGRAM grammar of `juicer_tpu/compile/gram.py`
(`_NGramStateManager`, `GramGen._build_arpa`), itself the rebuild of the
reference's `WFSTGramGen::writeFSMARPA`: one state per n-gram context,
managed as a word trie; an epsilon backoff arc per context; missing
contexts completed by default backoff paths (`addDefaultBackoffPath`). States are
numbered and arcs added in the JAX build's order, so state ids, and with
them the decoder's (arc, G state) keys, are the JAX package's.

Output word label i+1 is vocabulary index i (label 0 is epsilon).
Weights are costs: -log_prob, as the JAX build gives them at its defaults
(LM scale 1, no word insertion penalty, no `<unk>` word). Those three
options, word loops, word pairs, the sil/sp self-loops (`add_sil`) and
`#phi` backoff labels are not copied: the on-the-fly decode path sets or
builds none of them.
"""

from __future__ import annotations

from ..fst import EPSILON, LOG, Fst
from ..lexicon import Vocabulary
from ..lm import ArpaLM

LOG_ZERO = -1e30


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


def arpa_grammar(vocab: Vocabulary, lm_fname: str) -> Fst:
    """G of the ARPA file `lm_fname` over `vocab`, as `GramGen(vocab,
    GramType.NGRAM, lm_fname=lm_fname).build()` builds it (epsilon backoff
    labels, no silence loops)."""
    v = vocab
    lm = ArpaLM(lm_fname, v)
    g = Fst(LOG)
    sm = _NGramStateManager(v, g)
    have_final = False

    if v.sent_start_index >= 0 and v.get_num_pronuns(v.sent_start_index) > 0:
        lab = v.sent_start_index + 1
        g.add_arc(sm.init_state, sm.get_state((v.sent_start_index,)), lab, lab, 0.0)

    def add_default_backoff_path(from_st: int, to_words: tuple[int, ...]) -> None:
        # from context (w1..wk): an epsilon arc to (w2..wk), the chain made
        # recursively for contexts that do not exist yet
        is_new = not sm.has_state(to_words)
        to_st = sm.get_state(to_words)
        g.add_arc(from_st, to_st, EPSILON, EPSILON, 0.0)
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
                g.add_arc(from_st, to_st, lab, lab, -log_prob)
            else:
                g.finals[sm.get_state(ids[:-1] if n > 0 else ())] = -log_prob
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
        g.add_arc(from_st, to_st, last + 1, last + 1, -log_prob)

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
                g.add_arc(from_st, to_st, EPSILON, EPSILON, -log_bo)
    # the highest order
    n = lm.order - 1
    for ids, (log_prob, _) in lm.entries[n].items():
        emit_prob_arc(n, ids, log_prob, highest=True)

    g.set_start(sm.init_state)
    if not have_final:
        # every state final but the initial and the epsilon state
        for s in range(g.num_states):
            if s not in (sm.eps_state, sm.init_state):
                g.set_final(s, 0.0)
    elif v.sent_end_index >= 0 and v.get_num_pronuns(v.sent_end_index) > 0:
        g.set_final(sm.get_state((v.sent_end_index,)), 0.0)
    return g
