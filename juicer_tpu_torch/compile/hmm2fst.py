"""HMM-level transducer (H) generation.

A copy of `juicer_tpu/compile/hmm2fst.py`, the rebuild of `WFSTHMMGen`
(`WFSTHMMGen.cpp:58-180`): one FSM fragment per HMM between a global initial state (0) and final state (1).
The entry arc carries eps input / HMM-name output; within the fragment each
transition with probability > 0 becomes an arc with input label = the target
emitting state's shared-state (GMM) index + 1, output eps, and weight
-log(p). Requires all emitting states be shared (~s macros).
"""

from __future__ import annotations

import math

from ..fst import EPSILON, Fst, LOG, SymbolTable
from ..fst.fst import EPSILON_STR
from ..am.mmf import MmfDef


class HmmGen:
    def __init__(self, mmf: MmfDef):
        self.mmf = mmf
        for h in mmf.hmms:
            for s in h.states:
                if not isinstance(s, str):
                    raise ValueError(
                        f"WFSTHMMGen requires all emitting states shared (~s); "
                        f"HMM {h.name} has an inline state"
                    )
        self.state_names = list(mmf.sh_states.keys())
        self._state_index = {n: i for i, n in enumerate(self.state_names)}

    def build(self) -> Fst:
        f = Fst(LOG)
        init = f.add_state()
        final = f.add_state()
        f.set_start(init)
        f.set_final(final, 0.0)
        for h_ind, hmm in enumerate(self.mmf.hmms):
            tm = self.mmf.resolve_transmat(hmm.transmat)
            entry = f.add_states(hmm.n_states)
            f.add_arc(init, entry, EPSILON, h_ind + 1, 0.0)
            for i in range(hmm.n_states):
                for j in range(hmm.n_states):
                    p = tm.probs[i][j]
                    if p <= 0.0:
                        continue
                    label = EPSILON
                    if j != 0 and j != hmm.n_states - 1:
                        label = self._state_index[hmm.states[j - 1]] + 1
                    f.add_arc(entry + i, entry + j, label, EPSILON, -math.log(p))
            f.add_arc(entry + hmm.n_states - 1, final, EPSILON, EPSILON, 0.0)
        f.isyms = self.input_symbols()
        f.osyms = self.output_symbols()
        return f

    def input_symbols(self) -> SymbolTable:
        t = SymbolTable()
        t.add_with_index(EPSILON_STR, EPSILON)
        for i, n in enumerate(self.state_names):
            t.add_with_index(n, i + 1)
        return t

    def output_symbols(self) -> SymbolTable:
        t = SymbolTable()
        t.add_with_index(EPSILON_STR, EPSILON)
        for i, h in enumerate(self.mmf.hmms):
            t.add_with_index(h.name, i + 1)
        return t
