"""Synthetic ASR task generation for tests, benchmarks, and dry runs.

A copy of `juicer_tpu/utils/synth.py` over the port's classes: the same
seed gives the same lexicon, models, network and features. It builds a full toy/midsize recognition setup without external data: random
lexicon over a phone inventory, word-loop grammar, monophone context
dependency, random diagonal-GMM HMMs, composed CLG, and feature synthesis
by sampling the generative model (so decodes have a known answer).

`make_models` is the port's copy of the JAX package's test helper
(`tests/test_decoder.py`), which `scale_bench` uses for its 6,000 GMMs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..am.mmf import MmfDef, MmfHmm, MmfMixture, MmfState, MmfTransMat
from ..am.models import AcousticModelSet
from ..compile import CDGen, CDPhoneLookup, CDType, GramGen, GramType, LexGen, build_clg
from ..decoder.artifact import DecoderArtifact
from ..decoder.network import DecoderNetwork
from ..lexicon import Lexicon, PhoneSet, Vocabulary


def make_models(n_hmms, n_emit=3, dim=4, n_comps=2, seed=0, tee_probs=None) -> AcousticModelSet:
    """`n_hmms` left-to-right HMMs of `n_emit` emitting states, each state a
    GMM of `n_comps` equal-weight diagonal components with standard-normal
    means and variances |N(0, 1)| + 0.5; self-loop and forward probability
    0.5, and with `tee_probs[h]` > 0 a tee from entry to exit. The random
    numbers are drawn in the JAX helper's order, so the same seed gives the
    same parameters."""
    rng = np.random.default_rng(seed)
    d = MmfDef()
    d.global_opts.vec_size = dim
    n = n_emit + 2
    for h in range(n_hmms):
        probs = np.zeros((n, n))
        probs[0, 1] = 1.0
        tee = tee_probs[h] if tee_probs else 0.0
        if tee > 0:
            probs[0, 1] = 1.0 - tee
            probs[0, n - 1] = tee
        for i in range(1, n - 1):
            probs[i, i] = 0.5
            probs[i, i + 1] = 0.5
        states = [
            MmfState(mixtures=[
                MmfMixture(1.0 / n_comps, rng.normal(size=dim),
                           np.abs(rng.normal(size=dim)) + 0.5)
                for _ in range(n_comps)
            ])
            for _ in range(n_emit)
        ]
        d.hmms.append(MmfHmm(f"hmm{h}", n, states, MmfTransMat(None, n, probs)))
    return AcousticModelSet.from_def(d)


@dataclass
class SynthTask:
    lexicon: Lexicon
    models: AcousticModelSet
    network: DecoderNetwork
    artifact: DecoderArtifact
    vec_size: int

    def synth_utterance(self, words: list[str], rng, frames_per_state: int = 3):
        """Sample features for a word sequence from the generative model."""
        lex = self.lexicon
        models = self.models
        frames = []
        for w in words:
            vi = lex.vocab.get_index(w)
            entry = lex.entries[lex.vocab_to_lex[vi][0]]
            for p in entry.phones:
                h = models.get_hmm_index(lex.phone_set[p])
                n = models.get_num_states(h)
                for j in range(1, n - 1):
                    g = int(models.hmm_gmm_inds[h][j - 1])
                    c = rng.integers(len(models.gmm_means[g]))
                    mu = models.gmm_means[g][c]
                    sd = np.sqrt(models.gmm_vars[g][c])
                    for _ in range(frames_per_state):
                        frames.append(mu + rng.normal(size=len(mu)) * sd * 0.5)
        return np.asarray(frames, dtype=np.float32)


def make_synth_task(
    n_words: int = 50,
    n_phones: int = 20,
    min_phones: int = 2,
    max_phones: int = 6,
    n_emit_states: int = 3,
    n_comps: int = 4,
    vec_size: int = 39,
    word_ins_pen: float = 0.0,
    seed: int = 0,
) -> SynthTask:
    rng = np.random.default_rng(seed)
    phones = [f"p{i}" for i in range(n_phones)]
    phone_set = PhoneSet(phones=phones)

    # random lexicon with unique pronunciations
    seen: set[tuple] = set()
    while len(seen) < n_words:
        n = rng.integers(min_phones, max_phones + 1)
        seen.add(tuple(rng.integers(0, n_phones, size=n).tolist()))
    vocab = Vocabulary()
    for wi in range(n_words):
        vocab.add_word(f"w{wi}")
    lex = Lexicon(phone_set, vocab)
    vocab.n_pronuns = [0] * vocab.n_words
    for wi, pron in enumerate(sorted(seen)):
        v = vocab.get_index(f"w{wi}")
        lex.add_entry(list(pron), 0.0, v)
        vocab.n_pronuns[v] += 1

    # random GMM models per phone
    d = MmfDef()
    d.global_opts.vec_size = vec_size
    n = n_emit_states + 2
    for name in phones:
        probs = np.zeros((n, n))
        probs[0, 1] = 1.0
        for i in range(1, n - 1):
            probs[i, i] = 0.5
            probs[i, i + 1] = 0.5
        center = rng.normal(scale=4.0, size=vec_size)
        states = [
            MmfState(
                mixtures=[
                    MmfMixture(
                        1.0 / n_comps,
                        center + rng.normal(scale=1.0, size=vec_size),
                        np.abs(rng.normal(size=vec_size)) * 0.5 + 0.5,
                    )
                    for _ in range(n_comps)
                ]
            )
            for _ in range(n_emit_states)
        ]
        d.hmms.append(MmfHmm(name, n, states, MmfTransMat(None, n, probs)))
    models = AcousticModelSet.from_def(d)

    # G: word loop; L; C: monophone
    G = GramGen(vocab, GramType.WORDLOOP, word_ins_pen=word_ins_pen).build()
    lexgen = LexGen(lex)
    L = lexgen.build(output_aux_phones=True)
    lookup = CDPhoneLookup(phone_set)
    lookup.add_phones(phones)
    lookup.bind_models(phones)
    C = CDGen(CDType.MONOPHONE, lookup, phones, n_aux_syms=lexgen.n_aux).build()
    clg = build_clg(G, L, C).clg
    network = DecoderNetwork(clg, clg.isyms, clg.osyms)
    artifact = DecoderArtifact(network, models)
    return SynthTask(lex, models, network, artifact, vec_size)
