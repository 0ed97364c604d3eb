"""The host FST pipeline (compose, determinize, minimize) timed at growing
lexicon and LM sizes: the practical scale bound of the toolchain.

The counterpart of the JAX package's `scripts/pipeline_scale.py`, over
the port's `compile.GramGen` / `LexGen` and `fst/algos.py` (determinize
through the native library). The reference offloads these stages to
OpenFst / AT&T (`bin/build-wfst-openfst:99-180`); the WSJ L o G is 2.85M
arcs. For each size `synth_task` writes a random lexicon over 40 phones
and a bigram ARPA (n_words unigrams and 3 x n_words random bigrams), with
Python's `random.Random(seed)` drawn in the JAX script's order, so
`lex.dict`, `phones.lst` and `lm.arpa` are byte for byte the JAX ones.
Then G and L are built and the LG sequence of `compile/pipeline.py`
(`build_clg`) runs stage by stage, each stage's seconds printed, and a
summary line gives every machine's arcs and the stage times.

This is host code: no kernel, no device.

Run as

    python -m juicer_tpu_torch.harness.pipeline_scale [n_words ...]

(default 200 1000 5000).
"""

from __future__ import annotations

import os
import random
import sys
import tempfile
import time

from ..compile import GramGen, GramType, LexGen
from ..fst import algos
from ..lexicon import Lexicon

PHONES = [f"p{i}" for i in range(40)] + ["sil"]


def synth_task(tmp, n_words, seed=0):
    """Write `lex.dict`, `phones.lst` and `lm.arpa` of a random task into
    `tmp`. Returns (lexicon, the ARPA file's path)."""
    rng = random.Random(seed)
    lex_lines = []
    for w in range(n_words):
        pron = " ".join(rng.choice(PHONES[:-1])
                        for _ in range(rng.randint(2, 8)))
        lex_lines.append(f"w{w} {pron}")
    lexf = os.path.join(tmp, "lex.dict")
    phf = os.path.join(tmp, "phones.lst")
    with open(lexf, "w") as f:
        f.write("\n".join(lex_lines) + "\n")
    with open(phf, "w") as f:
        f.write("\n".join(PHONES) + "\n")
    lex = Lexicon.load(phf, lexf, sil_phone="sil")
    # bigram ARPA with n_words unigrams + 3x random bigrams
    lmf = os.path.join(tmp, "lm.arpa")
    bigrams = set()
    while len(bigrams) < 3 * n_words:
        bigrams.add((rng.randrange(n_words), rng.randrange(n_words)))
    with open(lmf, "w") as f:
        f.write(f"\\data\\\nngram 1={n_words}\nngram 2={len(bigrams)}\n\n")
        f.write("\\1-grams:\n")
        for w in range(n_words):
            f.write(f"-{1 + rng.random():.4f} w{w} -0.30103\n")
        f.write("\n\\2-grams:\n")
        for a, b in sorted(bigrams):
            f.write(f"-{rng.random():.4f} w{a} w{b}\n")
        f.write("\n\\end\\\n")
    return lex, lmf


def run_size(tmp, n_words) -> dict:
    """The pipeline of one size in directory `tmp`, each stage printed.
    Returns {"machines": {name: Fst}, "seconds": {stage: s}}."""
    lex, lmf = synth_task(tmp, n_words)
    seconds = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        r = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"  [{n_words}] {name}: {seconds[name]:.1f}s", flush=True)
        return r

    G, L = stage("build G+L", lambda: (
        GramGen(lex.vocab, GramType.NGRAM, lm_fname=lmf).build(),
        LexGen(lex).build(output_aux_phones=True)))
    # the LG sequence of compile/pipeline.py build_clg
    lg = stage("detG+closeL+compose", lambda: algos.compose(
        algos.closure(algos.arcsort(L)), algos.determinize(algos.arcsort(G))))
    lg2 = stage("epsnormalize", lambda: algos.epsnormalize_input(lg))
    det = stage("determinize", lambda: algos.determinize(lg2))
    mini = stage("minimize", lambda: algos.minimize(det))
    machines = dict(L=L, G=G, LG=lg, epsnorm=lg2, det=det, min=mini)
    print(f"n_words={n_words}: L={L.num_arcs} G={G.num_arcs} LG={lg.num_arcs} "
          f"det={det.num_arcs} min={mini.num_arcs} arcs | build {seconds['build G+L']:.1f}s "
          f"compose {seconds['detG+closeL+compose']:.1f}s epsnorm+determinize "
          f"{seconds['epsnormalize'] + seconds['determinize']:.1f}s minimize "
          f"{seconds['minimize']:.1f}s", flush=True)
    return {"machines": machines, "seconds": seconds}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for n_words in [int(a) for a in argv] or [200, 1000, 5000]:
        with tempfile.TemporaryDirectory() as tmp:
            run_size(tmp, n_words)
    return 0


if __name__ == "__main__":
    sys.exit(main())
