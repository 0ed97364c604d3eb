"""The benchmark's CPU tests: `python -m pytest port_bench/tests -q` from
the repository's root (`-m gpu` for the card test, on a machine with a
card). They import the benchmark's `pb` package and its metric readers
from `port_bench/`."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

# a mix small enough for the program's plain version on the CPU
TINY = {"batch": 2, "pool": 4, "frames_per_state": 3, "loop": "closed", "clients": 1,
        "corpus_seed": 5,
        "lengths": {"dist": "lognormal", "mean": 82, "sigma": 0.3, "min": 50, "max": 120}}
CELL = "wsj20k.read-b16"

# a tiny cross-word triphone task: three phones, sil and a one-state sp
# with a tee; two-phone words (no word's phones are another word's, so a
# sentence's phones spell its words one way), one ending in sp
TRI_PHONES = ("a", "b", "c")
TRI_PRONS = {"w0": "a b", "w1": "b a", "w2": "c c", "w3": "a c sp", "w4": "b c", "w5": "c a"}
TRI_MIX = dict(TINY, pool=6, corpus_seed=2**31 + 7)


def tri_physical(logical: str) -> str:
    """The tied list's rule: a triphone after sil is tied to the one after
    the first phone; every other name is its own physical model."""
    if logical.startswith("sil-"):
        return TRI_PHONES[0] + logical[3:]
    return logical


def tri_logical_names() -> list:
    ctx = TRI_PHONES + ("sil",)
    return [f"{l}-{p}+{r}" for p in TRI_PHONES for l in ctx for r in ctx]


def write_tri_task(td, tied=True, tied_lines=None, hmm_names=None):
    """The tiny task's files in `td`: phones.lst, lex.dict, lm.arpa and
    bigram.npz (one full bigram, random from a fixed seed), models.npz (D = 5, two
    components a state), and with `tied` the tied list tied.lst: one line
    of one name for each physical model, one of two for each tied name.
    Untied, every logical name is an HMM of its own. `tied_lines` and
    `hmm_names` replace the list's lines and the models' names."""
    import numpy as np

    td = str(td)
    os.makedirs(td, exist_ok=True)
    rng = np.random.default_rng(3)
    logical = tri_logical_names()
    if hmm_names is None:
        names = logical if not tied else sorted({tri_physical(n) for n in logical})
        hmm_names = list(names) + ["sil", "sp"]
    if tied:
        if tied_lines is None:
            tied_lines = ["sil", "sp"] + [n if tri_physical(n) == n else f"{n} {tri_physical(n)}"
                                          for n in logical]
        with open(os.path.join(td, "tied.lst"), "w") as fd:
            fd.write("\n".join(tied_lines) + "\n")
    with open(os.path.join(td, "phones.lst"), "w") as fd:
        fd.write("\n".join(TRI_PHONES + ("sil", "sp")) + "\n")
    with open(os.path.join(td, "lex.dict"), "w") as fd:
        for w, pron in TRI_PRONS.items():
            fd.write(f"{w} {pron}\n")
        fd.write("<s> sil\n</s> sil\n")
    # the bigram: every word after <s> and after every word, </s> after every word
    n = len(TRI_PRONS)
    bigram, arpa = {}, []
    for w in range(n + 1):
        ids = np.arange(n) if w == n else np.arange(n + 2)[np.arange(n + 2) != n]
        p = rng.dirichlet(np.full(len(ids), 4.0))
        bigram[f"ids_{w}"], bigram[f"logp_{w}"] = ids, np.log10(p)
        name = "<s>" if w == n else f"w{w}"
        arpa += [f"{lp:.6f} {name} {'</s>' if i == n + 1 else f'w{i}'}"
                 for i, lp in zip(ids, np.log10(p))]
    np.savez(os.path.join(td, "bigram.npz"), **bigram)
    uni = ["-99 <s> 0", f"{np.log10(1 / (n + 1)):.6f} </s>"] + [
        f"{np.log10(1 / (n + 1)):.6f} w{w} 0" for w in range(n)]
    with open(os.path.join(td, "lm.arpa"), "w") as fd:
        fd.write(f"\\data\\\nngram 1={len(uni)}\nngram 2={len(arpa)}\n\n\\1-grams:\n"
                 + "\n".join(uni) + "\n\n\\2-grams:\n" + "\n".join(arpa) + "\n\n\\end\\\n")
    # models: 3 emitting states a phone and for sil, sp one with a tee
    D, C = 5, 2
    three = np.full((5, 5), -1e30)
    three[0, 1] = 0.0
    for i in (1, 2, 3):
        three[i, i], three[i, i + 1] = np.log(0.6), np.log(0.4)
    one = np.full((3, 3), -1e30)
    one[0, 1], one[0, 2], one[1, 1], one[1, 2] = np.log(0.3), np.log(0.7), np.log(0.6), np.log(0.4)
    gi, g = [], 0
    for h in hmm_names:
        k = 1 if h == "sp" else 3
        gi.append(np.arange(g, g + k, dtype=np.int32))
        g += k
    np.savez(os.path.join(td, "models.npz"), vec_size=D, hybrid=False, log_priors=np.zeros(0),
             hmm_names=np.asarray(hmm_names),
             hmm_trans_ind=np.asarray([int(h == "sp") for h in hmm_names], np.int32),
             n_trans=2, tm_0=three, tm_1=one, n_gmms=g,
             **{f"gm_{i}": rng.normal(0.0, 3.0, (C, D)) for i in range(g)},
             **{f"gv_{i}": rng.uniform(0.5, 1.5, (C, D)) for i in range(g)},
             **{f"gw_{i}": np.full(C, np.log(1 / C)) for i in range(g)},
             **{f"gi_{h}": x for h, x in enumerate(gi)})
    return td


def build_tri_clg(td, context):
    """clg.npz of the tiny task, built by the program's toolchain with the
    cross-word triphone C of `context` over the task's tied list."""
    from juicer_tpu_torch.am.models import AcousticModelSet
    from juicer_tpu_torch.compile import (CDGen, CDPhoneLookup, CDType, GramGen, GramType,
                                          LexGen, build_clg)
    from juicer_tpu_torch.decoder.network import DecoderNetwork
    from juicer_tpu_torch.harness.wsj_task import task_lexicon

    lexicon = task_lexicon(td)
    names = AcousticModelSet.load_npz(os.path.join(td, "models.npz")).hmm_names
    G = GramGen(lexicon.vocab, GramType.NGRAM, lm_fname=os.path.join(td, "lm.arpa")).build()
    lexgen = LexGen(lexicon)
    L = lexgen.build(output_aux_phones=True)
    lookup = CDPhoneLookup(lexicon.phone_set)
    lookup.add_tied_list(os.path.join(td, "tied.lst"))
    lookup.bind_models(names)
    lookup.verify_all_models()
    C = CDGen(CDType(context), lookup, names, n_aux_syms=lexgen.n_aux).build()
    clg = build_clg(G, L, C).clg
    DecoderNetwork(clg, clg.isyms, clg.osyms).save_npz(os.path.join(td, "clg.npz"))


def bench_copy(root):
    """A checkout at `root` with a copy of the benchmark (BENCHMARK.json and
    port_bench/) and links to the program and the tasks, plus the
    configuration `wsj2k` (the 20k configuration on the tracked 2k task,
    small enough for the CPU) and its tiny cell `wsj2k.tiny`, added as new
    files and entries only: 4 short utterances in waves of 2, all of them
    compared, under the 20k cell's limits; and the tiny triphone task
    (`tasks/tri/`, its CLG built with the "xwrdtri" C), its configuration
    `tri` and its cell `tri.tiny`: 6 short utterances (`tri-tiny`), all of
    them compared."""
    root = str(root)
    shutil.copytree(BENCH, os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("scripts", "juicer_tpu_torch", "native"):
        os.symlink(os.path.join(REPO, name), os.path.join(root, name))
    with open(os.path.join(BENCH, "configs", "wsj20k.json")) as fd:
        config = json.load(fd)
    config["task_dir"] = "scripts/_wsj_cache_2k"
    with open(os.path.join(root, "port_bench", "configs", "wsj2k.json"), "w") as fd:
        json.dump(config, fd)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fd:
        spec = json.load(fd)
    spec["configs"].append({"name": "wsj2k", "source": "the tracked 2k task",
                            "file": "port_bench/configs/wsj2k.json", "reduced": [],
                            "why": "a CPU rehearsal"})
    spec["workloads"].append({"name": "wsj2k.tiny", "config": "wsj2k", "traffic": "tiny",
                              "chips": 1, "why": "a CPU rehearsal of the 2k cell"})
    with open(os.path.join(root, "port_bench", "traffic", "tiny.json"), "w") as fd:
        json.dump(TINY, fd)
    with open(os.path.join(BENCH, "cells", f"{CELL}.json")) as fd:
        cell = json.load(fd)
    cell["sample"] = 4  # every utterance of the pool
    with open(os.path.join(root, "port_bench", "cells", "wsj2k.tiny.json"), "w") as fd:
        json.dump(cell, fd)
    with open(os.path.join(root, "port_bench", "traffic", "tri-tiny.json"), "w") as fd:
        json.dump(TRI_MIX, fd)
    build_tri_clg(write_tri_task(os.path.join(root, "tasks", "tri")), "xwrdtri")
    tri = dict(config, task_dir="tasks/tri",
               network={"words": len(TRI_PRONS), "lm": "bigram", "context": "xwrdtri"})
    with open(os.path.join(root, "port_bench", "configs", "tri.json"), "w") as fd:
        json.dump(tri, fd)
    spec["configs"].append({"name": "tri", "source": "a tiny cross-word triphone task",
                            "file": "port_bench/configs/tri.json", "reduced": [],
                            "why": "a CPU rehearsal"})
    spec["workloads"].append({"name": "tri.tiny", "config": "tri", "traffic": "tri-tiny",
                              "chips": 1, "why": "a CPU rehearsal of a triphone cell"})
    with open(os.path.join(root, "port_bench", "cells", "tri.tiny.json"), "w") as fd:
        json.dump(dict(cell, sample=TRI_MIX["pool"]), fd)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fd:
        json.dump(spec, fd)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("checkout"))
