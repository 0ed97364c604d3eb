"""The traffic's context dependency on a tiny cross-word triphone task
(`conftest.write_tri_task`): each phone is drawn from the model that the
cross-word C assigns it, the generator and the C agree end to end, and no
lookup falls back silently."""

import os
import re
import time

import numpy as np
import pytest

from pb import cell as cell_run, check, spec, traffic
from pb.task import Lexicon, Models, Network

from conftest import tri_logical_names, tri_physical, write_tri_task

# words: "a b", "b a", "c c", "a c sp", "b c", "c a"
WORDS = [3, 4, 0]
# sil a c sp b c a b sil, by hand: sp is transparent, sil a context at both
# ends; sil-a+c is tied to a-a+c
LOGICAL = ["sil", "sil-a+c", "a-c+b", "sp", "c-b+c", "b-c+a", "c-a+b", "a-b+sil", "sil"]


def sentences(td, context):
    return traffic.Sentences(str(td), Models(os.path.join(td, "models.npz")), Lexicon(td),
                             context)


def gmms_of(td, names):
    models = Models(os.path.join(td, "models.npz"))
    return np.concatenate([models.hmm_gmms[models.hmm_index[n]] for n in names])


@pytest.mark.parametrize("context", ["xwrdtri", "xwrdtrindi"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_state_sequence_is_the_cross_word_triphones(tmp_path, context, tied):
    td = write_tri_task(tmp_path, tied=tied)
    s = sentences(td, context)
    physical = [tri_physical(n) for n in LOGICAL] if tied else LOGICAL
    if tied:
        assert physical[1] == "a-a+c" and "sil-a+c" not in s.models.hmm_index
    assert traffic.cross_word_names(["sil", "a", "c", "sp", "b", "c", "a", "b", "sil"]) == LOGICAL
    assert np.array_equal(s.state_gmms(WORDS), gmms_of(td, physical))
    # each phone's emitting states, sp's one among them
    assert s.frames(WORDS, 3) == 3 * (3 * 8 + 1)


def test_sil_inside_an_utterance_is_a_context():
    assert traffic.cross_word_names(["sil", "a", "sil", "sp", "b", "sil"]) == [
        "sil", "sil-a+sil", "sil", "sp", "sil-b+sil", "sil"]


@pytest.mark.parametrize("case", ["context", "monophone", "logical", "physical", "untied",
                                  "edge"])
def test_a_missing_model_raises_with_its_name(tmp_path, case):
    culprit = {"context": "triphone", "monophone": "'a'", "logical": "'c-b+c'",
               "physical": "'zz'", "untied": "'c-b+c'", "edge": "'a'"}[case]
    if case == "logical":
        lines = ["sil", "sp"] + [n for n in tri_logical_names() if n != "c-b+c"]
        td = write_tri_task(tmp_path, tied_lines=lines, hmm_names=tri_logical_names()
                            + ["sil", "sp"])
    elif case == "physical":
        td = write_tri_task(tmp_path)
        with open(os.path.join(td, "tied.lst")) as fd:
            lines = fd.read().replace("\nc-b+c\n", "\nc-b+c zz\n")
        with open(os.path.join(td, "tied.lst"), "w") as fd:
            fd.write(lines)
    elif case == "untied":
        td = write_tri_task(tmp_path, tied=False,
                            hmm_names=[n for n in tri_logical_names() if n != "c-b+c"]
                            + ["sil", "sp"])
    else:
        td = write_tri_task(tmp_path)
    with pytest.raises(ValueError, match=re.escape(culprit)):
        if case == "context":
            sentences(td, "triphone")
        elif case == "edge":
            traffic.cross_word_names(["a", "b", "sil"])
        else:
            sentences(td, "monophone" if case == "monophone" else "xwrdtri").state_gmms(WORDS)


@pytest.fixture(scope="module")
def tri(tiny_root):
    return spec.load_cell("tri.tiny", False, repo=tiny_root,
                          bench=os.path.join(tiny_root, "port_bench"))


def test_triphone_cell_is_correct_and_the_reference_reads_every_transcript(tri):
    """The generator and the toolchain's C agree: the reference decodes each
    pool utterance, drawn from its triphones, to its transcript over the
    CLG built with that C, and a whole CPU run of the cell is correct."""
    cfg = tri.config
    td = os.path.join(tri.repo, cfg["task_dir"])
    models, lex = Models(os.path.join(td, "models.npz")), Lexicon(td)
    pool = traffic.make_pool(td, models, lex, tri.mix, cfg["network"]["context"])
    used = set()
    sents = traffic.Sentences(td, models, lex, "xwrdtri")
    for ws in pool.words:
        used.update(models.hmm_names[h] for h in sents.hmms(ws))
    # the pool holds the sp word and a model that a tie stands for
    assert any(3 in ws for ws in pool.words) and "sp" in used
    assert used & {tri_physical(n) for n in tri_logical_names() if n.startswith("sil-")}
    refs = check.reference_answers(range(len(pool)), pool.feats, models,
                                   Network(os.path.join(td, "clg.npz")), cfg["point"])
    for u, ws in enumerate(pool.words):
        got = [w for w in refs[u][1].words if w not in lex.markers]
        assert got == [lex.labels[w] for w in ws], u
    out = cell_run.run(tri, 2**31 + 5, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0
