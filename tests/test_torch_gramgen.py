"""The port's grammar generator against the JAX package's.

A toy lexicon (a, cat, dog, the sentence marks; one variant with a
silence word), a trigram ARPA LM with `<unk>` (dog is not in it), the
same LM gzipped, and a BBN word-pair file go through
`juicer_tpu.compile.gram.GramGen` and the port's
`juicer_tpu_torch.compile.gram.GramGen` with the same options:

  - every `GramType` (word loop, sil-wordloop-sil, NGRAM, word pair) and
    the NGRAM options at non-default values (`add_sil`, `#phi` backoff
    labels, `normalise`, `<unk>`, the LM scale, the insertion penalty,
    gzip input, the npz cache written by one package and read by the
    other): the Fst state for state and arc for arc, weights exactly,
    and both symbol tables;
  - `arpa_grammar` is `GramGen(NGRAM)` at its defaults, on the 2k task;
  - the CLIs `jtpu-gramgen` and `jtpu-gramgen-torch`: the three files
    byte for byte and stdout (with `-genTestSeqs`) equal, for each type
    and option;
  - the errors: a word missing from the LM without `-unkWord`, a
    silence word in the LM, sil-wordloop-sil with a silence word.
"""

import gzip
import os

import numpy as np
import pytest

from juicer_tpu.cli import gramgen as jax_gramgen
from juicer_tpu.compile.gram import GramGen as JaxGramGen
from juicer_tpu.compile.gram import GramType as JaxGramType
from juicer_tpu.lexicon import Vocabulary as JaxVocabulary
from juicer_tpu.lm import ArpaLM as JaxArpaLM

from juicer_tpu_torch.cli import gramgen
from juicer_tpu_torch.compile import GramGen, GramType, arpa_grammar
from juicer_tpu_torch.harness import wsj_task
from juicer_tpu_torch.lexicon import Lexicon, Vocabulary
from juicer_tpu_torch.lm import ArpaLM

LEX = "a ah\ncat k ae t\ndog d ao g\n<s> sil\n</s> sil\n"
LEX_SIL = LEX + "sil sil\n"
LEX_NO_MARKS_PRON = "a ah\ncat k ae t\ndog d ao g\n"
LM = """\\data\\
ngram 1=5
ngram 2=4
ngram 3=2

\\1-grams:
-0.60206 </s>
-99 <s> -0.30103
-0.47712 a -0.30103
-0.60206 cat -0.30103
-1.0 <unk> -0.2

\\2-grams:
-0.30103 <s> a -0.1
-0.47712 a cat -0.2
-0.30103 cat </s>
-0.5 a <unk>

\\3-grams:
-0.2 <s> a cat
-0.3 a cat </s>

\\end\\
"""
WORDPAIR = """/* a BBN word-pair grammar
   with a comment block */
><s>
a cat
>a
cat dog
</s>
>cat
a </s>
>dog
</s>
"""
MARKS = ["-sentStartWord", "<s>", "-sentEndWord", "</s>"]
# name -> (lexicon, gramgen flags)
CASES = {
    "wordloop_sil_penalty": ("lex_sil", ["-gramType", "wordloop", "-silWord", "sil",
                                         "-wordInsPen", "-0.5"]),
    "wordloop_no_marks": ("lex_plain", ["-gramType", "wordloop"]),
    "silwordloopsil": ("lex", MARKS + ["-gramType", "silwordloopsil", "-wordInsPen", "0.25"]),
    "ngram_unk": ("lex", MARKS + ["-gramType", "ngram", "-lmFName", "{LM}", "-unkWord",
                                  "<unk>"]),
    "ngram_phi_sil_scaled": ("lex", MARKS + ["-gramType", "ngram", "-lmFName", "{LM}",
                                             "-unkWord", "<unk>", "-phiBackoff",
                                             "-addSilenceArcs", "-lmScaleFactor", "0.7",
                                             "-wordInsPen", "-0.5"]),
    "ngram_normalise_gzip": ("lex", MARKS + ["-gramType", "ngram", "-lmFName", "{LMGZ}",
                                             "-unkWord", "<unk>", "-normalise"]),
    "ngram_marks_without_pron": ("lex_plain", MARKS + ["-gramType", "ngram", "-lmFName",
                                                       "{LM}", "-unkWord", "<unk>"]),
    "wordpair_scaled": ("lex", MARKS + ["-gramType", "wordpair", "-lmFName", "{WP}",
                                        "-lmScaleFactor", "1.5", "-wordInsPen", "0.3"]),
    "wordpair_marks_without_pron": ("lex_plain", MARKS + ["-gramType", "wordpair",
                                                          "-lmFName", "{WP}"]),
}


@pytest.fixture
def files(tmp_path):
    for name, text in (("lex", LEX), ("lex_sil", LEX_SIL), ("lex_plain", LEX_NO_MARKS_PRON),
                       ("lm.arpa", LM), ("wp.txt", WORDPAIR)):
        (tmp_path / name).write_text(text)
    with gzip.open(tmp_path / "lm.arpa.gz", "wt") as fd:
        fd.write(LM)
    return tmp_path


def _argv(files, case, out):
    lex, flags = CASES[case]
    subs = {"{LM}": str(files / "lm.arpa"), "{LMGZ}": str(files / "lm.arpa.gz"),
            "{WP}": str(files / "wp.txt")}
    return (["-lexFName", str(files / lex)] + [subs.get(f, f) for f in flags]
            + ["-fsmFName", str(out / "g.fsm"), "-inSymsFName", str(out / "g.insyms"),
               "-outSymsFName", str(out / "g.outsyms")])


def _gens(files, case):
    """Both packages' GramGen for a case, with the build options."""
    argv = _argv(files, case, files)
    a = jax_gramgen.make_parser().parse_args(argv)
    vocabs = [cls(a.lexFName, "!", a.sentStartWord, a.sentEndWord, a.silWord)
              for cls in (JaxVocabulary, Vocabulary)]
    kw = dict(lm_scale=a.lmScaleFactor, word_ins_pen=a.wordInsPen, lm_fname=a.lmFName,
              unk_word=a.unkWord)
    build = dict(add_sil=a.addSilenceArcs, phi_bo_trans=a.phiBackoff, normalise=a.normalise)
    return (JaxGramGen(vocabs[0], JaxGramType(a.gramType), **kw),
            GramGen(vocabs[1], GramType(a.gramType), **kw), build)


def assert_same_fst(got, want):
    assert (got.num_states, got.start, got.finals) == (want.num_states, want.start, want.finals)
    for k in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight"):
        assert list(getattr(got, k)) == list(getattr(want, k)), k


def assert_same_symbols(got, want):
    assert list(got) == list(want)


@pytest.mark.parametrize("case", list(CASES))
def test_grammar_equals_jax_arc_for_arc(files, case):
    jgen, gen, build = _gens(files, case)
    want, got = jgen.build(**build), gen.build(**build)
    assert_same_fst(got, want)
    assert_same_symbols(got.isyms, want.isyms)
    assert_same_symbols(got.osyms, want.osyms)
    assert got.num_arcs > 0


@pytest.mark.parametrize("case", list(CASES))
def test_gramgen_cli_files_equal_jax_byte_for_byte(files, tmp_path_factory, case, capsys):
    outs = {}
    for name, main in (("jax", jax_gramgen.main), ("port", gramgen.main)):
        out = tmp_path_factory.mktemp(name)
        assert main(_argv(files, case, out) + ["-genTestSeqs"]) == 0
        stdout = capsys.readouterr().out.replace(str(out), "OUT")
        outs[name] = ([(out / f).read_bytes() for f in ("g.fsm", "g.insyms", "g.outsyms")],
                      stdout)
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][1].splitlines()) == 11


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lm_cache_is_read_by_both_packages(files, writer):
    """-writeBinaryFiles: one package caches the parsed LM as lm.arpa.npz;
    the ARPA file is then overwritten with garbage (dated before the
    cache), so the other package builds G only if it reads the cache."""
    case = "ngram_phi_sil_scaled"
    want = _gens(files, case)[0].build(**_gens(files, case)[2])
    argv = _argv(files, case, files) + ["-writeBinaryFiles"]
    (jax_gramgen if writer == "jax" else gramgen).main(argv)
    cache = files / "lm.arpa.npz"
    assert cache.exists()
    (files / "lm.arpa").write_text("garbage\n")
    st = os.stat(cache)
    os.utime(files / "lm.arpa", (st.st_atime - 10, st.st_mtime - 10))
    jgen, gen, build = _gens(files, case)
    assert_same_fst((gen if writer == "jax" else jgen).build(**build), want)


def test_arpa_lm_normalise_and_queries_equal_jax(files):
    jv = JaxVocabulary(str(files / "lex"), "!", "<s>", "</s>")
    v = Vocabulary(str(files / "lex"), "!", "<s>", "</s>")
    want, got = JaxArpaLM(str(files / "lm.arpa"), jv, "<unk>"), ArpaLM(str(files / "lm.arpa"),
                                                                          v, "<unk>")
    assert (got.order, got.unk_id, got.unk_words) == (want.order, want.unk_id, want.unk_words)
    for norm in (False, True):
        if norm:
            got.normalise()
            want.normalise()
        assert got.entries == want.entries
        for n in range(1, got.order + 1):
            assert got.n_ngrams(n) == want.n_ngrams(n)
        for ids in [(0,), (1, 0), (4, 1, 0), (3, 1, 2), (1, 5), (2, 2)]:
            assert got.score(ids) == want.score(ids)
            assert got.get(ids) == want.get(ids)


@pytest.mark.parametrize("what", ["missing_word", "silence_word", "silwordloopsil_sil"])
def test_errors_equal_jax(files, what):
    if what == "missing_word":  # dog is not in the LM and there is no <unk>
        kw, lex, t, sil = dict(lm_fname=str(files / "lm.arpa")), "lex", "NGRAM", None
    elif what == "silence_word":
        (files / "lex_sil").write_text(LEX_SIL + "<unk> sil\n")
        kw, lex, t, sil = dict(lm_fname=str(files / "lm.arpa")), "lex_sil", "NGRAM", "<unk>"
    else:
        kw, lex, t, sil = {}, "lex_sil", "SIL_WORDLOOP_SIL", "sil"
    errs = []
    for V, G, T in ((JaxVocabulary, JaxGramGen, JaxGramType), (Vocabulary, GramGen, GramType)):
        with pytest.raises(ValueError) as e:
            G(V(str(files / lex), "!", "<s>", "</s>", sil), T[t], **kw).build()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_arpa_grammar_is_gramgen_at_its_defaults():
    cache = wsj_task.task_dir("2k")
    vocab = Lexicon.load(f"{cache}/phones.lst", f"{cache}/lex.dict", sent_start_word="<s>",
                         sent_end_word="</s>", spec_word_char="").vocab
    lm = f"{cache}/lm.arpa"
    got = arpa_grammar(vocab, lm)
    assert_same_fst(got, GramGen(vocab, GramType.NGRAM, lm_fname=lm).build())
    assert (got.num_states, got.num_arcs) == (2004, 123026)
    # with #phi labels the backoff arcs change label only
    phi = GramGen(vocab, GramType.NGRAM, lm_fname=lm).build(phi_bo_trans=True)
    il = np.array(phi.arc_ilabel)
    assert np.array_equal(np.where(il == vocab.n_words + 1, 0, il), got.arc_ilabel)
