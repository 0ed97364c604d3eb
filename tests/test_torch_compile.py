"""The port's offline WFST toolchain against the JAX package's, on the CPU.

The same resources go through both packages' generators: the lexicon and
phone list (`Lexicon`, `PhoneSet`, `Vocabulary.add_word`), L (`LexGen`,
every pronunciation option), C (`CDGen`: monophone, monophone-ann and
both cross-word triphone types, tied lists, aux loops), H (`HmmGen`), the
CLG pipeline (`build_clg` default, `optimize_final`, `remove_aux` off;
`aux_to_eps`) and `untie_models`. Every machine must be equal state for
state and arc for arc, weights exactly, with the same symbol tables. The
resources are those of `tests/test_compile.py` and a synthetic lexicon
from a numpy seed.

The tracked networks need no JAX: the port's `wsj_task.build_task`
rebuilds the 20k CL and the 2k CLG from each task's `phones.lst`,
`lex.dict` and `lm.arpa` and holds them to `cl.npz` and `clg.npz` bit for
bit (the 2k CLG takes about 80 s on one core).
"""

import math
import os
import types

import numpy as np
import pytest
import torch

import juicer_tpu.am.mmf as jmmf
import juicer_tpu.compile as jcompile
import juicer_tpu.fst as jfst
import juicer_tpu.lexicon as jlexicon

import juicer_tpu_torch.am.mmf as tmmf
import juicer_tpu_torch.compile as tcompile
import juicer_tpu_torch.fst as tfst
import juicer_tpu_torch.lexicon as tlexicon
from juicer_tpu_torch.decoder.network import DecoderNetwork
from juicer_tpu_torch.harness import wsj_task

from test_compile import ARPA, LEX, PHONES
from test_torch_fst_algos import assert_same_fst

JAX = types.SimpleNamespace(fst=jfst, lexicon=jlexicon, compile=jcompile, mmf=jmmf)
PORT = types.SimpleNamespace(fst=tfst, lexicon=tlexicon, compile=tcompile, mmf=tmmf)

# a lexicon with priors, homophones (aux symbols), a word that is a prefix
# of another, and several pronunciations of one word
LEX_PRIORS = """\
a(0.6) ah
a(0.4) ey
cat k ae t
kat k ae t
cats k ae t s
dog(0.5) d ao g
dog(0.5) d aa g
<s> sil
</s> sil
"""
PHONES_PRIORS = "ah\ney\nk\nae\nt\ns\nd\nao\naa\ng\nsil\nsp\n"

MMF = """\
~o <STREAMINFO> 1 2 <VECSIZE> 2 <NULLD><MFCC><DIAGC>
~t "t3"
<TRANSP> 3
 0.0 1.0 0.0
 0.0 0.5 0.5
 0.0 0.0 0.0
~s "s1"
<MEAN> 2
 0.0 0.0
<VARIANCE> 2
 1.0 1.0
~s "s2"
<MEAN> 2
 1.0 -1.0
<VARIANCE> 2
 0.5 2.0
~h "aa"
<BEGINHMM>
<NUMSTATES> 3
<STATE> 2
~s "s1"
~t "t3"
<ENDHMM>
~h "bb"
<BEGINHMM>
<NUMSTATES> 4
<STATE> 2
~s "s2"
<STATE> 3
~s "s1"
<TRANSP> 4
 0.0 1.0 0.0 0.0
 0.0 0.6 0.4 0.0
 0.0 0.0 0.7 0.3
 0.0 0.0 0.0 0.0
<ENDHMM>
~h "sil"
<BEGINHMM>
<NUMSTATES> 3
<STATE> 2
~s "s2"
~t "t3"
<ENDHMM>
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_resources(seed, n_words=15, n_phones=8):
    """A random lexicon (with homophones and priors) and its phone list as
    text, from a numpy seed."""
    rng = np.random.default_rng(seed)
    phones = [f"p{i}" for i in range(n_phones)] + ["sil", "sp"]
    lines = []
    for w in range(n_words):
        for _ in range(int(rng.integers(1, 3))):
            n = int(rng.integers(1, 5))
            pron = " ".join(phones[int(i)] for i in rng.integers(0, n_phones, size=n))
            prior = f"({rng.uniform(0.1, 1.0):.3f})" if rng.random() < 0.5 else ""
            lines.append(f"w{w}{prior} {pron}")
    # homophones: two words with one pronunciation
    lines += ["hx p0 p1", "hy p0 p1", "<s> sil", "</s> sil"]
    return "\n".join(lines) + "\n", "\n".join(phones) + "\n"


@pytest.fixture(scope="module", params=["toy", "priors", "synth"])
def res(request, tmp_path_factory):
    td = tmp_path_factory.mktemp(f"res_{request.param}")
    lex, phones = {"toy": (LEX, PHONES), "priors": (LEX_PRIORS, PHONES_PRIORS),
                   "synth": synth_resources(4)}[request.param]
    (td / "lex.dict").write_text(lex)
    (td / "phones.lst").write_text(phones)
    (td / "lm.arpa").write_text(ARPA if request.param == "toy" else bigram_arpa(lex, 9))
    return td


def bigram_arpa(lex, seed):
    """An ARPA bigram LM over every word of a lexicon text: random
    unigrams with backoff weights and a bigram from each word to the next,
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    words = sorted({ln.split()[0].split("(")[0] for ln in lex.splitlines() if ln.split()}
                   - {"<s>", "</s>"})
    uni = [("-99", "<s>", -0.3)] + [(f"{-rng.uniform(0.5, 2.5):.5f}", w,
                                     -rng.uniform(0.1, 0.6)) for w in words]
    uni.append((f"{-rng.uniform(0.5, 1.5):.5f}", "</s>", None))
    bi = [("<s>", words[0])] + list(zip(words, words[1:])) + [(words[-1], "</s>")]
    out = ["\\data\\", f"ngram 1={len(uni)}", f"ngram 2={len(bi)}", "", "\\1-grams:"]
    out += [f"{p} {w}" + (f" {b:.5f}" if b is not None else "") for p, w, b in uni]
    out += ["", "\\2-grams:"]
    out += [f"{-rng.uniform(0.1, 1.0):.5f} {a} {b}" for a, b in bi]
    return "\n".join(out + ["", "\\end\\", ""])


def load_lexicon(P, td, **kw):
    args = dict(sil_phone="sil", pause_phone="sp", sent_start_word="<s>",
                sent_end_word="</s>", spec_word_char="")
    args.update(kw)
    return P.lexicon.Lexicon.load(str(td / "phones.lst"), str(td / "lex.dict"), **args)


def assert_same_syms(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert list(got) == list(want)


def assert_same_machine(got, want):
    assert_same_fst(got, want)
    assert_same_syms(got.isyms, want.isyms)
    assert_same_syms(got.osyms, want.osyms)


# ---------------------------------------------------------------------------
# lexicon.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    dict(sent_start_word="<s>", sent_end_word="<s>"),
    dict(sil_word="</s>"),
    dict(spec_word_char="<", sil_phone=None, pause_phone=None),
])
def test_lexicon_equals_jax(res, kw):
    got, want = load_lexicon(PORT, res, **kw), load_lexicon(JAX, res, **kw)
    for lex in (got, want):
        lex.normalise_pronuns()
    assert [vars(e) for e in got.entries] == [vars(e) for e in want.entries]
    assert got.vocab_to_lex == want.vocab_to_lex
    assert (got.sent_start_entry, got.sent_end_entry, got.sil_entry, got.n_entries) == (
        want.sent_start_entry, want.sent_end_entry, want.sil_entry, want.n_entries)
    gv, wv = got.vocab, want.vocab
    assert (gv.words, gv.special, gv.n_pronuns) == (wv.words, wv.special, wv.n_pronuns)
    assert (gv.sent_start_index, gv.sent_end_index, gv.sil_index) == (
        wv.sent_start_index, wv.sent_end_index, wv.sil_index)
    gp, wp = got.phone_set, want.phone_set
    assert (gp.phones, gp.sil_index, gp.pause_index) == (wp.phones, wp.sil_index, wp.pause_index)


def test_lexicon_errors_equal_jax(tmp_path):
    (tmp_path / "phones.lst").write_text("a\nb\nsil\n")
    cases = {"unknown phone": "w a c\n", "no phones": "w\n",
             "two starts": "<s> a\n<s> b\n</s> sil\n"}
    for what, lex in cases.items():
        (tmp_path / "lex.dict").write_text(lex)
        errs = []
        for P in (PORT, JAX):
            with pytest.raises(ValueError) as e:
                P.lexicon.Lexicon.load(str(tmp_path / "phones.lst"), str(tmp_path / "lex.dict"),
                                       sent_start_word="<s>", sent_end_word="</s>")
            errs.append(str(e.value))
        assert errs[0] == errs[1], what
    with pytest.raises(ValueError, match="silence phone"):
        tlexicon.PhoneSet(str(tmp_path / "phones.lst"), sil_name="zz")


def test_phone_set_and_vocabulary_built_in_code_equal_jax(tmp_path):
    (tmp_path / "noway.lst").write_text("3\n1 aa\n2 bb\n3 sil\n")
    for args in [dict(phones=["x", "y", "sil", "sp"], sil_name="sil", pause_name="sp"),
                 dict(list_fname=str(tmp_path / "noway.lst"), sil_name="sil")]:
        got, want = tlexicon.PhoneSet(**args), jlexicon.PhoneSet(**args)
        assert (got.phones, got.sil_index, got.pause_index) == (
            want.phones, want.sil_index, want.pause_index)
    # the one-argument form of the decoder CLI
    assert tlexicon.PhoneSet(str(tmp_path / "noway.lst")).phones == ["aa", "bb", "sil"]
    vocabs = []
    for P in (PORT, JAX):
        v = P.lexicon.Vocabulary()
        for w in ("m", "c", "x", "a", "c"):
            v.add_word(w)
        vocabs.append((v.words, v.special, v.n_pronuns, [v.get_index(w) for w in "acmx"]))
    assert vocabs[0] == vocabs[1]


# ---------------------------------------------------------------------------
# LexGen
# ---------------------------------------------------------------------------

LEXGEN_OPTIONS = {
    "default": ({}, {}),
    "no_aux": ({}, dict(output_aux_phones=False)),
    "phi_loop": ({}, dict(add_phi_loop=True)),
    "end_sil_pause": (dict(add_pronun_with_end_sil=True, add_pronun_with_end_pause=True), {}),
    "start_sil_pause": (dict(add_pronun_with_start_sil=True,
                             add_pronun_with_start_pause=True), {}),
    "all_with_tee": (dict(add_pronun_with_end_sil=True, add_pronun_with_end_pause=True,
                          add_pronun_with_start_sil=True, add_pronun_with_start_pause=True,
                          pause_tee_trans_log_prob=math.log(0.3)), dict(add_phi_loop=True)),
}


def build_l(P, td, opt):
    gen_kw, build_kw = LEXGEN_OPTIONS[opt]
    gen = P.compile.LexGen(load_lexicon(P, td), **gen_kw)
    return gen, gen.build(**build_kw)


@pytest.mark.parametrize("opt", list(LEXGEN_OPTIONS))
def test_lexgen_equals_jax(res, opt):
    (tg, got), (jg, want) = build_l(PORT, res, opt), build_l(JAX, res, opt)
    assert_same_machine(got, want)
    assert tg.n_aux == jg.n_aux
    assert got.num_arcs > 0


# ---------------------------------------------------------------------------
# CDGen
# ---------------------------------------------------------------------------


def triphone_names(ps, with_biphones):
    sil = ps.sil_index
    ah, k = ps.get_index("ah"), ps.get_index("k")
    names = {"sil"}
    for l in (sil, ah, k):
        for c in (ah, k):
            for r in (sil, ah, k):
                names.add(f"{ps[l]}-{ps[c]}+{ps[r]}")
    if with_biphones:
        names |= {"ah+k", "k+ah", "ah-k", "k-ah", "ah+ah", "k+k", "ah-ah", "k-k"}
    return sorted(names)


CD_CASES = {
    "monophone": ("MONOPHONE", 0, None),
    "monophone_aux": ("MONOPHONE", 3, None),
    "monophone_ann": ("MONOPHONE_ANN", 2, ["#a", "#b"]),
    "xwrdtri": ("XWORD_TRIPHONE", 2, None),
    "xwrdtri_ci_pause_off": ("XWORD_TRIPHONE", 0, None),
    "xwrdtrindi": ("XWORD_TRIPHONE_NDI", 2, None),
}


def build_c(P, td, case, tied=None):
    type_name, n_aux, aux_names = CD_CASES[case]
    ps = P.lexicon.PhoneSet(str(td / "phones.lst"), "sil", "sp")
    if type_name.startswith("MONOPHONE"):
        names = list(ps.phones)
    else:
        names = triphone_names(ps, type_name.endswith("NDI"))
    lookup = P.compile.CDPhoneLookup(ps)
    if tied is not None:
        lookup.add_tied_list(str(tied))
        names = sorted({ln.split()[-1] for ln in tied.read_text().splitlines() if ln.split()})
    else:
        lookup.add_phones(names)
    lookup.bind_models(names)
    lookup.verify_all_models()
    gen = P.compile.CDGen(getattr(P.compile.CDType, type_name), lookup, names, n_aux, aux_names)
    return gen.build(ci_pause=False if case.endswith("ci_pause_off") else None), lookup


@pytest.mark.parametrize("case", list(CD_CASES))
def test_cdgen_equals_jax(case, tmp_path):
    (tmp_path / "phones.lst").write_text(PHONES)
    (got, tl), (want, jl) = build_c(PORT, tmp_path, case), build_c(JAX, tmp_path, case)
    assert_same_machine(got, want)
    assert tl.all_model_info() == jl.all_model_info()
    assert (tl.have_ci_silence(), tl.have_ci_pause()) == (jl.have_ci_silence(),
                                                          jl.have_ci_pause())
    n_aux = CD_CASES[case][1]
    loops = [i for i in range(got.num_arcs) if got.arc_src[i] == got.arc_dst[i]
             and got.arc_ilabel[i] > len(got.isyms) - 1 - n_aux]
    assert len(loops) == n_aux * got.num_states


@pytest.mark.parametrize("case", ["monophone_aux", "xwrdtri"])
def test_cdgen_tied_list_equals_jax(case, tmp_path):
    """A tied list of one- and two-column lines: logical names tied to a
    few physical models."""
    (tmp_path / "phones.lst").write_text(PHONES)
    ps = tlexicon.PhoneSet(str(tmp_path / "phones.lst"), "sil", "sp")
    if case.startswith("monophone"):
        lines = [p for p in ps.phones if p not in ("k", "t")] + ["k ah", "t ah"]
    else:
        names = triphone_names(ps, False)
        lines = [f"{n} {names[0]}" if i % 3 == 1 else n for i, n in enumerate(names)]
    tied = tmp_path / "tied.lst"
    tied.write_text("\n".join(lines) + "\n\n")
    (got, tl), (want, jl) = (build_c(PORT, tmp_path, case, tied),
                             build_c(JAX, tmp_path, case, tied))
    assert_same_machine(got, want)
    assert tl.logical_to_physical == jl.logical_to_physical
    assert tl.get_model_ind("k") == jl.get_model_ind("k")


def test_cd_lookup_errors_equal_jax(tmp_path):
    (tmp_path / "phones.lst").write_text(PHONES)
    msgs = []
    for P in (PORT, JAX):
        ps = P.lexicon.PhoneSet(str(tmp_path / "phones.lst"), "sil", "sp")
        lookup = P.compile.CDPhoneLookup(ps)
        lookup.add_phones(["ah", "k"])
        lookup.bind_models(["ah"])
        with pytest.raises(ValueError) as e1:
            lookup.verify_all_models()
        with pytest.raises(ValueError) as e2:
            lookup.parse_cd("zz-ah+k")
        msgs.append((str(e1.value), str(e2.value), lookup.parse_cd("ah-k+sil")))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# HmmGen and untie_models
# ---------------------------------------------------------------------------


def test_hmmgen_equals_jax(tmp_path):
    (tmp_path / "m.mmf").write_text(MMF)
    got = tcompile.HmmGen(tmmf.parse_mmf(str(tmp_path / "m.mmf"))).build()
    want = jcompile.HmmGen(jmmf.parse_mmf(str(tmp_path / "m.mmf"))).build()
    assert_same_machine(got, want)
    assert got.num_states == 2 + 3 + 4 + 3


def test_hmmgen_on_a_synth_model_set_equals_jax(tmp_path):
    """The synthetic task's models as a text MMF (one ~s macro a GMM, one
    ~t a transition matrix), turned into H by each package."""
    from juicer_tpu.utils.synth import make_synth_task

    m = make_synth_task(n_words=6, n_phones=5, n_comps=2, vec_size=4, seed=2).models
    vec = lambda v: " ".join(repr(float(x)) for x in v)
    text = [f"~o <STREAMINFO> 1 {m.vec_size} <VECSIZE> {m.vec_size} <NULLD><DIAGC>"]
    for t, tm in enumerate(m.trans_mats):
        text += [f'~t "T{t}"', f"<TRANSP> {len(tm)}"]
        text += [" " + vec(np.where(row <= -1e30, 0.0, np.exp(row))) for row in tm]
    for g in range(m.n_gmms):
        text += [f'~s "S{g}"', f"<NUMMIXES> {len(m.gmm_means[g])}"]
        for c, (lw, mu, var) in enumerate(zip(m.gmm_log_weights[g], m.gmm_means[g],
                                              m.gmm_vars[g])):
            text += [f"<MIXTURE> {c + 1} {float(np.exp(lw))!r}", f"<MEAN> {len(mu)}",
                     " " + vec(mu), f"<VARIANCE> {len(var)}", " " + vec(var)]
    for h, name in enumerate(m.hmm_names):
        text += [f'~h "{name}"', "<BEGINHMM>", f"<NUMSTATES> {m.get_num_states(h)}"]
        for j, g in enumerate(m.hmm_gmm_inds[h]):
            text += [f"<STATE> {j + 2}", f'~s "S{int(g)}"']
        text += [f'~t "T{m.hmm_trans_ind[h]}"', "<ENDHMM>"]
    path = tmp_path / "synth.mmf"
    path.write_text("\n".join(text) + "\n")
    got = tcompile.HmmGen(tmmf.parse_mmf(str(path))).build()
    want = jcompile.HmmGen(jmmf.parse_mmf(str(path))).build()
    assert_same_machine(got, want)
    assert got.num_arcs > 0


@pytest.mark.parametrize("tied", ["aa\nbb\nsil\n", "x-aa+bb aa\nbb\nsil sil\nb-sil bb\nAA aa\n"])
def test_untie_models_equals_jax(tmp_path, tied):
    (tmp_path / "tied.lst").write_text(tied)
    (tmp_path / "m.mmf").write_text(MMF)
    outs = []
    for M in (tmmf, jmmf):
        d = M.untie_models(M.parse_mmf(str(tmp_path / "m.mmf")), str(tmp_path / "tied.lst"))
        buf = tmp_path / f"out_{M.__name__.split('.')[0]}.mmf"
        M.write_mmf(d, str(buf))
        outs.append(([h.name for h in d.hmms], buf.read_text()))
    assert outs[0] == outs[1]
    assert outs[0][0] == sorted(outs[0][0], key=str.encode)
    (tmp_path / "bad.lst").write_text("x zz\n")
    with pytest.raises(KeyError, match="zz"):
        tmmf.untie_models(tmmf.parse_mmf(str(tmp_path / "m.mmf")), str(tmp_path / "bad.lst"))


# ---------------------------------------------------------------------------
# build_clg
# ---------------------------------------------------------------------------


def build_glc(P, td):
    lexicon = load_lexicon(P, td)
    G = P.compile.GramGen(lexicon.vocab, P.compile.GramType.NGRAM,
                          lm_fname=str(td / "lm.arpa")).build()
    lg = P.compile.LexGen(lexicon)
    L = lg.build(output_aux_phones=True)
    ps = lexicon.phone_set
    lookup = P.compile.CDPhoneLookup(ps)
    lookup.add_phones(list(ps.phones))
    lookup.bind_models(list(ps.phones))
    C = P.compile.CDGen(P.compile.CDType.MONOPHONE, lookup, list(ps.phones),
                        n_aux_syms=lg.n_aux).build()
    return G, L, C


@pytest.mark.parametrize("kw", [{}, dict(optimize_final=True), dict(remove_aux=False)])
def test_build_clg_equals_jax(res, kw, capsys):
    got = tcompile.build_clg(*build_glc(PORT, res), verbose=True, **kw)
    lines = capsys.readouterr().out.splitlines()
    want = jcompile.build_clg(*build_glc(JAX, res), **kw)
    assert_same_machine(got.clg, want.clg)
    assert_same_fst(got.lg, want.lg)
    assert_same_syms(got.in_syms, want.in_syms)
    assert_same_syms(got.out_syms, want.out_syms)
    stages = [ln.split(":")[0] for ln in lines]
    assert stages == ["[build_clg] det(G)", "[build_clg] prep(L,C)", "[build_clg] L.G",
                      "[build_clg] epsnorm", "[build_clg] det(L.G)", "[build_clg] min",
                      "[build_clg] C.LG", "[build_clg] push"]


def test_aux_to_eps_equals_jax(res):
    (_, tl), (_, jl) = build_l(PORT, res, "default"), build_l(JAX, res, "default")
    got, want = tcompile.aux_to_eps(tl, tl.isyms), jcompile.aux_to_eps(jl, jl.isyms)
    assert_same_fst(got, want)
    aux = [i for i in range(len(tl.isyms)) if tl.isyms.is_auxiliary(i)]
    assert not set(got.arc_ilabel) & set(aux)


def test_toy_clg_decodes_the_sentence():
    """`tests/test_compile.py`'s end-to-end case on the port's CLG."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        td = Path(d)
        (td / "lex.dict").write_text(LEX)
        (td / "phones.lst").write_text(PHONES)
        (td / "lm.arpa").write_text(ARPA)
        lexicon = load_lexicon(PORT, td)
        clg = tcompile.build_clg(*build_glc(PORT, td)).clg
    ps, v = lexicon.phone_set, lexicon.vocab
    acc = tfst.Fst(tfst.TROPICAL)
    s = acc.add_state()
    acc.set_start(s)
    for p in ["sil", "ah", "k", "ae", "t", "sil"]:
        t = acc.add_state()
        acc.add_arc(s, t, ps.get_index(p) + 1, ps.get_index(p) + 1, 0.0)
        s = t
    acc.set_final(s, 0.0)
    _, _, ol = tfst.algos.shortest_path(tfst.algos.compose(acc, clg))
    assert [v.get_word(o - 1) for o in ol] == ["<s>", "a", "cat", "</s>"]


# ---------------------------------------------------------------------------
# the tracked networks, rebuilt by the port alone
# ---------------------------------------------------------------------------


def test_build_task_20k_cl_equals_cl_npz(capsys):
    out = wsj_task.build_task("20k", networks=("cl",))
    assert out["cl"].n_arcs == 37443 and out["cl"].n_states == 17442
    assert "equal to cl.npz bit for bit" in capsys.readouterr().out


def test_build_task_2k_clg_equals_clg_npz(capsys):
    out = wsj_task.build_task("2k", networks=("clg",))
    assert (out["clg"].n_states, out["clg"].n_arcs) == (181003, 1617510)
    text = capsys.readouterr().out
    assert "equal to clg.npz bit for bit" in text and "[build_clg] push" in text


def test_require_same_network_names_the_first_difference():
    net = DecoderNetwork.load_npz(os.path.join(wsj_task.task_dir("20k"), "cl.npz"))
    other = DecoderNetwork.load_npz(os.path.join(wsj_task.task_dir("20k"), "cl.npz"))
    wsj_task.require_same_network("cl", net, other)
    other.arc_weight = other.arc_weight.copy()
    other.arc_weight[17] = np.nextafter(other.arc_weight[17], np.inf)
    with pytest.raises(RuntimeError, match="arc_weight differs at index 17"):
        wsj_task.require_same_network("cl", net, other)
    other.arc_weight = net.arc_weight
    other.init_state = net.init_state + 1
    with pytest.raises(RuntimeError, match="init_state"):
        wsj_task.require_same_network("cl", net, other)


def test_task_main_exits_non_zero_on_a_difference(monkeypatch, capsys):
    real = DecoderNetwork.load_npz

    def shifted(path):
        net = real(path)
        net.arc_dst = net.arc_dst.copy()
        net.arc_dst[3] += 1
        return net

    monkeypatch.setattr(DecoderNetwork, "load_npz", staticmethod(shifted))
    assert wsj_task.main(["--build", "20k"]) == 1  # CL, built first, differs
    assert "arc_dst differs at index 3" in capsys.readouterr().out
