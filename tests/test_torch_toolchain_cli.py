"""The port's toolchain CLIs against the JAX package's, on the CPU.

`jtpu-lexgen-torch`, `jtpu-cdgen-torch`, `jtpu-hmmgen-torch`,
`jtpu-build-wfst-torch`, `jtpu-genwfstseqs-torch` and `jtpu-untie-torch`
(their `main`s, in this process) run beside `jtpu-lexgen`, ... with the
same flags on the same files, each package writing into a directory of
its own. Every file a tool writes must be equal byte for byte, and its
stdout equal once the output directory's path is taken out:

  - lexgen: the sil/pause pronunciation flags, -pauseTeeTransProb,
    -outputAuxPhones, -addPhiLoop, -normalise (and the `#sil`/`#sp` lines
    appended to the output symbols without a phi loop);
  - cdgen: every -cdType spelling (the reference's and the aliases, and
    -ndixt), -lexInSymsFName's aux symbols, -tiedListFName,
    -htkModelsFName, -priorsFName with -statesPerModel, -genTestSeqs; the
    monophone C in the reference's layout (aux self-loops twice);
  - build-wfst: the default CLG, -of, -cl and -outDir, on the CLI
    route's G, L and C (whose C makes det(L o G) minimise unpushed: the
    -log 2 aux cycles keep the tropical push from converging);
  - genwfstseqs: -nSeqs and -seed, with and without symbol files;
  - hmmgen on an MMF of shared states; untie with -outListFName.
"""

import itertools

import numpy as np
import pytest
import torch

from juicer_tpu.cli import build_wfst as jax_build_wfst
from juicer_tpu.cli import cdgen as jax_cdgen
from juicer_tpu.cli import genwfstseqs as jax_genwfstseqs
from juicer_tpu.cli import gramgen as jax_gramgen
from juicer_tpu.cli import hmmgen as jax_hmmgen
from juicer_tpu.cli import lexgen as jax_lexgen
from juicer_tpu.cli import untie as jax_untie

from juicer_tpu_torch.cli import build_wfst, cdgen, genwfstseqs, hmmgen, lexgen, untie
from juicer_tpu_torch.fst import read_fsm

from test_compile import ARPA

PHONES = ["ah", "ey", "k", "ae", "t", "d", "ao", "g", "sil", "sp"]
LEX = """\
a(0.6) ah
a(0.4) ey
cat k ae t
kat k ae t
dog d ao g
<s> sil
</s> sil
"""
TOOLS = {"lexgen": (jax_lexgen.main, lexgen.main), "cdgen": (jax_cdgen.main, cdgen.main),
         "hmmgen": (jax_hmmgen.main, hmmgen.main),
         "build_wfst": (jax_build_wfst.main, build_wfst.main),
         "genwfstseqs": (jax_genwfstseqs.main, genwfstseqs.main),
         "untie": (jax_untie.main, untie.main)}
OUT3 = ("x.fsm", "x.insyms", "x.outsyms")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mmf_text(names, seed):
    """An MMF over `names`: shared states (~s) from a seed, one shared
    3-state transition matrix and one 4-state matrix inline."""
    rng = np.random.default_rng(seed)
    vec = lambda v: " ".join(f"{x:.6f}" for x in v)
    out = ["~o <STREAMINFO> 1 3 <VECSIZE> 3 <NULLD><MFCC><DIAGC>",
           '~t "t3"', "<TRANSP> 3", " 0.0 1.0 0.0", " 0.0 0.6 0.4", " 0.0 0.0 0.0"]
    for s in range(4):
        out += [f'~s "s{s}"', "<MEAN> 3", " " + vec(rng.normal(size=3)), "<VARIANCE> 3",
                " " + vec(rng.uniform(0.5, 2.0, size=3))]
    for i, name in enumerate(names):
        out += [f'~h "{name}"', "<BEGINHMM>"]
        if i % 2:
            out += ["<NUMSTATES> 4", "<STATE> 2", f'~s "s{i % 4}"', "<STATE> 3",
                    f'~s "s{(i + 1) % 4}"', "<TRANSP> 4", " 0.0 1.0 0.0 0.0",
                    " 0.0 0.5 0.5 0.0", " 0.0 0.0 0.7 0.3", " 0.0 0.0 0.0 0.0"]
        else:
            out += ["<NUMSTATES> 3", "<STATE> 2", f'~s "s{i % 4}"', '~t "t3"']
        out.append("<ENDHMM>")
    return "\n".join(out) + "\n"


CTX = ["sil", "ah", "k", "ae", "t"]


def triphone_tied_list(ndi, sep="-+"):
    """Logical triphones (and, for the non-det-inverse C, biphones) over a
    few phones, each tied to the physical triphone sil-centre+sil (a
    physical name must parse as a context-dependent phone too); sil and sp
    alone."""
    lsep, rsep = sep
    tri = lambda l, c, r: f"{l}{lsep}{c}{rsep}{r}"
    lines = [f"{tri(l, c, r)} {tri('sil', c, 'sil')}"
             for l, c, r in itertools.product(CTX, CTX[1:], CTX)]
    if ndi:
        lines += [f"{c}{rsep}{r} {tri('sil', c, 'sil')}"
                  for c, r in itertools.product(CTX[1:], CTX[1:])]
        lines += [f"{l}{lsep}{c} {tri('sil', c, 'sil')}"
                  for l, c in itertools.product(CTX[1:], CTX[1:])]
    return "\n".join(lines + ["sil", "sp"]) + "\n"


def triphone_models(sep="-+"):
    return [f"sil{sep[0]}{c}{sep[1]}sil" for c in CTX[1:]] + ["sil", "sp"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    td = tmp_path_factory.mktemp("toolchain_files")
    (td / "phones.lst").write_text("\n".join(PHONES) + "\n")
    (td / "lex.dict").write_text(LEX)
    (td / "lm.arpa").write_text(ARPA)
    (td / "models.mmf").write_text(mmf_text(PHONES, 1))
    (td / "priors.txt").write_text(" ".join(f"{x:.4f}" for x in
                                            np.random.default_rng(2).dirichlet(
                                                np.ones(len(PHONES)))) + "\n")
    (td / "tri.tied").write_text(triphone_tied_list(False))
    (td / "tri_ndi.tied").write_text(triphone_tied_list(True))
    (td / "tri.mmf").write_text(mmf_text(triphone_models(), 3))
    (td / "tri_sep.tied").write_text(triphone_tied_list(False, "_^"))
    (td / "tri_sep.mmf").write_text(mmf_text(triphone_models("_^"), 4))
    (td / "untie.tied").write_text("x-ah+k ah\nk\nah\nsil-k+t k\nAH ah\nzz-sil sil\nsil\n")
    # G (jtpu-gramgen) and L (jtpu-lexgen) of the CLI route, from the JAX
    # tools: the common inputs of the cdgen and build-wfst cases
    assert jax_gramgen.main(["-lexFName", str(td / "lex.dict"), "-sentStartWord", "<s>",
                             "-sentEndWord", "</s>", "-gramType", "ngram", "-lmFName",
                             str(td / "lm.arpa"), "-fsmFName", str(td / "g.fsm"),
                             "-inSymsFName", str(td / "g.insyms"), "-outSymsFName",
                             str(td / "g.outsyms")]) == 0
    assert jax_lexgen.main(["-monoListFName", str(td / "phones.lst"), "-lexFName",
                            str(td / "lex.dict"), "-sentStartWord", "<s>", "-sentEndWord",
                            "</s>", "-silMonophone", "sil", "-pauseMonophone", "sp",
                            "-outputAuxPhones", "-fsmFName", str(td / "l.fsm"), "-inSymsFName",
                            str(td / "l.insyms"), "-outSymsFName", str(td / "l.outsyms")]) == 0
    assert jax_cdgen.main(["-cdType", "monophone", "-monoListFName", str(td / "phones.lst"),
                           "-silMonophone", "sil", "-pauseMonophone", "sp", "-lexInSymsFName",
                           str(td / "l.insyms"), "-fsmFName", str(td / "c.fsm"), "-inSymsFName",
                           str(td / "c.insyms"), "-outSymsFName", str(td / "c.outsyms")]) == 0
    return td


def run_both(tool, argv, outs, tmp_path_factory, capsys):
    """Run both packages' `tool` with argv(out_dir); return, for each, the
    bytes of every file in `outs` and stdout with out_dir replaced."""
    got = {}
    for name, main in zip(("jax", "port"), TOOLS[tool]):
        out = tmp_path_factory.mktemp(f"{tool}_{name}")
        rc = main(argv(out))
        assert rc in (0, None)
        stdout = capsys.readouterr().out.replace(str(out), "OUT")
        got[name] = ([(out / f).read_bytes() for f in outs], stdout)
    assert all(got["port"][0]), "a tool wrote an empty file"
    return got


def assert_same_outputs(got):
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]


LEXGEN_CASES = {
    "plain": [],
    "sil_pause_aux": ["-silMonophone", "sil", "-pauseMonophone", "sp", "-outputAuxPhones"],
    "variants_tee": ["-silMonophone", "sil", "-pauseMonophone", "sp", "-outputAuxPhones",
                     "-addPronunsWithEndSil", "-addPronunsWithEndPause",
                     "-addPronunsWithStartSil", "-addPronunsWithStartPause",
                     "-pauseTeeTransProb", "0.3"],
    "phi_normalise": ["-silMonophone", "sil", "-pauseMonophone", "sp", "-outputAuxPhones",
                      "-addPhiLoop", "-normalise", "-silWord", "</s>"],
}


@pytest.mark.parametrize("case", list(LEXGEN_CASES))
def test_lexgen_cli_equals_jax(files, case, tmp_path_factory, capsys):
    def argv(out):
        return (["-monoListFName", str(files / "phones.lst"), "-lexFName",
                 str(files / "lex.dict"), "-sentStartWord", "<s>", "-sentEndWord", "</s>"]
                + LEXGEN_CASES[case] + ["-fsmFName", str(out / "x.fsm"), "-inSymsFName",
                                        str(out / "x.insyms"), "-outSymsFName",
                                        str(out / "x.outsyms")])

    got = run_both("lexgen", argv, OUT3, tmp_path_factory, capsys)
    assert_same_outputs(got)
    outsyms = got["port"][0][2].decode().splitlines()
    assert (outsyms[-2].split() == ["#sil", "0"]) == (case != "phi_normalise")


CDGEN_CASES = {
    "mono_aux": ["-cdType", "mono", "-lexInSymsFName", "{L}"],
    "monophone_alias": ["-cdType", "monophone"],
    "monoann_models": ["-cdType", "monoann", "-htkModelsFName", "{MMF}", "-lexInSymsFName",
                       "{L}"],
    "monophoneann_priors": ["-cdType", "monophoneann", "-priorsFName", "{PRIORS}",
                            "-statesPerModel", "4"],
    "mono_models_seqs": ["-cdType", "mono", "-htkModelsFName", "{MMF}", "-genTestSeqs"],
    "xwrdtri_tied": ["-cdType", "xwrdtri", "-tiedListFName", "{TRI}", "-htkModelsFName",
                     "{TRI_MMF}", "-lexInSymsFName", "{L}", "-genTestSeqs"],
    "xwrdtrindi_tied": ["-cdType", "xwrdtrindi", "-tiedListFName", "{TRI_NDI}",
                        "-htkModelsFName", "{TRI_MMF}"],
    "xwrdtri_ndixt": ["-cdType", "xwrdtri", "-ndixt", "-tiedListFName", "{TRI_NDI}",
                      "-htkModelsFName", "{TRI_MMF}", "-lexInSymsFName", "{L}"],
    "xwrdtri_sep": ["-cdType", "xwrdtri", "-cdSepChars=_^", "-tiedListFName", "{TRI_SEP}",
                    "-htkModelsFName", "{TRI_SEP_MMF}"],
}


@pytest.mark.parametrize("case", list(CDGEN_CASES))
def test_cdgen_cli_equals_jax(files, case, tmp_path_factory, capsys):
    subs = {"{L}": str(files / "l.insyms"), "{MMF}": str(files / "models.mmf"),
            "{PRIORS}": str(files / "priors.txt"), "{TRI}": str(files / "tri.tied"),
            "{TRI_NDI}": str(files / "tri_ndi.tied"), "{TRI_MMF}": str(files / "tri.mmf"),
            "{TRI_SEP}": str(files / "tri_sep.tied"), "{TRI_SEP_MMF}": str(files / "tri_sep.mmf")}

    def argv(out):
        return ([subs.get(a, a) for a in CDGEN_CASES[case]]
                + ["-monoListFName", str(files / "phones.lst"), "-silMonophone", "sil",
                   "-pauseMonophone", "sp", "-fsmFName", str(out / "x.fsm"), "-inSymsFName",
                   str(out / "x.insyms"), "-outSymsFName", str(out / "x.outsyms")])

    got = run_both("cdgen", argv, OUT3, tmp_path_factory, capsys)
    assert_same_outputs(got)
    if CDGEN_CASES[case][1] in ("mono", "monophone") and "{L}" in CDGEN_CASES[case]:
        # the reference layout: the final-state line mid-file, the aux
        # self-loops twice
        lines = got["port"][0][0].decode().splitlines()
        aux = lines[lines.index("0") + 1:]
        assert aux and aux[:len(aux) // 2] == aux[len(aux) // 2:]
    if "-genTestSeqs" in CDGEN_CASES[case]:
        # up to 10 paths of at most 30 labels, one line each
        assert 1 < len(got["port"][1].splitlines()) <= 11


BUILD_CASES = {
    "default": [],
    "optimise_final": ["-of"],
    "cl": ["-cl"],
    "out_dir": ["-outDir", "{OUT}"],
}
BUILD_OUTS = {"cl": ("cl.fsm", "cl.insyms", "cl.outsyms")}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_wfst_cli_equals_jax(files, case, tmp_path_factory, capsys, monkeypatch):
    """The CLI route's G, L and C (the monophone C in the reference layout,
    its aux loops twice) through both packages' build-wfst. Without
    -outDir the tool writes beside the grammar FSM, so each package gets
    a copy of the three machines in its own directory. The CLG cases go
    through `minimize`'s unpushed branch: det(inverse(C)) turns the doubled
    aux loops into -log 2 cycles, on which the tropical push raises."""
    import shutil

    from juicer_tpu_torch.fst import algos

    push, diverged = algos.push_weights, []

    def spy(f, *a, **kw):
        try:
            return push(f, *a, **kw)
        except RuntimeError:
            diverged.append(kw.get("semiring"))
            raise

    monkeypatch.setattr(algos, "push_weights", spy)

    def argv(out):
        if case != "out_dir":
            for f in ("g", "l", "c"):
                for ext in ("fsm", "insyms", "outsyms"):
                    shutil.copy(files / f"{f}.{ext}", out / f"{f}.{ext}")
        src = files if case == "out_dir" else out
        return ([a if a != "{OUT}" else str(out) for a in BUILD_CASES[case]]
                + [str(src / "g.fsm"), str(src / "l.fsm"), str(src / "c.fsm")])

    outs = BUILD_OUTS.get(case, ("lg.fsm", "final.fsm", "final.insyms", "final.outsyms"))
    got = run_both("build_wfst", argv, outs, tmp_path_factory, capsys)
    assert_same_outputs(got)
    assert "build-wfst: " in got["port"][1]
    assert (algos.TROPICAL in diverged) == (case != "cl")


@pytest.mark.parametrize("syms", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_genwfstseqs_cli_equals_jax(files, seed, syms, tmp_path_factory, capsys):
    final = tmp_path_factory.mktemp("final")
    assert jax_build_wfst.main([str(files / "g.fsm"), str(files / "l.fsm"),
                                str(files / "c.fsm"), "-outDir", str(final)]) == 0
    capsys.readouterr()

    def argv(out):
        a = ["-fsmFName", str(final / "final.fsm"), "-nSeqs", "7", "-seed", str(seed)]
        if syms:
            a += ["-inSymsFName", str(final / "final.insyms"), "-outSymsFName",
                  str(final / "final.outsyms")]
        return a

    got = run_both("genwfstseqs", argv, (), tmp_path_factory, capsys)
    assert_same_outputs(got)
    assert len(got["port"][1].splitlines()) == 7


def test_hmmgen_cli_equals_jax(files, tmp_path_factory, capsys):
    def argv(out):
        return ["-htkModelsFName", str(files / "models.mmf"), "-fsmFName", str(out / "x.fsm"),
                "-inSymsFName", str(out / "x.insyms"), "-outSymsFName", str(out / "x.outsyms")]

    got = run_both("hmmgen", argv, OUT3, tmp_path_factory, capsys)
    assert_same_outputs(got)
    assert "hmmgen: " in got["port"][1]


@pytest.mark.parametrize("out_list", [False, True])
def test_untie_cli_equals_jax(files, out_list, tmp_path_factory, capsys):
    def argv(out):
        a = ["-htkModelsFName", str(files / "models.mmf"), "-tiedListFName",
             str(files / "untie.tied"), "-outModelsFName", str(out / "untied.mmf")]
        return a + (["-outListFName", str(out / "untied.lst")] if out_list else [])

    outs = ("untied.mmf", "untied.lst") if out_list else ("untied.mmf",)
    got = run_both("untie", argv, outs, tmp_path_factory, capsys)
    assert_same_outputs(got)
    if out_list:
        names = got["port"][0][1].decode().split()
        assert names == sorted(names, key=str.encode) and len(names) == 7


def test_cli_route_chain_equals_jax(files, tmp_path_factory, capsys):
    """lexgen, cdgen and build-wfst of the port chained on the port's own
    outputs: final.fsm equals the JAX chain's byte for byte, and reads
    back as a machine with the CLG's states."""
    td = tmp_path_factory.mktemp("port_chain")
    base = ["-monoListFName", str(files / "phones.lst"), "-silMonophone", "sil",
            "-pauseMonophone", "sp"]
    assert lexgen.main(base + ["-lexFName", str(files / "lex.dict"), "-sentStartWord", "<s>",
                               "-sentEndWord", "</s>", "-outputAuxPhones", "-fsmFName",
                               str(td / "l.fsm"), "-inSymsFName", str(td / "l.insyms"),
                               "-outSymsFName", str(td / "l.outsyms")]) == 0
    assert cdgen.main(base + ["-cdType", "monophone", "-lexInSymsFName", str(td / "l.insyms"),
                              "-fsmFName", str(td / "c.fsm"), "-inSymsFName",
                              str(td / "c.insyms"), "-outSymsFName", str(td / "c.outsyms")]) == 0
    for ext in ("fsm", "insyms", "outsyms"):
        (td / f"g.{ext}").write_bytes((files / f"g.{ext}").read_bytes())
    assert build_wfst.main([str(td / f"{m}.fsm") for m in "glc"]) == 0
    jd = tmp_path_factory.mktemp("jax_chain")
    assert jax_build_wfst.main([str(files / f"{m}.fsm") for m in "glc"]
                               + ["-outDir", str(jd)]) == 0
    capsys.readouterr()
    for f in ("l.fsm", "c.fsm"):
        assert (td / f).read_bytes() == (files / f).read_bytes()
    for f in ("final.fsm", "final.insyms", "final.outsyms", "lg.fsm"):
        assert (td / f).read_bytes() == (jd / f).read_bytes()
    assert read_fsm(str(td / "final.fsm")).num_arcs > 0
