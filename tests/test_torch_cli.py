"""The port's decoder CLI end to end against the JAX CLI, on the CPU.

A tiny task is built once per module with the JAX package's own tools,
as `tests/test_harness.py` builds it (`gramgen`, `lexgen`, `cdgen`,
`build-wfst`, and `build-wfst -cl` for on-the-fly composition, with an
epsilon-backoff G and a `#phi`-backoff G), with an MMF of random
well-separated models, four utterances of HTK features synthesised from
them (two speakers, different lengths), their LNA posteriors for a
hybrid set, a CMLLR transform for one speaker, and references as plain
text and as an MLF. Each case runs `juicer_tpu.cli.juicer.main` and the
port's `main(... "-device", "cpu")` on the same files and compares what
they write:
  - text outputs byte for byte, leaving out the timing lines of the
    verbose format ("Total time spent decoding", "Real-time (RT)
    factor");
  - xmlf: words and times exactly, the per-word scores as floats within
    SCORE_TOL (1e-3: the two packages' float32 GMM scorers sum in another
    order, and the decoders agree within 1e-4 on equal scores);
  - lattice files: states and labels exactly, weights within LAT_TOL
    (2e-3: written with three decimals from scores within 1e-3);
  - stdout (`-loop`, `-doModelsIOTest`, `-genTestSeqs`) exactly.
"""

import io
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from juicer_tpu.am import AcousticModelSet as JaxModels
from juicer_tpu.am.mmf import MmfDef, MmfHmm, MmfMixture, MmfState, MmfTransMat, write_mmf
from juicer_tpu.cli import build_wfst, cdgen, gramgen, lexgen
from juicer_tpu.cli import juicer as jax_juicer
from juicer_tpu.harness import write_htk, write_lna

from juicer_tpu_torch.cli import juicer

SCORE_TOL = 1e-3
LAT_TOL = 2e-3
TIMING = ("Total time spent decoding", "Real-time (RT) factor")
PHONES = ["ah", "k", "ae", "t", "sil"]
UTTS = {  # name -> phone sequence (words: a = ah, cat = k ae t)
    "spkA_u0": ["sil", "ah", "k", "ae", "t", "sil"],
    "spkA_u1": ["sil", "ah", "sil"],
    "spkB_u2": ["sil", "k", "ae", "t", "sil"],
    "spkB_u3": ["sil", "k", "ae", "t", "ah", "sil"],
}
REFS = ["<s> a cat </s>", "<s> a </s>", "<s> cat </s>", "<s> cat a </s>"]
XFORM = """~a "spkA"
<XFORMSET>
<XFORMKIND> CMLLR
<LINXFORM> 1
<VECSIZE> 8
<BIAS> 8
 {b}
<LOGDET> 0.0
<BLOCKINFO> 1 8
<BLOCK> 1
<XFORM> 8 8
 {a}
"""


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("cli"))

    def j(name):
        return os.path.join(td, name)

    with open(j("lex.dict"), "w") as fd:
        fd.write("a(1.0) ah\ncat k ae t\n<s> sil\n</s> sil\n")
    with open(j("phones.lst"), "w") as fd:
        fd.write("\n".join(PHONES) + "\n")
    with open(j("lm.arpa"), "w") as fd:
        fd.write("\\data\\\nngram 1=4\nngram 2=3\n\n\\1-grams:\n"
                 "-0.60206 </s>\n-99 <s> -0.30103\n-0.47712 a -0.30103\n"
                 "-0.60206 cat -0.30103\n\n\\2-grams:\n-0.30103 <s> a\n"
                 "-0.47712 a cat\n-0.30103 cat </s>\n\n\\end\\\n")
    rng = np.random.default_rng(0)
    D = 8
    d = MmfDef()
    d.global_opts.vec_size = D
    for name in PHONES:
        probs = np.zeros((5, 5))
        probs[0, 1] = 1
        for i in range(1, 4):
            probs[i, i] = probs[i, i + 1] = 0.5
        center = rng.normal(scale=6.0, size=D)
        sts = [MmfState(mixtures=[MmfMixture(1.0, center + rng.normal(scale=0.5, size=D),
                                             np.ones(D))]) for _ in range(3)]
        d.hmms.append(MmfHmm(name, 5, sts, MmfTransMat(None, 5, probs)))
    write_mmf(d, j("models.mmf"))
    words = ["-lexFName", j("lex.dict"), "-sentStartWord", "<s>", "-sentEndWord", "</s>"]
    for g, extra in (("g", []), ("gphi", ["-phiBackoff"])):
        assert gramgen.main(words + ["-gramType", "ngram", "-lmFName", j("lm.arpa"),
                                     "-fsmFName", j(f"{g}.fsm"), "-inSymsFName",
                                     j(f"{g}.insyms"), "-outSymsFName",
                                     j(f"{g}.outsyms")] + extra) == 0
    assert lexgen.main(["-monoListFName", j("phones.lst"), "-silMonophone", "sil",
                        *words, "-outputAuxPhones", "-fsmFName", j("l.fsm"),
                        "-inSymsFName", j("l.insyms"), "-outSymsFName", j("l.outsyms")]) == 0
    assert cdgen.main(["-cdType", "monophone", "-monoListFName", j("phones.lst"),
                       "-htkModelsFName", j("models.mmf"), "-lexInSymsFName", j("l.insyms"),
                       "-fsmFName", j("c.fsm"), "-inSymsFName", j("c.insyms"),
                       "-outSymsFName", j("c.outsyms")]) == 0
    assert build_wfst.main([j("g.fsm"), j("l.fsm"), j("c.fsm")]) == 0
    assert build_wfst.main(["-cl", j("g.fsm"), j("l.fsm"), j("c.fsm")]) == 0

    models = JaxModels.from_mmf(j("models.mmf"))
    lines, lna_lines = [], []
    for name, seq in UTTS.items():
        frames, post = [], []
        for p in seq:
            h = models.get_hmm_index(p)
            for k in range(1, 4):
                g = int(models.hmm_gmm_inds[h][k - 1])
                for _ in range(3):
                    frames.append(models.gmm_means[g][0] + rng.normal(scale=0.3, size=D))
                    pr = np.full(len(PHONES), 0.1 / (len(PHONES) - 1))
                    pr[PHONES.index(p)] = 0.9
                    post.append(np.log(pr))
        write_htk(j(f"{name}.mfc"), np.asarray(frames))
        write_lna(j(f"{name}.lna"), np.asarray(post, np.float32))
        lines.append(f"{name}={j(name + '.mfc')}")
        lna_lines.append(f"{name}={j(name + '.lna')}")
    with open(j("input.lst"), "w") as fd:
        fd.write("\n".join(lines) + "\n")
    with open(j("lna.lst"), "w") as fd:
        fd.write("\n".join(lna_lines) + "\n")
    with open(j("refs.txt"), "w") as fd:
        fd.write("\n".join(REFS) + "\n")
    with open(j("refs.mlf"), "w") as fd:
        fd.write("#!MLF!#\n" + "".join(
            f'"*/{n}.lab"\n' + "\n".join(r.split()) + "\n.\n" for n, r in zip(UTTS, REFS)))
    with open(j("priors.txt"), "w") as fd:
        fd.write(" ".join(["0.2"] * len(PHONES)) + "\n")
    os.makedirs(j("xforms"))
    A = np.eye(D) + rng.normal(scale=0.02, size=(D, D))
    with open(j("xforms/spkA.xform"), "w") as fd:
        fd.write(XFORM.format(b=" ".join(repr(float(x)) for x in rng.normal(scale=0.1, size=D)),
                              a="\n ".join(" ".join(repr(float(x)) for x in row) for row in A)))
    return td


def base_args(td, fsm="final", refs="refs.txt"):
    def j(name):
        return os.path.join(td, name)

    out = ["-lexFName", j("lex.dict"), "-sentStartWord", "<s>", "-sentEndWord", "</s>",
           "-fsmFName", j(f"{fsm}.fsm"), "-inSymsFName", j(f"{fsm}.insyms"),
           "-outSymsFName", j(f"{fsm}.outsyms"), "-inputFName", j("input.lst")]
    return out + (["-refFName", j(refs)] if refs else [])


def mmf_args(td):
    return ["-htkModelsFName", os.path.join(td, "models.mmf")]


def run_both(argv, out_dir, capsys=None):
    """Both CLIs on argv, each writing its own -outputFName (and
    -latticeDir where asked); returns (JAX text, port text) and, with
    capsys, their stdout."""
    texts, stdouts = [], []
    for name, run, extra in (("jax", jax_juicer.main, []),
                             ("port", juicer.main, ["-device", "cpu"])):
        out = os.path.join(out_dir, f"{name}.out")
        args = [a.replace("{LAT}", os.path.join(out_dir, f"{name}_lat")) for a in argv]
        assert run(args + ["-outputFName", out] + extra) == 0
        with open(out) as fd:
            texts.append(fd.read())
        if capsys is not None:
            stdouts.append(capsys.readouterr().out)
    return (*texts, *stdouts)


def without_timing(text):
    return [ln for ln in text.splitlines() if not ln.startswith(TIMING)]


def assert_xmlf_equal(port, ref):
    pl, rl = port.splitlines(), ref.splitlines()
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        fa, fb = a.split(), b.split()
        if len(fb) == 4 and fb[0].isdigit():
            assert fa[:3] == fb[:3], (a, b)
            assert abs(float(fa[3]) - float(fb[3])) <= SCORE_TOL, (a, b)
        else:
            assert a == b


# (flags, format check): every output format, sentence marks removed,
# references as plain text and as an MLF, and the batch route
FORMATS = {
    "verbose": ([], "verbose"),
    "verbose_mlf_refs_batch2": (["-batchSize", "2", "{MLF}"], "verbose"),
    "ref": (["-outputFormat", "ref"], "exact"),
    "trans_batch2": (["-outputFormat", "trans", "-batchSize", "2"], "exact"),
    "mlf_no_sent_marks": (["-outputFormat", "mlf", "-removeSentMarks"], "exact"),
    "xmlf": (["-outputFormat", "xmlf"], "xmlf"),
    "xmlf_no_sent_marks_batch2": (["-outputFormat", "xmlf", "-removeSentMarks",
                                   "-batchSize", "2"], "xmlf"),
}


@pytest.mark.parametrize("case", list(FORMATS))
def test_output_formats_equal_jax(task, tmp_path, case):
    flags, check = FORMATS[case]
    refs = "refs.mlf" if "{MLF}" in flags else "refs.txt"
    flags = [f for f in flags if f != "{MLF}"]
    jax_text, port_text = run_both(base_args(task, refs=refs) + mmf_args(task) + flags,
                                   str(tmp_path))
    if check == "verbose":
        assert without_timing(port_text) == without_timing(jax_text)
        assert "Word accuracy = 100.00%" in port_text
    elif check == "xmlf":
        assert_xmlf_equal(port_text, jax_text)
    else:
        assert port_text == jax_text


def read_lattice(path):
    rows = []
    with open(path) as fd:
        for line in fd:
            rows.append([float(x) if "." in x else int(x) for x in line.split()])
    return rows


def test_lattices_and_model_level_output_equal_jax(task, tmp_path):
    argv = base_args(task) + mmf_args(task) + ["-latticeDir", "{LAT}", "-outputFormat",
                                               "trans"]
    jax_text, port_text = run_both(argv, str(tmp_path))
    assert port_text == jax_text
    names = sorted(os.listdir(tmp_path / "jax_lat"))
    assert names == sorted(os.listdir(tmp_path / "port_lat")) and len(names) == len(UTTS)
    for n in names:
        a, b = read_lattice(tmp_path / "port_lat" / n), read_lattice(tmp_path / "jax_lat" / n)
        assert len(a) == len(b) > 0, n
        for ra, rb in zip(a, b):
            ints = [x for x in rb if isinstance(x, int)]
            assert [x for x in ra if isinstance(x, int)] == ints, (n, ra, rb)
            for x, y in zip(ra[len(ints):], rb[len(ints):]):
                assert abs(x - y) <= LAT_TOL, (n, ra, rb)
    out = tmp_path / "models"
    out.mkdir()
    jax_text, port_text = run_both(base_args(task) + mmf_args(task) + ["-modelLevelOutput"],
                                   str(out))
    assert without_timing(port_text) == without_timing(jax_text)
    assert "Actual :    sil ah k ae t sil" in port_text


OTF = {
    "pushing_scaled": ["-pushing", "-lmScaleFactor", "0.8", "-insPenalty", "-1"],
    "phi_batch2": ["-gramInSymsFName", "{GPHI}.insyms", "-batchSize", "2"],
}


@pytest.mark.parametrize("case", list(OTF))
def test_on_the_fly_composition_equals_jax(task, tmp_path, case):
    g = "gphi" if case.startswith("phi") else "g"
    flags = [f.replace("{GPHI}", os.path.join(task, "gphi")) for f in OTF[case]]
    argv = (base_args(task, fsm="cl") + mmf_args(task)
            + ["-gramFsmFName", os.path.join(task, f"{g}.fsm")] + flags)
    jax_text, port_text = run_both(argv, str(tmp_path))
    assert without_timing(port_text) == without_timing(jax_text)
    assert "Word accuracy = 100.00%" in port_text


def test_input_transforms_equal_jax(task, tmp_path):
    argv = base_args(task) + mmf_args(task) + [
        "-inputXformDir", os.path.join(task, "xforms"), "-speakerNamePattern", r"^(spk\w)_",
        "-outputFormat", "xmlf"]
    jax_text, port_text = run_both(argv, str(tmp_path))
    assert_xmlf_equal(port_text, jax_text)
    plain, _ = run_both(base_args(task) + mmf_args(task) + ["-outputFormat", "xmlf"],
                        str(tmp_path))
    assert plain != jax_text  # the transform changed spkA's scores


def test_hybrid_lna_equals_jax(task, tmp_path):
    def j(name):
        return os.path.join(task, name)

    argv = base_args(task) + ["-monoListFName", j("phones.lst"), "-priorsFName",
                              j("priors.txt"), "-statesPerModel", "5", "-inputFormat", "lna"]
    argv[argv.index("-inputFName") + 1] = j("lna.lst")
    for flags in ([], ["-batchSize", "2", "-outputFormat", "xmlf"]):
        jax_text, port_text = run_both(argv + flags, str(tmp_path))
        if flags:
            assert_xmlf_equal(port_text, jax_text)
        else:
            assert without_timing(port_text) == without_timing(jax_text)
            assert "Word accuracy = 100.00%" in port_text


def test_loop_on_stdin_equals_jax(task, tmp_path, capsys, monkeypatch):
    from juicer_tpu.harness import read_htk

    feats = np.concatenate([read_htk(os.path.join(task, f"{n}.mfc"))[0]
                            for n in ("spkA_u0",)])
    argv = base_args(task, refs=None) + mmf_args(task) + ["-loop", "-loopChunk", "7"]
    outs = []
    for run, extra in ((jax_juicer.main, []), (juicer.main, ["-device", "cpu"])):
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(feats.astype("<f4").tobytes())))
        assert run(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert outs[1].splitlines()[-1] == "final: <s> a cat </s>"


def test_models_io_test_and_test_sequences_equal_jax(task, tmp_path, capsys):
    argv = base_args(task) + mmf_args(task) + ["-doModelsIOTest", "-genTestSeqs",
                                               "-outputFormat", "ref"]
    jax_text, port_text, jax_out, port_out = run_both(argv, str(tmp_path), capsys)
    assert port_text == jax_text
    assert port_out == jax_out
    assert "modelsIOTest passed: 5 HMMs round-tripped" in port_out
    assert len(port_out.splitlines()) == 11


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_binary_caches_are_read_by_both_packages(task, tmp_path, writer):
    """-writeBinaryFiles: one package writes `final.fsm.npz` and
    `models.mmf.npz`; then the text sources are overwritten with garbage
    (dated before the caches), so the other package decodes only if it
    reads the caches."""
    td = str(tmp_path / "copy")
    shutil.copytree(task, td)
    argv = base_args(td) + mmf_args(td) + ["-outputFormat", "trans"]
    runs = {"jax": (jax_juicer.main, []), "port": (juicer.main, ["-device", "cpu"])}
    reader = "port" if writer == "jax" else "jax"
    first = os.path.join(td, "first.out")
    run, extra = runs[writer]
    assert run(argv + ["-writeBinaryFiles", "-outputFName", first] + extra) == 0
    for src in ("final.fsm", "models.mmf"):
        path = os.path.join(td, src)
        assert os.path.exists(path + ".npz")
        with open(path, "w") as fd:
            fd.write("garbage\n")
        st = os.stat(path + ".npz")
        os.utime(path, (st.st_atime - 10, st.st_mtime - 10))
    second = os.path.join(td, "second.out")
    run, extra = runs[reader]
    assert run(argv + ["-outputFName", second] + extra) == 0
    with open(first) as a, open(second) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flags", [["-refCore"], ["-mllrXformFile", "x.xf"],
                                   ["-regClassFile", "x.bc"], ["-inputFormat", "factory"],
                                   ["-audioDevice", "-", "-loop"]])
def test_flags_not_ported_exit_with_their_message(task, flags):
    with pytest.raises(SystemExit, match="not ported to juicer_tpu_torch yet"):
        juicer.main(base_args(task) + mmf_args(task) + flags + ["-device", "cpu"])


@pytest.mark.parametrize("flags", [["-parentXformDir", "{TD}"],
                                   ["-monoListFName", "{TD}/phones.lst", "-silMonophone", "sl"],
                                   ["-monoListFName", "{TD}/phones.lst", "-pauseMonophone",
                                    "sp"]])
def test_rejections_equal_the_jax_cli(task, flags):
    """-parentXformDir (rejected by the JAX CLI although it reads it
    further on; copied as it is) and monophones missing from the list."""
    argv = base_args(task) + mmf_args(task) + [f.replace("{TD}", task) for f in flags]
    with pytest.raises(SystemExit) as want:
        jax_juicer.main(argv)
    with pytest.raises(SystemExit) as got:
        juicer.main(argv + ["-device", "cpu"])
    assert str(got.value) == str(want.value) and str(got.value).startswith("juicer: ")


def test_cuda_without_a_card_exits_with_the_device_error(task):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        juicer.main(base_args(task) + mmf_args(task))


def test_run_reports_route_and_stages(task, tmp_path):
    report = juicer.run(base_args(task) + mmf_args(task)
                        + ["-device", "cpu", "-batchSize", "3",
                           "-outputFName", str(tmp_path / "o")])
    assert report.route == "route: plain frame loop (device cpu)"
    assert set(report.stages) == {"models", "fsm parse", "network", "artifact", "tables",
                                  "features", "decode", "output"}
    assert [len(r.words) for r in report.results] == [len(r.split()) for r in REFS]
