"""The decoder CLI's readers and writers in the port against the JAX package.

Every reader gets the same file in both packages and must give the same
thing: `read_fsm` (native and Python parsers, which must also agree with
each other) and `read_symbols` exactly; `DecoderNetwork.from_files` in
every array and marker at a non-default LM scale and insertion penalty,
auxiliary symbols removed on both sides or the input side only, and its
npz cache read by the other package; `parse_mmf` / `from_mmf` on an MMF
with ~o, ~v, ~t, ~s and ~h macros and <GCONST>, `flat_params` and the
topology bit for bit, `write_mmf` text byte for byte, hybrid sets and
the float64 oracle scores exactly; `Vocabulary` with the special-word
character and a silence word, `PhoneSet` (plain and Noway lists);
`GNetwork(lm_scale=0.8, phi_label=k)` on a G with both `#phi` and
epsilon backoffs, its arrays and its advance for every (state, word);
HTK and LNA features, `EditDistance` / `align`, CMLLR transforms with a
parent cascade, the batch tester's input and reference lists, the log's
environment tunables and `generate_sequences`' draws. Floats compare
exactly (`np.array_equal`) unless a tolerance is stated.
"""

import numpy as np
import pytest

from juicer_tpu.am import AcousticModelSet as JaxModels
from juicer_tpu.am import mmf as jax_mmf
from juicer_tpu.am import xform as jax_xform
from juicer_tpu.decoder import DecoderNetwork as JaxNetwork
from juicer_tpu.decoder.otf import GNetwork as JaxGNetwork
from juicer_tpu.fst import Fst as JaxFst
from juicer_tpu.fst import algos as jax_algos
from juicer_tpu.fst import io as jax_io
from juicer_tpu.harness import batch as jax_batch
from juicer_tpu.harness import editdist as jax_editdist
from juicer_tpu.harness import features as jax_features
from juicer_tpu import lexicon as jax_lexicon
from juicer_tpu.utils import log as jax_log

from juicer_tpu_torch.am import AcousticModelSet
from juicer_tpu_torch.am import mmf, xform
from juicer_tpu_torch.decoder import DecoderNetwork
from juicer_tpu_torch.decoder.otf import GNetwork
from juicer_tpu_torch.fst import Fst, algos, io
from juicer_tpu_torch.harness import batch, editdist, features
from juicer_tpu_torch import lexicon
from juicer_tpu_torch.utils import log

NET_ARRAYS = ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight", "row_ptr",
              "final_weight")
NET_SCALARS = ("n_states", "n_arcs", "init_state", "word_end_marker", "sil_marker",
               "sp_marker", "lm_scale", "ins_pen")


def assert_same_fst(port, ref):
    for a, b in zip(port.arcs_numpy(), ref.arcs_numpy()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (port.start, port.num_states, port.finals) == (ref.start, ref.num_states, ref.finals)


def assert_same_network(port, ref):
    for k in NET_ARRAYS:
        a, b = getattr(port, k), getattr(ref, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in NET_SCALARS:
        assert getattr(port, k) == getattr(ref, k), k


def random_fsm_text(seed, n_states=30, n_arcs=120, n_in=9, n_out=7):
    """An AT&T text FSM with weights of full float64 precision and of
    three decimals, weightless arcs, finals with and without weight, and
    lines both parsers skip."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_arcs):
        s = 3 if i < 4 else int(rng.integers(n_states))
        d, il, ol = (int(rng.integers(n_states)), int(rng.integers(n_in)),
                     int(rng.integers(n_out)))
        kind = i % 3
        w = "" if kind == 0 else (f" {rng.normal() * 5:.3f}" if kind == 1
                                  else f" {repr(float(rng.normal() * 7))}")
        lines.append(f"{s} {d} {il} {ol}{w}")
        if i == 50:
            lines.append("no numbers")  # skipped by both parsers
            lines.append("")
    lines += ["5", f"12 {rng.normal():.17g}", "29 1.5"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [0, 1])
def test_read_fsm_equals_jax(tmp_path, seed):
    p = tmp_path / "a.fsm"
    p.write_text(random_fsm_text(seed))
    native = io.read_fsm(str(p))
    python = io.read_fsm(str(p), use_native=False)
    assert isinstance(native.arc_src, np.ndarray)  # the parser's arrays
    assert native.start == 3 and native.num_arcs == 120
    assert_same_fst(native, python)
    for use_native in (True, False):
        assert_same_fst(io.read_fsm(str(p), use_native=use_native),
                        jax_io.read_fsm(str(p), use_native=use_native))
    with open(p) as fd:  # a file object takes the Python parser
        assert_same_fst(io.read_fsm(fd), python)


def test_read_and_write_symbols_equal_jax(tmp_path):
    p = tmp_path / "syms"
    # gaps, an exact duplicate, and the lexgen "#sil 0 / #sp 1" trailer
    p.write_text("<eps> 0\na 1\nb 2\n#1 5\nb 2\nbad line here\n#sil 0\n#sp 1\n")
    t, jt = io.read_symbols(str(p)), jax_io.read_symbols(str(p))
    assert list(t) == list(jt) and len(t) == len(jt) == 6
    assert [t.find(s) for s in ("a", "#1", "zz")] == [jt.find(s) for s in ("a", "#1", "zz")]
    assert [t.is_auxiliary(i) for i in range(6)] == [jt.is_auxiliary(i) for i in range(6)]
    io.write_symbols(t, str(tmp_path / "o1"))
    jax_io.write_symbols(jt, str(tmp_path / "o2"))
    assert (tmp_path / "o1").read_bytes() == (tmp_path / "o2").read_bytes()
    bad = tmp_path / "bad"
    bad.write_text("a 1\nb 1\n")
    with pytest.raises(ValueError, match="conflict"):
        io.read_symbols(str(bad))


def network_files(tmp_path):
    """An FSM over symbol tables that hold auxiliary symbols on both sides
    and the literal sil / sp models."""
    rng = np.random.default_rng(5)
    isy = ["<eps>", "aa", "sil", "bb", "sp", "#0", "#1"]
    osy = ["<eps>", "w1", "w2", "#2", "w3"]
    lines = []
    for i in range(80):
        s = 0 if i < 3 else int(rng.integers(20))
        lines.append(f"{s} {int(rng.integers(20))} {int(rng.integers(len(isy)))} "
                     f"{int(rng.integers(len(osy)))} {float(rng.normal()) * 3!r}")
    lines += ["4 0.25", "19"]
    (tmp_path / "n.fsm").write_text("\n".join(lines) + "\n")
    (tmp_path / "n.in").write_text("".join(f"{s} {i}\n" for i, s in enumerate(isy)))
    (tmp_path / "n.out").write_text("".join(f"{s} {i}\n" for i, s in enumerate(osy)))
    return [str(tmp_path / n) for n in ("n.fsm", "n.in", "n.out")]


@pytest.mark.parametrize("remove_aux", ["both", "input"])
def test_network_from_files_equals_jax(tmp_path, remove_aux):
    files = network_files(tmp_path)
    kw = dict(lm_scale=0.7, ins_pen=-2.5, remove_aux=remove_aux)
    port, ref = DecoderNetwork.from_files(*files, **kw), JaxNetwork.from_files(*files, **kw)
    assert_same_network(port, ref)
    assert port.sil_marker == 2 and port.sp_marker == 4 and port.word_end_marker == 7
    assert (port.arc_ilabel >= 5).sum() == 0  # input aux symbols became epsilon
    assert ((port.arc_olabel == 3).sum() == 0) == (remove_aux == "both")


def test_network_npz_is_read_by_both_packages(tmp_path):
    files = network_files(tmp_path)
    port = DecoderNetwork.from_files(*files, lm_scale=0.7, ins_pen=-2.5)
    ref = JaxNetwork.from_files(*files, lm_scale=0.7, ins_pen=-2.5)
    port.save_npz(str(tmp_path / "p.npz"))
    ref.save_npz(str(tmp_path / "j.npz"))
    assert_same_network(JaxNetwork.load_npz(str(tmp_path / "p.npz")), ref)
    assert_same_network(DecoderNetwork.load_npz(str(tmp_path / "j.npz")), ref)


def mmf_text(seed=3, D=4):
    """An MMF with the global options, a variance floor, a shared matrix,
    a shared two-mixture state, inline states with <GCONST> and an HMM with
    an inline matrix."""
    rng = np.random.default_rng(seed)

    def vec(v):
        return " ".join(repr(float(x)) for x in v)

    def mix_body(gconst=True):
        out = (f"<MEAN> {D}\n {vec(rng.normal(size=D) * 3)}\n<VARIANCE> {D}\n "
               f"{vec(rng.random(D) + 0.3)}\n")
        return out + (f"<GCONST> {rng.normal():.6e}\n" if gconst else "")

    tm = np.array([[0, 1, 0, 0, 0], [0, .6, .4, 0, 0], [0, 0, .7, .3, 0],
                   [0, 0, 0, .5, .5], [0, 0, 0, 0, 0]], dtype=float)
    tm_text = f"<TRANSP> 5\n" + "".join(f" {vec(r)}\n" for r in tm)
    out = (f'~o <STREAMINFO> 1 {D} <VECSIZE> {D} <NULLD><MFCC_D_A_Z><DIAGC>\n'
           f'~v "varFloor1"\n<VARIANCE> {D}\n {vec(np.full(D, 0.01))}\n'
           f'~t "T3"\n{tm_text}'
           f'~s "S_shared"\n<NUMMIXES> 2\n<MIXTURE> 1 0.25\n{mix_body()}'
           f'<MIXTURE> 2 0.75\n{mix_body(False)}')
    for name in ("aa", "bb", "sil"):
        out += f'~h "{name}"\n<BEGINHMM>\n<NUMSTATES> 5\n'
        for j in (2, 3, 4):
            out += f"<STATE> {j}\n"
            if j == 3:
                out += '~s "S_shared"\n'
            else:
                w = rng.random(3) + 0.1
                w /= w.sum()
                out += "<NUMMIXES> 3\n" + "".join(
                    f"<MIXTURE> {c + 1} {float(w[c])!r}\n{mix_body()}" for c in range(3))
        out += ('~t "T3"\n' if name != "sil" else tm_text) + "<ENDHMM>\n"
    return out


def test_mmf_parse_models_and_writer_equal_jax(tmp_path):
    p = tmp_path / "m.mmf"
    p.write_text(mmf_text())
    d, jd = mmf.parse_mmf(str(p)), jax_mmf.parse_mmf(str(p))
    assert vars(d.global_opts) == vars(jd.global_opts) and list(d.sh_states) == list(jd.sh_states)
    port, ref = AcousticModelSet.from_mmf(str(p)), JaxModels.from_mmf(str(p))
    assert port.hmm_names == ref.hmm_names and port.hmm_trans_ind == ref.hmm_trans_ind
    assert port.n_gmms == ref.n_gmms == 7 and len(port.trans_mats) == 2
    fp, fr = port.flat_params(), ref.flat_params()
    for k in ("V", "M", "b", "mask"):
        assert np.array_equal(getattr(fp, k), getattr(fr, k)), k
    for a, b in zip(port.packed_topology(), ref.packed_topology()):
        assert np.array_equal(a, b)
    x = np.random.default_rng(1).normal(size=4)
    assert np.array_equal(port.score_all(x), ref.score_all(x))
    assert [port.get_tee_log_prob(h) for h in range(3)] == [
        ref.get_tee_log_prob(h) for h in range(3)]
    assert port.calc_output(1, 2, x) == ref.calc_output(1, 2, x)
    mmf.write_mmf(d, str(tmp_path / "p.mmf"))
    jax_mmf.write_mmf(jd, str(tmp_path / "j.mmf"))
    assert (tmp_path / "p.mmf").read_bytes() == (tmp_path / "j.mmf").read_bytes()
    # the npz cache, each package reading the other's
    port.save_npz(str(tmp_path / "p.npz"))
    ref.save_npz(str(tmp_path / "j.npz"))
    for m in (JaxModels.load_npz(str(tmp_path / "p.npz")),
              AcousticModelSet.load_npz(str(tmp_path / "j.npz"))):
        assert np.array_equal(m.score_all(x), ref.score_all(x))


def test_hybrid_models_equal_jax(tmp_path):
    phones = ["aa", "bb", "sil"]
    priors = np.array([0.2, 0.5, 0.3])
    port = AcousticModelSet.hybrid(phones, priors, 5)
    ref = JaxModels.hybrid(phones, priors, 5)
    assert port.hybrid_mode and port.n_gmms == 3 and port.vec_size == 3
    assert np.array_equal(port.log_priors, ref.log_priors)
    for a, b in zip(port.packed_topology(), ref.packed_topology()):
        assert np.array_equal(a, b)
    x = np.log(np.array([0.1, 0.7, 0.2]))
    assert np.array_equal(port.score_all(x), ref.score_all(x))
    ref.save_npz(str(tmp_path / "h.npz"))
    back = AcousticModelSet.load_npz(str(tmp_path / "h.npz"))
    assert back.hybrid_mode and np.array_equal(back.log_priors, ref.log_priors)
    with pytest.raises(ValueError):
        port.flat_params()


def test_vocabulary_and_phone_set_equal_jax(tmp_path):
    lex = tmp_path / "lex"
    lex.write_text("# comment\n(also)\nzed(0.5) z eh d\nzed(0.5) z iy\n!sil sil\n"
                   "abc a b\n!noise n\n<s> sil\n</s> sil\n")
    args = (str(lex), "!", "<s>", "</s>", "<sil>")
    v, jv = lexicon.Vocabulary(*args), jax_lexicon.Vocabulary(*args)
    for k in ("words", "special", "n_pronuns", "sent_start_index", "sent_end_index",
              "sil_index"):
        assert getattr(v, k) == getattr(jv, k), k
    assert v.sil_index >= 0 and v.special[v.get_index("!noise")]
    plain = tmp_path / "plain"
    plain.write_text("aa\nbb x\n# c\nsil\nsp\n")
    noway = tmp_path / "noway"
    noway.write_text("3\n1 aa\n2 bb\n3 sil\n")
    for path in (plain, noway):
        ps, jps = lexicon.PhoneSet(str(path)), jax_lexicon.PhoneSet(str(path))
        assert ps.phones == jps.phones and len(ps) == len(jps)
        assert [ps.get_index(p) for p in ("sil", "zz")] == [jps.get_index(p)
                                                            for p in ("sil", "zz")]


def both_backoff_g():
    """A G whose states back off by epsilon and by #phi (label 9), with
    duplicate (state, word) arcs and finals, built in both packages."""
    rng = np.random.default_rng(7)
    arcs = []
    for s in range(1, 8):
        arcs.append((s, 0, 0 if s % 2 else 9, 0, float(rng.random() * 2)))
        for w in rng.choice(np.arange(1, 7), size=3, replace=False):
            arcs.append((s, int(rng.integers(1, 8)), int(w), int(w), float(rng.random() * 4)))
    for w in range(1, 7):
        arcs.append((0, int(rng.integers(1, 8)), w, w, float(rng.random() * 5)))
    arcs.append((3, 5, 2, 2, 0.125))  # a second arc for (3, word 2)
    out = []
    for cls in (Fst, JaxFst):
        f = cls()
        f.set_start(0)
        for a in arcs:
            f.add_arc(*a)
        f.set_final(0, 0.5)
        f.set_final(4, 1.25)
        out.append(f)
    return out


def test_gnetwork_scale_and_phi_equal_jax():
    f, jf = both_backoff_g()
    g, jg = GNetwork(f, lm_scale=0.8, phi_label=9), JaxGNetwork(jf, lm_scale=0.8, phi_label=9)
    for k in ("arc_il", "arc_dst", "arc_w", "row_ptr", "bo_dst", "bo_w", "final_w",
              "final_reach"):
        assert np.array_equal(getattr(g, k), getattr(jg, k)), k
    assert g.max_backoff == jg.max_backoff and (g.bo_dst[1:8] >= 0).all()
    for s in range(g.n_states):
        for w in range(1, 8):
            assert g.advance(s, w) == jg.advance(s, w), (s, w)
    with pytest.raises(ValueError, match="multiple backoff"):
        GNetwork(f, phi_label=0 + 2)  # word 2 arcs become backoffs too


def test_features_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(23, 7)).astype(np.float32)
    # the port writes the JAX writer's default header; both read any header
    features.write_htk(str(tmp_path / "p.htk"), x)
    jax_features.write_htk(str(tmp_path / "j.htk"), x)
    assert (tmp_path / "p.htk").read_bytes() == (tmp_path / "j.htk").read_bytes()
    jax_features.write_htk(str(tmp_path / "k.htk"), x, 200000, 6)
    got, jgot = features.read_htk(str(tmp_path / "k.htk")), jax_features.read_htk(
        str(tmp_path / "k.htk"))
    assert np.array_equal(got[0], x) and got[1:] == jgot[1:] == (200000, 6)
    lp = np.log(rng.dirichlet(np.ones(5), size=11)).astype(np.float32)
    features.write_lna(str(tmp_path / "p.lna"), lp)
    jax_features.write_lna(str(tmp_path / "j.lna"), lp)
    assert (tmp_path / "p.lna").read_bytes() == (tmp_path / "j.lna").read_bytes()
    assert np.array_equal(features.read_lna(str(tmp_path / "p.lna"), 5),
                          jax_features.read_lna(str(tmp_path / "p.lna"), 5))


def test_edit_distance_equals_jax():
    rng = np.random.default_rng(4)
    ed, jed = editdist.EditDistance(7, 7, 10), jax_editdist.EditDistance(7, 7, 10)
    for _ in range(40):
        hyp = list(rng.integers(0, 5, size=int(rng.integers(0, 9))))
        ref = list(rng.integers(0, 5, size=int(rng.integers(0, 9))))
        assert editdist.align(hyp, ref) == jax_editdist.align(hyp, ref)
        assert ed.distance(hyp, ref) == jed.distance(hyp, ref)
    assert ed.summary() == jed.summary()


XFORM = """~a "{name}"
<XFORMSET>
<XFORMKIND> CMLLR
<LINXFORM> 1
<VECSIZE> 4
<BIAS> 4
 {b}
<LOGDET> 0.5
<BLOCKINFO> 2 2 2
<BLOCK> 1
<XFORM> 2 2
 {a1}
<BLOCK> 2
<XFORM> 2 2
 {a2}
"""


def test_xforms_with_parent_cascade_equal_jax(tmp_path):
    rng = np.random.default_rng(6)
    for d in ("spk", "par"):
        (tmp_path / d).mkdir()
        for s in ("s1", "s2"):
            vals = [" ".join(repr(float(v)) for v in rng.normal(size=n)) for n in (4, 4, 4)]
            (tmp_path / d / f"{s}.xf").write_text(
                XFORM.format(name=s, b=vals[0], a1=vals[1], a2=vals[2]))
    (tmp_path / "spk" / "s2.xf").unlink()  # s2: the parent's transform alone
    x = rng.normal(size=(6, 4))
    p = xform.parse_xform(str(tmp_path / "par" / "s1.xf"))
    jp = jax_xform.parse_xform(str(tmp_path / "par" / "s1.xf"))
    assert np.array_equal(p.A, jp.A) and np.array_equal(p.b, jp.b) and p.logdet == jp.logdet
    sx = xform.SpeakerXforms(str(tmp_path / "spk"), "xf", r"^(s\d)_",
                             parent=xform.SpeakerXforms(str(tmp_path / "par"), ".xf", r"^(s\d)_"))
    jsx = jax_xform.SpeakerXforms(
        str(tmp_path / "spk"), "xf", r"^(s\d)_",
        parent=jax_xform.SpeakerXforms(str(tmp_path / "par"), ".xf", r"^(s\d)_"))
    for utt in ("s1_a", "s2_b", "s3_c"):
        a, b = sx.for_utterance(utt), jsx.for_utterance(utt)
        assert (a is None) == (b is None) == (utt == "s3_c")
        if a is not None:
            assert np.array_equal(a.apply(x), b.apply(x)) and a.logdet == b.logdet


def test_batch_tester_lists_equal_jax(tmp_path):
    lst = tmp_path / "in.lst"
    lst.write_text("u1=/a/b/x.mfc[3,40]\n/c/y.htk\n\nz.mfc\n")
    specs, jspecs = (batch.BatchTester.read_input_list(str(lst)),
                     jax_batch.BatchTester.read_input_list(str(lst)))
    fields = ("name", "path", "start_frame", "end_frame")
    assert ([[getattr(s, f) for f in fields] for s in specs]
            == [[getattr(s, f) for f in fields] for s in jspecs])
    index = {"a": 0, "cat": 1, "</s>": 2}.get
    mlf = tmp_path / "r.mlf"
    mlf.write_text('#!MLF!#\n"*/x.lab"\na\n0 100 cat -3.5\n.\n"*/y.rec"\ndog\n.\n')
    plain = tmp_path / "r.txt"
    plain.write_text("a cat\ncat </s>\nq\n")
    for path in (mlf, plain):
        assert (batch.BatchTester.read_references(str(path), specs, lambda w: index(w, -1))
                == jax_batch.BatchTester.read_references(str(path), jspecs,
                                                         lambda w: index(w, -1)))


def test_log_file_and_env_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_MAX_INSTS", "77")
    monkeypatch.setenv("JTPU_EXPAND_BUDGET", "not a number")
    for mod in (log, jax_log):
        assert mod.get_env("MAX_INSTS", 8192) == 77
        assert mod.get_env("EXPAND_BUDGET", 32768) == 32768
        assert mod.get_env("MISSING", 1.5) == 1.5
    path = tmp_path / "x.log"
    log.LogFile.open(str(path))
    log.LogFile.printf("%s=%d\n", "a", 3)
    log.LogFile.close()
    text = path.read_text().splitlines()
    assert text[0].startswith("started ") and text[1].startswith("host ") and text[2] == "a=3"


@pytest.mark.parametrize("seed", [0, 5])
def test_generate_sequences_equals_jax(tmp_path, seed):
    p = tmp_path / "a.fsm"
    p.write_text(random_fsm_text(seed + 1, n_states=12, n_arcs=50))
    got = algos.generate_sequences(io.read_fsm(str(p)), 10, max_len=200, seed=seed)
    want = jax_algos.generate_sequences(jax_io.read_fsm(str(p)), 10, max_len=200, seed=seed)
    assert got == want and len(got) > 0
