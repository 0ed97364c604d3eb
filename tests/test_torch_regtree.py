"""The port's model-space MLLR (`am/regtree.py`) against the JAX package.

The files of `tests/test_regtree.py` (an MMF of three models, a
two-class base-class file, a regression tree, a two-transform MLLRMEAN
set) and a 39-dimensional model set with random transforms from a seed
go through both packages on the same inputs:

  - every parser (item lists, base classes, regression tree, transform
    set) gives the same fields as the JAX one;
  - `component_classes` exactly;
  - `apply_mllr_means`, `apply_mllr_var`, `apply_mllr_cov` (with its
    feature transform) and `with_mean_transform` within TOL (1e-12) of
    the JAX results: both products run in float64, the port's one
    stacked product a class on the device (`device="cpu"` here);
  - the refusals: a multi-class MLLRCOV set raises NotImplementedError
    in both, and the CLI refuses -useHModels and -parentXformDir as the
    JAX CLI does.
"""

import numpy as np
import pytest
import torch

from juicer_tpu.am import AcousticModelSet as JaxModels
from juicer_tpu.am import regtree as jax_regtree
from juicer_tpu.am.mmf import MmfDef, MmfHmm, MmfMixture, MmfState, MmfTransMat, write_mmf
from juicer_tpu.cli import juicer as jax_juicer

from juicer_tpu_torch.am import AcousticModelSet
from juicer_tpu_torch.am import regtree
from juicer_tpu_torch.cli import juicer

from test_regtree import BASECLASS, MLLR, MMF, REGTREE

TOL = 1e-12
COV = MLLR.replace("MLLRMEAN", "MLLRCOV")
GLOBAL_COV = """~a "spk.cov"
<ADAPTKIND> BASE
<XFORMSET>
<XFORMKIND> MLLRCOV
<NUMXFORMS> 1
<LINXFORM> 1
<VECSIZE> 3
<BLOCKINFO> 1 3
<BLOCK> 1
<XFORM> 3 3
 1.2 0.3 0.0
 -0.2 1.1 0.1
 0.0 0.2 0.9
"""
BIG_BASE = """~b "big"
<NUMCLASSES> 3
<CLASS> 1 {(m0*,m1*).state[2-3].mix[1-2]}
<CLASS> 2 {*.state[4].mix[2-3], m2*.state[2]}
<CLASS> 3 {m3.state[2-4]}
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The small files of test_regtree, and a 39-dimensional set of 12
    models (3 emitting states, 3 components, two states shared) with a
    three-class base file and a three-transform MLLRMEAN set."""
    td = tmp_path_factory.mktemp("regtree")
    for name, text in (("models.mmf", MMF), ("global.base", BASECLASS), ("rtree", REGTREE),
                       ("spk.mllr", MLLR), ("spk.cov", COV), ("g.cov", GLOBAL_COV),
                       ("big.base", BIG_BASE), ("spk.var", MLLR.replace("MLLRMEAN", "MLLRVAR"))):
        (td / name).write_text(text)
    rng = np.random.default_rng(7)
    D = 39
    d = MmfDef()
    d.global_opts.vec_size = D
    shared = None
    for h in range(12):
        probs = np.zeros((5, 5))
        probs[0, 1] = 1
        for i in range(1, 4):
            probs[i, i] = probs[i, i + 1] = 0.5
        sts = [MmfState(mixtures=[MmfMixture(w, rng.normal(scale=3, size=D),
                                             rng.random(D) + 0.5)
                                  for w in (0.5, 0.3, 0.2)]) for _ in range(3)]
        shared = sts[0] if shared is None else shared
        if h % 5 == 4:
            sts[0] = shared  # a GMM shared by two models: the first one's class wins
        d.hmms.append(MmfHmm(f"m{h}", 5, sts, MmfTransMat(None, 5, probs)))
    write_mmf(d, str(td / "big.mmf"))
    xf = ""
    for k in (1, 2, 3):
        A = np.eye(D) + rng.normal(scale=0.05, size=(D, D))
        xf += (f"<LINXFORM> {k}\n<VECSIZE> {D}\n<OFFSET>\n<BIAS> {D}\n "
               + " ".join(repr(float(x)) for x in rng.normal(size=D))
               + f"\n<BLOCKINFO> 1 {D}\n<BLOCK> 1\n<XFORM> {D} {D}\n "
               + "\n ".join(" ".join(repr(float(x)) for x in r) for r in A) + "\n")
    (td / "big.mllr").write_text(
        '~a "big"\n<ADAPTKIND> TREE\n<BASECLASS> ~b "big"\n<REGTREE> ~r "rt"\n<XFORMSET>\n'
        "<XFORMKIND> MLLRMEAN\n<NUMXFORMS> 3\n" + xf
        + "<XFORMWGTSET>\n<CLASSXFORM> 1 2\n<CLASSXFORM> 2 1\n<CLASSXFORM> 3 3\n")
    return td


def both_models(td, name):
    return JaxModels.from_mmf(str(td / name)), AcousticModelSet.from_mmf(str(td / name))


def assert_models_close(got, want, tol=TOL):
    assert len(got.gmm_means) == len(want.gmm_means)
    for k in ("gmm_means", "gmm_vars", "gmm_log_weights"):
        for a, b in zip(getattr(got, k), getattr(want, k)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float64, k
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
    assert got.hmm_names == want.hmm_names
    for a, b in zip(got.hmm_gmm_inds, want.hmm_gmm_inds):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("text", ["{aa.state[2-4].mix[1-2]}",
                                  "{(a*,sil).state[2].mix[1]}, {*.state[3]}",
                                  "{x.state[2,4-5].mix[1,3]}",
                                  "{(ax,eh-b+d).state[2-4].stream[1].mix[1-12]}"])
def test_item_lists_equal_jax(text):
    got, want = regtree.parse_item_list(text), jax_regtree.parse_item_list(text)
    assert [(i.names, i.states, i.mixes) for i in got] == [
        (i.names, i.states, i.mixes) for i in want]
    for name in ("aa", "ax", "sil", "x", "bb", "eh-b+d"):
        for st in range(1, 7):
            for mix in range(1, 14):
                assert ([i.matches(name, st, mix) for i in got]
                        == [i.matches(name, st, mix) for i in want])


def test_bad_item_pattern_raises():
    for mod in (regtree, jax_regtree):
        with pytest.raises(ValueError, match="unsupported item pattern"):
            mod.parse_item_list("{aa}")


@pytest.mark.parametrize("name", ["global.base", "big.base"])
def test_base_classes_equal_jax(files, name):
    got = regtree.parse_baseclass(str(files / name))
    want = jax_regtree.parse_baseclass(str(files / name))
    for k in ("name", "mmf_id_mask", "parameters", "num_classes"):
        assert getattr(got, k) == getattr(want, k), k
    assert sorted(got.class_items) == sorted(want.class_items)
    for h in ("aa", "bb", "cc", "m0", "m2", "m3", "m11"):
        for st in range(2, 5):
            for mix in range(1, 4):
                assert got.class_of(h, st, mix) == want.class_of(h, st, mix)


def test_regression_tree_equals_jax(files):
    got = regtree.parse_regtree(str(files / "rtree"))
    want = jax_regtree.parse_regtree(str(files / "rtree"))
    assert (got.name, got.baseclass_name, got.children, got.node_classes) == (
        want.name, want.baseclass_name, want.children, want.node_classes)
    for node in (1, 2, 3):
        assert got.terminal_classes(node) == want.terminal_classes(node)


@pytest.mark.parametrize("name", ["spk.mllr", "spk.cov", "g.cov", "big.mllr"])
def test_transform_sets_equal_jax(files, name):
    got = regtree.parse_xformset(str(files / name))
    want = jax_regtree.parse_xformset(str(files / name))
    for k in ("name", "adapt_kind", "kind", "baseclass_name", "regtree_name", "class_to_xform"):
        assert getattr(got, k) == getattr(want, k), k
    assert sorted(got.xforms) == sorted(want.xforms)
    for n in got.xforms:
        a, b = got.xforms[n], want.xforms[n]
        assert np.array_equal(a.A, b.A) and np.array_equal(a.b, b.b) and a.logdet == b.logdet
    for c in range(5):
        assert (got.xform_for_class(c) is None) == (want.xform_for_class(c) is None)


def test_transform_set_without_linxform_raises(files, tmp_path):
    p = tmp_path / "empty.xf"
    p.write_text("~a \"x\"\n<XFORMSET>\n<XFORMKIND> MLLRMEAN\n")
    with pytest.raises(ValueError, match="no <LINXFORM>"):
        regtree.parse_xformset(str(p))


@pytest.mark.parametrize("mmf,base", [("models.mmf", "global.base"), ("big.mmf", "big.base")])
def test_component_classes_equal_jax(files, mmf, base):
    jm, pm = both_models(files, mmf)
    got = regtree.component_classes(pm, regtree.parse_baseclass(str(files / base)))
    want = jax_regtree.component_classes(jm, jax_regtree.parse_baseclass(str(files / base)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["small_classes", "small_global", "big_classes", "big_global"])
def test_apply_mllr_means_equals_jax(files, case):
    mmf, xf, base = (("models.mmf", "spk.mllr", "global.base") if case.startswith("small")
                     else ("big.mmf", "big.mllr", "big.base"))
    jm, pm = both_models(files, mmf)
    use_base = case.endswith("classes")
    got = regtree.apply_mllr_means(
        pm, regtree.parse_xformset(str(files / xf)),
        regtree.parse_baseclass(str(files / base)) if use_base else None, device="cpu")
    want = jax_regtree.apply_mllr_means(
        jm, jax_regtree.parse_xformset(str(files / xf)),
        jax_regtree.parse_baseclass(str(files / base)) if use_base else None)
    assert_models_close(got, want)
    # the input set is unchanged, and the kernel's packing follows the means
    assert_models_close(pm, jm)
    fp, fj = got.flat_params(np.float64), want.flat_params(np.float64)
    for k in ("V", "M", "b"):
        np.testing.assert_allclose(getattr(fp, k), getattr(fj, k), rtol=1e-12, atol=1e-9)


def test_with_mean_transform_equals_jax(files):
    jm, pm = both_models(files, "big.mmf")
    xs = regtree.parse_xformset(str(files / "big.mllr"))
    A, b = xs.xforms[3].A, xs.xforms[3].b
    assert_models_close(pm.with_mean_transform(A, b, device="cpu"),
                        jm.with_mean_transform(A, b))


@pytest.mark.parametrize("mmf,xf,base", [("models.mmf", "spk.var", "global.base"),
                                         ("big.mmf", "big.mllr", "big.base")])
def test_apply_mllr_var_equals_jax(files, mmf, xf, base):
    jm, pm = both_models(files, mmf)
    got = regtree.apply_mllr_var(pm, regtree.parse_xformset(str(files / xf)),
                                 regtree.parse_baseclass(str(files / base)), device="cpu")
    want = jax_regtree.apply_mllr_var(jm, jax_regtree.parse_xformset(str(files / xf)),
                                      jax_regtree.parse_baseclass(str(files / base)))
    assert_models_close(got, want)


def test_apply_mllr_cov_equals_jax(files):
    jm, pm = both_models(files, "models.mmf")
    got, gx = regtree.apply_mllr_cov(pm, regtree.parse_xformset(str(files / "g.cov")),
                                     device="cpu")
    want, wx = jax_regtree.apply_mllr_cov(jm, jax_regtree.parse_xformset(str(files / "g.cov")))
    assert_models_close(got, want)
    np.testing.assert_allclose(gx.A, wx.A, rtol=0, atol=TOL)
    assert np.array_equal(gx.b, wx.b) and abs(gx.logdet - wx.logdet) < TOL
    x = np.array([0.3, -0.2, 0.9])
    for g in range(pm.n_gmms):
        assert abs(got.score_gmm(g, gx.apply(x[None])[0]) - want.score_gmm(
            g, wx.A @ x + wx.b)) < 1e-9


def test_multi_class_cov_set_is_refused(files):
    for mod, models in ((regtree, both_models(files, "models.mmf")[1]),
                        (jax_regtree, both_models(files, "models.mmf")[0])):
        kw = dict(device="cpu") if mod is regtree else {}
        with pytest.raises(NotImplementedError, match="GLOBAL"):
            mod.apply_mllr_cov(models, mod.parse_xformset(str(files / "spk.cov")), **kw)


def test_cli_loads_adapted_models(files):
    """`load_models` + `adapt_models` of the port's CLI equal the JAX CLI's
    `load_models` with -mllrXformFile / -regClassFile."""
    argv = ["-lexFName", "x", "-fsmFName", "x", "-inSymsFName", "x", "-outSymsFName", "x",
            "-htkModelsFName", str(files / "big.mmf"), "-mllrXformFile",
            str(files / "big.mllr"), "-regClassFile", str(files / "big.base")]
    want = jax_juicer.load_models(jax_juicer.make_parser().parse_args(argv))
    args = juicer.make_parser().parse_args(argv)
    got = juicer.adapt_models(args, juicer.load_models(args), torch.device("cpu"))
    assert_models_close(got, want)


@pytest.mark.parametrize("flags", [["-useHModels"], ["-htkConfig", "h.cfg"],
                                   ["-parentXformDir", "p"]])
def test_cli_refuses_htklib_adaptation_as_jax(files, flags):
    argv = ["-lexFName", "x", "-fsmFName", "x", "-inSymsFName", "x", "-outSymsFName", "x",
            "-htkModelsFName", str(files / "big.mmf"), "-mllrXformFile",
            str(files / "big.mllr")] + flags
    with pytest.raises(SystemExit) as want:
        jax_juicer.main(argv)
    with pytest.raises(SystemExit) as got:
        juicer.main(argv + ["-device", "cpu"])
    assert str(got.value) == str(want.value)
