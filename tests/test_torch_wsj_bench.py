"""The port's reference-scale tools against the JAX package's scripts, on
the CPU: `juicer_tpu_torch/harness/{wsj_bench,wsj_otf,bench_otf}.py`
against `scripts/{wsj_bench,wsj_otf,bench_otf}.py`.

- The task generator and the models are held to the tracked caches
  `scripts/_wsj_cache_{2k,20k}`: text files byte for byte, every array of
  `bigram.npz` and of the model files equal. The mismatched models and the
  utterance sampler (bigram walk and free text) equal the JAX functions'.
- On the 2k task at a small size (a few utterances of ~150 frames), the
  bench's JSON line (tuned K and E, accuracy) and `steady_bench`'s
  overflow counts equal the JAX script's, on the static network and on
  the on-the-fly (OTF) pair (`wsj_otf`'s bench, with a G); an OTF decode
  and `bench_otf --quick` give the JAX decoder's words, scores within
  1e-4 (float32, the OTF tests' tolerance).

The JAX scripts are imported by path and given in-memory artifacts: their
own `ensure_artifact` writes under `scripts/`, which no test may do. The
JAX side reads the tracked files only; the port writes into temporary
directories (and its artifact cache, `juicer_tpu_torch/_cache/`).
"""

import importlib.util
import io
import json
import os
import shutil
import sys
import zipfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from juicer_tpu.am import AcousticModelSet as JaxModels
from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.network import DecoderNetwork as JaxNetwork
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.ops.gmm import make_gmm_scorer as jax_gmm_scorer

from juicer_tpu_torch.am.models import AcousticModelSet
from juicer_tpu_torch.decoder import TorchDecoderConfig
from juicer_tpu_torch.decoder.artifact import DecoderArtifact
from juicer_tpu_torch.decoder.autotune import pad_batch
from juicer_tpu_torch.harness import bench_otf, wsj_bench, wsj_otf, wsj_task
from juicer_tpu_torch.ops.gmm import make_gmm_scorer

from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-4
TASKS = {"2k": (2000, 100_000), "20k": (20000, 120_000)}


def jax_script(name):
    """`scripts/<name>.py` as a module (it puts `scripts/` on sys.path to
    import its siblings, as it does when run)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same_npz(got_path, want_path):
    """The same arrays under the same names: every member of the two npz
    archives (an array's .npy bytes: dtype, shape and data) equal."""
    with zipfile.ZipFile(got_path) as g, zipfile.ZipFile(want_path) as w:
        assert sorted(g.namelist()) == sorted(w.namelist())
        for name in w.namelist():
            assert g.read(name) == w.read(name), name


@pytest.fixture(scope="module")
def task2k(tmp_path_factory):
    """The tracked 2k task for both packages: the port's artifact (built by
    the port, cached in `_cache/`) and the JAX one read from the port's npz
    (the same format), so neither writes under `scripts/`."""
    cache = wsj_task.task_dir("2k")
    net, models = wsj_bench.ensure_task(cache, 2000, 100_000)
    art = wsj_bench.ensure_artifact(cache, net, models, verbose=False)
    path = str(tmp_path_factory.mktemp("art") / "art.npz")
    art.save_npz(path)
    jnet = JaxNetwork.load_npz(os.path.join(cache, "clg.npz"))
    jmodels = JaxModels.load_npz(os.path.join(cache, "models.npz"))
    return dict(cache=cache, net=net, models=models, art=art, jnet=jnet, jmodels=jmodels,
                jart=JaxArtifact.load_npz(path, jnet, jmodels))


def run_main(main, argv):
    """Run a script's `main` with `argv` (JAX: through sys.argv); its
    stdout, and the JSON object of its last line."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["script"] + argv
    try:
        with redirect_stdout(out):
            main() if main.__module__.startswith("_jax_script_") else main(argv)
    finally:
        sys.argv = saved
    text = out.getvalue()
    return text, json.loads(text.strip().splitlines()[-1])


# ---- the task and its models --------------------------------------------------


@pytest.mark.parametrize("name", list(TASKS))
def test_gen_task_files_rebuilds_the_tracked_task(tmp_path, name):
    n_words, n_bigrams = TASKS[name]
    phones = wsj_bench.gen_task_files(str(tmp_path), n_words, n_bigrams, 45, 7)
    assert phones == [f"p{i:02d}" for i in range(45)]
    tracked = wsj_task.task_dir(name)
    for f in ("phones.lst", "lex.dict", "lm.arpa"):
        with open(tmp_path / f, "rb") as a, open(os.path.join(tracked, f), "rb") as b:
            assert a.read() == b.read(), f
    assert_same_npz(str(tmp_path / "bigram.npz"), os.path.join(tracked, "bigram.npz"))


MODEL_SETS = [("2k", 1.2), ("2k", 0.6), ("2k", 0.8), ("20k", 1.2), ("20k", 0.35),
              ("20k", 0.5), ("20k", 0.7)]


@pytest.mark.parametrize("name,cs", MODEL_SETS)
def test_models_equal_the_tracked_model_sets(tmp_path, name, cs):
    """`build_models` (the task's models.npz, centre scale 1.2) and
    `ensure_models` (the other scales, built in a task directory holding
    only phones.lst) write the tracked file's arrays."""
    tracked = wsj_task.task_dir(name)
    shutil.copy(os.path.join(tracked, "phones.lst"), tmp_path)
    if cs == 1.2:
        phones = [f"p{i:02d}" for i in range(45)]
        wsj_bench.build_models(str(tmp_path), phones, 3, 8, 39, cs, 7)
        fname = "models.npz"
    else:
        wsj_bench.ensure_models(str(tmp_path), cs)
        fname = f"models_cs{cs:g}.npz"
        # a second call reads the file it wrote
        again = wsj_bench.ensure_models(str(tmp_path), cs)
        assert np.array_equal(again.gmm_means[5], AcousticModelSet.load_npz(
            os.path.join(tracked, fname)).gmm_means[5])
    assert_same_npz(str(tmp_path / fname), os.path.join(tracked, fname))


def test_tracked_task_is_read_not_written():
    """A model set of a tracked task that is not tracked goes to the
    port's cache, never under scripts/."""
    cache = wsj_task.task_dir("2k")
    assert wsj_task.writable_dir(cache) == os.path.join(wsj_task.ARTIFACT_CACHE, "_wsj_cache_2k")
    assert wsj_task.artifact_file(cache) == os.path.join(wsj_task.ARTIFACT_CACHE,
                                                         "2k_artifact.npz")
    assert wsj_bench.default_cache(2000) == cache
    assert wsj_bench.default_cache(5000) == os.path.join(wsj_task.ARTIFACT_CACHE,
                                                         "_wsj_cache_5k")
    with pytest.raises(ValueError, match="scripts/"):
        wsj_bench.ensure_task(os.path.join(ROOT, "scripts", "_wsj_cache_3k"), 3000, 100_000)


def test_mismatch_models_equal_jax(task2k):
    jwb = jax_script("wsj_bench")
    got = wsj_bench.mismatch_models(task2k["models"], 1.5, seed=23)
    want = jwb.mismatch_models(task2k["jmodels"], 1.5, seed=23)
    assert len(got.gmm_means) == len(want.gmm_means)
    for g, w in zip(got.gmm_means, want.gmm_means):
        assert np.array_equal(g, w)
    assert got.gmm_vars is task2k["models"].gmm_vars
    assert wsj_bench.mismatch_models(task2k["models"], 0.0) is task2k["models"]


@pytest.mark.parametrize("free_text", [False, True])
@pytest.mark.parametrize("name", list(TASKS))
def test_sample_utterances_equal_jax(name, free_text):
    jwb = jax_script("wsj_bench")
    cache = wsj_task.task_dir(name)
    models = AcousticModelSet.load_npz(os.path.join(cache, "models.npz"))
    jmodels = JaxModels.load_npz(os.path.join(cache, "models.npz"))
    got = wsj_task.sample_utterances(cache, models, n_utts=3, target_frames=300, seed=11,
                                     free_text=free_text)
    want = jwb.sample_utterances(
        cache, jmodels, (os.path.join(cache, "phones.lst"), os.path.join(cache, "lex.dict")),
        n_utts=3, target_frames=300, seed=11, free_text=free_text)
    for (gw, gf), (ww, wf) in zip(got, want):
        assert gw == ww
        assert gf.dtype == wf.dtype and np.array_equal(gf, wf)


# ---- the bench on the 2k task ----------------------------------------------------

QUICK = ["--quick", "--batch", "2", "--frames", "150", "--K", "512", "--E", "1024",
         "--beam", "70", "--end-beam", "50", "--maxhyps", "500", "--cpu"]


def test_bench_main_on_the_cpu():
    """`--quick` at a small size: the JSON line with the route and device,
    the lattices hold the 1-best and the transcripts, the float32 engine
    matches the oracle's words, and --parity-only holds the float64
    engine to the oracle (words exact, score within 1e-6). The tuning and
    accuracy loop is held to the JAX script's by the sweep's test."""
    text, got = run_main(wsj_bench.main, QUICK + ["--lattice"])
    assert got["metric"] == "wsj_e2e_frames_per_sec_chip" and got["accuracy"] == 1.0
    assert got["route"] == "frame_step" and got["device"] == "cpu"
    assert got["n_arcs"] == 1617510 and got["K"] <= 512 and got["E"] <= 1024
    assert "best-path 2/2, coverage 2/2" in text
    assert text.count("words exact (f32 engine vs f64 oracle") == 2
    out = io.StringIO()
    with redirect_stdout(out):
        assert wsj_bench.main(QUICK + ["--parity-only"]) == 0
    assert out.getvalue().count("words exact, score diff") == 2


def test_steady_bench_overflow_equals_jax(task2k):
    """The overflow count of each benched wave equals the JAX bench's, on
    budgets that bind for some utterances (the sweep's test holds the
    bench of budgets that do not); each record names its route."""
    jwb = jax_script("wsj_bench")
    cache = task2k["cache"]
    K, E = 128, 256
    utts = wsj_task.sample_utterances(cache, task2k["models"], 3, 150, seed=11)
    scores = [make_gmm_scorer(task2k["models"].flat_params(), device="cpu")(torch.as_tensor(f))
              for _, f in utts]
    db = pad_batch(scores)
    beams = dict(emit_prune_win=60.0, phone_end_prune_win=40.0, word_prune_win=40.0,
                 max_emit_hyps=300, max_insts=K, expand_budget=E, final_budget=1024)
    got = wsj_bench.steady_bench(task2k["art"], TorchDecoderConfig(**beams), db, [2, 4],
                                 device="cpu")
    want = jwb.steady_bench(task2k["jart"], TpuDecoderConfig(**beams), jnp.asarray(db.numpy()),
                            [2, 4])
    assert {B: r["overflow"] for B, r in got.items()} == {B: r["overflow"]
                                                         for B, r in want.items()}
    assert all(r["route"] == "frame_step" for r in got.values())
    assert 0 < got[4]["overflow"] < 4


# ---- on-the-fly composition ---------------------------------------------------------


def assert_results_match(got, want, ctx):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.words == list(w.words), (ctx, i)
        assert [h.end_frame for h in g.word_hyps] == [h.end_frame for h in w.word_hyps]
        assert abs(g.score - float(w.score)) < SCORE_TOL, (ctx, i, g.score, w.score)
        assert bool(g.overflow) == bool(w.overflow), (ctx, i)


@pytest.fixture(scope="module")
def otf2k(task2k):
    """The 2k pair (CL from cl.npz, G from lm.arpa) of both packages: the
    port's through `wsj_otf`, the JAX one through the script's own
    `ensure_cl` (which reads the tracked cl.npz) and its CL artifact."""
    from juicer_tpu.compile import GramGen, GramType
    from juicer_tpu.decoder.otf import GNetwork as JaxGNetwork

    cache = task2k["cache"]
    cl_net, lexicon = wsj_otf.ensure_cl(cache)
    g_net = wsj_otf.build_g(cache, lexicon)
    jcl, jlex = jax_script("wsj_otf").ensure_cl(cache)
    jg = JaxGNetwork(GramGen(jlex.vocab, GramType.NGRAM,
                             lm_fname=os.path.join(cache, "lm.arpa")).build())
    return dict(cl=cl_net, g=g_net, art=DecoderArtifact(cl_net, task2k["models"]), jg=jg,
                jart=JaxArtifact.load_npz(os.path.join(cache, "cl_artifact.npz"), jcl,
                                          task2k["jmodels"]))


def test_otf_decode_equals_jax(task2k, otf2k):
    """`wsj_otf`'s pieces on the 2k pair: tuned on the port, decoded at
    those budgets by the port and by `TpuDecoder(g_network=)` on the JAX
    script's own pair and utterances: words, word-end frames and overflow
    equal, scores within 1e-4; the oracle agrees. (The tuner itself is
    held to the JAX tuner's with a G by `test_torch_otf.py`.)"""
    cache = task2k["cache"]
    cpu = torch.device("cpu")
    cl_net, g_net, art = otf2k["cl"], otf2k["g"], otf2k["art"]
    utts = wsj_task.sample_utterances(cache, task2k["models"], 2, 150, seed=11)
    scores = [make_gmm_scorer(task2k["models"].flat_params(), device="cpu")(torch.as_tensor(f))
              for _, f in utts]
    beams = dict(emit_prune_win=85.0, phone_end_prune_win=60.0, word_prune_win=60.0,
                 max_emit_hyps=800, final_budget=1024)
    tuned = wsj_otf.tune(art, scores, TorchDecoderConfig(max_insts=512, expand_budget=1024,
                                                         **beams), g_net, cpu)
    dec, results, ed, route = wsj_otf.decode_batch(art, tuned, g_net, utts, scores, cache, cpu)
    assert route.startswith("plain loop: on-the-fly composition")
    assert ed.accuracy == 1.0
    assert wsj_otf.parity(dec, cl_net, g_net, task2k["models"], scores[:1]) == 1

    jscorer = jax_gmm_scorer(task2k["jmodels"].flat_params())
    jutts = jax_script("wsj_bench").sample_utterances(
        cache, task2k["jmodels"],
        (os.path.join(cache, "phones.lst"), os.path.join(cache, "lex.dict")), 2, 150, 11)
    jdec = TpuDecoder(otf2k["jart"], TpuDecoderConfig(max_insts=tuned.max_insts,
                                                      expand_budget=tuned.expand_budget,
                                                      **beams),
                      g_network=otf2k["jg"])
    want = [jdec.decode_scores(np.asarray(jscorer(jnp.asarray(f)))) for _, f in jutts]
    assert_results_match(results, want, "otf")


def test_otf_steady_bench_overflow_equals_jax(task2k, otf2k):
    """`wsj_otf`'s steady bench, `steady_bench(g_network=)` on the 2k pair
    at (arc, G state) budgets that bind for one of the four tiled
    utterances: the benched wave's overflow count equals the JAX bench's
    with a G, and the record names the plain loop and its reason."""
    utts = wsj_task.sample_utterances(task2k["cache"], task2k["models"], 3, 150, seed=11)
    scores = [make_gmm_scorer(task2k["models"].flat_params(), device="cpu")(torch.as_tensor(f))
              for _, f in utts]
    db = pad_batch(scores)
    beams = dict(emit_prune_win=85.0, phone_end_prune_win=60.0, word_prune_win=60.0,
                 max_emit_hyps=800, max_insts=256, expand_budget=512, final_budget=1024)
    got = wsj_bench.steady_bench(otf2k["art"], TorchDecoderConfig(**beams), db, [4],
                                 g_network=otf2k["g"], device="cpu")
    want = jax_script("wsj_bench").steady_bench(
        otf2k["jart"], TpuDecoderConfig(**beams), jnp.asarray(db.numpy()), [4],
        g_network=otf2k["jg"])
    assert got[4]["overflow"] == want[4]["overflow"]
    assert 0 < got[4]["overflow"] < 4
    assert got[4]["route"].startswith("plain loop: on-the-fly composition")


def test_bench_otf_quick_equals_jax():
    """`bench_otf --quick`: certified with and without pushing, and each
    distinct utterance's diagnostics decode equals the JAX decoder's."""
    from juicer_tpu.decoder.artifact import DecoderArtifact as JA

    jbo = jax_script("bench_otf")
    out = bench_otf.run(quick=True, device="cpu")
    assert out["route"].startswith("plain loop: on-the-fly composition")
    p = bench_otf.QUICK
    jtask, jcl, jg = jbo.build(p["n_words"], p["n_phones"], p["vec"])
    jart = JA(jcl, jtask.models)
    jscorer = jax_gmm_scorer(jtask.models.flat_params())
    distinct, _ = bench_otf.features(jtask, p["n_words"], p["B"], p["T"])
    for name, pushing in (("otf", False), ("otf (pushing)", True)):
        fps, certified, results = out[name]
        assert certified and fps > 0
        jdec = TpuDecoder(jart, TpuDecoderConfig(otf_pushing=pushing, emit_diagnostics=True,
                                                 **bench_otf.BUDGETS, **bench_otf.BEAMS),
                          g_network=jg)
        want = [jdec.decode_scores(np.asarray(jscorer(jnp.asarray(f)))) for f in distinct]
        assert_results_match(results, want, name)
