"""The cross-word triphone path of the port on the CPU: the tied-state
model generator (`harness/tri_models.py`), a tiny cross-word task built by
the port's toolchain and decoded against the references (the JAX
package's oracle and engine, the port's oracle, the benchmark's), the tracked
`20k-tri1` task, and the frame-step kernel's shared memory at that
task's operating point.

The benchmark's reference (`port_bench/pb`) is imported as its own tests
import it, with `port_bench/` put first on `sys.path`; its tiny task
writer comes from `port_bench/tests/conftest.py`."""

import hashlib
import importlib.util
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from juicer_tpu.am.models import AcousticModelSet as JaxModels
from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.network import DecoderNetwork as JaxNetwork
from juicer_tpu.decoder.ref_core import RefDecoder as JaxRefDecoder
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig

from juicer_tpu_torch.am.models import AcousticModelSet
from juicer_tpu_torch.decoder import fused_scan
from juicer_tpu_torch.decoder.artifact import DecoderArtifact
from juicer_tpu_torch.decoder.core import TorchDecoder, TorchDecoderConfig
from juicer_tpu_torch.decoder.network import DecoderNetwork
from juicer_tpu_torch.decoder.ref_core import RefDecoder
from juicer_tpu_torch.harness import tri_models, wsj_task
from juicer_tpu_torch.harness.tri_models import make_tied_set, split_targets
from juicer_tpu_torch.ops.gmm import make_gmm_scorer
from juicer_tpu_torch.parallel.mesh import BatchDecoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "port_bench")
sys.path.insert(0, BENCH)

from pb import reference, traffic  # noqa: E402
from pb.task import Lexicon, Models, Network  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "pb_tests_conftest", os.path.join(BENCH, "tests", "conftest.py"))
pb_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pb_conftest)

TRI = "20k-tri1"
CONFIG = os.path.join(BENCH, "configs", "wsj20k-tri1.json")
# SHA-256 of the 20k task's shared files, which the triphone task copies
SHARED_SHA256 = {
    "phones.lst": "30f0b3ed293cd9b3f795413e18febcddf71c8a33fc99b93c5c810fcdd6c89a9f",
    "lex.dict": "f13ffc91dd43497b56f6eda84275f93a14da3fd8438da3b9b03e1d382ea44180",
    "lm.arpa": "e2a10081912754d975e63bc6e4afb5221591596d679bdeb48e4999d438ed605c",
    "bigram.npz": "4c7f2d59d5eed183c861c6920b8775a3986d5e704a8a55d1f18aec8a8c12f5de",
}
TINY = dict(n_states=24, n_gauss=60, vec_size=39, seed=11)
# the tiny task's search: the benchmark's beams, budgets no utterance reaches
POINT = dict(beam=70.0, end_beam=40.0, maxhyps=500, K=128, E=256, F=64)


def sha256(path):
    with open(path, "rb") as fd:
        return hashlib.sha256(fd.read()).hexdigest()


def phones_of(td):
    with open(os.path.join(td, "phones.lst")) as fd:
        return [line.strip() for line in fd if line.strip()]


def tied_map(lines):
    """logical -> physical of the tied list's lines; and the physical ones."""
    out, physical = {}, set()
    for line in lines:
        parts = line.split()
        out[parts[0]] = parts[-1]
        if len(parts) == 1:
            physical.add(parts[0])
    return out, physical


# -- (a) the generator ---------------------------------------------------------


def test_split_targets_is_kaldis_rule():
    """One Gaussian a state, then each to the largest occ^power over its
    count, ties to the lowest state: step by step against the rule."""
    rng = np.random.default_rng(0)
    occs = np.exp(rng.normal(0, 2, 37))
    occs[5] = occs[6]  # a tie
    got = split_targets(occs, 200, 0.25)
    want = np.ones(37, np.int64)
    w = occs ** 0.25
    for _ in range(200 - 37):
        want[int(np.argmax(w / want))] += 1
    assert np.array_equal(got, want) and got.sum() == 200


@pytest.mark.parametrize("size", ["tiny", "tri1"])
def test_tied_set_follows_its_rules(size):
    """Every `l-p+r` with `sil` contexts is listed, each physical model on
    a line of its own and every tie to one; state 1 follows the left
    context alone, state 3 the right alone; sp is sil's centre state; the
    tied states and Gaussians are the counts asked for, every mixture of
    1 to C_max components and C_max within the GMM kernel's limit."""
    if size == "tiny":
        phones, kw = ["a", "b", "c", "sil", "sp"], TINY
    else:
        phones, kw = phones_of(wsj_task.task_dir("20k")), {}
    ts = make_tied_set(phones, **kw)
    n_states = kw.get("n_states", 2000)
    n_gauss = kw.get("n_gauss", 10000)
    base = [p for p in phones if p not in ("sil", "sp")]
    ctx = base + ["sil"]
    ms = ts.models
    assert ms.n_gmms == n_states and ms.vec_size == kw.get("vec_size", 39)
    assert int(ts.gaussians.sum()) == n_gauss == sum(len(m) for m in ms.gmm_means)
    assert ts.gaussians.min() >= 1 and ts.gaussians.max() <= 32
    assert [len(m) for m in ms.gmm_means] == ts.gaussians.tolist()
    assert len(set(ts.gaussians.tolist())) > 1  # the mixtures vary
    tied, physical = tied_map(ts.tied_lines)
    logical = {f"{l}-{p}+{r}" for p in base for l in ctx for r in ctx}
    assert set(tied) == logical | {"sil", "sp"} and len(ts.tied_lines) == len(tied)
    assert ts.n_logical == len(logical) and ts.n_physical == len(physical) - 2
    assert set(tied.values()) == physical == set(ms.hmm_names)
    sil, sp = ms.get_hmm_index("sil"), ms.get_hmm_index("sp")
    assert ms.get_num_states(sp) == 3 and ms.get_tee_log_prob(sp) > -1e29
    assert ms.hmm_gmm_inds[sp].tolist() == [ms.hmm_gmm_inds[sil][1]]
    used = np.concatenate(ms.hmm_gmm_inds)
    assert set(used.tolist()) == set(range(n_states))
    states = {n: tuple(ms.hmm_gmm_inds[ms.get_hmm_index(tied[n])]) for n in logical}
    assert len({states[tied[n]] for n in logical}) == ts.n_physical  # a triple a model
    for p in base:
        for l in ctx:
            assert len({states[f"{l}-{p}+{r}"][0] for r in ctx}) == 1
        for r in ctx:
            assert len({states[f"{l}-{p}+{r}"][2] for l in ctx}) == 1
    # each (phone, position) holds its own tied states
    owners = {}
    for n, st in states.items():
        p = n.split("-")[1].split("+")[0]
        for j, g in enumerate(st):
            assert owners.setdefault(g, (p, j)) == (p, j)
    assert make_tied_set(phones, **kw).tied_text == ts.tied_text


def test_tied_set_refuses_too_few_states():
    with pytest.raises(ValueError, match="too few"):
        make_tied_set(["a", "b", "sil", "sp"], n_states=8, n_gauss=100)
    with pytest.raises(ValueError, match="empty"):
        make_tied_set(["a", "b", "sil", "sp"], n_states=3 + 6 * 4, n_gauss=100)


# -- (b) a tiny cross-word task built by the port's toolchain ------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The benchmark's tiny triphone task (3 phones, a one-state sp tee, 6
    words) with the generator's tied list and models, and its CLG built
    by `wsj_task.build_task_clg` with the cross-word C over the list."""
    td = pb_conftest.write_tri_task(tmp_path_factory.mktemp("tri"))
    ts = make_tied_set(phones_of(td), **TINY)
    with open(os.path.join(td, "tied.lst"), "w") as fd:
        fd.write(ts.tied_text)
    ts.models.save_npz(os.path.join(td, "models.npz"))
    f = wsj_task.build_task_clg(wsj_task.task_lexicon(td), os.path.join(td, "lm.arpa"),
                                verbose=False, tied_list=os.path.join(td, "tied.lst"),
                                hmm_names=ts.models.hmm_names)
    net = DecoderNetwork(f, f.isyms, f.osyms)
    net.save_npz(os.path.join(td, "clg.npz"))
    models = AcousticModelSet.load_npz(os.path.join(td, "models.npz"))
    pmodels, lex = Models(os.path.join(td, "models.npz")), Lexicon(td)
    mix = dict(pb_conftest.TRI_MIX, pool=8)
    pool = traffic.make_pool(td, pmodels, lex, mix, "xwrdtri")
    return types.SimpleNamespace(td=td, ts=ts, net=net, models=models, pmodels=pmodels,
                                 lex=lex, pool=pool)


def jax_task(tiny):
    """The JAX package's network and models of the tiny task, read from
    the files the port wrote."""
    return (JaxNetwork.load_npz(os.path.join(tiny.td, "clg.npz")),
            JaxModels.load_npz(os.path.join(tiny.td, "models.npz")))


def _cfg():
    return TorchDecoderConfig(max_insts=POINT["K"], expand_budget=POINT["E"],
                              final_budget=POINT["F"], emit_prune_win=POINT["beam"],
                              phone_end_prune_win=POINT["end_beam"],
                              word_prune_win=POINT["end_beam"], max_emit_hyps=POINT["maxhyps"])


def test_tiny_task_decodes_as_both_references(tiny):
    """Every pool utterance, its features drawn from its cross-word
    triphones, decodes through `TorchDecoder` and `BatchDecoder` on the CPU
    to its transcript, with the words and word-end frames of the JAX
    package's `RefDecoder` (on its own network and models, read from the
    same files), the port's `ref_core.RefDecoder` and the benchmark's
    `Oracle`, and a total score within float32 rounding of theirs.

    The tolerance: the references add the same float32 scores (read as
    float64) in float64; the port adds them in float32, one rounding of
    at most 2**-24 of the running score each frame, and one more where it
    renormalises by the frame's best, so after T frames its total may
    differ by 2 T 2**-24 of the largest running score, at most the
    total's size plus the transitions' and the LM's."""
    assert np.diff([len(m) for m in tiny.models.gmm_means]).any()  # variable mixtures
    art = DecoderArtifact(tiny.net, tiny.models)
    dec = TorchDecoder(art, _cfg(), device="cpu")
    scorer = make_gmm_scorer(tiny.models.flat_params(), device="cpu")
    ref = RefDecoder(tiny.net, tiny.models, emit_prune_win=POINT["beam"],
                     phone_end_prune_win=POINT["end_beam"], word_prune_win=POINT["end_beam"],
                     max_emit_hyps=POINT["maxhyps"])
    oracle = reference.Oracle(Network(os.path.join(tiny.td, "clg.npz")), tiny.pmodels,
                              POINT["beam"], POINT["end_beam"], POINT["maxhyps"])
    jax_ref = JaxRefDecoder(*jax_task(tiny), emit_prune_win=POINT["beam"],
                            phone_end_prune_win=POINT["end_beam"],
                            word_prune_win=POINT["end_beam"], max_emit_hyps=POINT["maxhyps"])
    pool, lex = tiny.pool, tiny.lex
    scores = [scorer(torch.as_tensor(f)) for f in pool.feats]
    singles = []
    for u, sc in enumerate(scores):
        got = dec.decode_scores(sc)
        singles.append(got)
        s64 = sc.double().numpy()
        want = ref.decode(score_fn=lambda t, g: s64[t, g], n_frames=len(s64))
        orc = oracle.decode(s64)
        jax_want = jax_ref.decode(score_fn=lambda t, g: s64[t, g], n_frames=len(s64))
        words = [w for w in got.words if w not in lex.markers]
        assert words == [lex.labels[w] for w in pool.words[u]], u
        assert got.words == want.words == orc.words == jax_want.words, u
        ends = [h.end_frame for h in got.word_hyps]
        assert ends == [h.end_frame for h in want.word_hyps] == list(orc.end_frames), u
        assert ends == [h.end_frame for h in jax_want.word_hyps], u
        T = len(s64)
        tol = 2 * T * 2.0**-24 * (abs(want.score) + T)
        assert abs(got.score - want.score) <= tol and abs(got.score - orc.score) <= tol, u
        assert abs(got.score - jax_want.score) <= tol, u
        assert not got.overflow and orc.peak_active < POINT["K"]
    # the batch entry point, waves of 3 padded to their longest
    bd = BatchDecoder(dec)
    for lo in range(0, len(scores), 3):
        part = scores[lo:lo + 3]
        lens = [len(s) for s in part]
        pad = torch.stack([torch.cat([s, s[-1:].expand(max(lens) - len(s), -1)]) for s in part])
        for r, want in zip(bd.decode_scores_batch(pad, lens), singles[lo:lo + 3]):
            assert (r.words, r.score) == (want.words, want.score)
            assert [h.end_frame for h in r.word_hyps] == [h.end_frame for h in want.word_hyps]


def test_tiny_task_equals_the_jax_engine(tiny):
    """The JAX package's engine (`TpuDecoder` on the CPU) on the tiny
    cross-word task, its artifact built by the JAX package from the same
    files: the port's artifact has its tables, and on every pool
    utterance the port's frame loop writes its word records bit for bit
    (the padded scan's record arrays) and gives its words, word-end
    frames and overflow, with scores within float32 rounding of each
    other (the two add the same float32 terms, in orders the two
    compilers choose)."""
    jnet, jmodels = jax_task(tiny)
    jart = JaxArtifact(jnet, jmodels)
    art = DecoderArtifact(tiny.net, tiny.models)
    assert art.seqs == jart.seqs
    for k in ("row_ptr", "arc", "w_score", "w_lm", "w_ac", "seq", "frow_ptr",
              "f_score", "f_lm", "f_ac", "f_seq"):
        a, b = getattr(art.expansion, k), getattr(jart.expansion, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("hmm_arc_ids", "arc_hmm", "arc_olabel", "arc_dst", "trP", "state_gmm", "tee"):
        assert np.array_equal(getattr(art, k), getattr(jart, k)), k
    kw = dict(max_insts=POINT["K"], expand_budget=POINT["E"], final_budget=POINT["F"],
              emit_prune_win=POINT["beam"], phone_end_prune_win=POINT["end_beam"],
              word_prune_win=POINT["end_beam"], max_emit_hyps=POINT["maxhyps"])
    jdec = TpuDecoder(jart, TpuDecoderConfig(**kw))
    dec = TorchDecoder(art, TorchDecoderConfig(**kw), device="cpu")
    assert (dec.K, dec.E, dec.F) == (jdec.K, jdec.E, jdec.F)
    scorer = make_gmm_scorer(tiny.models.flat_params(), device="cpu")
    for u, f in enumerate(tiny.pool.feats):
        sc = scorer(torch.as_tensor(f)).numpy()
        rj, rp = jdec.decode_scores(sc), dec.decode_scores(sc)
        assert rp.words == rj.words and not rp.empty, u
        assert [h.end_frame for h in rp.word_hyps] == [h.end_frame for h in rj.word_hyps], u
        assert rp.overflow == rj.overflow, u
        T = len(sc)
        tol = 2 * T * 2.0**-24 * (abs(rj.score) + T)
        assert abs(rp.score - rj.score) <= tol, u
        T_pad = -(-T // 128) * 128
        padded = np.concatenate([sc, np.repeat(sc[-1:], T_pad - T, axis=0)])
        _, ys, rec0 = jdec._decode_jit(jnp.asarray(padded))
        _, pys, prec0 = dec.run(torch.as_tensor(padded)[None])
        for k in ("rec_prev", "rec_seq", "rec_src", "rec_arc"):
            assert np.array_equal(pys[k][:, 0].numpy(), np.asarray(ys[k])), (u, k)
            assert np.array_equal(prec0[k][0].numpy(), np.asarray(rec0[k[4:]])), (u, k)


def test_port_sampler_draws_the_benchmarks_triphones(tiny):
    """`wsj_task.sample_utterances` reads the tied list as the benchmark's
    traffic does: the same HMM for every phone of an utterance."""
    s = wsj_task._Sentences(tiny.td, tiny.models)
    b = traffic.Sentences(tiny.td, tiny.pmodels, tiny.lex, "xwrdtri")
    for words in tiny.pool.words + [[3, 4, 0], [2, 3, 3]]:
        assert s.hmms(s.phone_seq(words)) == b.hmms(words)
    utts = wsj_task.sample_utterances(tiny.td, tiny.models, 2, 60, seed=3)
    assert all(f.shape[1] == 39 and len(w) for w, f in utts)


def test_build_tri_task_writes_then_holds(tmp_path, monkeypatch, tiny):
    """`build_tri_task` writes what is missing and holds what is there: a
    rebuild passes, and a changed file fails naming it."""
    base = tmp_path / "scripts" / "_wsj_cache_tinybase"
    base.mkdir(parents=True)
    for f in wsj_task.SHARED_FILES:
        (base / f).write_bytes(open(os.path.join(tiny.td, f), "rb").read())
    monkeypatch.setattr(wsj_task, "ROOT", str(tmp_path))
    monkeypatch.setitem(wsj_task.TRI_TASKS, "tiny-tri", ("tinybase", TINY))
    out = wsj_task.build_task("tiny-tri", networks=("clg",), verbose=False)
    td = wsj_task.task_dir("tiny-tri")
    assert td.endswith("_wsj_cache_tiny_tri")
    assert sorted(os.listdir(td)) == sorted(wsj_task.SHARED_FILES + ("tied.lst", "models.npz",
                                                                      "clg.npz"))
    wsj_task.require_same_network("tiny", out["clg"], tiny.net)
    wsj_task.build_tri_task("tiny-tri", verbose=False)  # a rebuild holds
    with open(os.path.join(td, "tied.lst"), "a") as fd:
        fd.write("x-a+b a-a+a\n")
    with pytest.raises(RuntimeError, match="tied.lst"):
        wsj_task.build_tri_task("tiny-tri", verbose=False)
    with pytest.raises(ValueError, match="only a CLG"):
        wsj_task.build_task("tiny-tri", networks=("cl", "clg"), verbose=False)


# -- (c) the tracked 20k-tri1 task ---------------------------------------------


def test_tracked_task_shares_the_20k_files():
    td, src = wsj_task.task_dir(TRI), wsj_task.task_dir("20k")
    for f, digest in SHARED_SHA256.items():
        assert sha256(os.path.join(td, f)) == sha256(os.path.join(src, f)) == digest, f


def test_tracked_models_are_the_generators_and_the_configurations():
    """tied.lst and models.npz are what the generator makes, and the
    configuration's counts are the files'."""
    td = wsj_task.task_dir(TRI)
    ts = make_tied_set(phones_of(td), **wsj_task.TRI_TASKS[TRI][1])
    with open(os.path.join(td, "tied.lst")) as fd:
        assert fd.read() == ts.tied_text
    wsj_task.require_same_models("tracked", ts.models, os.path.join(td, "models.npz"))
    with open(CONFIG) as fd:
        cfg = json.load(fd)
    am, net = cfg["acoustic_model"], cfg["network"]
    m = Models(os.path.join(td, "models.npz"))
    assert (am["tied_states"], am["gaussians"], am["largest_mixture"], am["feature_dim"]) == (
        m.G, m.real_components, m.C, m.D) == (2000, 10000, int(ts.gaussians.max()), 39)
    assert am["physical_hmms"] == len(m.hmm_names) == ts.n_physical + 2
    assert am["physical_triphones"] == ts.n_physical
    assert am["logical_triphones"] == ts.n_logical == 45 * 46 * 46
    assert am["phones"] == len(phones_of(td)) == 47
    assert net["context"] == "xwrdtri" and cfg["task_dir"] == "scripts/_wsj_cache_20k_tri1"
    assert cfg["reduced"] == []


def test_tracked_network_counts_are_the_configurations():
    """The CLG's states and arcs are the configuration's, its input labels
    the physical models."""
    td = wsj_task.task_dir(TRI)
    z = np.load(os.path.join(td, "clg.npz"))
    with open(CONFIG) as fd:
        net = json.load(fd)["network"]
    assert (len(z["row_ptr"]) - 1, len(z["arc_dst"])) == (net["states"], net["arcs"])
    n_hmms = len(Models(os.path.join(td, "models.npz")).hmm_names)
    assert 0 <= int(z["arc_ilabel"].min()) and int(z["arc_ilabel"].max()) <= n_hmms


# -- (d) the frame-step kernel at the configuration's point --------------------


def _dims_at(point, G, H, S=5):
    """`fused_scan._dims` of a decoder at `point` with G GMMs and H HMMs of
    S states, from arithmetic alone (no artifact)."""
    n_bins = int(201.0 - float(int(-point["beam"] - 800.0 - 1.0))) + 1
    fake = types.SimpleNamespace(
        K=point["K"], E=point["E"], S=S, H=H, _n_bins=n_bins,
        cfg=types.SimpleNamespace(max_emit_hyps=point["maxhyps"]),
        art=types.SimpleNamespace(state_gmm=np.array([[G - 1]])))
    return fused_scan._dims(fake)


def test_kernel_holds_the_triphone_point():
    """At the configuration's point (G = 2,000, ~9,800 HMMs, a frontier of
    thousands of slots) a block's search state lies in device memory, the
    HMM tables (1.2 MB) too, and the rest of the block fits shared memory.
    At K = 1,024 the search state fits shared memory up to the hash
    table's E = 1,706 beside one frame's score row, where two rows (the
    kernel before) would not fit at E = 1,664; the monophone cell's point
    stays all in shared memory, its HMM tables staged."""
    with open(CONFIG) as fd:
        cfg = json.load(fd)
    p, am = cfg["point"], cfg["acoustic_model"]
    H = am["physical_hmms"]
    # the port's own tools decode the task at the same point
    assert {k: wsj_task.TRI_POINT[k] for k in ("beam", "end_beam", "maxhyps", "K", "E")} == {
        k: p[k] for k in ("beam", "end_beam", "maxhyps", "K", "E")}
    d = _dims_at(p, am["tied_states"], H)
    assert d["G"] == 2000 and d["state_in_smem"] is False and d["hmm_words"] == 0
    assert fused_scan.search_state_bytes(p["K"], p["E"], 5, d["HT"]) > fused_scan.SMEM_LIMIT
    assert fused_scan.smem_bytes(**d) <= 48 * 1024  # no opt-in past 48 KB
    small = _dims_at(dict(p, K=1024, E=1664), 2000, H)
    assert small["state_in_smem"] is True and small["hmm_words"] == 0
    need = fused_scan.smem_bytes(**small)
    assert need <= fused_scan.SMEM_LIMIT < need + 4 * 2000  # a second score row
    top = _dims_at(dict(p, K=1024, E=1706), 2000, H)
    assert top["state_in_smem"] is True and top["HT"] == 4096
    mono = _dims_at(dict(p, K=1024, E=1664), 141, 49)
    assert mono["state_in_smem"] is True and mono["hmm_words"] == 49 * 30
