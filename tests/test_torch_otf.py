"""On-the-fly composition of the PyTorch port against the JAX package.

Following `tests/test_otf.py` and `test_fuzz_parity.test_fuzz_otf`: the
toy CL (C o closure(L) of a three-word lexicon) with its ARPA G, and the
random networks `random_case(130..133)` with a random backoff G
(`random_g`), go through `TpuDecoder(g_network=)` (float64 under
`jax_enable_x64`, as the JAX tests run it) and
`TorchDecoder(g_network=, device="cpu")` with the same configuration and
the same numpy scores. Every record plane of the padded scan must be
equal slot for slot (integers exactly, floats within 1e-9 in float64 and
1e-4 in float32), and so must words and word-end frames; scores agree
within the same tolerance, and the words equal `RefOtfDecoder`'s.

The grammar side is held arc for arc: the port's `GNetwork` arrays and
its advance (host and device) on every (state, word) pair, its ARPA
grammar against `GramGen(NGRAM)` on the toy and the 2k task, and
`anticipated_labels` on the toy, the fuzz networks and the 2k CL. Then
lattices (records with `lat_to_g` / `ev_g`, the `Fst` arc by arc, best
path), the stream chunk by chunk, the autotuner's budgets and
`BatchDecoder` with padded lengths.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_fuzz_parity
from juicer_tpu.compile import (CDGen, CDPhoneLookup, CDType, GramGen, GramType,
                                LexGen)
from juicer_tpu.decoder import DecoderNetwork as JaxNetwork
from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.autotune import autotune_budgets as jax_autotune
from juicer_tpu.decoder.otf import GNetwork as JaxGNetwork
from juicer_tpu.decoder.otf import RefOtfDecoder
from juicer_tpu.decoder.stream import StreamingDecoder as JaxStream
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.fst import algos as jax_algos
from juicer_tpu.lexicon import Lexicon

from juicer_tpu_torch.compile import arpa_grammar
from juicer_tpu_torch.convert import g_network_from_numpy
from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig, autotune_budgets
from juicer_tpu_torch.decoder.core import FLAT_FIELDS
from juicer_tpu_torch.decoder.fused_scan import why_not_fused
from juicer_tpu_torch.decoder.lattice import shortest_path
from juicer_tpu_torch.decoder.otf import GNetwork
from juicer_tpu_torch.fst import LOG, Fst
from juicer_tpu_torch.harness import wsj_task
from juicer_tpu_torch.lexicon import Lexicon as TorchLexicon
from juicer_tpu_torch.parallel.mesh import BatchDecoder

from test_decoder import make_models, scores_matrix
from test_fuzz_parity import random_case, random_g
from test_torch_decoder import carry_across
from test_torch_lattice import assert_same_fst

TOL = {"float64": 1e-9, "float32": 1e-4}
FUZZ_SEEDS = (130, 131, 132, 133)
TOY_LM = ("\\data\\\nngram 1=4\nngram 2=3\n\n\\1-grams:\n"
          "-0.60206 </s>\n-99 <s> -0.30103\n-0.47712 a -0.30103\n"
          "-0.60206 cat -0.30103\n\n\\2-grams:\n-0.30103 <s> a\n"
          "-0.47712 a cat\n-0.30103 cat </s>\n\n\\end\\\n")
TOY_BUDGETS = dict(max_insts=256, expand_budget=1024, final_budget=256)
# below `test_fuzz_otf`'s (E=8192) so that the JAX dense merge's (E, E)
# compare stays quick; every decode here is checked to be free of overflow
FUZZ_BUDGETS = dict(max_insts=256, expand_budget=2048, final_budget=1024)


@pytest.fixture(scope="module", autouse=True)
def _x64_one_thread():
    """float64 in JAX needs x64; it is switched off again after the module
    (other modules of a worker run float32). The port's small CPU tensors
    use one torch thread, as in the other port test files."""
    jax.config.update("jax_enable_x64", True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_x64", False)


def port_g(jg: JaxGNetwork) -> GNetwork:
    """The JAX G's arrays carried across (`convert.g_network_from_numpy`)."""
    return g_network_from_numpy(**{k: getattr(jg, k) for k in (
        "n_states", "init_state", "arc_il", "arc_dst", "arc_w", "row_ptr", "bo_dst", "bo_w",
        "final_w", "final_reach", "max_backoff")})


def port_fst(f) -> Fst:
    """A JAX `Fst` as the port's, arc for arc."""
    out = Fst(LOG)
    out.num_states, out.start = f.num_states, f.start
    out.arc_src, out.arc_dst = list(f.arc_src), list(f.arc_dst)
    out.arc_ilabel, out.arc_olabel = list(f.arc_ilabel), list(f.arc_olabel)
    out.arc_weight, out.finals = list(f.arc_weight), dict(f.finals)
    return out


@dataclasses.dataclass
class Case:
    """One network of both packages: artifacts, G (the JAX one, the port's
    carried across, and the Fst it was built from), models."""
    name: str
    jart: JaxArtifact
    part: object
    jg: JaxGNetwork
    g: GNetwork
    g_fst: object
    models: object
    cl_net: JaxNetwork
    rng: object = None


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    td = tmp_path_factory.mktemp("otf")
    (td / "lex.dict").write_text("a(1.0) ah\ncat k ae t\n<s> sil\n</s> sil\n")
    (td / "phones.lst").write_text("ah\nk\nae\nt\nsil\n")
    (td / "lm.arpa").write_text(TOY_LM)
    lex = Lexicon.load(str(td / "phones.lst"), str(td / "lex.dict"), sil_phone="sil",
                       sent_start_word="<s>", sent_end_word="</s>", spec_word_char="")
    ps = lex.phone_set
    G = GramGen(lex.vocab, GramType.NGRAM, lm_fname=str(td / "lm.arpa")).build()
    lg = LexGen(lex)
    L = lg.build(output_aux_phones=True)
    lookup = CDPhoneLookup(ps)
    lookup.add_phones(list(ps.phones))
    lookup.bind_models(list(ps.phones))
    C = CDGen(CDType.MONOPHONE, lookup, list(ps.phones), n_aux_syms=lg.n_aux).build()
    cl = jax_algos.compose(C, jax_algos.closure(jax_algos.arcsort(L)))
    models = make_models(len(ps.phones), n_emit=3, seed=31)
    cl_net = JaxNetwork(cl, C.isyms, L.osyms, remove_aux="input")
    jart = JaxArtifact(cl_net, models)
    _, _, part = carry_across(td, cl_net, models, jart)
    jg = JaxGNetwork(G)
    return Case("toy", jart, part, jg, port_g(jg), G, models, cl_net), td, lex


@pytest.fixture(scope="module")
def fuzz(tmp_path_factory):
    """The fuzz cases of `test_fuzz_otf`, the G's Fst captured as built."""
    out = {}
    built = []

    def capture(f, **kw):
        built.append(f)
        return JaxGNetwork(f, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_fuzz_parity, "GNetwork", capture)
        for seed in FUZZ_SEEDS:
            rng, models, net = random_case(seed)
            jg = random_g(rng)
            jart = JaxArtifact(net, models)
            _, _, part = carry_across(tmp_path_factory.mktemp(f"fz{seed}"), net, models, jart)
            out[seed] = Case(f"fuzz{seed}", jart, part, jg, port_g(jg), built[-1], models,
                             net, rng)
    return out


def _case(toy, fuzz, name):
    return toy[0] if name == "toy" else fuzz[int(name[4:])]


def _pair(case, **kw):
    return (TpuDecoder(case.jart, TpuDecoderConfig(**kw), g_network=case.jg),
            TorchDecoder(case.part, TorchDecoderConfig(**kw), device="cpu", g_network=case.g))


# ---- the grammar side -----------------------------------------------------

G_ARRAYS = ("arc_il", "arc_dst", "arc_w", "row_ptr", "bo_dst", "bo_w", "final_w",
            "final_reach")


@pytest.mark.parametrize("name", ["toy"] + [f"fuzz{s}" for s in FUZZ_SEEDS])
def test_gnetwork_equals_jax(toy, fuzz, name):
    """The port's `GNetwork` built from the same Fst holds the JAX one's
    arrays, and its advance on every (state, word) pair, host and device
    (`TorchDecoder._g_advance`, float64), equals JAX's."""
    case = _case(toy, fuzz, name)
    jg = case.jg
    for g in (GNetwork(port_fst(case.g_fst)), case.g):
        for k in G_ARRAYS:
            a, b = getattr(g, k), getattr(jg, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert (g.n_states, g.init_state, g.max_backoff, g.W) == (
            jg.n_states, jg.init_state, jg.max_backoff, jg.W)
    states, words = np.meshgrid(np.arange(jg.n_states), np.arange(jg.W + 2), indexing="ij")
    want = [jg.advance(int(s), int(w)) for s, w in zip(states.ravel(), words.ravel())]
    assert [case.g.advance(int(s), int(w)) for s, w in zip(states.ravel(), words.ravel())] == want
    assert any(s >= 0 for s, _ in want) and any(s < 0 for s, _ in want[1:])
    dec = TorchDecoder(case.part, TorchDecoderConfig(dtype="float64", **TOY_BUDGETS),
                       device="cpu", g_network=case.g)
    w_t = torch.as_tensor(words.ravel())[None]
    cur, gw, ok = dec._g_advance(torch.as_tensor(states.ravel())[None], w_t != 0, w_t)
    for i, (s, w) in enumerate(want):
        if words.ravel()[i] == 0:
            assert bool(ok[0, i])  # nothing to consume
            continue
        assert bool(ok[0, i]) == (s >= 0), i
        if s >= 0:
            assert (int(cur[0, i]), float(gw[0, i])) == (s, w), i


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_g_advance_equals_jax_on_the_2k_grammar(dtype):
    """The device advance against `TpuDecoder._g_advance` on the 2k task's
    ARPA G at `scripts/wsj_otf.py`'s pad_cap=256, where 10 states (the
    unigram root among them) exceed the padded rows and the JAX engine
    reads them from its dense word tables: every word from each of those
    states, and random (state, word) pairs, in both dtypes."""
    from juicer_tpu.am.models import AcousticModelSet as JaxModels

    task = wsj_task.load_otf_task("2k", verbose=False)
    jlex = Lexicon.load(f"{task.cache}/phones.lst", f"{task.cache}/lex.dict",
                        sil_phone="sil", pause_phone="sp", sent_start_word="<s>",
                        sent_end_word="</s>", spec_word_char="")
    jg = JaxGNetwork(GramGen(jlex.vocab, GramType.NGRAM,
                             lm_fname=f"{task.cache}/lm.arpa").build(), pad_cap=256)
    dense = np.nonzero(jg.dense_idx >= 0)[0]
    assert len(dense) == 10
    net = JaxNetwork.load_npz(f"{task.cache}/cl.npz")
    jart = JaxArtifact.load_npz(f"{task.cache}/cl_artifact.npz", net,
                                JaxModels.load_npz(f"{task.cache}/models.npz"))
    cfg = dict(max_insts=128, expand_budget=256, final_budget=128, dtype=dtype)
    jdec = TpuDecoder(jart, TpuDecoderConfig(**cfg), g_network=jg)
    pdec = TorchDecoder(task.artifact, TorchDecoderConfig(**cfg), device="cpu",
                        g_network=task.g)
    rng = np.random.default_rng(7)
    states = np.concatenate([np.repeat(dense, jg.W + 1), rng.integers(0, jg.n_states, 20000)])
    words = np.concatenate([np.tile(np.arange(jg.W + 1), len(dense)),
                            rng.integers(0, jg.W + 1, 20000)])
    want = [np.asarray(a) for a in jdec._g_advance(
        jnp.asarray(states, jnp.int32), jnp.asarray(words != 0), jnp.asarray(words, jnp.int32))]
    w_t = torch.as_tensor(words)
    got = [a.numpy() for a in pdec._g_advance(torch.as_tensor(states), w_t != 0, w_t)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])  # the same rounding: bit for bit
    assert want[2].any() and not want[2].all()


def _toy_vocab(td):
    return TorchLexicon.load(str(td / "phones.lst"), str(td / "lex.dict"), sent_start_word="<s>",
                             sent_end_word="</s>", spec_word_char="").vocab


@pytest.mark.parametrize("task", ["toy", "2k"])
def test_arpa_grammar_equals_gramgen(toy, task):
    """ARPA -> G: the port's vocabulary equals the JAX lexicon's (and its
    labels `word_labels`'), and its grammar equals `GramGen(NGRAM)` state
    for state and arc for arc (2k: 2,004 states, 123,026 arcs)."""
    if task == "toy":
        _, td, lex = toy
        vocab, lm = _toy_vocab(td), str(td / "lm.arpa")
        jvocab = lex.vocab
    else:
        cache = wsj_task.task_dir("2k")
        files = (f"{cache}/phones.lst", f"{cache}/lex.dict")
        vocab = TorchLexicon.load(*files, sent_start_word="<s>", sent_end_word="</s>",
                                  spec_word_char="").vocab
        lm = f"{cache}/lm.arpa"
        jvocab = Lexicon.load(*files, sil_phone="sil", pause_phone="sp", sent_start_word="<s>",
                              sent_end_word="</s>", spec_word_char="").vocab
        labels, markers = wsj_task.word_labels(cache)
        assert labels == [vocab.get_index(f"w{i}") + 1 for i in range(len(labels))]
        assert markers == {vocab.sent_start_index + 1, vocab.sent_end_index + 1}
    assert (vocab.words, vocab.n_pronuns, vocab.special) == (
        jvocab.words, jvocab.n_pronuns, jvocab.special)
    got = arpa_grammar(vocab, lm)
    want = GramGen(jvocab, GramType.NGRAM, lm_fname=lm).build()
    assert (got.num_states, got.start, got.finals) == (want.num_states, want.start, want.finals)
    for k in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight"):
        assert list(getattr(got, k)) == list(getattr(want, k)), k
    if task == "2k":
        assert (got.num_states, got.num_arcs) == (2004, 123026)


@pytest.mark.parametrize("name", ["toy"] + [f"fuzz{s}" for s in FUZZ_SEEDS] + ["2k"])
def test_anticipated_labels_equal(toy, fuzz, name):
    if name == "2k":
        task = wsj_task.load_otf_task("2k", verbose=False)
        net = JaxNetwork.load_npz(f"{task.cache}/cl.npz")
        from juicer_tpu.am.models import AcousticModelSet as JaxModels
        jart = JaxArtifact.load_npz(f"{task.cache}/cl_artifact.npz", net,
                                    JaxModels.load_npz(f"{task.cache}/models.npz"))
        part = task.artifact
    else:
        case = _case(toy, fuzz, name)
        jart, part = case.jart, case.part
    got, want = part.anticipated_labels(), jart.anticipated_labels()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got > 0).any()


# ---- the decoder ----------------------------------------------------------

def _padded(sc):
    T_pad = -(-sc.shape[0] // 128) * 128
    return np.concatenate([sc, np.repeat(sc[-1:], T_pad - sc.shape[0], axis=0)])


def assert_same_decode(jdec, pdec, sc, ctx):
    """decode_scores results and every plane of the padded scan (the JAX
    result is its `decode_scores` read from that one scan)."""
    tol = TOL[pdec.cfg.dtype]
    padded = _padded(sc)
    jstate = jdec._decode_jit(jnp.asarray(padded, jdec._dt))
    T = sc.shape[0]
    rj = jdec._traceback(*jstate, len(padded), true_T=T if len(padded) != T else None)
    rp = pdec.decode_scores(sc)
    assert rj.empty == rp.empty and not rj.overflow and not rp.overflow, ctx
    assert rj.words == rp.words, (ctx, rj.words, rp.words)
    assert [h.end_frame for h in rj.word_hyps] == [h.end_frame for h in rp.word_hyps], ctx
    if not rj.empty:
        for a, b in ((rj.score, rp.score), (rj.acoustic_score, rp.acoustic_score),
                     (rj.lm_score, rp.lm_score)):
            assert abs(a - b) < tol, ctx
        for hj, hp in zip(rj.word_hyps, rp.word_hyps):
            assert abs(hj.score - hp.score) < tol and abs(hj.lm - hp.lm) < tol, ctx
    _, ys, rec0 = pdec.run(pdec.scores_tensor(padded)[None])
    _, jys, jrec0 = jstate
    assert set(ys) == set(jys), ctx
    for k, want in jys.items():
        got = ys[k][:, 0].numpy()
        want = np.asarray(want)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {k}")
    for k in ("prev", "seq", "src", "arc", "score", "ac", "lm"):
        np.testing.assert_allclose(rec0["rec_" + k][0].numpy(), np.asarray(jrec0[k]), rtol=0,
                                   atol=tol, err_msg=f"{ctx} rec0 {k}")
    return rp


def _ref_words(case, sc):
    ref = RefOtfDecoder(case.cl_net, case.jg, case.models)
    return ref.decode(score_fn=lambda t, g: float(sc[t, g]), n_frames=sc.shape[0]).words


@pytest.mark.parametrize("merge", ["dense", "sort"])
@pytest.mark.parametrize("pushing", [False, True])
def test_toy_equals_jax(toy, merge, pushing):
    """The toy (T=30, `scores_matrix(seed=33)`), float64: records slot for
    slot, words equal to the oracle's; pushing gives plain OTF's words
    and un-normalised acoustic and LM scores."""
    case = toy[0]
    sc = scores_matrix(case.models, 30, seed=33)
    jdec, pdec = _pair(case, dtype="float64", merge_strategy=merge, otf_pushing=pushing,
                       **TOY_BUDGETS)
    assert (pdec.K, pdec.E, pdec.F) == (jdec.K, jdec.E, jdec.F)
    assert pdec.merge_strategy == merge and pdec.pushing == pushing
    r = assert_same_decode(jdec, pdec, sc, (merge, pushing))
    assert r.words and r.words == _ref_words(case, sc)
    if pushing:
        plain = TorchDecoder(case.part, TorchDecoderConfig(dtype="float64", **TOY_BUDGETS),
                             device="cpu", g_network=case.g).decode_scores(sc)
        assert plain.words == r.words
        assert abs(plain.acoustic_score - r.acoustic_score) < 1e-9
        assert abs(plain.lm_score - r.lm_score) < 1e-9


def test_toy_float32_equals_jax(toy):
    """float32 (toy, dense, no pushing): the records equal, scores within
    1e-4 (the G weights rounded once from float64 to float32 in both)."""
    case = toy[0]
    jdec, pdec = _pair(case, dtype="float32", merge_strategy="dense", **TOY_BUDGETS)
    assert pdec.gtab["g_w"].dtype == torch.float32
    r = assert_same_decode(jdec, pdec, scores_matrix(case.models, 30, seed=33), "float32")
    assert r.words


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_equals_jax(fuzz, seed):
    """`test_fuzz_otf`'s networks and budgets, two score draws each, float64;
    odd seeds with pushing too."""
    case = fuzz[seed]
    rng = np.random.default_rng(seed)
    pairs = [_pair(case, dtype="float64", **FUZZ_BUDGETS)]
    if seed % 2:
        pairs.append(_pair(case, dtype="float64", otf_pushing=True, **FUZZ_BUDGETS))
    for draw in range(2):
        T = int(rng.integers(6, 30))
        sc = scores_matrix(case.models, T, seed=(seed - 130) * 10 + draw + 11)
        ref = _ref_words(case, sc)
        for i, (jdec, pdec) in enumerate(pairs):
            assert (pdec.K, pdec.E, pdec.F) == (jdec.K, jdec.E, jdec.F)
            r = assert_same_decode(jdec, pdec, sc, (seed, draw, i))
            assert r.words == ref, (seed, draw, i)


# ---- lattices, stream, tuner, batch ---------------------------------------

@pytest.mark.parametrize("name,kw", [("toy", dict(merge_strategy="dense")),
                                     ("toy", dict(merge_strategy="sort", otf_pushing=True)),
                                     ("fuzz131", dict(otf_pushing=True))])
def test_lattice_equals_jax(toy, fuzz, name, kw):
    """Lattice records where valid (edges keyed to (arc, G state) events by
    `lat_to_g` and `ev_g`), the lattice `Fst` arc by arc, and its best
    path = the 1-best at cost -(ac + lm)."""
    case = _case(toy, fuzz, name)
    budgets = TOY_BUDGETS if name == "toy" else FUZZ_BUDGETS
    jdec, pdec = _pair(case, dtype="float64", gen_lattice=True, **budgets, **kw)
    sc = scores_matrix(case.models, 30 if name == "toy" else 20, seed=33)
    _, jys, jrec0 = jdec._decode_jit(jnp.asarray(sc, jdec._dt))
    _, ys, rec0 = pdec.run(pdec.scores_tensor(sc)[None])
    assert "lat_to_g" in ys and "ev_g" in ys and "ev_g" in rec0
    masks = {"lat": "lat_valid", "flat": "flat_valid"}
    for k in pdec.lat_fields + FLAT_FIELDS + pdec.ev_fields:
        kind = k.split("_")[0]
        mask = np.asarray(jys[masks[kind]]) if kind in masks else np.asarray(jys["ev_arc"]) >= 0
        assert mask.any(), k
        np.testing.assert_allclose(ys[k][:, 0].numpy()[mask], np.asarray(jys[k])[mask],
                                   rtol=0, atol=1e-9, err_msg=k)
    for k in pdec.lat_fields + pdec.ev_fields:
        mask = np.asarray(jrec0["lat_valid"]) if k.startswith("lat") else (
            np.asarray(jrec0["ev_arc"]) >= 0)
        np.testing.assert_allclose(rec0[k][0].numpy()[mask], np.asarray(jrec0[k])[mask],
                                   rtol=0, atol=1e-9, err_msg="rec0 " + k)
    rj, lj = jdec.decode_scores_lattice(sc)
    rp, lp = pdec.decode_scores_lattice(sc)
    assert rp.words == rj.words and rp.words
    assert_same_fst(lp, lj, 1e-9)
    cost, words = shortest_path(lp)
    assert words == rp.words
    assert abs(cost + rp.acoustic_score + rp.lm_score) < 1e-6


@pytest.mark.parametrize("chunk,pushing", [(1, False), (7, False), (7, True), (30, True)])
def test_stream_equals_jax(toy, chunk, pushing):
    """The toy in chunks of 1, 7 and the whole utterance: per chunk the
    same emitted words, frames and scores as the JAX stream (landing
    values: no remainders with a G), and `finish()` equal to it and to
    the port's own `decode_scores`."""
    case = toy[0]
    sc = scores_matrix(case.models, 30, seed=33)
    jdec, pdec = _pair(case, dtype="float64", otf_pushing=pushing, **TOY_BUDGETS)
    js, ps = JaxStream(jdec), pdec.stream(use_fused=False)
    for i in range(0, 30, chunk):
        got, want = ps.feed(sc[i:i + chunk]), js.feed(sc[i:i + chunk])
        assert [(h.word, h.end_frame) for h in got] == [(h.word, h.end_frame) for h in want]
        for a, b in zip(got, want):
            assert abs(a.score - b.score) < 1e-9 and abs(a.lm - b.lm) < 1e-9
    fin, jfin = ps.finish(), js.finish()
    whole = pdec.decode_scores(sc)
    assert fin.words == jfin.words == whole.words and fin.words
    assert [h.end_frame for h in fin.word_hyps] == [h.end_frame for h in jfin.word_hyps]
    assert abs(fin.score - jfin.score) < 1e-9 and fin.score == whole.score


def test_autotune_equals_jax(toy):
    """`autotune_budgets(g_network=)` from budgets the toy overflows gives
    the JAX tuner's budgets."""
    case = toy[0]
    samples = [scores_matrix(case.models, T, seed=40 + T) for T in (30, 24)]
    start = dict(max_insts=8, expand_budget=16, final_budget=8, dtype="float64")
    want = jax_autotune(case.jart, samples, TpuDecoderConfig(**start), margin=1.4,
                        g_network=case.jg)
    got = autotune_budgets(case.part, samples, TorchDecoderConfig(**start), margin=1.4,
                           device="cpu", g_network=case.g)
    assert (got.max_insts, got.expand_budget, got.final_budget) == (
        want.max_insts, want.expand_budget, want.final_budget)
    assert got.max_insts > start["max_insts"]


def test_batch_decoder_with_padded_lengths(toy):
    """`BatchDecoder(use_fused=False)` over an OTF decoder, three padded
    utterances: each result equals `decode_scores` of it alone (and "auto"
    on a CPU decoder takes the same plain loop)."""
    case = toy[0]
    pdec = TorchDecoder(case.part, TorchDecoderConfig(dtype="float64", **TOY_BUDGETS),
                        device="cpu", g_network=case.g)
    utts = [scores_matrix(case.models, T, seed=50 + T) for T in (25, 12, 30)]
    batch = np.stack([np.pad(u, ((0, 30 - len(u)), (0, 0)), mode="edge") for u in utts])
    for use_fused in (False, "auto"):
        got = BatchDecoder(pdec, use_fused=use_fused).decode_scores_batch(
            batch, [len(u) for u in utts])
        for r, u in zip(got, utts):
            want = pdec.decode_scores(u)
            assert r.words == want.words and r.score == want.score and not r.overflow
    assert any(r.words for r in got)


def test_why_not_fused_names_the_grammar(toy):
    case = toy[0]
    pdec = TorchDecoder(case.part, TorchDecoderConfig(), device="cpu", g_network=case.g)
    assert why_not_fused(pdec) == "on-the-fly composition: the kernel searches a static network"
    assert why_not_fused(TorchDecoder(case.part, TorchDecoderConfig(), device="cpu")) is None


def test_otf_task_sizes():
    """The 20k pair `load_otf_task` builds in memory: the sizes the card's
    `[otf] task` line checks, and the CL artifact equal to the tracked
    `cl_artifact.npz`."""
    from juicer_tpu.am.models import AcousticModelSet as JaxModels

    task = wsj_task.load_otf_task("20k", verbose=False)
    art, g = task.artifact, task.g
    assert (task.net.n_arcs, art.n_hmm_arcs, len(art.expansion.arc)) == (37443, 35098, 310115)
    assert (g.n_states, len(g.arc_il), g.max_backoff) == (20004, 151567, 2)
    net = JaxNetwork.load_npz(f"{task.cache}/cl.npz")
    jart = JaxArtifact.load_npz(f"{task.cache}/cl_artifact.npz", net,
                                JaxModels.load_npz(f"{task.cache}/models.npz"))
    assert art.seqs == jart.seqs
    for k in ("row_ptr", "arc", "w_score", "seq", "frow_ptr", "f_score", "f_seq"):
        assert np.array_equal(getattr(art.expansion, k), getattr(jart.expansion, k)), k
