"""Decoder of the PyTorch port against the JAX engine (float32).

Networks, models and artifacts are built with `juicer_tpu`, written with
its `save_npz` methods, and read back by the port, which never imports
the JAX package. The same numpy scores then go through `TpuDecoder` and
`TorchDecoder(device="cpu")` with the same configuration: words, word-end
frames and the traceback record arrays must be equal, scores within 1e-4
(float32 accumulation; in practice they agree bit for bit).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.network import DecoderNetwork as JaxNetwork
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.fst import EPSILON, Fst, LOG
from juicer_tpu.ops.gmm import make_gmm_scorer as jax_gmm_scorer
from juicer_tpu.utils.synth import make_synth_task

from juicer_tpu_torch.am.models import AcousticModelSet
from juicer_tpu_torch.convert import artifact_from_npz
from juicer_tpu_torch.decoder.artifact import _row_keys
from juicer_tpu_torch.decoder import (DecoderArtifact, DecoderNetwork,
                                      TorchDecoder, TorchDecoderConfig)
from juicer_tpu_torch.decoder.otf import GNetwork
from juicer_tpu_torch.fst import LOG as PORT_LOG
from juicer_tpu_torch.fst import Fst as PortFst
from juicer_tpu_torch.parallel.mesh import BatchDecoder

from test_decoder import make_models, scores_matrix
from test_fuzz_parity import random_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = ("rec_prev", "rec_seq", "rec_src", "rec_arc")
SCORE_TOL = 1e-4

BEAMS = dict(emit_prune_win=50.0, phone_end_prune_win=40.0, word_prune_win=40.0)
# rows without maxHyps and with a binding maxHyps
ROWS = [
    dict(),
    BEAMS,
    dict(emit_prune_win=50.0, phone_end_prune_win=40.0, max_emit_hyps=3),
    dict(max_emit_hyps=2),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on shared cores, beside JAX's own
    thread pools; the port's small CPU tensors gain nothing from torch's
    intra-op threads, so these tests use one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry_across(tmp_path, net, models, art):
    """The JAX package's network, models and artifact, through its npz
    files, as the port's objects."""
    net.save_npz(str(tmp_path / "net.npz"))
    models.save_npz(str(tmp_path / "models.npz"))
    art.save_npz(str(tmp_path / "art.npz"))
    pnet = DecoderNetwork.load_npz(str(tmp_path / "net.npz"))
    pmodels = AcousticModelSet.load_npz(str(tmp_path / "models.npz"))
    return pnet, pmodels, artifact_from_npz(str(tmp_path / "art.npz"), pnet, pmodels)


def assert_same_artifact(port, ref):
    assert port.seqs == ref.seqs
    for k in ("row_ptr", "arc", "w_score", "w_lm", "w_ac", "seq", "frow_ptr",
              "f_score", "f_lm", "f_ac", "f_seq"):
        a, b = getattr(port.expansion, k), getattr(ref.expansion, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("hmm_arc_ids", "arc_hmm", "arc_olabel", "arc_dst", "trP", "state_gmm", "tee"):
        assert np.array_equal(getattr(port, k), getattr(ref, k)), k


def assert_decodes_equal(jdec, pdec, sc, ctx):
    """decode_scores results and the raw record arrays of the padded scan."""
    rj, rp = jdec.decode_scores(sc), pdec.decode_scores(sc)
    assert rj.empty == rp.empty, ctx
    assert rj.words == rp.words, (ctx, rj.words, rp.words)
    assert [h.end_frame for h in rj.word_hyps] == [h.end_frame for h in rp.word_hyps], ctx
    assert rj.overflow == rp.overflow, ctx
    if not rj.empty:
        assert abs(rj.score - rp.score) < SCORE_TOL, ctx
        assert abs(rj.acoustic_score - rp.acoustic_score) < SCORE_TOL, ctx
        assert abs(rj.lm_score - rp.lm_score) < SCORE_TOL, ctx
    T = sc.shape[0]
    T_pad = -(-T // 128) * 128
    padded = np.concatenate([sc, np.repeat(sc[-1:], T_pad - T, axis=0)]).astype(np.float32)
    _, ys, rec0 = jdec._decode_jit(jnp.asarray(padded))
    _, pys, prec0 = pdec.run(torch.as_tensor(padded)[None])
    for k in REC:
        np.testing.assert_array_equal(pys[k][:, 0].numpy(), np.asarray(ys[k]), err_msg=f"{ctx} {k}")
        np.testing.assert_array_equal(prec0[k][0].numpy(), np.asarray(rec0[k[4:]]), err_msg=f"{ctx} rec0 {k}")
    return rp


def budgets(big):
    return dict(max_insts=512 if big else 128, expand_budget=4096 if big else 1024,
                final_budget=512 if big else 256)


@pytest.mark.parametrize("net_seed", range(8))
def test_fuzz_parity_with_jax(tmp_path, net_seed):
    big = net_seed >= 6
    rng, models, net = random_case(net_seed, max_states=64 if big else 9)
    jart = JaxArtifact(net, models)
    pnet, pmodels, part = carry_across(tmp_path, net, models, jart)
    prune = ROWS[net_seed % len(ROWS)]
    kw = dict(**budgets(big), **prune)
    jdec = TpuDecoder(jart, TpuDecoderConfig(**kw))
    pdec = TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")
    assert (pdec.K, pdec.E, pdec.F) == (jdec.K, jdec.E, jdec.F)
    for draw in range(2):
        T = int(rng.integers(4, 40))
        sc = scores_matrix(models, T, seed=net_seed * 100 + draw)
        assert_decodes_equal(jdec, pdec, sc, (net_seed, prune, draw))


@pytest.mark.parametrize("net_seed", [0, 3, 6])
def test_artifact_build_matches_jax(tmp_path, net_seed):
    """The port's vectorised build gives the JAX build's tables, label-
    sequence ids included."""
    _, models, net = random_case(net_seed, max_states=64 if net_seed >= 6 else 9)
    jart = JaxArtifact(net, models)
    pnet, pmodels, _ = carry_across(tmp_path, net, models, jart)
    assert_same_artifact(DecoderArtifact(pnet, pmodels), jart)


def test_label_keys_equal_iff_rows_equal():
    """Both forms of the sequence-interning key (packed, and np.unique for
    labels too large to pack) are equal exactly when the rows are, and
    the empty sequence keys to 0."""
    rng = np.random.default_rng(0)
    for high in (50, 1 << 40):
        rows = rng.integers(1, 4, size=(300, 3)) * (high // 3)
        rows[rng.random((300, 3)) < 0.4] = 0
        rows[::7] = 0
        keys = _row_keys(rows)
        _, inv = np.unique(rows, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        assert (keys[::7] == 0).all() and (keys[~(rows == 0).all(1)] != 0).all()
        assert np.array_equal(keys[:, None] == keys[None], inv[:, None] == inv[None])


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    task = make_synth_task(n_words=12, n_phones=8, n_comps=4, vec_size=6, seed=3)
    pnet, pmodels, part = carry_across(
        tmp_path_factory.mktemp("synth"), task.network, task.models, task.artifact)
    rng = np.random.default_rng(5)
    words = [f"w{rng.integers(12)}" for _ in range(5)]
    feats = task.synth_utterance(words, rng)
    scores = np.asarray(jax_gmm_scorer(task.models.flat_params())(jnp.asarray(feats)))
    return task, pnet, pmodels, part, scores


def test_synth_task_parity(synth):
    task, pnet, pmodels, part, scores = synth
    assert_same_artifact(DecoderArtifact(pnet, pmodels), task.artifact)
    kw = dict(max_insts=256, expand_budget=1024, final_budget=256,
              emit_prune_win=60.0, phone_end_prune_win=40.0, max_emit_hyps=40)
    jdec = TpuDecoder(task.artifact, TpuDecoderConfig(**kw))
    pdec = TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")
    r = assert_decodes_equal(jdec, pdec, scores, "synth")
    assert len(r.words) >= 5


def test_batch_matches_single(synth):
    """Padded batch decoding equals per-utterance decode_scores."""
    _, _, _, part, scores = synth
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=1024, final_budget=256,
                             emit_prune_win=60.0, max_emit_hyps=40)
    dec = TorchDecoder(part, cfg, device="cpu")
    utts = [scores, scores[: len(scores) * 2 // 3], scores[len(scores) // 3:]]
    Tmax = max(len(u) for u in utts)
    batch = np.stack([np.pad(u, ((0, Tmax - len(u)), (0, 0)), mode="edge") for u in utts])
    got = BatchDecoder(dec).decode_scores_batch(batch, [len(u) for u in utts])
    for u, r in zip(utts, got):
        ref = dec.decode_scores(u)
        assert r.words == ref.words
        assert [h.end_frame for h in r.word_hyps] == [h.end_frame for h in ref.word_hyps]
        assert r.score == ref.score and r.acoustic_score == ref.acoustic_score
        assert r.n_frames == len(u)
    assert got[0].words


def test_binding_histogram_changes_result(tmp_path):
    """A binding maxHyps really prunes in the port: some decode differs
    from its unpruned twin."""
    base = dict(max_insts=128, expand_budget=1024, final_budget=256)
    changed = 0
    for seed in range(40, 43):
        _, models, net = random_case(seed)
        _, _, art = carry_across(tmp_path, net, models, JaxArtifact(net, models))
        free = TorchDecoder(art, TorchDecoderConfig(**base), device="cpu")
        bound = TorchDecoder(art, TorchDecoderConfig(max_emit_hyps=2, **base), device="cpu")
        for draw in range(2):
            sc = scores_matrix(models, 20, seed=seed * 10 + draw)
            r0, r1 = free.decode_scores(sc), bound.decode_scores(sc)
            changed += r0.words != r1.words or r0.score != r1.score
    assert changed > 0


def _tie_network():
    """Two eps paths with equal weights and different words into the same
    HMM arc, and an HMM whose states tie: recombination and internal
    propagation both see exact ties."""
    f = Fst(LOG)
    for _ in range(4):
        f.add_state()
    f.set_start(0)
    f.add_arc(0, 1, EPSILON, 2, 0.25)
    f.add_arc(0, 1, EPSILON, 1, 0.25)
    f.add_arc(1, 2, 1, EPSILON, 0.0)
    f.add_arc(2, 3, 2, 3, 0.5)
    f.add_arc(2, 3, 2, 4, 0.5)
    f.add_arc(1, 3, 2, 5, 0.5)
    f.set_final(3, 0.0)
    return f


def test_ties_break_like_jax(tmp_path):
    models = make_models(2, n_emit=3, dim=4, n_comps=2, seed=9)
    net = JaxNetwork(_tie_network())
    jart = JaxArtifact(net, models)
    _, _, part = carry_across(tmp_path, net, models, jart)
    kw = dict(max_insts=128, expand_budget=256, final_budget=128)
    jdec = TpuDecoder(jart, TpuDecoderConfig(**kw))
    pdec = TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")
    # equal scores for every GMM in every frame: every comparison ties
    r = assert_decodes_equal(jdec, pdec, np.zeros((9, models.n_gmms)), "ties")
    assert r.words


def test_configs_construct(synth):
    """Every configuration of `TpuDecoder` constructs, on-the-fly
    composition (`g_network=`) with its (arc, G state) budgets too, and
    unknown values raise."""
    part = synth[3]
    for kw in (dict(dtype="float64"), dict(gen_lattice=True),
               dict(histogram_mode="exact", max_emit_hyps=5), dict(merge_strategy="sort"),
               dict(dtype="float64", histogram_mode="exact", merge_strategy="sort",
                    gen_lattice=True)):
        dec = TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")
        assert dec.cfg == TorchDecoderConfig(**kw)
    f = PortFst(PORT_LOG)
    f.add_arc(0, 1, 1, 1, 0.5)
    f.add_arc(1, 0, 0, 0, 0.1)
    f.set_start(0)
    f.set_final(1, 0.0)
    g = GNetwork(f)
    for pushing in (False, True):
        dec = TorchDecoder(part, TorchDecoderConfig(otf_pushing=pushing), device="cpu",
                           g_network=g)
        assert dec.otf and dec.pushing == pushing and dec.nG == 2
        assert dec.K == min(2048, -(-(part.n_hmm_arcs * 2 + 1) // 128) * 128)
    for kw in (dict(dtype="float16"), dict(histogram_mode="top"), dict(merge_strategy="hash")):
        with pytest.raises(ValueError):
            TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")


def test_decoder_needs_card_unless_cpu(synth):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDecoder(synth[3], TorchDecoderConfig())


_IMPORT_CHECK = r"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import juicer_tpu_torch
for m in pkgutil.walk_packages(juicer_tpu_torch.__path__, "juicer_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1] + "/chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "juicer_tpu", "wsj_bench", "scripts")]
print("BAD", bad)
"""


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports JAX, the JAX
    package or scripts/ — at import time (in a fresh interpreter) or in a
    function body (by their source text)."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|juicer_tpu|scripts|wsj_bench)\b(?!_)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "juicer_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fd:
            assert not pat.search(fd.read()), path
