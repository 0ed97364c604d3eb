"""Tests of the port that need a CUDA card (marker `gpu`).

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch; there, run it without the repository's
conftest (which configures JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Without a card every test skips.
"""

import dataclasses
import gc
import itertools
import json
import os

import numpy as np
import pytest
import torch

from juicer_tpu_torch.am.models import LOG_ZERO, AcousticModelSet
from juicer_tpu_torch.convert import gmm_params_from_numpy
from juicer_tpu_torch.decoder import autotune_budgets, core, fused_scan
from juicer_tpu_torch.decoder.artifact import DecoderArtifact
from juicer_tpu_torch.decoder.core import (REC_FIELDS, TorchDecoder,
                                           TorchDecoderConfig, host_batch,
                                           host_planes_diff)
from juicer_tpu_torch.decoder.fused_scan import (REC_NAMES, FusedDecodeScan,
                                                 assemble_results, compact_records,
                                                 concat_records, expand_records,
                                                 state_differences)
from juicer_tpu_torch.decoder.network import DecoderNetwork
from juicer_tpu_torch.decoder.otf import GNetwork
from juicer_tpu_torch.decoder.stream import StreamingDecoder
from juicer_tpu_torch.fst import LOG, Fst
from juicer_tpu_torch.harness import wsj_task
from juicer_tpu_torch.ops import gmm_cuda
from juicer_tpu_torch.ops.gmm import gmm_scores_dense, make_gmm_scorer
from juicer_tpu_torch.parallel.mesh import BatchDecoder, make_mesh

NEG = -1e30


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _random_params(rng, D, G, C):
    """Diagonal GMMs in expanded form; every 4th GMM has one component and
    GMM 1, where there is one, none (it must score -1e30)."""
    mu = rng.normal(scale=2.0, size=(G, C, D))
    var = rng.random((G, C, D)) + 0.5
    mask = np.ones((G, C), bool)
    mask[::4, 1:] = False
    if G > 1:
        mask[1] = False
    V = (-0.5 / var).reshape(G * C, D).T
    M = (mu / var).reshape(G * C, D).T
    b = (-0.5 * (mu * mu / var).sum(-1) - 0.5 * np.log(var).sum(-1)).reshape(-1)
    return gmm_params_from_numpy(V, M, b, mask), mu


# the kernel's tile edges: 64 frames, 16 GMMs, components 8 at a time,
# input dims of W staged 40 at a time (D=192 takes five chunks)
EDGES = list(itertools.product([1, 65, 127, 129, 4099], [1, 13, 39, 192], [1, 15, 17, 141],
                               [1, 3, 8, 16, 32]))


@pytest.mark.gpu
@pytest.mark.parametrize("T,D,G,C", [(1, 4, 3, 2), (100, 39, 141, 8), (4099, 13, 33, 3)]
                         + EDGES)
def test_kernel_matches_plain(card, T, D, G, C):
    """Within 1e-3 of the plain scorer at the repo's D <= 39. The expanded
    terms' float32 sums over 2D inputs reach ~1e3 at D=192 and drift by
    more ulps in each order, so the tolerance grows with D above 39."""
    rng = np.random.default_rng([T, D, G, C])
    params, mu = _random_params(rng, D, G, C)
    scorer = make_gmm_scorer(params, device=card)
    g = rng.integers(G, size=T)
    x = mu[g, 0] + rng.normal(size=(T, D))
    x = torch.as_tensor(x.astype(np.float32), device=card)
    n0 = gmm_cuda.counter.launches
    out = scorer(x)
    torch.cuda.synchronize()
    assert gmm_cuda.counter.launches == n0 + 1
    dense = gmm_scores_dense(x, scorer.V, scorer.M, scorer.b, scorer.mask)
    assert out.shape == (T, G) and torch.isfinite(out).all()
    if G > 1:
        assert (out[:, 1] == NEG).all()
    np.testing.assert_allclose(out.cpu().numpy(), dense.cpu().numpy(),
                               atol=1e-3 * max(1.0, D / 39), rtol=0)


@pytest.mark.gpu
def test_kernel_refuses_bad_input(card):
    params, _ = _random_params(np.random.default_rng(0), 4, 5, 2)
    scorer = make_gmm_scorer(params, device=card)
    x = torch.zeros((8, 4), device=card)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_logsumexp(x.double(), scorer.W, scorer.b_packed, 5)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_logsumexp(torch.zeros((8, 5), device=card), scorer.W, scorer.b_packed, 5)
    with pytest.raises(ValueError):
        scorer(torch.zeros((8, 4)))
    with pytest.raises(ValueError):  # b no longer matches W
        gmm_cuda.gmm_logsumexp(x, scorer.W, scorer.b_packed[:, :4].contiguous(), 5)
    big, _ = _random_params(np.random.default_rng(0), gmm_cuda.MAX_DIM + 1, 3, 2)
    with pytest.raises(ValueError):
        make_gmm_scorer(big, device=card)


@pytest.mark.gpu
def test_card_decode_equals_cpu(card):
    """A short 2k-task sentence: card and CPU decode the same scores to the
    same records and words, and the words are the transcript."""
    task = wsj_task.load_task("2k", verbose=False)
    words, feats = wsj_task.sample_utterances(task.cache, task.models, 2, 250, seed=12)[1]
    scores = make_gmm_scorer(task.models.flat_params(), device=card)(
        torch.as_tensor(feats, device=card))
    cfg = wsj_task.decoder_config()
    out = []
    for device, sc in ((card, scores), ("cpu", scores.cpu())):
        dec = TorchDecoder(task.artifact, cfg, device=device)
        host = host_batch(*dec.run(sc[None]))
        out.append((dec.traceback(host, 0, sc.shape[0]), host[1]))
    (r_card, ys_card), (r_cpu, ys_cpu) = out
    for k in REC_FIELDS:
        np.testing.assert_array_equal(ys_card[k], ys_cpu[k], err_msg=k)
    assert r_card.words == r_cpu.words and r_card.score == r_cpu.score
    labels, markers = wsj_task.word_labels(task.cache)
    assert [w for w in r_card.words if w not in markers] == [labels[w] for w in words]


# ---- the fused frame-step kernel against its plain version ------------------


def _fuzz_artifact(seed, n_states=40, n_models=5, n_emit=3, n_gmms=12):
    """A random left-to-right HMM set and a random network (epsilon arcs
    only forward, a chain to a final state), built without the JAX
    package."""
    rng = np.random.default_rng(seed)
    ms = AcousticModelSet()
    ms.vec_size = 4
    n = n_emit + 2
    for h in range(n_models):
        tm = np.full((n, n), LOG_ZERO)
        tm[0, 1] = 0.0
        for j in range(1, n - 1):
            stay = rng.uniform(0.3, 0.7)
            tm[j, j] = np.log(stay)
            tm[j, j + 1] = np.log(1.0 - stay)
        ms.trans_mats.append(tm)
        ms.hmm_names.append(f"m{h}")
        ms.hmm_trans_ind.append(h)
        ms.hmm_gmm_inds.append(rng.integers(0, n_gmms, size=n_emit))
    ms._hmm_index = {name: i for i, name in enumerate(ms.hmm_names)}
    ms.gmm_means = [np.zeros((1, 4))] * n_gmms
    ms.gmm_vars = [np.ones((1, 4))] * n_gmms
    ms.gmm_log_weights = [np.zeros(1)] * n_gmms

    arcs = []
    for _ in range(int(rng.integers(2 * n_states, 4 * n_states))):
        src, dst = int(rng.integers(n_states)), int(rng.integers(n_states))
        il = 0 if rng.random() < 0.25 else int(rng.integers(1, n_models + 1))
        if il == 0 and dst <= src:
            if src == n_states - 1:
                continue
            dst = int(rng.integers(src + 1, n_states))
        ol = int(rng.integers(1, 6)) if rng.random() < 0.4 else 0
        # a coarse grid of weights, so that equal path scores do occur
        arcs.append((src, dst, il, ol, float(np.round(rng.normal(0, 0.8), 1))))
    for s_ in range(n_states - 1):
        arcs.append((s_, s_ + 1, int(rng.integers(1, n_models + 1)), 0, -0.1))
    arcs.sort(key=lambda a: a[0])
    net = DecoderNetwork.__new__(DecoderNetwork)  # the arrays are set below
    cols = list(zip(*arcs))
    net.arc_src, net.arc_dst, net.arc_ilabel, net.arc_olabel = (
        np.asarray(c, np.int32) for c in cols[:4])
    net.arc_weight = np.asarray(cols[4], np.float64)
    net.n_states, net.n_arcs, net.init_state = n_states, len(arcs), 0
    net.row_ptr = np.searchsorted(net.arc_src, np.arange(n_states + 1)).astype(np.int64)
    net.final_weight = np.full(n_states, LOG_ZERO)
    net.final_weight[n_states - 1] = -0.5
    net.final_weight[int(rng.integers(n_states))] = -0.2
    net.word_end_marker = net.sil_marker = net.sp_marker = -1
    net.lm_scale, net.ins_pen = 1.0, 0.0
    return DecoderArtifact(net, ms), n_gmms


def _fuzz_scores(seed, T, B, G, device):
    # a coarse grid again: ties between paths are part of what is checked
    rng = np.random.default_rng(seed)
    sc = np.round(rng.normal(-8.0, 3.0, size=(T, B, G)) * 4) / 4
    return torch.as_tensor(sc.astype(np.float32), device=device)


def _assert_kernel_equals_plain(dec, scores):
    """One fused call against `TorchDecoder.run` on the same device, bit
    for bit: the kernel's compact output equals `compact_records` of the
    plain planes, and expands to them."""
    B = scores.shape[1]
    n0 = fused_scan.counter.launches
    fs = FusedDecodeScan(dec, B)
    got = fs(scores)
    torch.cuda.synchronize()
    assert fused_scan.counter.launches - n0 == 1
    assert got[1]["records"].shape == (B, scores.shape[0] * dec.K, 8)
    carry, ys, _ = dec.run(scores.transpose(0, 1))
    assert state_differences(got, (carry, compact_records(ys))) == []
    dense = expand_records(got[1], dec.K)
    for k in REC_NAMES:
        assert torch.equal(dense[k], ys[k]), k
    return fs, got


def _n_records(state):
    return int(state[1]["rec_count"][-1].sum())


FUZZ_PRUNING = [
    dict(),
    dict(emit_prune_win=40.0, phone_end_prune_win=30.0, word_prune_win=25.0),
    dict(emit_prune_win=40.0, phone_end_prune_win=30.0, max_emit_hyps=12),
    dict(phone_start_prune_win=30.0, max_emit_hyps=30),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("row", range(len(FUZZ_PRUNING)))
def test_frame_step_matches_plain_on_fuzz_network(card, row, B):
    art, G = _fuzz_artifact(seed=row)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             **FUZZ_PRUNING[row])
    dec = TorchDecoder(art, cfg, device=card)
    scores = _fuzz_scores(10 * row + B, 60, B, G, card)
    fs, whole = _assert_kernel_equals_plain(dec, scores)
    assert not bool(whole[0]["overflow"].any())
    assert _n_records(whole) > 0 and (whole[1]["bf_score"] > NEG / 2).any()
    # two calls with the carried state equal one launch
    first = fs(scores[:37])
    second = fs(scores[37:], carry=first[0], t0=37)
    assert state_differences((second[0], concat_records([first[1], second[1]])), whole) == []


@pytest.mark.gpu
@pytest.mark.parametrize("budgets", [dict(max_insts=8), dict(expand_budget=6),
                                     dict(final_budget=1)])
def test_frame_step_overflow_flags_equal(card, budgets):
    """Budgets that overflow on purpose: the same flags are set and the
    same candidates dropped."""
    art, G = _fuzz_artifact(seed=7)
    kw = dict(max_insts=256, expand_budget=512, final_budget=128)
    kw.update(budgets)
    dec = TorchDecoder(art, TorchDecoderConfig(**kw), device=card)
    _, got = _assert_kernel_equals_plain(dec, _fuzz_scores(3, 40, 4, G, card))
    assert bool(got[0]["overflow"].any())


@pytest.mark.gpu
@pytest.mark.parametrize("n_emit", [1, 2, 4, 6])
def test_frame_step_other_state_counts(card, n_emit):
    """The kernel is compiled per HMM state count S = n_emit + 2."""
    art, G = _fuzz_artifact(seed=20 + n_emit, n_emit=n_emit)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             emit_prune_win=40.0, phone_end_prune_win=30.0, max_emit_hyps=25)
    dec = TorchDecoder(art, cfg, device=card)
    assert dec.S == n_emit + 2
    scores = _fuzz_scores(n_emit, 50, 5, G, card)
    fs, got = _assert_kernel_equals_plain(dec, scores)
    assert _n_records(got) > 0
    first = fs(scores[:20])
    second = fs(scores[20:], carry=first[0], t0=20)
    assert state_differences((second[0], concat_records([first[1], second[1]])), got) == []


@pytest.mark.gpu
@pytest.mark.parametrize("max_hyps", [0, 500])
def test_frame_step_matches_plain_on_wsj_sentence(card, max_hyps):
    """A short sentence of the 2k-word task at the operating point's
    budgets, with and without maxHyps, tiled to three utterances; the
    traced-back words are the transcript."""
    task = wsj_task.load_task("2k", verbose=False)
    words, feats = wsj_task.sample_utterances(task.cache, task.models, 2, 250, seed=12)[1]
    sc = make_gmm_scorer(task.models.flat_params(), device=card)(
        torch.as_tensor(feats, device=card))
    cfg = wsj_task.decoder_config(dict(wsj_task.WSJ_POINT, maxhyps=max_hyps))
    dec = TorchDecoder(task.artifact, cfg, device=card)
    assert fused_scan.fused_eligible(dec)
    scores = sc[:, None, :].expand(-1, 3, -1).contiguous()
    fs, got = _assert_kernel_equals_plain(dec, scores)
    results = assemble_results(dec, fs, *got, [sc.shape[0]] * 3)
    labels, markers = wsj_task.word_labels(task.cache)
    for r in results:
        assert not r.overflow
        assert [w for w in r.words if w not in markers] == [labels[w] for w in words]


@pytest.mark.gpu
def test_walk_equals_plain_on_2k_batch(card, monkeypatch):
    """The best-path walk on the card (`path_walk_kernel`) against its plain
    version on 16 padded sentences of the 2k-word task at the operating
    point: the headers, the rows copied with them and every path's rows,
    bit for bit. `assemble_results` equals the host lookup's `traceback`
    field for field, also with a cap of 4 rows (the second copy), and
    gives the transcripts."""
    task = wsj_task.load_task("2k", verbose=False)
    utts = wsj_task.sample_utterances(task.cache, task.models, 16, 300, seed=19)
    scorer = make_gmm_scorer(task.models.flat_params(), device=card)
    B, lens = len(utts), [len(f) for _, f in utts]
    T = max(lens)
    scores = torch.empty((T, B, scorer.n_gmms), device=card)
    for b, (_, f) in enumerate(utts):
        sc = scorer(torch.as_tensor(f, device=card))
        scores[: len(f), b] = sc
        scores[len(f):, b] = sc[-1]
    dec = TorchDecoder(task.artifact, wsj_task.decoder_config(), device=card)
    fs = FusedDecodeScan(dec, B)
    carry, ys = fs(scores)
    n0 = fused_scan.walk_counter.launches
    got = fused_scan.walk_paths(fs, carry, ys, lens).cpu()
    assert fused_scan.walk_counter.launches == n0 + 1
    want = fused_scan.walk_paths_plain(
        {k: v.cpu() for k, v in ys.items()}, {f: v.cpu() for f, v in carry["best_final"].items()},
        carry["overflow"].cpu(), fs.rec0_rows.cpu(), lens, dec.K)
    hw, H = fused_scan.HEAD_WORDS, fused_scan.H
    first = B * hw + min(T + 1, fused_scan.PATH_CAP) * B * 8
    assert torch.equal(got[:first], want[:first])
    head = want[: B * hw].view(B, hw)
    n = head[:, H["len"]].tolist()
    assert (head[:, H["status"]] == 0).all() and min(n) > 0
    rows_got, rows_want = got[B * hw:].view(T + 1, B, 8), want[B * hw:].view(T + 1, B, 8)
    for b in range(B):
        assert torch.equal(rows_got[: n[b], b], rows_want[: n[b], b]), b
    host = host_batch(carry, ys, fs.rec0)
    lookup = [dec.traceback(host, b, T, true_T=m) for b, m in enumerate(lens)]
    assert assemble_results(dec, fs, carry, ys, lens) == lookup
    monkeypatch.setattr(fused_scan, "PATH_CAP", 4)
    assert max(n) > 4 and assemble_results(dec, fs, carry, ys, lens) == lookup
    labels, markers = wsj_task.word_labels(task.cache)
    for r, (words, _) in zip(lookup, utts):
        assert not r.overflow
        assert [w for w in r.words if w not in markers] == [labels[w] for w in words]


@pytest.mark.gpu
def test_frame_step_refuses_bad_input(card):
    art, G = _fuzz_artifact(seed=1)
    dec = TorchDecoder(art, TorchDecoderConfig(max_insts=128, expand_budget=256), device=card)
    fs = FusedDecodeScan(dec, 2)
    scores = _fuzz_scores(0, 5, 2, G, card)
    d = fs.dims
    assert d["hmm_words"] == dec.H * dec.S * (dec.S + 1)  # staged: they fit
    assert fused_scan._get_lib().jtpu_frame_step_smem_bytes(
        d["K"], d["E"], d["S"], d["G"], d["n_bins"], d["HT"],
        d["hmm_words"], d["state_in_smem"]) == fused_scan.smem_bytes(**d)
    n0 = fused_scan.counter.launches
    with pytest.raises(ValueError, match="is on cpu"):
        fs._launch(scores.cpu(), fs.init, 0)  # the kernel entry takes no CPU tensor
    with pytest.raises(ValueError, match="float64"):
        fs(scores.double())
    with pytest.raises(ValueError, match="not contiguous"):
        fs(scores.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="GMMs"):
        fs(scores[:, :, : d["G"] - 1].contiguous())
    bad = dict(fs.init, norm=fs.init["norm"].double())
    with pytest.raises(ValueError, match="carry norm"):
        fs(scores, carry=bad)
    assert fused_scan.counter.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
def test_frame_step_hmm_tables_left_in_device_memory(card, B):
    """300 HMMs at the operating point's budgets: their tables (36 KB) do
    not fit shared memory beside the block's state, so the wrapper leaves
    them in device memory and the kernel reads them there."""
    art, G = _fuzz_artifact(seed=2, n_states=500, n_models=300)
    cfg = TorchDecoderConfig(max_insts=1024, expand_budget=1408, final_budget=128,
                             **FUZZ_PRUNING[2])
    dec = TorchDecoder(art, cfg, device=card)
    assert (dec.K, dec.E) == (1024, 1408) and fused_scan.fused_eligible(dec)
    fs, got = _assert_kernel_equals_plain(dec, _fuzz_scores(5, 60, B, G, card))
    assert fs.dims["hmm_words"] == 0
    assert _n_records(got) > 0


def _wide_scores(seed, T, B, G, device):
    """Two good GMMs near 0 and the rest near -400: most states lie
    hundreds of histogram bins below the frame's best."""
    rng = np.random.default_rng(seed)
    sc = np.round(rng.normal(-400.0, 40.0, size=(T, B, G)))
    sc[:, :, :2] = np.round(rng.normal(-2.0, 1.0, size=(T, B, 2)) * 4) / 4
    return torch.as_tensor(sc.astype(np.float32), device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("max_hyps", [6, 40])
def test_frame_step_histogram_threshold_far_below_the_best(card, max_hyps):
    """The kernel scans the histogram from the best score's bin down, a
    window of bins at a time: here the bin that reaches maxHyps lies
    beyond the first window in many frames."""
    art, G = _fuzz_artifact(seed=5)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             max_emit_hyps=max_hyps)
    dec = TorchDecoder(art, cfg, device=card)
    scores = _wide_scores(max_hyps, 50, 4, G, card)
    fs, got = _assert_kernel_equals_plain(dec, scores)
    # the threshold really went that far: after the last frame it lies more
    # than a window (256 bins) below 0, the score of a frame's best state
    # before its GMM score is added
    assert float(got[0]["kth_emit"].min()) < -256.0 - 20.0


@pytest.mark.gpu
def test_record_order_is_the_same_in_every_launch(card):
    """Positions come from ballots and warp counts, not from the order in
    which threads arrive: three launches write identical arenas."""
    art, G = _fuzz_artifact(seed=0)
    dec = TorchDecoder(art, TorchDecoderConfig(max_insts=256, expand_budget=2048,
                                               final_budget=128), device=card)
    scores = _fuzz_scores(1, 60, 16, G, card)
    fs = FusedDecodeScan(dec, 16)
    runs = [fs(scores) for _ in range(3)]
    torch.cuda.synchronize()
    assert _n_records(runs[0]) > 0
    for other in runs[1:]:
        assert state_differences(other, runs[0]) == []
    n = runs[0][1]["rec_count"][-1]
    for u in range(16):
        ids = runs[0][1]["records"][u, : n[u], 0]
        assert bool((ids[1:] > ids[:-1]).all())


@pytest.mark.gpu
def test_a_card_full_of_utterances_equals_the_small_batch(card):
    """132 blocks (one an SM): each tiled utterance gives the records,
    counts and snapshots it gives in a batch of 16."""
    art, G = _fuzz_artifact(seed=3)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             **FUZZ_PRUNING[3])
    dec = TorchDecoder(art, cfg, device=card)
    small = _fuzz_scores(7, 60, 16, G, card)
    tile = torch.arange(132, device=card) % 16
    _, y16 = FusedDecodeScan(dec, 16)(small)
    c132, y132 = FusedDecodeScan(dec, 132)(small[:, tile].contiguous())
    torch.cuda.synchronize()
    assert not bool(c132["overflow"].any())
    for k in y16:
        if k != "records":
            assert torch.equal(y132[k], y16[k][:, tile]), k
    n = y16["rec_count"][-1]
    for u in range(132):
        m = int(n[u % 16])
        assert torch.equal(y132["records"][u, :m], y16["records"][u % 16, :m]), u


@pytest.mark.gpu
@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("n", [2, 3])
def test_mesh_on_one_card_equals_single_device(card, n, use_fused):
    """A mesh of n replicas on one card: shares of 16 utterances (8 + 8,
    6 + 5 + 5) decode bit for bit as the single-device batch, with one
    kernel launch a share, and without a second copy of the tables."""
    art, G = _fuzz_artifact(seed=3)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             **FUZZ_PRUNING[3])
    dec = TorchDecoder(art, cfg, device=card)
    scores = _fuzz_scores(7, 60, 16, G, card).transpose(0, 1)
    lengths = [60 - (b % 5) * 7 for b in range(16)]
    want = BatchDecoder(dec, use_fused=use_fused).decode_scores_batch(scores, lengths)
    # tensors of earlier tests that only the cycle collector frees would
    # otherwise leave during the measurement
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    bd = BatchDecoder(dec, mesh=(card,) * n, use_fused=use_fused)
    assert list(bd.replicas.values()) == [dec]
    assert torch.cuda.memory_allocated(card) <= before  # no replica, no second copy
    n0 = fused_scan.counter.launches
    got = bd.decode_scores_batch(scores, lengths)
    assert fused_scan.counter.launches - n0 == (n if use_fused else 0)
    assert got == want and any(r.words for r in got)


@pytest.mark.gpu
def test_mesh_over_distinct_cards(card):
    """With two or more cards: a mesh over cuda:0 and cuda:1 equals the
    single-device decode, and each kernel launched on cuda:1 while cuda:0
    is the current device equals its plain version (the launch must run
    on the tensors' device)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    art, G = _fuzz_artifact(seed=3)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             **FUZZ_PRUNING[3])
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    dec = TorchDecoder(art, cfg, device=d0)
    scores = _fuzz_scores(7, 60, 16, G, d0).transpose(0, 1)
    want = BatchDecoder(dec).decode_scores_batch(scores)
    bd = BatchDecoder(dec, mesh=make_mesh(2))
    assert set(bd.replicas) == {d0, d1}
    assert bd.decode_scores_batch(scores) == want
    with torch.cuda.device(d0):
        dec1 = bd.replicas[d1]
        _assert_kernel_equals_plain(dec1, _fuzz_scores(8, 60, 3, G, d1))
        rng = np.random.default_rng(1)
        params, _ = _random_params(rng, 39, 141, 8)
        scorer = make_gmm_scorer(params, device=d1)
        x = torch.as_tensor(rng.normal(size=(300, 39)).astype(np.float32), device=d1)
        got = scorer(x)
        plain = gmm_scores_dense(x, scorer.V, scorer.M, scorer.b, scorer.mask)
        assert got.device == d1 and torch.cuda.current_device() == 0
        assert float((got - plain).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_decode_scores_on_the_card_launches_the_kernel_once(card):
    art, G = _fuzz_artifact(seed=4)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128)
    dec = TorchDecoder(art, cfg, device=card)
    cpu = TorchDecoder(art, cfg, device="cpu")
    sc = _fuzz_scores(9, 75, 1, G, "cpu")[:, 0]
    n0, w0 = fused_scan.counter.launches, fused_scan.walk_counter.launches
    got = dec.decode_scores(sc)
    assert fused_scan.counter.launches - n0 == 1
    assert fused_scan.walk_counter.launches - w0 == 1  # read back through the walk
    want = cpu.decode_scores(sc)
    assert got == want and got.n_frames == 75
    dec.K, dec.E = 4096, 65535  # past the kernel's 16-bit candidate numbers
    with pytest.raises(ValueError, match="decode_scores.*65535"):
        dec.decode_scores(sc)
    assert fused_scan.counter.launches - n0 == 1


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 7, 90])
def test_stream_through_the_kernel_equals_decode_scores(card, chunk):
    """Each feed is one launch of the kernel; the partial emissions and the
    final result equal the CPU stream's (the plain loop), and `finish()`
    equals `decode_scores` on the card."""
    art, G = _fuzz_artifact(seed=6)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             **FUZZ_PRUNING[1])
    dec = TorchDecoder(art, cfg, device=card)
    sc = _fuzz_scores(11, 90, 1, G, "cpu")[:, 0]
    want = dec.decode_scores(sc)
    stream, cpu_stream = StreamingDecoder(dec), TorchDecoder(art, cfg, device="cpu").stream()
    n0 = fused_scan.counter.launches
    for i in range(0, 90, chunk):
        assert stream.feed(sc[i:i + chunk]) == cpu_stream.feed(sc[i:i + chunk]), i
    assert fused_scan.counter.launches - n0 == -(-90 // chunk)
    fin = stream.finish()
    assert fin == cpu_stream.finish()
    assert fin.words and fin.words == want.words and fin.score == want.score
    assert [h.end_frame for h in fin.word_hyps] == [h.end_frame for h in want.word_hyps]


@pytest.mark.gpu
def test_autotune_on_the_card_keeps_to_the_kernel(card, monkeypatch):
    """Through the kernel the tuner gives the CPU plain loop's budgets, a
    probe past a block's shared memory among them (its search state in
    device memory); a probe outside the kernel raises with the reason (the
    first one, or a doubled one), and only use_fused=False runs the plain
    loop on the card. Out of scope here is the sort merge, which "auto"
    takes past E = 2048 once the threshold is lowered to that: this
    network's 14,808 closure entries cap E below the threshold's 32768."""
    art, G = _fuzz_artifact(seed=2, n_states=500, n_models=300)
    samples = [_fuzz_scores(30 + i, 40, 1, G, card)[:, 0] for i in range(2)]
    on_cpu = [s.cpu() for s in samples]
    prune = FUZZ_PRUNING[2]
    inside = TorchDecoderConfig(max_insts=1024, expand_budget=1408, final_budget=128, **prune)
    n0 = fused_scan.counter.launches
    tuned = autotune_budgets(art, samples, cfg=inside, device=card)
    assert fused_scan.counter.launches - n0 == 2  # the probe's wave and the verification's
    assert tuned == autotune_budgets(art, on_cpu, cfg=inside, device="cpu")
    assert tuned.max_insts < inside.max_insts

    wide = TorchDecoderConfig(max_insts=1024, expand_budget=8192, final_budget=128, **prune)
    assert not fused_scan._dims(TorchDecoder(art, wide, device=card))["state_in_smem"]
    n0 = fused_scan.counter.launches
    assert (autotune_budgets(art, samples, cfg=wide, device=card)
            == autotune_budgets(art, on_cpu, cfg=wide, device="cpu"))
    assert fused_scan.counter.launches - n0 == 2

    monkeypatch.setattr(core, "SORT_ABOVE_E", 2048)
    big = wide
    overflowing = TorchDecoderConfig(max_insts=1024, expand_budget=1408, final_budget=1, **prune)
    n0 = fused_scan.counter.launches
    with pytest.raises(ValueError, match="probe K=1024, E=8192.*sort merge.*use_fused=False"):
        autotune_budgets(art, samples, cfg=big, device=card)
    with pytest.raises(ValueError, match="probe K=2048, E=2816.*sort merge"):
        autotune_budgets(art, samples, cfg=overflowing, device=card)
    assert fused_scan.counter.launches - n0 == 1  # the overflowing first probe's wave
    with pytest.raises(ValueError, match="use_fused=False"):
        TorchDecoder(art, big, device=card).decode_scores(samples[0])
    plain = autotune_budgets(art, samples, cfg=big, device=card, use_fused=False)
    assert fused_scan.counter.launches - n0 == 1
    assert plain == autotune_budgets(art, on_cpu, cfg=big, device="cpu")


# ---- the configurations outside the kernel: the plain loop on the card ------

VARIANTS = {
    "float64": dict(dtype="float64"),
    "exact": dict(histogram_mode="exact", max_emit_hyps=12),
    "sort": dict(merge_strategy="sort"),
    "lattice": dict(gen_lattice=True),
    "all": dict(dtype="float64", histogram_mode="exact", max_emit_hyps=12,
                merge_strategy="sort", gen_lattice=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_on_the_card_equals_the_cpu(card, name):
    """Each configuration the kernel does not cover, through
    `use_fused=False` on the card: every plane of `run` (records,
    snapshots, lattice records) equals the CPU's, integers exactly and
    floats within 1e-9 (float64) or 1e-4 (float32); `decode_scores` and,
    with lattices, `decode_scores_lattice` give the CPU's result; no
    kernel launches."""
    art, G = _fuzz_artifact(seed=8)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             emit_prune_win=40.0, phone_end_prune_win=30.0, **VARIANTS[name])
    dec, cpu = TorchDecoder(art, cfg, device=card), TorchDecoder(art, cfg, device="cpu")
    sc = _fuzz_scores(21, 60, 2, G, "cpu").transpose(0, 1).contiguous()  # (B, T, G)
    n0 = fused_scan.counter.launches
    got, want = host_batch(*dec.run(sc.to(card))), host_batch(*cpu.run(sc))
    tol = 1e-9 if cfg.dtype == "float64" else 1e-4
    host_planes_diff(got, want, tol)
    for b in range(2):
        r, w = dec.traceback(got, b, 60), cpu.traceback(want, b, 60)
        assert r.words == w.words and [h.end_frame for h in r.word_hyps] == [
            h.end_frame for h in w.word_hyps] and abs(r.score - w.score) < tol
    one = sc[0]
    r, w = dec.decode_scores(one, use_fused=False), cpu.decode_scores(one)
    assert r.words == w.words and r.words and abs(r.score - w.score) < tol
    if cfg.gen_lattice:
        (r, lat), (w, lat_w) = (dec.decode_scores_lattice(one, use_fused=False),
                                cpu.decode_scores_lattice(one))
        assert r.words == w.words
        assert (lat.num_states, lat.arc_src, lat.arc_dst, lat.arc_olabel) == (
            lat_w.num_states, lat_w.arc_src, lat_w.arc_dst, lat_w.arc_olabel)
        np.testing.assert_allclose(lat.arc_weight, lat_w.arc_weight, rtol=0, atol=tol)
    assert fused_scan.counter.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_under_auto_raises_on_the_card(card, name):
    """Under "auto" (and True) every entry point refuses such a decoder on
    the card with `why_not_fused`'s reason instead of giving way to the
    plain loop: `decode_scores`, `decode_scores_lattice`, `BatchDecoder`,
    `autotune_budgets` and the stream."""
    art, G = _fuzz_artifact(seed=8)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128,
                             **VARIANTS[name])
    dec = TorchDecoder(art, cfg, device=card)
    why = fused_scan.why_not_fused(dec)
    assert why is not None
    sc = _fuzz_scores(22, 40, 1, G, card)[:, 0]
    n0 = fused_scan.counter.launches
    for use_fused in ("auto", True):
        with pytest.raises(ValueError) as e:
            dec.decode_scores(sc, use_fused=use_fused)
        assert why in str(e.value) and "use_fused=False" in str(e.value)
        with pytest.raises(ValueError, match="use_fused"):
            BatchDecoder(dec, use_fused=use_fused).decode_scores_batch(sc[None])
        with pytest.raises(ValueError) as e:
            dec.stream(use_fused=use_fused)
        assert why in str(e.value)
    if cfg.gen_lattice:
        with pytest.raises(ValueError) as e:
            dec.decode_scores_lattice(sc)
        assert why in str(e.value)
    with pytest.raises(ValueError) as e:
        autotune_budgets(art, [sc], cfg=cfg, device=card)
    assert why in str(e.value)
    assert fused_scan.counter.launches == n0
    stream = dec.stream(use_fused=False)
    stream.feed(sc)
    assert stream.finish().words == dec.decode_scores(sc, use_fused=False).words


# ---- on-the-fly composition: the plain loop on the card ---------------------

def _fuzz_grammar(seed, n_words=5):
    """A random backoff G over the fuzz networks' word labels 1..5 (the
    shape of `test_fuzz_parity.random_g`: every word from the root, some
    from each other state, one acyclic backoff arc a state), built with
    the port's own `Fst`."""
    rng = np.random.default_rng(seed)
    f = Fst(LOG)
    n = int(rng.integers(2, 6))
    f.set_start(0)
    for w in range(1, n_words + 1):
        f.add_arc(0, int(rng.integers(0, n)), w, w, float(np.round(abs(rng.normal(0, 0.7)), 3)))
    for s_ in range(1, n):
        for w in range(1, n_words + 1):
            if rng.random() < 0.4:
                f.add_arc(s_, int(rng.integers(0, n)), w, w,
                          float(np.round(abs(rng.normal(0, 0.7)), 3)))
        f.add_arc(s_, int(rng.integers(0, s_)), 0, 0,
                  float(np.round(abs(rng.normal(0, 0.3)) + 0.05, 3)))
    f.set_final(0, 0.1)
    f.set_final(n - 1, 0.3)
    return GNetwork(f)


def _otf_cases(card):
    """(name, artifact, G, (B, T, G) CPU scores, config) of the fuzz network
    with a random G, and of the 2k task's CL and ARPA G on a whole 2k
    sentence (seed 12) scored by the GMM kernel, at `OTF_POINT`'s beams."""
    art, G = _fuzz_artifact(seed=8)
    g = _fuzz_grammar(8)
    yield ("fuzz", art, g, _fuzz_scores(23, 60, 2, G, "cpu").transpose(0, 1).contiguous(),
           TorchDecoderConfig(max_insts=512, expand_budget=4096, final_budget=512,
                              emit_prune_win=40.0, phone_end_prune_win=30.0))
    task = wsj_task.load_otf_task("2k", verbose=False)
    _, feats = wsj_task.sample_utterances(task.cache, task.models, 2, 250, seed=12)[1]
    sc = make_gmm_scorer(task.models.flat_params(), device=card)(
        torch.as_tensor(feats, device=card))
    p = wsj_task.OTF_POINT
    yield ("2k", task.artifact, task.g, sc.cpu()[None],
           wsj_task.decoder_config(dict(p, K=1024, E=4096)))


@pytest.mark.gpu
@pytest.mark.parametrize("pushing", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_otf_on_the_card_equals_the_cpu(card, dtype, pushing):
    """On-the-fly composition through `use_fused=False` on the card: every
    plane of `run` equals the CPU's bit for bit, in float32 and float64,
    with and without pushing; `decode_scores` gives the CPU's words; no
    frame-step launch."""
    for name, art, g, sc, cfg in _otf_cases(card):
        cfg = dataclasses.replace(cfg, dtype=dtype, otf_pushing=pushing)
        dec = TorchDecoder(art, cfg, device=card, g_network=g)
        cpu = TorchDecoder(art, cfg, device="cpu", g_network=g)
        n0 = fused_scan.counter.launches
        got, want = host_batch(*dec.run(sc.to(card))), host_batch(*cpu.run(sc))
        assert host_planes_diff(got, want, 0.0) == 0.0
        B, T = sc.shape[:2]
        for b in range(B):
            r, w = dec.traceback(got, b, T), cpu.traceback(want, b, T)
            assert r.words == w.words and r.score == w.score, (name, b)
        r = dec.decode_scores(sc[0], use_fused=False)
        assert r.words and r.words == cpu.decode_scores(sc[0]).words, name
        assert fused_scan.counter.launches == n0


@pytest.mark.gpu
def test_otf_under_auto_raises_on_the_card(card):
    """Under "auto" every entry point refuses a decoder with a G on the card
    with `why_not_fused`'s reason; `use_fused=False` decodes."""
    art, G = _fuzz_artifact(seed=8)
    g = _fuzz_grammar(8)
    cfg = TorchDecoderConfig(max_insts=512, expand_budget=4096, final_budget=512)
    dec = TorchDecoder(art, cfg, device=card, g_network=g)
    why = fused_scan.why_not_fused(dec)
    assert why == "on-the-fly composition: the kernel searches a static network"
    sc = _fuzz_scores(24, 40, 1, G, card)[:, 0]
    n0 = fused_scan.counter.launches
    with pytest.raises(ValueError) as e:
        dec.decode_scores(sc)
    assert why in str(e.value)
    with pytest.raises(ValueError, match="use_fused"):
        BatchDecoder(dec).decode_scores_batch(sc[None])
    with pytest.raises(ValueError) as e:
        dec.stream()
    assert why in str(e.value)
    with pytest.raises(ValueError) as e:
        autotune_budgets(art, [sc], cfg=cfg, device=card, g_network=g)
    assert why in str(e.value)
    got = BatchDecoder(dec, use_fused=False).decode_scores_batch(sc[None])[0]
    assert got.words == dec.decode_scores(sc, use_fused=False).words
    assert fused_scan.counter.launches == n0


# ---- the decoder CLI on the card against the CLI on the CPU ----------------

CLI_PHONES = ["ah", "k", "ae", "t", "sil"]
CLI_WORDS = {"a": ["ah"], "cat": ["k", "ae", "t"]}
CLI_UTTS = [["a", "cat"], ["cat"], ["a"], ["cat", "a", "cat"], ["a", "a"]]
TIMING = ("Total time spent decoding", "Real-time (RT) factor")


def _word_loop(f, labels, lm):
    """<s> (word)* </s> over the phone models: state 0 -sil:<s>-> 1, every
    word a chain of its phones from 1 back to 1 (the first arc carries the
    word and the cost lm[word]), 1 -sil:</s>-> 2, final."""
    hmm = {p: i + 1 for i, p in enumerate(CLI_PHONES)}
    f.set_start(0)
    f.add_arc(0, 1, hmm["sil"], labels["<s>"], 0.0)
    for w, phones in CLI_WORDS.items():
        src = 1
        for i, p in enumerate(phones):
            dst = 1 if i == len(phones) - 1 else f.add_state()
            f.add_arc(src, dst, hmm[p], labels[w] if i == 0 else 0, lm.get(w, 0.0) if i == 0
                      else 0.0)
            src = dst
    f.add_arc(1, 2, hmm["sil"], labels["</s>"], lm.get("</s>", 0.0))
    f.set_final(2, 0.0)
    return f


@pytest.fixture(scope="module")
def cli_task(tmp_path_factory):
    """A synthetic task written with the port's own writers: an MMF of five
    well-separated phone models, a word-loop CLG, its CL with a backoff G
    for on-the-fly composition, symbol files, a lexicon, five utterances
    of HTK features synthesised from the models and their references."""
    from juicer_tpu_torch.am.mmf import MmfDef, MmfHmm, MmfMixture, MmfState, MmfTransMat
    from juicer_tpu_torch.am.mmf import write_mmf
    from juicer_tpu_torch.fst import SymbolTable, write_fsm, write_symbols
    from juicer_tpu_torch.harness.features import write_htk

    td = tmp_path_factory.mktemp("cli_gpu")
    rng = np.random.default_rng(0)
    D = 8
    d = MmfDef()
    d.global_opts.vec_size = D
    centers = {}
    for name in CLI_PHONES:
        probs = np.zeros((5, 5))
        probs[0, 1] = 1
        for i in range(1, 4):
            probs[i, i] = probs[i, i + 1] = 0.5
        center = rng.normal(scale=6.0, size=D)
        means = [center + rng.normal(scale=0.5, size=D) for _ in range(3)]
        centers[name] = means
        d.hmms.append(MmfHmm(name, 5, [MmfState(mixtures=[MmfMixture(1.0, m, np.ones(D))])
                                       for m in means], MmfTransMat(None, 5, probs)))
    write_mmf(d, str(td / "models.mmf"))
    (td / "lex.dict").write_text("a ah\ncat k ae t\n<s> sil\n</s> sil\n")
    words = sorted(["a", "cat", "<s>", "</s>"])
    labels = {w: i + 1 for i, w in enumerate(words)}
    write_symbols(SymbolTable(["<eps>"] + CLI_PHONES), str(td / "in.syms"))
    write_symbols(SymbolTable(["<eps>"] + words), str(td / "out.syms"))
    write_fsm(_word_loop(Fst(LOG), labels, {"a": 0.7, "cat": 1.2, "</s>": 0.4}),
              str(td / "clg.fsm"))
    write_fsm(_word_loop(Fst(LOG), labels, {}), str(td / "cl.fsm"))
    g = Fst(LOG)  # 0 -<s>-> 1; unigram state 2; word histories 3, 4; 5 final
    g.set_start(0)
    g.add_arc(0, 1, labels["<s>"], labels["<s>"], 0.0)
    for s, bo in ((1, 0.3), (3, 0.5), (4, 0.6)):
        g.add_arc(s, 2, 0, 0, bo)
    g.add_arc(1, 3, labels["a"], labels["a"], 0.4)
    g.add_arc(3, 4, labels["cat"], labels["cat"], 0.2)
    for w, s, c in (("a", 3, 1.1), ("cat", 4, 1.3), ("</s>", 5, 0.9)):
        g.add_arc(2, s, labels[w], labels[w], c)
    g.set_final(5, 0.0)
    write_fsm(g, str(td / "g.fsm"))
    lines = []
    for u, utt in enumerate(CLI_UTTS):
        frames = []
        for p in ["sil"] + [p for w in utt for p in CLI_WORDS[w]] + ["sil"]:
            for m in centers[p]:
                frames += [m + rng.normal(scale=0.3, size=D) for _ in range(3 + u % 2)]
        write_htk(str(td / f"u{u}.mfc"), np.asarray(frames))
        lines.append(str(td / f"u{u}.mfc"))
    (td / "in.lst").write_text("\n".join(lines) + "\n")
    (td / "refs.txt").write_text("".join(f"<s> {' '.join(u)} </s>\n" for u in CLI_UTTS))
    return td


def _cli_argv(td, fsm="clg"):
    return ["-lexFName", str(td / "lex.dict"), "-sentStartWord", "<s>", "-sentEndWord",
            "</s>", "-fsmFName", str(td / f"{fsm}.fsm"), "-inSymsFName", str(td / "in.syms"),
            "-outSymsFName", str(td / "out.syms"), "-htkModelsFName", str(td / "models.mmf"),
            "-inputFName", str(td / "in.lst"), "-refFName", str(td / "refs.txt")]


CLI_CASES = {
    "per_utterance": ([], "route: frame_step kernel"),
    "batch": (["-batchSize", "3"], "route: frame_step kernel"),
    "otf": (["-gramFsmFName", "{G}", "-batchSize", "2", "-pushing"],
            "route: plain frame loop (on-the-fly composition: the kernel searches a static "
            "network)"),
    "lattice": (["-latticeDir", "{LAT}"],
                "route: plain frame loop (gen_lattice: the kernel writes no lattice records)"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_on_the_card_equals_the_cpu(card, cli_task, tmp_path, case):
    """The CLI's output on the card equals its output with -device cpu
    (timing lines aside; lattice files: states and labels equal, weights
    within 2e-3 + 1e-5 of their size), 100 % word accuracy; the
    route line names the kernel or the plain loop's reason, and the
    kernels launch as the route says (`gmm_logsumexp` once an utterance,
    `frame_step` once a batch or an utterance on the kernel's route)."""
    from juicer_tpu_torch.cli import juicer

    flags, route = CLI_CASES[case]
    fsm = "cl" if case == "otf" else "clg"
    texts, reports = {}, {}
    for dev in ("cuda", "cpu"):
        argv = [f.replace("{G}", str(cli_task / "g.fsm"))
                .replace("{LAT}", str(tmp_path / f"lat_{dev}")) for f in flags]
        out = tmp_path / f"{dev}.out"
        n0 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
        reports[dev] = juicer.run(_cli_argv(cli_task, fsm) + argv
                                  + ["-device", dev, "-outputFName", str(out)])
        launches = (gmm_cuda.counter.launches - n0[0], fused_scan.counter.launches - n0[1])
        texts[dev] = [ln for ln in out.read_text().splitlines() if not ln.startswith(TIMING)]
        if dev == "cuda":
            n_fs = {"per_utterance": len(CLI_UTTS), "batch": 2}.get(case, 0)
            assert launches == (len(CLI_UTTS), n_fs), launches
    assert reports["cuda"].route == route
    assert reports["cpu"].route == "route: plain frame loop (device cpu)"
    assert texts["cuda"] == texts["cpu"]
    assert any(ln.startswith("Word accuracy = 100.00%") for ln in texts["cuda"])
    if case == "lattice":
        # the card scores with the GMM kernel, the CPU with the plain scorer
        # (1e-4 apart a frame at |score| ~3e2): an edge's float32 weight,
        # up to ~2e4 on dead paths, carries that within 1e-5 of its size,
        # and is written with three decimals
        names = sorted(os.listdir(tmp_path / "lat_cuda"))
        assert names == sorted(os.listdir(tmp_path / "lat_cpu")) and names
        for n in names:
            a = [ln.split() for ln in (tmp_path / "lat_cuda" / n).read_text().splitlines()]
            b = [ln.split() for ln in (tmp_path / "lat_cpu" / n).read_text().splitlines()]
            assert len(a) == len(b) > 0, n
            for ra, rb in zip(a, b):
                k = 4 if len(rb) >= 4 else 1
                assert ra[:k] == rb[:k], (n, ra, rb)
                assert all(abs(float(x) - float(y)) <= 2e-3 + 1e-5 * abs(float(y))
                           for x, y in zip(ra[k:], rb[k:])), (n, ra, rb)


@pytest.mark.gpu
def test_cli_loop_on_the_card_equals_the_cpu(card, cli_task, monkeypatch, capsys):
    """-loop: the stream's partial and final lines on the card equal the
    CPU's; one frame_step launch a chunk on the card."""
    import io
    import sys

    from juicer_tpu_torch.cli import juicer
    from juicer_tpu_torch.harness.features import read_htk

    feats = read_htk(str(cli_task / "u3.mfc"))[0]
    outs = {}
    for dev in ("cuda", "cpu"):
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(feats.astype("<f4").tobytes())))
        n0 = fused_scan.counter.launches
        report = juicer.run(_cli_argv(cli_task) + ["-loop", "-loopChunk", "20", "-device", dev])
        outs[dev] = capsys.readouterr().out
        if dev == "cuda":
            assert report.route == "route: frame_step kernel"
            assert fused_scan.counter.launches - n0 == -(-len(feats) // 20)
    assert outs["cuda"] == outs["cpu"]
    assert outs["cuda"].splitlines()[-1] == "final: <s> cat a cat </s>"


# ---- the wav front end, live capture, MLLR and the oracle core -------------

AUDIO_TONES = {"ah": 300.0, "k": 2500.0, "ae": 900.0, "t": 5000.0, "sil": 0.0}


def _tone_pcm(phones, rng):
    """S16LE PCM of a phone sequence, a tone a phone held 14-18 frames
    (silence a low noise), and each phone's (first sample, samples)."""
    out, spans, pos = [], [], 0
    for p in phones:
        n = 160 * int(rng.integers(14, 19))
        x = 30 * rng.normal(size=n)
        if AUDIO_TONES[p]:
            x += 6000 * np.sin(2 * np.pi * AUDIO_TONES[p] * np.arange(n) / 16000
                               + 6 * rng.random())
        out.append(x)
        spans.append((pos, n, p))
        pos += n
    return np.clip(np.concatenate(out), -32768, 32767).astype("<i2"), spans


@pytest.fixture(scope="module")
def audio_task(cli_task):
    """`cli_task` with wav audio of its utterances, a 39-dimensional MMF
    whose means and variances are the front end's features of each
    phone's frames (the port's `mfcc` on the CPU), a two-class base-class
    file and an MLLRMEAN set."""
    import wave

    from juicer_tpu_torch.am.mmf import MmfDef, MmfHmm, MmfMixture, MmfState, MmfTransMat
    from juicer_tpu_torch.am.mmf import write_mmf
    from juicer_tpu_torch.harness.frontend import mfcc

    td = cli_task
    rng = np.random.default_rng(5)
    frames = {p: [] for p in CLI_PHONES}
    lines = []
    for u, utt in enumerate(CLI_UTTS):
        phones = ["sil"] + [p for w in utt for p in CLI_WORDS[w]] + ["sil"]
        pcm, spans = _tone_pcm(phones, rng)
        with wave.open(str(td / f"u{u}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        np.save(str(td / f"u{u}.pcm.npy"), pcm)
        lines.append(str(td / f"u{u}.wav"))
        f = mfcc(pcm.astype(np.float64), device="cpu").numpy()
        for start, n, p in spans:
            frames[p].append(f[start // 160 + 2:(start + n) // 160 - 3])
    (td / "wav.lst").write_text("\n".join(lines) + "\n")
    d = MmfDef()
    d.global_opts.vec_size = 39
    for name in CLI_PHONES:
        x = np.concatenate(frames[name]).astype(np.float64)
        probs = np.zeros((5, 5))
        probs[0, 1] = 1
        for i in range(1, 4):
            probs[i, i] = probs[i, i + 1] = 0.5
        d.hmms.append(MmfHmm(name, 5, [MmfState(mixtures=[MmfMixture(1.0, x.mean(0),
                                                                     x.var(0) + 1.0)])
                                       for _ in range(3)], MmfTransMat(None, 5, probs)))
    write_mmf(d, str(td / "models39.mmf"))
    (td / "two.base").write_text('~b "two"\n<NUMCLASSES> 2\n<CLASS> 1 {(ah,k).state[2-4]}\n'
                                 "<CLASS> 2 {*.state[2-4]}\n")
    xf = ""
    for k in (1, 2):
        A = np.eye(39) + rng.normal(scale=0.01, size=(39, 39))
        xf += (f"<LINXFORM> {k}\n<VECSIZE> 39\n<BIAS> 39\n "
               + " ".join(repr(float(v)) for v in rng.normal(scale=0.05, size=39))
               + "\n<XFORM> 39 39\n "
               + "\n ".join(" ".join(repr(float(v)) for v in row) for row in A) + "\n")
    (td / "spk.mllr").write_text('~a "spk"\n<XFORMSET>\n<XFORMKIND> MLLRMEAN\n<NUMXFORMS> 2\n'
                                 + xf + "<XFORMWGTSET>\n<CLASSXFORM> 1 1\n<CLASSXFORM> 2 2\n")
    return td


def _audio_argv(td):
    argv = _cli_argv(td)
    argv[argv.index("-inputFName") + 1] = str(td / "wav.lst")
    argv[argv.index("-htkModelsFName") + 1] = str(td / "models39.mmf")
    return argv + ["-inputFormat", "factory"]


@pytest.mark.gpu
def test_front_end_on_the_card_equals_the_cpu(card):
    """`mfcc`, `mfcc_batch` (each row its utterance alone, padding zero) and
    `StreamingFrontend` chunk by chunk on the card against the CPU, within
    1e-4 (float64 inside, another FFT and product order)."""
    from juicer_tpu_torch.harness import capture, frontend

    rng = np.random.default_rng(3)
    sigs = [3000 * np.sin(np.arange(n) * 0.07) + 500 * rng.normal(size=n)
            for n in (16000, 5123, 9001, 250)]
    feats, lengths = frontend.mfcc_batch(sigs, device=card)
    assert feats.device == card and feats.dtype == torch.float32
    for b, s in enumerate(sigs):
        want = frontend.mfcc(s, device="cpu")
        one = frontend.mfcc(s, device=card)
        assert one.device == card and one.shape == want.shape == (lengths[b], 39)
        assert float((one.cpu() - want).abs().max()) <= 1e-4
        assert float((feats[b, :lengths[b]].cpu() - want).abs().max()) <= 1e-4
        assert not feats[b, lengths[b]:].any()
    for cmn in (False, True):
        cfg = frontend.FrontendConfig(cmn=cmn)
        on_card, on_cpu = (capture.StreamingFrontend(cfg, device=card),
                           capture.StreamingFrontend(cfg, device="cpu"))
        for i in range(0, 16000, 777):
            a, b = on_card.feed(sigs[0][i:i + 777]), on_cpu.feed(sigs[0][i:i + 777])
            assert a.device == card and a.shape == b.shape
            assert a.numel() == 0 or float((a.cpu() - b).abs().max()) <= 1e-4
        a, b = on_card.flush(), on_cpu.flush()
        assert a.shape == b.shape and float((a.cpu() - b).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_mllr_on_the_card_equals_the_cpu(card, audio_task):
    """`apply_mllr_means` and `with_mean_transform` on the card: float64
    means and flat parameters within 1e-12 (relative above 1) of the CPU's."""
    from juicer_tpu_torch.am.regtree import apply_mllr_means, parse_baseclass, parse_xformset

    models = AcousticModelSet.from_mmf(str(audio_task / "models39.mmf"))
    xs = parse_xformset(str(audio_task / "spk.mllr"))
    bc = parse_baseclass(str(audio_task / "two.base"))
    pairs = [(apply_mllr_means(models, xs, bc, device=card),
              apply_mllr_means(models, xs, bc, device="cpu")),
             (models.with_mean_transform(xs.xforms[2].A, xs.xforms[2].b, device=card),
              models.with_mean_transform(xs.xforms[2].A, xs.xforms[2].b, device="cpu"))]
    for got, want in pairs:
        for a, b in zip(got.gmm_means, want.gmm_means):
            assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(b).max())
        fa, fb = got.flat_params(np.float64), want.flat_params(np.float64)
        for k in ("V", "M", "b"):
            a, b = getattr(fa, k), getattr(fb, k)
            assert (np.abs(a - b) / np.maximum(1.0, np.abs(b))).max() <= 1e-12, k


AUDIO_CLI_CASES = {
    "factory_mllr_batch": (["-batchSize", "3", "{MLLR}"], "route: frame_step kernel"),
    "factory_ref_core": (["-refCore"], "route: oracle token passing on the host (-refCore; "
                                       "GMM scores on cuda"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(AUDIO_CLI_CASES))
def test_cli_audio_on_the_card_equals_the_cpu(card, audio_task, tmp_path, case):
    """wav input through the front end on the card, with MLLR in batches of
    3 through the kernels, and through the oracle core: output equal to
    `-device cpu` (timing lines aside), four sentences of five correct (the
    fifth, "a a", is one tone held twice as long); the front end named on
    the card; launches gmm_logsumexp one an utterance, frame_step one a batch
    (none for the oracle)."""
    from juicer_tpu_torch.cli import juicer

    flags, route = AUDIO_CLI_CASES[case]
    mllr = ["-mllrXformFile", str(audio_task / "spk.mllr"), "-regClassFile",
            str(audio_task / "two.base")]
    flags = [g for f in flags for g in (mllr if f == "{MLLR}" else [f])]
    texts = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.out"
        n0 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
        report = juicer.run(_audio_argv(audio_task) + flags
                            + ["-device", dev, "-outputFName", str(out)])
        launches = (gmm_cuda.counter.launches - n0[0], fused_scan.counter.launches - n0[1])
        texts[dev] = [ln for ln in out.read_text().splitlines() if not ln.startswith(TIMING)]
        if dev == "cuda":
            assert report.route.startswith(route)
            assert report.front_end.startswith("front end: MFCC of wav files, a batch in one "
                                               "pass on cuda")
            n_fs = 0 if "-refCore" in flags else 2
            assert launches == (len(CLI_UTTS), n_fs), launches
    assert texts["cuda"] == texts["cpu"]
    # "a a" is one tone held twice as long: the word loop hears one "a"
    correct = [ln.split("Sentence correct = ")[1] for ln in texts["cuda"] if "Sentence correct" in ln]
    assert len(correct) == 1 and int(correct[0].split("/")[0]) >= 4, correct


@pytest.mark.gpu
def test_cli_loop_audio_on_the_card_equals_the_cpu(card, audio_task, monkeypatch, capsys):
    """-loop -audioDevice -: PCM on stdin through the streaming front end
    and the stream decoder; the card's partial and final lines equal the
    CPU's; the kernel launched for the chunks on the card."""
    import io
    import sys

    from juicer_tpu_torch.cli import juicer

    pcm = np.load(str(audio_task / "u3.pcm.npy"))
    argv = _cli_argv(audio_task)
    argv[argv.index("-htkModelsFName") + 1] = str(audio_task / "models39.mmf")
    outs = {}
    for dev in ("cuda", "cpu"):
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(pcm.tobytes())))
        n0 = fused_scan.counter.launches
        report = juicer.run(argv + ["-loop", "-loopChunk", "20", "-audioDevice", "-",
                                    "-device", dev])
        outs[dev] = capsys.readouterr().out
        if dev == "cuda":
            assert report.route == "route: frame_step kernel"
            assert report.front_end.startswith("front end: MFCC of PCM, streamed on cuda")
            assert fused_scan.counter.launches - n0 >= 2
    assert outs["cuda"] == outs["cpu"]
    # the running mean of the stream's first frames is theirs alone, which
    # moves the start of the first word
    assert outs["cuda"].splitlines()[-1].startswith("final: <s> ")


# ---- tasks built by the port's offline toolchain, decoded on the card --------


def _decode_batch(art, scores, lengths, device):
    """Both kernels' launches and the results of one `BatchDecoder` wave at
    `WSJ_POINT` over padded (B, T, G) scores."""
    dec = TorchDecoder(art, wsj_task.decoder_config(), device=device)
    n0 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    results = BatchDecoder(dec).decode_scores_batch(scores, lengths)
    return results, (gmm_cuda.counter.launches - n0[0], fused_scan.counter.launches - n0[1])


@pytest.mark.gpu
def test_toolchain_synth_task_on_the_card_equals_the_cpu(card):
    """`utils.synth.make_synth_task` (lexicon, models, CLG and artifact made
    by the port's toolchain from a seed, no JAX) on the card: four sampled
    utterances scored by the GMM kernel, decoded by the frame-step kernel
    in one wave, equal the CPU's decode of the same scores; every
    utterance decodes to its words."""
    from juicer_tpu_torch.utils.synth import make_synth_task

    task = make_synth_task(n_words=20, n_phones=10, n_comps=4, vec_size=13, seed=3)
    rng = np.random.default_rng(5)
    utts = [[f"w{i}" for i in rng.integers(20, size=int(rng.integers(2, 5)))] for _ in range(4)]
    feats = [task.synth_utterance(u, rng) for u in utts]
    scorer = make_gmm_scorer(task.models.flat_params(), device=card)
    n0 = gmm_cuda.counter.launches
    scs = [scorer(torch.as_tensor(f, device=card)) for f in feats]
    assert gmm_cuda.counter.launches - n0 == len(feats)
    lengths = [len(f) for f in feats]
    T = max(lengths)
    scores = torch.stack([torch.cat([s, s[-1:].expand(T - len(s), -1)]) for s in scs])
    got, launches = _decode_batch(task.artifact, scores, lengths, card)
    want, _ = _decode_batch(task.artifact, scores.cpu(), lengths, "cpu")
    assert launches == (0, 1)
    vocab = task.lexicon.vocab
    for r, w, u in zip(got, want, utts):
        assert not r.overflow and not r.empty
        assert (r.words, r.score) == (w.words, w.score)
        assert [h.end_frame for h in r.word_hyps] == [h.end_frame for h in w.word_hyps]
        assert [vocab.get_word(x - 1) for x in r.words] == u


TOOLCHAIN_LM = """\\data\\
ngram 1=4
ngram 2=5

\\1-grams:
-0.60206 </s>
-99 <s> -0.30103
-0.47712 a -0.30103
-0.60206 cat -0.30103

\\2-grams:
-0.30103 <s> a
-0.4 <s> cat
-0.47712 a cat
-0.30103 cat </s>
-0.5 a </s>

\\end\\
"""


@pytest.mark.gpu
def test_toolchain_cli_task_on_the_card_equals_the_cpu(card, cli_task, tmp_path):
    """The port's CLIs build a tiny task from `cli_task`'s lexicon and
    phone models (`jtpu-gramgen-torch -gramType ngram` over a bigram LM,
    `jtpu-lexgen-torch`, `jtpu-cdgen-torch -cdType monophone`,
    `jtpu-build-wfst-torch`); `jtpu-juicer-torch` decodes its final.fsm on
    the card through both kernels, equal to `-device cpu`, 100 % word
    accuracy."""
    from juicer_tpu_torch.cli import build_wfst, cdgen, gramgen, juicer, lexgen

    td = tmp_path
    (td / "phones.lst").write_text("\n".join(CLI_PHONES) + "\n")
    (td / "lm.arpa").write_text(TOOLCHAIN_LM)

    def outs(prefix):
        return ["-fsmFName", str(td / f"{prefix}.fsm"), "-inSymsFName",
                str(td / f"{prefix}.insyms"), "-outSymsFName", str(td / f"{prefix}.outsyms")]

    lex, marks = str(cli_task / "lex.dict"), ["-sentStartWord", "<s>", "-sentEndWord", "</s>"]
    assert gramgen.main(["-lexFName", lex, *marks, "-gramType", "ngram", "-lmFName",
                         str(td / "lm.arpa"), *outs("g")]) == 0
    assert lexgen.main(["-monoListFName", str(td / "phones.lst"), "-lexFName", lex, *marks,
                        "-silMonophone", "sil", "-outputAuxPhones", *outs("l")]) == 0
    assert cdgen.main(["-cdType", "monophone", "-monoListFName", str(td / "phones.lst"),
                       "-silMonophone", "sil", "-lexInSymsFName", str(td / "l.insyms"),
                       *outs("c")]) == 0
    assert build_wfst.main([str(td / f"{m}.fsm") for m in "glc"]) == 0
    argv = _cli_argv(cli_task)
    for flag, name in (("-fsmFName", "final.fsm"), ("-inSymsFName", "final.insyms"),
                       ("-outSymsFName", "final.outsyms")):
        argv[argv.index(flag) + 1] = str(td / name)
    texts = {}
    for dev in ("cuda", "cpu"):
        out = td / f"{dev}.out"
        n0 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
        report = juicer.run(argv + ["-device", dev, "-outputFName", str(out)])
        launches = (gmm_cuda.counter.launches - n0[0], fused_scan.counter.launches - n0[1])
        texts[dev] = [ln for ln in out.read_text().splitlines() if not ln.startswith(TIMING)]
        if dev == "cuda":
            assert report.route == "route: frame_step kernel"
            assert launches == (len(CLI_UTTS), len(CLI_UTTS)), launches
    assert texts["cuda"] == texts["cpu"]
    assert any(ln.startswith("Word accuracy = 100.00%") for ln in texts["cuda"])


# ---- the reference-scale tools (harness/wsj_bench.py, wsj_sweep.py) ---------


@pytest.mark.gpu
def test_steady_bench_on_the_kernel_route(card):
    """`wsj_bench.steady_bench` on the 2k task at `WSJ_POINT`: route
    frame_step, overflow 0, one launch of the GMM kernel for the scores of
    the wave and one of the frame-step kernel a wave (two waves: the first
    and the timed one); the benched wave's words equal the entry point's."""
    from juicer_tpu_torch.harness import wsj_bench

    task = wsj_task.load_task("2k", verbose=False)
    utts = wsj_task.sample_utterances(task.cache, task.models, 2, 300, seed=11)
    scorer = make_gmm_scorer(task.models.flat_params(), device=card)
    cfg = wsj_task.decoder_config()
    Tmax = max(f.shape[0] for _, f in utts)
    feats = torch.stack([torch.as_tensor(f, device=card)[
        torch.arange(Tmax, device=card).clamp(max=f.shape[0] - 1)] for _, f in utts])
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    db = scorer(feats.reshape(-1, feats.shape[-1])).view(len(utts), Tmax, -1)
    got = wsj_bench.steady_bench(task.artifact, cfg, db, [2], device=card)
    assert (gmm_cuda.counter.launches, fused_scan.counter.launches) == (1, 2)
    assert got[2]["route"] == "frame_step" and got[2]["overflow"] == 0 and got[2]["fps"] > 0
    dec = TorchDecoder(task.artifact, cfg, device=card)
    labels, markers = wsj_task.word_labels(task.cache)
    for r, (words, _) in zip(BatchDecoder(dec).decode_scores_batch(
            db, [f.shape[0] for _, f in utts]), utts):
        assert [w for w in r.words if w not in markers] == [labels[w] for w in words]


@pytest.mark.gpu
def test_sweep_rung_past_shared_memory_takes_the_plain_loop(card):
    """A rung whose budgets need more shared memory than a block has
    (free text on confusable, mismatched models at 60/40/300: the CPU
    tunes K=1536, E=1664 on these two utterances) runs through the kernel
    with its search state in device memory: its row and its bench records
    name frame_step, nothing overflows, and tuning it through the kernel
    gives the CPU's budgets."""
    from juicer_tpu_torch.harness import wsj_sweep

    task = wsj_task.load_task("2k", verbose=False)
    args = wsj_sweep.parse_args(["--words", "2000", "--batch", "2", "--frames", "150",
                                 "--settings", "60,40,300", "--center-scale", "0.8",
                                 "--free-text", "--mismatch", "1.5", "--batches", "2"])
    inp = wsj_sweep.prepare(args, task.net, task.artifact, task.cache)
    dec = TorchDecoder(task.artifact, TorchDecoderConfig(max_insts=2048, expand_budget=4096),
                       device=card)
    assert fused_scan.why_not_fused(dec) is None and not fused_scan._dims(dec)["state_in_smem"]
    fused_scan.counter.launches = 0
    row = wsj_sweep.rung(args, "60,40,300", task.net, task.artifact, inp, "card")
    assert fused_scan.counter.launches > 0
    assert "error" not in row and row["overflow"] == 0
    assert row["route"] == "frame_step" and (row["K"], row["E"]) == (1536, 1664)
    assert row["bench"]["2"]["route"] == row["route"] and row["bench"]["2"]["overflow"] == 0


# ---- the last tools: the probe kernels, scale_bench, profile_step, graft ----

# The blocks `probe_cuda.extract` copies, (rows, cols, row0, n_rows, col0,
# n_cols, shift): x is (rows, cols) of float32 starting `shift` floats into
# its buffer (`_shifted`). Held to the plain version on the card here and to
# numpy's slicing on the CPU (`test_torch_pallas_probe.py`).
EXTRACT_CASES = [
    (2048, 16, 0, 256, 0, 16, 0),  # H: one contiguous span of 1,024 float4s
    (301, 19, 0, 301, 0, 19, 0),  # a whole matrix, 5,719 floats: a tail of 3
    (300, 19, 0, 300, 0, 19, 0),  # a whole matrix, 5,700 floats: no tail
    (2048, 16, 0, 256, 0, 16, 1),  # a span off a 16-byte boundary: floats
    (301, 19, 7, 50, 0, 19, 0),  # odd row0, the span off a 16-byte boundary
    (300, 16, 7, 100, 0, 16, 0),  # odd row0, the span 16-byte aligned
    (2048, 16, 0, 2048, 0, 1, 0),  # columns: col0 = 0,
    (2048, 16, 0, 2048, 3, 1, 0),  # D, F and G's middle column,
    (300, 19, 5, 290, 18, 1, 1),  # the last column,
    (500, 1, 3, 400, 0, 1, 1),  # row_stride 1
    (300, 19, 13, 200, 4, 9, 0),  # the general block
    (300, 19, 7, 1, 18, 1, 0),  # one float
    (300, 19, 299, 1, 0, 19, 0),  # one row, the last
    (300, 19, 150, 1, 3, 11, 1),  # part of one row
    # past kMaxBlocks blocks of threads: each kernel's grid-stride loop runs
    (4100, 1040, 0, 4100, 0, 1040, 0),  # a span of 1,066,000 float4s, 256 a block
    (600_000, 2, 0, 600_000, 1, 1, 0),  # a column of 600,000 rows, 128 a block
    (20_000, 60, 0, 20_000, 1, 50, 0),  # a block of 20,000 rows, 4 rows a block
]


def _probe_counts():
    from juicer_tpu_torch.ops import probe_cuda

    return {k: c.launches for k, c in probe_cuda.counters.items()}


@pytest.mark.gpu
def test_probe_patterns_match_plain(card):
    """All nine probes of `harness/pallas_probe` on the card: each kernel
    equals its plain version (exactly for D-I, within 1e-5 relative for
    A-C), one launch a call of each."""
    from juicer_tpu_torch.harness import pallas_probe

    before = _probe_counts()
    records = pallas_probe.run(card)
    assert len(records) == 9 and all(r["ok"] for r in records), [
        (r["name"], r["err"]) for r in records if not r["ok"]]
    after = _probe_counts()
    # each probe: its first call, one plain-version comparison (no launch)
    # and two timings of 51 calls each (a warm-up and 50), more where a
    # profiler session recorded nothing and `device_ms_split` timed again
    for name in after:
        calls = [r["calls"] for r in records if r["kernel"] == name]
        assert all(c >= 103 for c in calls), (name, calls)
        assert after[name] - before[name] == sum(calls), name


@pytest.mark.gpu
@pytest.mark.parametrize("R,Kd,N", [(1, 1, 1), (17, 3, 5), (2048, 128, 16), (4099, 64, 40)])
def test_probe_product_edges(card, R, Kd, N):
    """Rows past a block's 16, odd depths and widths: within 1e-5 relative
    (and 1e-6 absolute for sums near 0) of the plain version."""
    from juicer_tpu_torch.ops import probe_cuda

    rng = np.random.default_rng([R, Kd, N])
    x = torch.as_tensor(rng.normal(size=(R, Kd)).astype(np.float32), device=card)
    t = torch.as_tensor(rng.normal(size=(Kd, N)).astype(np.float32), device=card)
    got = probe_cuda.product(x, t)
    want = probe_cuda.product_plain(x.double(), t.double())
    assert ((got.double() - want).abs() <= 1e-5 * want.abs() + 1e-6 * Kd).all()


@pytest.mark.gpu
def test_probe_gather_and_extract_edges(card):
    """Indices that match no one-hot column give zero rows. The blocks of
    rows and columns that extract copies exactly are `EXTRACT_CASES`
    (`test_probe_extract_cases`)."""
    from juicer_tpu_torch.ops import probe_cuda

    rng = np.random.default_rng(3)
    tab = torch.as_tensor(rng.random((37, 7)).astype(np.float32), device=card)
    idx = torch.tensor([0.0, 36.0, 2.5, -1.0, 37.0, float("nan"), 5.0] * 40, device=card)
    assert torch.equal(probe_cuda.gather(idx, tab), probe_cuda.gather_plain(idx, tab))


@pytest.mark.gpu
@pytest.mark.parametrize("case", EXTRACT_CASES, ids=str)
def test_probe_extract_cases(card, case):
    """Each of `EXTRACT_CASES` through the kernel, one launch, equal to
    the plain version: the contiguous span by float4 with and without a
    tail and by floats off a 16-byte boundary, columns, the general block,
    one row, and copies whose grid-stride loops run."""
    from juicer_tpu_torch.ops import probe_cuda

    rows, cols, row0, n_rows, col0, n_cols, shift = case
    x = _shifted(np.random.default_rng(list(case)).random((rows, cols)), card, shift)
    before = probe_cuda.counters["probe_extract"].launches
    got = probe_cuda.extract(x, row0, n_rows, col0, n_cols)
    assert probe_cuda.counters["probe_extract"].launches == before + 1
    assert torch.equal(got, probe_cuda.extract_plain(x, row0, n_rows, col0, n_cols))


@pytest.mark.gpu
def test_probe_extract_64bit_offsets(card):
    """Columns whose extent passes 2^31 floats (8.6 GB), offsets past 31
    bits: equal to the plain version."""
    from juicer_tpu_torch.ops import probe_cuda

    rows = 2 ** 27 + 8
    x = torch.rand((rows, 16), device=card, generator=torch.Generator(card).manual_seed(0))
    for args in ((0, rows, 15, 1), (5, rows - 5, 0, 1)):
        assert torch.equal(probe_cuda.extract(x, *args), probe_cuda.extract_plain(x, *args))
    del x
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_probe_kernels_refuse_bad_input(card):
    from juicer_tpu_torch.ops import probe_cuda

    x = torch.zeros((8, 4), device=card)
    with pytest.raises(ValueError, match="float32"):
        probe_cuda.product(x.double(), torch.zeros((4, 2), device=card, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        probe_cuda.product(x.t(), torch.zeros((8, 2), device=card))
    with pytest.raises(ValueError, match="shared memory"):
        probe_cuda.product(torch.zeros((2, 4096), device=card), torch.zeros((4096, 4),
                                                                              device=card))
    with pytest.raises(ValueError, match="not inside"):
        probe_cuda.extract(x, 4, 5, 0, 4)
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe_cuda.gather(torch.zeros(4, device=card), torch.zeros((4, 2)))


def _shifted(a, card, by):
    """The numpy array `a` on the card as a contiguous float32 view that
    starts `by` floats into its buffer (by=1: data_ptr() not 16-byte
    aligned)."""
    buf = torch.empty(a.size + by, dtype=torch.float32, device=card)
    view = buf[by:].view(a.shape)
    view.copy_(torch.as_tensor(a.astype(np.float32)))
    assert view.is_contiguous() and (view.data_ptr() % 16 == 0) == (by % 4 == 0)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("R,Kd,N,x_by,t_by", [
    (2048, 128, 16, 1, 0), (2048, 128, 16, 0, 1), (2048, 128, 16, 3, 2),
    (33, 130, 16, 0, 0), (29, 6, 18, 0, 0), (1000, 129, 7, 0, 0), (15, 128, 33, 0, 3),
    (17, 257, 12, 1, 0), (100, 5, 4, 0, 0),
    (33, 700, 1, 0, 0)])  # 56,320 bytes of shared memory: the block opts in past 48 KB
def test_probe_product_paths(card, R, Kd, N, x_by, t_by):
    """The product on inputs that start off a 16-byte boundary (t's rows
    then staged by plain loads), on Kd and N that are not multiples of 4
    or of a pass's 128 / 16, and on R that is not a multiple of a block's
    32 rows: within 1e-5 relative (and 1e-6 absolute a k) of the float64
    plain version, as `test_probe_product_edges`."""
    from juicer_tpu_torch.ops import probe_cuda

    rng = np.random.default_rng([R, Kd, N, x_by, t_by])
    x = _shifted(rng.normal(size=(R, Kd)), card, x_by)
    t = _shifted(rng.normal(size=(Kd, N)), card, t_by)
    before = probe_cuda.counters["probe_product"].launches
    got = probe_cuda.product(x, t)
    assert probe_cuda.counters["probe_product"].launches == before + 1
    want = probe_cuda.product_plain(x.double(), t.double())
    assert ((got.double() - want).abs() <= 1e-5 * want.abs() + 1e-6 * Kd).all()


@pytest.mark.gpu
def test_probe_product_smem_takes_every_earlier_shape(card):
    """A product block stages t padded to whole row groups and column tiles
    (`jtpu_probe_product_smem_bytes`), up to 227 KB: every (Kd, N) the first
    kernel took (t and 16 rows of x within 48 KB) still fits; t of
    (4096, 4) still does not; the probe's (128, 16) takes 10,240 bytes."""
    from juicer_tpu_torch.ops import probe_cuda

    smem = probe_cuda._get_lib().jtpu_probe_product_smem_bytes
    for N in range(1, 12288 // 17 + 1):
        Kd = 12288 // (N + 16)  # the most the first kernel took at this width
        assert smem(Kd, N) <= probe_cuda.PRODUCT_SMEM_LIMIT, (Kd, N)
    assert smem(4096, 4) > probe_cuda.PRODUCT_SMEM_LIMIT
    assert smem(128, 16) == 4 * 128 * 20
    assert smem(3, 5) == 4 * 8 * 20 and smem(64, 40) == 4 * 64 * 52


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,tab_by", [
    (2048, 16, 0), (2048, 16, 1), (1001, 7, 0), (37, 8, 2), (33, 12, 0), (5, 1, 0),
    (4099, 16, 0)])
def test_probe_gather_paths(card, R, W, tab_by):
    """The gather by float4 (W % 4 == 0, the table 16-byte aligned) and by
    floats (W = 7, 1, or a table that starts off a 16-byte boundary), R not
    a multiple of a block's 32 rows; indices that match no one-hot column
    (a fraction, negative, past the table, NaN) give zero rows: exactly
    the plain version."""
    from juicer_tpu_torch.ops import probe_cuda

    rng = np.random.default_rng([R, W, tab_by])
    tab = _shifted(rng.random((37, W)), card, tab_by)
    idx = rng.integers(0, 37, R).astype(np.float32)
    odd = np.array([2.5, -1.0, 37.0, np.nan, 36.0, 0.0, -0.0, 1e9], np.float32)
    idx[::3] = odd[np.arange(len(idx[::3])) % len(odd)]
    idx = torch.as_tensor(idx, device=card)
    before = probe_cuda.counters["probe_gather"].launches
    got = probe_cuda.gather(idx, tab)
    assert probe_cuda.counters["probe_gather"].launches == before + 1
    assert torch.equal(got, probe_cuda.gather_plain(idx, tab))
    assert not got[0::24].any()  # idx[0] = 2.5 and every 24th row after it


@pytest.mark.gpu
def test_probe_yardsticks_are_not_counted(card):
    """The floor's kernel and the one-float kernel launch and count as no
    probe kernel; the one-float kernel copies the float."""
    from juicer_tpu_torch.ops import probe_cuda

    before = _probe_counts()
    src, dst = torch.full((3,), 2.5, device=card), torch.zeros(2, device=card)
    probe_cuda.empty(card)
    probe_cuda.touch(src, dst)
    torch.cuda.synchronize()
    assert _probe_counts() == before
    assert dst.tolist() == [2.5, 0.0]


@pytest.mark.gpu
def test_probe_against_this_tree(card, capsys):
    """`harness/probe_against` builds a source outside the package and
    times it beside the package's kernels in turns with the yardsticks:
    here this tree's own source against itself, probe E (a gather)."""
    from juicer_tpu_torch import _cuda_build
    from juicer_tpu_torch.harness import probe_against

    src = os.path.join(_cuda_build.CSRC, "probe_patterns.cu")
    records = probe_against.compare(src, "E")
    assert [r["name"] for r in records] == ["E_onehot_gather_2d"]
    rec, = records
    assert rec["ok"] and len(rec["this"]) == len(rec["other"]) == 2
    # each turn one profiler session: no kernel under the floor
    assert all(0 < t["floor"] < t["kernel"] for t in rec["this"] + rec["other"])
    assert "PASS E_onehot_gather_2d (probe_gather)" in capsys.readouterr().out


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "port_bench", "configs")


@pytest.mark.gpu
@pytest.mark.parametrize("name, config, in_smem", [("2k", "wsj20k", True),
                                                   ("2k", "wsj20k-tri1", False),
                                                   ("20k-tri1", "wsj20k-tri1", False)])
def test_frame_step_at_the_benchmark_points_equals_plain(card, name, config, in_smem):
    """A wave of 4 sentences at a benchmark configuration's point: at the
    monophone's (K=1,024, E=1,664) the search state rides in shared memory
    beside one frame's score row; at the triphone's (K=8,576, E=12,672) it
    lies in a workspace of device memory. On the 20k-tri1 task (G=2,000
    tied states of 3 to 12 components, ~9,800 HMMs) the HMM tables stay in
    device memory; on the 2k monophone task (G=141) they are staged. The
    kernel equals the plain loop bit for bit, and every utterance's words
    are its transcript."""
    with open(os.path.join(CONFIGS, f"{config}.json")) as fd:
        point = json.load(fd)["point"]
    task = wsj_task.load_task(name, verbose=False, cache=name == "2k")
    utts = wsj_task.sample_utterances(task.cache, task.models, 4, 200, seed=12)
    scorer = make_gmm_scorer(task.models.flat_params(), device=card)
    lens = [len(f) for _, f in utts]
    scores = torch.stack([scorer(torch.as_tensor(f, device=card)[
        torch.arange(max(lens), device=card).clamp(max=len(f) - 1)]) for _, f in utts])
    dec = TorchDecoder(task.artifact, wsj_task.decoder_config(point), device=card)
    assert fused_scan.fused_eligible(dec)
    fs, got = _assert_kernel_equals_plain(dec, scores.transpose(0, 1).contiguous())
    staged = fs.dims["hmm_words"] > 0
    assert (fs.dims["G"], staged) == ((141, True) if name == "2k" else (2000, False))
    assert fs.dims["state_in_smem"] is in_smem
    labels, markers = wsj_task.word_labels(task.cache)
    for (words, _), r in zip(utts, assemble_results(dec, fs, *got, lens)):
        assert not r.overflow
        assert [w for w in r.words if w not in markers] == [labels[w] for w in words]
    del task, dec, fs, got
    gc.collect()
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def scale_small():
    """`scale_bench`'s network kind at 20,000 arcs with its 2,000 models
    (6,000 GMMs of 8 components, D=39)."""
    from juicer_tpu_torch.harness import scale_bench

    _, models, art, _ = scale_bench.build(20_000)
    return models, art


@pytest.mark.gpu
def test_frame_step_at_6000_gmms_equals_plain(card, scale_small):
    """K=768 / E=1024 at G=6,000 fits a block (a frame of scores takes 24
    KB of it); K=1024 / E=1408 does not, and the kernel keeps its search
    state in device memory. On a B=2 wave of the script's scores the
    kernel equals the plain loop bit for bit at both."""
    from juicer_tpu_torch.harness import scale_bench

    models, art = scale_small
    for K, E, in_smem in ((768, 1024, True), (1024, 1408, False)):
        dec = TorchDecoder(art, scale_bench.decoder_config(K, E), device=card)
        assert fused_scan.why_not_fused(dec) is None
        sc = dec.scores_tensor(scale_bench.score_batch(2, models.n_gmms, T=60))
        fs = FusedDecodeScan(dec, 2)
        assert fs.dims["state_in_smem"] is in_smem
        got = fs(sc.transpose(0, 1).contiguous())
        carry, ys, _ = dec.run(sc)
        assert state_differences(got, (carry, compact_records(ys))) == []


@pytest.mark.gpu
def test_gmm_kernel_at_6000_gmms_matches_plain(card, scale_small):
    models, _ = scale_small
    scorer = make_gmm_scorer(models.flat_params(), device=card)
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(999, 39)).astype(np.float32),
                        device=card)
    got = scorer(x)
    want = gmm_scores_dense(x, scorer.V, scorer.M, scorer.b, scorer.mask)
    assert got.shape == (999, 6000) and float((got - want).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_profile_step_on_the_card_restores_its_stubs(card):
    from juicer_tpu_torch.harness import profile_step

    task, dec = profile_step.build(card)
    sc = dec.scores_tensor(profile_step.score_batch(2, 20, task.models.n_gmms))
    before = dec.run(sc)[0]["best_final"]["score"]
    fused_scan.counter.launches = 0
    out = profile_step.profile(dec, sc, iters=1)
    assert fused_scan.counter.launches == 2  # the frame_step line: warm-up, one timed
    assert np.array_equal(out["full"]["best_final"], out["full (frame_step)"]["best_final"])
    assert torch.equal(dec.run(sc)[0]["best_final"]["score"], before)
    assert not {"_merge_and_insert", "_expand", "_final_rows", "_best_final"} & set(vars(dec))


@pytest.mark.gpu
def test_graft_entry_on_the_card_equals_the_cpu(card):
    """`entry`'s step on the card (one launch of each kernel) gives the CPU
    step's best final within 1e-3; `dryrun_multichip` over two replicas on
    the card passes its checks."""
    from juicer_tpu_torch import graft_entry
    from juicer_tpu_torch.utils.synth import make_synth_task

    fn, _ = graft_entry.entry(card)
    cpu_fn, _ = graft_entry.entry("cpu")
    f = make_synth_task(n_words=30, n_phones=16, vec_size=20, seed=0).synth_utterance(
        ["w3", "w17"], np.random.default_rng(5))[:50]
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    got = float(fn(torch.as_tensor(f, device=card)))
    assert (gmm_cuda.counter.launches, fused_scan.counter.launches) == (1, 1)
    want = float(cpu_fn(torch.as_tensor(f)))
    assert got > -1e29 and abs(got - want) <= 1e-3
    out = graft_entry.dryrun_multichip(2, device=card, mesh=(card, card))
    assert len(out["fused"]) == 16 and out["routes"]["fused"] == "frame_step"
