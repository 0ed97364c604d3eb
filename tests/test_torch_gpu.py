"""Tests of the port that need a CUDA card (marker `gpu`).

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch; there, run it without the repository's
conftest (which configures JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from juicer_tpu_torch.am.models import LOG_ZERO, AcousticModelSet
from juicer_tpu_torch.convert import gmm_params_from_numpy
from juicer_tpu_torch.decoder import fused_scan
from juicer_tpu_torch.decoder.artifact import DecoderArtifact
from juicer_tpu_torch.decoder.core import (REC_FIELDS, TorchDecoder,
                                           TorchDecoderConfig, host_batch)
from juicer_tpu_torch.decoder.fused_scan import (REC_NAMES, FusedDecodeScan,
                                                 assemble_results, compact_records,
                                                 concat_records, expand_records,
                                                 state_differences)
from juicer_tpu_torch.decoder.network import DecoderNetwork
from juicer_tpu_torch.harness import wsj_task
from juicer_tpu_torch.ops import gmm_cuda
from juicer_tpu_torch.ops.gmm import gmm_scores_dense, make_gmm_scorer

NEG = -1e30


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _random_params(rng, D, G, C):
    """Diagonal GMMs in expanded form; every 4th GMM has one component and
    GMM 1 none (it must score -1e30)."""
    mu = rng.normal(scale=2.0, size=(G, C, D))
    var = rng.random((G, C, D)) + 0.5
    mask = np.ones((G, C), bool)
    mask[::4, 1:] = False
    mask[1] = False
    V = (-0.5 / var).reshape(G * C, D).T
    M = (mu / var).reshape(G * C, D).T
    b = (-0.5 * (mu * mu / var).sum(-1) - 0.5 * np.log(var).sum(-1)).reshape(-1)
    return gmm_params_from_numpy(V, M, b, mask), mu


@pytest.mark.gpu
@pytest.mark.parametrize("T,D,G,C", [(1, 4, 3, 2), (100, 39, 141, 8), (4099, 13, 33, 3)])
def test_kernel_matches_plain(card, T, D, G, C):
    rng = np.random.default_rng(T + D)
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
    assert (out[:, 1] == NEG).all()
    np.testing.assert_allclose(out.cpu().numpy(), dense.cpu().numpy(), atol=1e-3, rtol=0)


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
    net = DecoderNetwork()
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
def test_frame_step_refuses_bad_input(card):
    art, G = _fuzz_artifact(seed=1)
    dec = TorchDecoder(art, TorchDecoderConfig(max_insts=128, expand_budget=256), device=card)
    fs = FusedDecodeScan(dec, 2)
    scores = _fuzz_scores(0, 5, 2, G, card)
    d = fs.dims
    assert d["hmm_words"] == dec.H * dec.S * (dec.S + 1)  # staged: they fit
    assert fused_scan._get_lib().jtpu_frame_step_smem_bytes(
        d["K"], d["E"], d["S"], d["G"], d["n_bins"], d["HT"],
        d["hmm_words"]) == fused_scan.smem_bytes(**d)
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
def test_decode_scores_on_the_card_launches_the_kernel_once(card):
    art, G = _fuzz_artifact(seed=4)
    cfg = TorchDecoderConfig(max_insts=256, expand_budget=2048, final_budget=128)
    dec = TorchDecoder(art, cfg, device=card)
    cpu = TorchDecoder(art, cfg, device="cpu")
    sc = _fuzz_scores(9, 75, 1, G, "cpu")[:, 0]
    n0 = fused_scan.counter.launches
    got = dec.decode_scores(sc)
    assert fused_scan.counter.launches - n0 == 1
    want = cpu.decode_scores(sc)
    assert got == want and got.n_frames == 75
    dec.K, dec.E = 4096, 8192  # beyond one block's shared memory
    with pytest.raises(ValueError, match="decode_scores.*shared memory"):
        dec.decode_scores(sc)
    assert fused_scan.counter.launches - n0 == 1
