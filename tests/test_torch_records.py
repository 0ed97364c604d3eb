"""Compact traceback records of the PyTorch port.

The fused scan hands back only the records that landed (`records`,
`rec_count`), where `TorchDecoder.run` and the JAX package write seven
dense (T, B, K) planes. Here, on the CPU:

  - `compact_records` and `expand_records` are each other's inverse, on
    fuzz networks and the synth CLG of `tests/test_torch_fused.py`, with
    and without a binding `max_emit_hyps`, for B in {1, 3}, whole and in
    two carried pieces, and on random sparse planes (a `hypothesis`
    property);
  - the traceback through the compact lookup gives the dense route's
    `DecodeResult` field for field, and the JAX `TpuDecoder`'s words and
    word-end frames on the same numpy scores (float32; scores within the
    1e-4 that `tests/test_torch_decoder.py` states);
  - the walked route (`fused_scan.assemble_results`) equals the host
    lookup, and the walk's header layout is the kernel source's;
  - `decode_scores` of a CPU decoder still runs the plain frame loop.
"""

import contextlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.parallel.mesh import BatchDecoder as JaxBatchDecoder

from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig
from juicer_tpu_torch.decoder import fused_scan
from juicer_tpu_torch.decoder.core import REC_FIELDS, REC_WORDS, host_batch
from juicer_tpu_torch.decoder.fused_scan import (REC_NAMES, SNAP_NAMES, YS_NAMES,
                                                 FusedDecodeScan, compact_records,
                                                 concat_records, expand_records,
                                                 state_differences)
from juicer_tpu_torch.parallel.mesh import BatchDecoder

from test_decoder import scores_matrix
from test_fuzz_parity import random_case
# `_one_torch_thread` is autouse; `synth` is the fused tests' module fixture
from test_torch_decoder import ROWS, SCORE_TOL, _one_torch_thread, budgets, carry_across  # noqa: F401
from test_torch_fused import BUDGETS, synth  # noqa: F401


def assert_dense_equal(a, b, ctx=""):
    assert set(a) == set(b) == set(REC_NAMES)
    for k in REC_NAMES:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{ctx}{k}"


def assert_compact_equal(a, b):
    """Two compact `ys`: counts, snapshots and the written records."""
    assert set(a) == set(b) == set(YS_NAMES)
    for k in ("rec_count",) + SNAP_NAMES:
        assert torch.equal(a[k], b[k]), k
    n = a["rec_count"][-1]
    for u in range(n.shape[0]):
        assert torch.equal(a["records"][u, : n[u]], b["records"][u, : n[u]]), u


def check_round_trip(dec, scores_btg, cut):
    """Dense planes of `run` -> compact -> dense, whole and in two pieces
    cut at frame `cut` with the state carried."""
    K = dec.K
    carry, dense, _ = dec.run(scores_btg)
    compact = compact_records(dense)
    n = compact["rec_count"][-1]
    assert compact["records"].shape[0] == scores_btg.shape[0]
    assert int(n.sum()) == int((dense["rec_seq"] != 0).sum())
    for u in range(n.shape[0]):
        ids = compact["records"][u, : n[u], 0]
        assert bool((ids[1:] > ids[:-1]).all())  # (frame, slot) order
    assert_dense_equal(expand_records(compact, K), dense)
    assert_compact_equal(compact_records(expand_records(compact, K)), compact)

    c1, d1, _ = dec.run(scores_btg[:, :cut])
    c2, d2, _ = dec.run(scores_btg[:, cut:], carry=c1, t0=cut)
    p1, p2 = compact_records(d1), compact_records(d2, t0=cut)
    assert_dense_equal(expand_records(p2, K, t0=cut),
                       {k: v[cut:] for k, v in dense.items()}, "second piece ")
    joined = concat_records([p1, p2])
    assert_compact_equal(joined, compact)
    assert state_differences((c2, joined), (carry, compact)) == []
    return int(n.sum())


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("net_seed", [0, 2, 3, 6])
def test_compact_expand_inverse_on_fuzz_network(tmp_path, net_seed, B):
    """Rows 0: no pruning; 2 and 6: beams and maxHyps 3; 3: maxHyps 2."""
    big = net_seed >= 6
    _, models, net = random_case(net_seed, max_states=64 if big else 9)
    _, _, part = carry_across(tmp_path, net, models, JaxArtifact(net, models))
    cfg = TorchDecoderConfig(**budgets(big), **ROWS[net_seed % len(ROWS)])
    dec = TorchDecoder(part, cfg, device="cpu")
    T = 30
    scores = np.stack([scores_matrix(models, T, seed=net_seed * 10 + u) for u in range(B)])
    check_round_trip(dec, torch.as_tensor(scores.astype(np.float32)), cut=11)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("max_hyps", [0, 10])
def test_compact_expand_inverse_on_synth_clg(synth, max_hyps, B):
    dec = TorchDecoder(synth[1], TorchDecoderConfig(
        **BUDGETS, emit_prune_win=150.0, phone_end_prune_win=75.0, max_emit_hyps=max_hyps),
        device="cpu")
    tbg = torch.as_tensor(synth[2][:, :B])
    assert check_round_trip(dec, tbg.transpose(0, 1), cut=50) > 0
    # the fused scan's CPU route hands back the same compact form
    fs = FusedDecodeScan(dec, B)
    carry, ys = fs(tbg)
    _, dense, _ = dec.run(tbg.transpose(0, 1))
    assert_compact_equal(ys, compact_records(dense))
    first = fs(tbg[:50])
    second = fs(tbg[50:], carry=first[0], t0=50)
    assert state_differences((second[0], concat_records([first[1], second[1]])),
                             (carry, ys)) == []


@settings(max_examples=40, deadline=None)
@given(T=st.integers(1, 6), B=st.integers(1, 3), K=st.integers(1, 9),
       density=st.floats(0.0, 1.0), t0=st.integers(0, 5), seed=st.integers(0, 2**31 - 1))
def test_round_trip_on_random_sparse_planes(T, B, K, density, t0, seed):
    """Any planes that hold filler wherever `rec_seq` is 0 survive the
    round trip; the count plane is the running number of records."""
    rng = np.random.default_rng(seed)
    landed = rng.random((T, B, K)) < density
    dense = {}
    for name in REC_FIELDS:
        if name in ("rec_score", "rec_ac", "rec_lm"):
            vals = rng.normal(scale=50.0, size=(T, B, K)).astype(np.float32)
            vals[rng.random((T, B, K)) < 0.1] = -0.0
            dense[name] = np.where(landed, vals, np.float32(-1e30))
        elif name == "rec_seq":
            dense[name] = np.where(landed, rng.integers(1, 99, (T, B, K)), 0).astype(np.int32)
        else:
            dense[name] = np.where(landed, rng.integers(-5, 2**31 - 1, (T, B, K)), -1).astype(np.int32)
    for name in SNAP_NAMES:
        dense[name] = rng.integers(0, 9, (T, B)).astype(
            np.float32 if name in ("bf_score", "bf_ac", "bf_lm") else np.int32)
    dense = {k: torch.as_tensor(v) for k, v in dense.items()}
    compact = compact_records(dense, t0=t0)
    assert compact["records"].shape[2] == len(REC_WORDS)
    np.testing.assert_array_equal(compact["rec_count"].numpy(),
                                  np.cumsum(landed.sum(axis=2), axis=0))
    back = expand_records(compact, K, t0=t0)
    for k in REC_NAMES:
        # bit for bit: -0.0 stays -0.0
        assert torch.equal(back[k].view(torch.int32), dense[k].view(torch.int32)), k
    if T > 1:
        pieces = [compact_records({k: v[:1] for k, v in dense.items()}, t0=t0),
                  compact_records({k: v[1:] for k, v in dense.items()}, t0=t0 + 1)]
        assert_compact_equal(concat_records(pieces), compact)


@pytest.mark.parametrize("max_hyps", [0, 10])
def test_traceback_through_compact_lookup(synth, max_hyps):
    """The fused route's results (compact records, `searchsorted` lookup)
    equal the dense route's field for field, and the JAX decoder's words,
    word-end frames and scores."""
    kw = dict(emit_prune_win=150.0, phone_end_prune_win=75.0, max_emit_hyps=max_hyps)
    task, part, scores, utts, lens = synth
    pdec = TorchDecoder(part, TorchDecoderConfig(**BUDGETS, **kw), device="cpu")
    jdec = TpuDecoder(task.artifact, TpuDecoderConfig(**BUDGETS, emit_diagnostics=True, **kw))
    btg = np.ascontiguousarray(scores.transpose(1, 0, 2))
    compact = BatchDecoder(pdec, use_fused=True).decode_scores_batch(btg, lens)
    dense = BatchDecoder(pdec, use_fused=False).decode_scores_batch(btg, lens)
    assert compact == dense  # dataclasses: every field, every word hypothesis
    for u in range(3):
        got, want = compact[u], jdec.decode_scores(utts[u])
        assert got.words == want.words and got.words
        assert [h.end_frame for h in got.word_hyps] == [h.end_frame for h in want.word_hyps]
        assert abs(got.score - want.score) < SCORE_TOL
        assert abs(got.acoustic_score - want.acoustic_score) < SCORE_TOL
        assert abs(got.lm_score - want.lm_score) < SCORE_TOL
    # the host copy holds the written rows only
    fs = FusedDecodeScan(pdec, scores.shape[1])
    carry, ys = fs(torch.as_tensor(scores))
    carry_h, ys_h, rec0_h = host_batch(carry, ys, fs.rec0)
    assert ys_h["records"].shape == (int(ys["rec_count"][-1].sum()), len(REC_WORDS))
    assert ys_h["rec_offsets"][-1] == len(ys_h["records"])
    # a record id that is not there is an error, not a wrong row
    ys_h = dict(ys_h, records=ys_h["records"][:0],
                rec_offsets=np.zeros_like(ys_h["rec_offsets"]))
    with pytest.raises(RuntimeError, match="no record"):
        pdec.traceback((carry_h, ys_h, rec0_h), 0, scores.shape[0])
    # and so is one the walk does not find
    bad = dict(ys, records=ys["records"].clone())
    bad["records"][0, :, 0] = -5
    with pytest.raises(RuntimeError, match="no record .* of utterance 0"):
        fused_scan.assemble_results(pdec, fs, carry, bad, lens)


def path_ids(host, b, T, n, K):
    """The record ids of utterance b's best path at its true length n, read
    from a `host_batch` copy apart from either traceback."""
    carry, ys, rec0 = host
    pid = int(ys["bf_path"][n - 1, b] if 0 < n < T else carry["best_final"]["path"][b])
    lo, hi = ys["rec_offsets"][b], ys["rec_offsets"][b + 1]
    prev = dict(zip(ys["records"][lo:hi, 0].tolist(), ys["records"][lo:hi, 1].tolist()))
    out = []
    while pid != -1:
        out.append(pid)
        pid = prev[pid] if pid >= 0 else int(rec0["rec_prev"][b, pid + K])
    return out


TINY = dict(max_insts=8, expand_budget=16, final_budget=8)


@pytest.mark.parametrize("net_seed,big,tiny", [(3, False, True), (0, True, False),
                                               (1, True, True)])
def test_walked_paths_equal_host_lookup_on_fuzz_network(tmp_path, net_seed, big, tiny):
    """On fuzz networks whose initial propagation lands word records, the
    walked route (`assemble_results`) equals the host lookup's
    `traceback` field for field and the JAX `BatchDecoder`'s words,
    word-end frames, flags and scores, padded: paths that end in an init
    record (id < 0), empty results and, with budgets of 8 slots, flagged
    overflows."""
    _, models, net = random_case(net_seed, max_states=64 if big else 9)
    jart = JaxArtifact(net, models)
    _, _, part = carry_across(tmp_path, net, models, jart)
    kw = dict(TINY if tiny else budgets(big), **ROWS[net_seed % len(ROWS)])
    dec = TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")
    lens = [30, 17, 5]
    scores = np.stack([scores_matrix(models, 30, seed=net_seed * 10 + u)
                       for u in range(len(lens))]).astype(np.float32)
    fs = FusedDecodeScan(dec, len(lens))
    carry, ys = fs(torch.as_tensor(scores).transpose(0, 1).contiguous())
    with pytest.warns() if tiny else contextlib.nullcontext():
        got = fused_scan.assemble_results(dec, fs, carry, ys, lens)
        host = host_batch(carry, ys, fs.rec0)
        assert got == [dec.traceback(host, b, 30, true_T=n) for b, n in enumerate(lens)]
    jdec = TpuDecoder(jart, TpuDecoderConfig(**kw, emit_diagnostics=True))
    with pytest.warns() if tiny else contextlib.nullcontext():
        want = JaxBatchDecoder(jdec, use_pallas=False).decode_scores_batch(scores, lens)
    for g, w in zip(got, want):
        assert (g.words, g.empty, g.overflow, g.n_frames, g.max_active, g.max_cand) == (
            w.words, w.empty, w.overflow, w.n_frames, w.max_active, w.max_cand)
        assert [h.end_frame for h in g.word_hyps] == [h.end_frame for h in w.word_hyps]
        assert abs(g.score - w.score) < SCORE_TOL and abs(g.lm_score - w.lm_score) < SCORE_TOL
    paths = [path_ids(host, b, 30, n, dec.K) for b, n in enumerate(lens) if not got[b].empty]
    assert any(p and p[-1] < 0 for p in paths)  # a path that ends in an init record
    assert any(r.empty for r in got) == (net_seed != 1)
    assert all(r.overflow for r in got) == tiny


def test_walk_header_layout_is_the_kernel_sources():
    """`fused_scan.HEAD`, the header words that the plain walk writes and
    the host reads, is the kernel source's `JTPU_WALK_HEAD` list in its
    order, and `HEAD_WORDS` its `kHeadWords`: the library repeats the same
    list at load, which only a card can check."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(fused_scan.__file__), os.pardir, "csrc",
                            "frame_step.cu")).read()
    body = re.search(r"#define JTPU_WALK_HEAD\(X\)(.*?)\nenum Head", src, re.S).group(1)
    assert tuple(re.findall(r"X\(\w+, (\w+)\)", body)) == fused_scan.HEAD
    assert int(re.search(r"constexpr int kHeadWords = (\d+);", src).group(1)) == \
        fused_scan.HEAD_WORDS


def test_decode_scores_on_cpu_decoder_is_the_plain_loop(synth, monkeypatch):
    """A CPU decoder's `decode_scores` runs `run` and builds no fused scan;
    `_fused_single`, the route of a decoder on the card, gives the same
    result from compact records, through the host lookup and through the
    walk that `decode_scores` reads it with on the card, and refuses what
    the kernel does not cover."""
    part, utt = synth[1], synth[3][0]
    dec = TorchDecoder(part, TorchDecoderConfig(
        **BUDGETS, emit_prune_win=150.0, phone_end_prune_win=75.0, max_emit_hyps=10), device="cpu")
    calls = []
    run = dec.run
    monkeypatch.setattr(dec, "run", lambda *a, **k: calls.append(1) or run(*a, **k))
    n0 = fused_scan.counter.launches
    want = dec.decode_scores(utt)
    assert calls == [1] and "_fused1" not in dec.__dict__
    assert fused_scan.counter.launches == n0 and want.words
    T_pad = -(-len(utt) // 128) * 128
    sc = torch.as_tensor(np.concatenate([utt, np.repeat(utt[-1:], T_pad - len(utt), axis=0)]))
    carry, ys, fs = dec._fused_single(sc)
    assert set(ys) == set(YS_NAMES) and fs is dec._fused1 and fs.B == 1
    assert dec.traceback(host_batch(carry, ys, fs.rec0), 0, T_pad, true_T=len(utt)) == want
    assert fused_scan.assemble_results(dec, fs, carry, ys, [len(utt)]) == [want]
    dec.K, dec.E = 4096, 8192  # beyond one block's shared memory
    with pytest.raises(ValueError, match="decode_scores.*shared memory.*TorchDecoder.run"):
        dec._fused_single(sc)
