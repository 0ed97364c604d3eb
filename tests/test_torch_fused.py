"""Fused decode scan of the PyTorch port against the JAX package.

The same numpy scores go through the JAX `PallasDecodeScan` (in interpret
mode, as `tests/test_decode_pallas.py` runs it on the CPU) and through
the port's `FusedDecodeScan` on `device="cpu"`, where the wrapper runs the
kernel's plain version (`TorchDecoder.run`, its planes made compact by
`compact_records`). The port's compact `ys`, expanded again by
`expand_records`, is held against the JAX planes: integer fields, liveness
and overflow must be equal. Float fields are held within 1e-4: both sides are
float32 step for step, but the TPU kernel selects payloads by one-hot
sums (an exact 0.0 added per unselected term) where the port gathers, so
the tolerance is stated rather than relying on bit equality across two
frameworks; in practice they agree exactly.

With `max_emit_hyps > 0` the TPU kernel refuses, so the port's fused scan
is held against `TpuDecoder` float32 (the XLA scan) instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from juicer_tpu.decoder.pallas_scan import (PallasDecodeScan, pallas_eligible)
from juicer_tpu.decoder.pallas_scan import assemble_results as jax_assemble_results
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.ops.gmm import make_gmm_scorer
from juicer_tpu.utils.synth import make_synth_task

from juicer_tpu_torch.convert import fused_state_from_jax
from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig
from juicer_tpu_torch.decoder import fused_scan
from juicer_tpu_torch.decoder.fused_scan import (REC_NAMES, YS_NAMES, FusedDecodeScan,
                                                 assemble_results, compact_records,
                                                 concat_records, expand_records,
                                                 fused_eligible, max_scan_T,
                                                 state_differences)
from juicer_tpu_torch.harness import wsj_task
from juicer_tpu_torch.parallel.batch import BatchDecoder

# `_one_torch_thread` is autouse: these CPU tests run torch on one thread too
from test_torch_decoder import _one_torch_thread, carry_across  # noqa: F401

B, T = 8, 128
TOL = 1e-4
BUDGETS = dict(max_insts=128, expand_budget=256, final_budget=128)
BEAMS = dict(emit_prune_win=150.0, phone_end_prune_win=75.0)
INT_FIELDS = ("rec_prev", "rec_seq", "rec_src", "rec_arc", "bf_path", "bf_seq",
              "bf_src", "n_active", "n_cand")
FLOAT_FIELDS = ("rec_score", "rec_ac", "rec_lm", "bf_score", "bf_ac", "bf_lm")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synth task of tests/test_decode_pallas.py, for both packages,
    and one padded score batch (T, B, G) with true lengths."""
    task = make_synth_task(n_words=12, n_phones=8, vec_size=8, n_comps=2, seed=0)
    _, _, part = carry_across(tmp_path_factory.mktemp("fused"), task.network,
                              task.models, task.artifact)
    scorer = make_gmm_scorer(task.models.flat_params())
    rng = np.random.default_rng(3)
    scores = None
    utts, lens = [], []
    for i in range(B):
        f = task.synth_utterance([f"w{(2 * i) % 12}", f"w{(i + 1) % 12}"], rng)
        s = np.asarray(scorer(jnp.asarray(f, jnp.float32)))[:T]
        if scores is None:
            scores = np.zeros((T, B, s.shape[-1]), np.float32)
        scores[: len(s), i] = s
        scores[len(s):, i] = s[-1]
        utts.append(s)
        lens.append(len(s))
    return task, part, scores, utts, lens


def decoders(synth, **kw):
    task, part = synth[0], synth[1]
    jdec = TpuDecoder(task.artifact, TpuDecoderConfig(**BUDGETS, emit_diagnostics=True, **kw))
    pdec = TorchDecoder(part, TorchDecoderConfig(**BUDGETS, **kw), device="cpu")
    return jdec, pdec


def assert_ys_close(ys, ref, ctx=""):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(ys[k]), np.asarray(ref[k]), err_msg=f"{ctx}{k}")
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(np.asarray(ys[k]), np.asarray(ref[k]), rtol=0, atol=TOL,
                                   err_msg=f"{ctx}{k}")


def assert_same_state(a, b):
    """Two (carry, compact ys) of the port, bit for bit."""
    assert set(a[1]) == set(b[1]) == set(YS_NAMES)
    assert state_differences(a, b) == []


@pytest.mark.parametrize("beams", [True, False])
def test_fused_scan_matches_pallas(synth, beams):
    jdec, pdec = decoders(synth, **(BEAMS if beams else {}))
    scores = synth[2]
    assert pallas_eligible(jdec) and fused_eligible(pdec)
    ps = PallasDecodeScan(jdec, B=B, chunk=64, interpret=True)
    jcarry, jys = ps(jnp.asarray(scores))
    jcarry, jys = fused_state_from_jax(jax.tree.map(np.asarray, jcarry),
                                       jax.tree.map(np.asarray, jys))

    fs = FusedDecodeScan(pdec, B)
    carry, ys = fs(torch.as_tensor(scores))
    assert set(ys) == set(YS_NAMES)
    assert ys["records"].shape[::2] == (B, 8) and ys["rec_count"].shape == (T, B)
    assert ys["records"].dtype == ys["rec_count"].dtype == torch.int32
    ys = expand_records(ys, pdec.K)
    assert set(ys) == set(REC_NAMES)
    assert ys["rec_prev"].shape == (T, B, pdec.K) and ys["bf_score"].shape == (T, B)
    assert all(ys[k].dtype == torch.int32 for k in INT_FIELDS)
    assert (np.asarray(jys["rec_seq"]) != 0).any() and (np.asarray(jys["bf_score"]) > -1e29).any()
    assert_ys_close({k: v.numpy() for k, v in ys.items()}, jys)
    np.testing.assert_array_equal(carry["overflow"].numpy(), jcarry["overflow"])
    np.testing.assert_allclose(carry["norm"].numpy(), jcarry["norm"], rtol=0, atol=TOL)
    np.testing.assert_allclose(carry["best_emit"].numpy(), jcarry["best_emit"], rtol=0, atol=TOL)
    # the frontier the two kernels would resume from
    live = carry["fr"]["score"].numpy() > -1e29
    np.testing.assert_array_equal(live, jcarry["fr"]["score"] > -1e29)
    on = live.any(axis=2)
    np.testing.assert_array_equal(carry["fr"]["arc"].numpy()[on], jcarry["fr"]["arc"][on])
    np.testing.assert_array_equal(carry["fr"]["path"].numpy()[live], jcarry["fr"]["path"][live])
    np.testing.assert_allclose(carry["fr"]["score"].numpy()[live], jcarry["fr"]["score"][live],
                               rtol=0, atol=TOL)


CHUNK_ROWS = [
    dict(),
    BEAMS,
    dict(emit_prune_win=150.0, phone_end_prune_win=75.0, word_prune_win=60.0, max_emit_hyps=20),
    dict(phone_start_prune_win=100.0, max_emit_hyps=30),
]


@pytest.mark.parametrize("row", range(len(CHUNK_ROWS)))
def test_chunked_run_equals_one_piece(synth, row):
    """`TorchDecoder.run(carry=, t0=)`: two chunks of 64 frames, the state
    carried, equal one run of 128, and the carry handed in is not changed."""
    _, pdec = decoders(synth, **CHUNK_ROWS[row])
    scores = torch.as_tensor(synth[2]).transpose(0, 1)  # (B, T, G)
    whole_c, whole_y, rec0 = pdec.run(scores)
    c1, y1, rec0_1 = pdec.run(scores[:, :64])
    kept = {k: v.clone() for k, v in c1["fr"].items()}
    c2, y2, none = pdec.run(scores[:, 64:], carry=c1, t0=64)
    assert none is None
    for k, v in kept.items():
        assert torch.equal(v, c1["fr"][k]), k
    for k in rec0:
        assert torch.equal(rec0[k], rec0_1[k]), k
    for k in y1:
        assert torch.equal(torch.cat([y1[k], y2[k]]), whole_y[k]), k
    whole_compact = compact_records(whole_y)
    assert_same_state((c2, concat_records([compact_records(y1), compact_records(y2, 64)])),
                      (whole_c, whole_compact))
    assert (whole_y["rec_prev"][64:] >= 64 * pdec.K).any()  # ids carry the offset

    # the same through the fused scan's interface (its plain version)
    fs = FusedDecodeScan(pdec, B)
    tbg = torch.as_tensor(synth[2])
    f1 = fs(tbg[:64])
    f2 = fs(tbg[64:], carry=f1[0], t0=64)
    assert_same_state((f2[0], concat_records([f1[1], f2[1]])), fs(tbg))
    assert_same_state(fs(tbg), (whole_c, whole_compact))
    late = expand_records(f2[1], pdec.K, t0=64)
    for k in REC_NAMES:
        assert torch.equal(late[k], whole_y[k][64:]), k


def test_assemble_results_match_pallas(synth):
    """Words, scores and word-end frames at the true lengths equal the JAX
    `assemble_results` of the TPU kernel's output."""
    jdec, pdec = decoders(synth, **BEAMS)
    scores, lens = synth[2], synth[4]
    ps = PallasDecodeScan(jdec, B=B, chunk=64, interpret=True)
    want = jax_assemble_results(jdec, ps, *ps(jnp.asarray(scores)), lens)
    fs = FusedDecodeScan(pdec, B)
    got = assemble_results(pdec, fs, *fs(torch.as_tensor(scores)), lens)
    assert len(got) == B
    for g, w in zip(got, want):
        assert g.words == w.words and g.words
        assert [h.end_frame for h in g.word_hyps] == [h.end_frame for h in w.word_hyps]
        assert g.n_frames == w.n_frames and g.overflow == w.overflow
        assert g.score == pytest.approx(w.score, abs=TOL)
        assert g.acoustic_score == pytest.approx(w.acoustic_score, abs=TOL)
        assert g.lm_score == pytest.approx(w.lm_score, abs=TOL)


@pytest.mark.parametrize("max_hyps", [4, 10])
def test_fused_scan_with_histogram_matches_tpu_decoder(synth, max_hyps):
    """maxHyps is outside the TPU kernel's scope and inside the port's: the
    fused scan against the XLA scan of `TpuDecoder` float32."""
    kw = dict(emit_prune_win=150.0, phone_end_prune_win=75.0, max_emit_hyps=max_hyps)
    jdec, pdec = decoders(synth, **kw)
    assert not pallas_eligible(jdec) and fused_eligible(pdec)
    scores = synth[2]

    def one(s):
        carry, ys, _ = jdec._decode_scan(s.astype(jdec._dt))
        return carry, ys

    jcarry, jys = jax.vmap(one, in_axes=1)(jnp.asarray(scores))
    jys = {k: np.moveaxis(np.asarray(v), 0, 1) for k, v in jys.items()}  # (B, T, ..) -> (T, B, ..)
    carry, ys = FusedDecodeScan(pdec, B)(torch.as_tensor(scores))
    ys = expand_records(ys, pdec.K)
    assert_ys_close({k: v.numpy() for k, v in ys.items()},
                    {k: jys[k] for k in INT_FIELDS + FLOAT_FIELDS})
    np.testing.assert_array_equal(carry["overflow"].numpy(), np.asarray(jcarry["overflow"]))
    np.testing.assert_allclose(carry["norm"].numpy(), np.asarray(jcarry["norm"]), rtol=0, atol=TOL)
    # the histogram really pruned: fewer active than without it
    _, free = decoders(synth, emit_prune_win=150.0, phone_end_prune_win=75.0)
    _, ys_free = FusedDecodeScan(free, B)(torch.as_tensor(scores))
    assert ys["n_active"].sum() < ys_free["n_active"].sum()


@pytest.mark.parametrize("use_fused", ["auto", True])
def test_batch_decoder_fused_route_equals_plain(synth, use_fused):
    _, pdec = decoders(synth, emit_prune_win=150.0, phone_end_prune_win=75.0, max_emit_hyps=40)
    scores, lens = synth[2], synth[4]
    btg = np.ascontiguousarray(scores.transpose(1, 0, 2))
    bd = BatchDecoder(pdec, use_fused=use_fused)
    got = bd.decode_scores_batch(btg, lens)
    assert B in bd._fs  # the fused route ran
    plain = BatchDecoder(pdec, use_fused=False)
    want = plain.decode_scores_batch(btg, lens)
    assert not plain._fs
    for g, w in zip(got, want):
        assert g.words == w.words and g.words
        assert g.word_hyps == w.word_hyps
        assert (g.score, g.acoustic_score, g.lm_score) == (w.score, w.acoustic_score, w.lm_score)
        assert (g.n_frames, g.overflow, g.max_active, g.max_cand) == (
            w.n_frames, w.overflow, w.max_active, w.max_cand)
    # unpadded
    whole = BatchDecoder(pdec, use_fused=use_fused).decode_scores_batch(btg)
    assert [r.words for r in whole] == [r.words for r in plain.decode_scores_batch(btg)]


def test_batch_decoder_refuses_ineligible(synth):
    _, pdec = decoders(synth)
    # budgets beyond one block's shared memory (the synth network is too
    # small to reach them through the configuration)
    pdec.K, pdec.E = 4096, 8192
    assert not fused_eligible(pdec)
    btg = np.zeros((2, 4, synth[2].shape[2]), np.float32)
    with pytest.raises(ValueError, match="use_fused=True.*shared memory"):
        BatchDecoder(pdec, use_fused=True).decode_scores_batch(btg)
    with pytest.raises(ValueError, match="outside the fused scan.*shared memory"):
        FusedDecodeScan(pdec, 2)
    with pytest.raises(ValueError):
        BatchDecoder(pdec, use_fused="yes")


def test_batch_decoder_auto_on_ineligible_decoder(synth):
    """"auto" never gives way to the plain frame loop for a decoder on the
    card: it raises with the reason. For a CPU decoder, where both routes
    are the plain version, it takes `TorchDecoder.run`."""
    _, pdec = decoders(synth)
    btg = np.ascontiguousarray(synth[2].transpose(1, 0, 2))[:2, :8]
    want = BatchDecoder(pdec, use_fused=False).decode_scores_batch(btg)
    K, E = pdec.K, pdec.E
    pdec.K, pdec.E = 4096, 8192  # beyond one block's shared memory; restored below
    assert "shared memory" in fused_scan.why_not_fused(pdec)
    on_card = BatchDecoder(pdec)
    pdec.device = torch.device("cuda", 0)  # routing looks at the device only
    with pytest.raises(ValueError, match="use_fused='auto'.*shared memory.*use_fused=False"):
        on_card.decode_scores_batch(btg)
    pdec.device = torch.device("cpu")
    pdec.K, pdec.E = K, E
    # an eligible decoder, a batch beyond one scan's frame numbers
    with pytest.raises(ValueError, match="frames"):
        BatchDecoder(pdec, use_fused=True)._fused_ok(max_scan_T(pdec) + 1)
    bd = BatchDecoder(pdec)
    assert bd._fused_ok(max_scan_T(pdec) + 1) is False and bd._fused_ok(8) is True
    got = bd.decode_scores_batch(btg)
    assert [r.words for r in got] == [r.words for r in want]


def test_fused_scan_of_decoder_without_diagnostics(synth):
    """The kernel always writes the (T, B) snapshots; so does the CPU route,
    whatever the decoder's `emit_diagnostics`."""
    _, pdec = decoders(synth, **BEAMS)
    quiet = TorchDecoder(synth[1], TorchDecoderConfig(**BUDGETS, emit_diagnostics=False, **BEAMS),
                         device="cpu")
    tbg = torch.as_tensor(synth[2][:16])
    assert set(quiet.run(tbg.transpose(0, 1))[1]) == set(fused_scan.REC_FIELDS)
    fs = FusedDecodeScan(quiet, B)
    assert_same_state(fs(tbg), FusedDecodeScan(pdec, B)(tbg))
    assert quiet.cfg.emit_diagnostics is False


def test_eligibility_at_the_operating_point():
    """`WSJ_POINT` (K=1024, E=1408, S=5, 141 GMMs, beam 70 with maxHyps)
    fits one block's shared memory; twice the frontier does not."""
    p = wsj_task.WSJ_POINT
    n_bins = int(201.0 - float(int(-p["beam"] - 800.0 - 1.0))) + 1
    need = fused_scan.smem_bytes(K=p["K"], E=p["E"], S=5, G=141, n_bins=n_bins,
                                 HT=fused_scan.hash_size(p["K"], p["E"]))
    assert 180_000 < need <= fused_scan.SMEM_LIMIT
    assert fused_scan.hash_size(p["K"], p["E"]) == 4096
    assert fused_scan.smem_bytes(K=2 * p["K"], E=p["E"], S=5, G=141, n_bins=n_bins,
                                 HT=fused_scan.hash_size(2 * p["K"], p["E"])) > fused_scan.SMEM_LIMIT


def test_fused_scan_needs_no_compiler_on_cpu(synth):
    """Importing the module and running its CPU route builds and launches
    nothing; the interface refuses what it does not take."""
    _, pdec = decoders(synth)
    n0 = fused_scan.counter.launches
    fs = FusedDecodeScan(pdec, B)
    tbg = torch.as_tensor(synth[2])
    fs(tbg[:4])
    assert fused_scan.counter.launches == n0 and fused_scan._lib is None
    assert max_scan_T(pdec) == (2**31 - 1) // pdec.K
    with pytest.raises(ValueError):
        fs(tbg[:4, :3])  # wrong batch
    with pytest.raises(ValueError):
        fs(tbg[:0])  # no frames
    with pytest.raises(ValueError):
        fs(tbg[:4], t0=max_scan_T(pdec))  # record ids would overflow
    with pytest.raises(ValueError):
        FusedDecodeScan(pdec, 0)
