"""The decoder core's other configurations against the JAX engine.

float64, the exact histogram and the sort merge, alone and together, on
the random networks of `tests/test_fuzz_parity.py`: the same numpy scores
go through `TpuDecoder` (float64 under `jax_enable_x64`, as the JAX tests
run it) and `TorchDecoder(device="cpu")` with the same configuration.
Words, word-end frames and every traceback record must be equal, slot for
slot: record ids are `t*K + slot`, and the sort merge numbers slots
otherwise than the dense merge, so equal records mean equal slot
numbering. Scores and the records' float fields agree within 1e-9 in
float64 and 1e-4 in float32 (in practice bit for bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig

from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig, core, fused_scan
from juicer_tpu_torch.decoder.fused_scan import compact_records, expand_records
from juicer_tpu_torch.parallel.mesh import BatchDecoder

from test_decoder import scores_matrix
from test_fuzz_parity import CONFIG_ROWS, random_case
from test_torch_decoder import carry_across

TOL = {"float64": 1e-9, "float32": 1e-4}
INT_REC = ("rec_prev", "rec_seq", "rec_src", "rec_arc")
FLOAT_REC = ("rec_score", "rec_ac", "rec_lm")


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


def _budgets(big):
    return dict(max_insts=512 if big else 128, expand_budget=4096 if big else 1024,
                final_budget=512 if big else 256)


def _case(tmp_path, net_seed):
    """A fuzz network as both packages' artifacts."""
    big = net_seed >= 6
    rng, models, net = random_case(net_seed, max_states=64 if big else 9)
    jart = JaxArtifact(net, models)
    _, _, part = carry_across(tmp_path, net, models, jart)
    return rng, models, jart, part, big


def _records(pdec, sc):
    """The port's dense record planes of the 128-padded scan (B=1)."""
    T_pad = -(-sc.shape[0] // 128) * 128
    padded = np.concatenate([sc, np.repeat(sc[-1:], T_pad - sc.shape[0], axis=0)])
    _, ys, rec0 = pdec.run(pdec.scores_tensor(padded)[None])
    return padded, ys, rec0


def assert_same_decode(jdec, pdec, sc, ctx):
    """decode_scores results and the record arrays of the padded scan;
    returns the port's record planes."""
    tol = TOL[pdec.cfg.dtype]
    rj, rp = jdec.decode_scores(sc), pdec.decode_scores(sc)
    assert rj.empty == rp.empty and rj.overflow == rp.overflow, ctx
    assert rj.words == rp.words, (ctx, rj.words, rp.words)
    assert [h.end_frame for h in rj.word_hyps] == [h.end_frame for h in rp.word_hyps], ctx
    if not rj.empty:
        for a, b in ((rj.score, rp.score), (rj.acoustic_score, rp.acoustic_score),
                     (rj.lm_score, rp.lm_score)):
            assert abs(a - b) < tol, ctx
        for hj, hp in zip(rj.word_hyps, rp.word_hyps):
            assert abs(hj.score - hp.score) < tol and abs(hj.lm - hp.lm) < tol, ctx
    padded, ys, rec0 = _records(pdec, sc)
    _, jys, jrec0 = jdec._decode_jit(jnp.asarray(padded, jdec._dt))
    for k in INT_REC:
        np.testing.assert_array_equal(ys[k][:, 0].numpy(), np.asarray(jys[k]), err_msg=f"{ctx} {k}")
        np.testing.assert_array_equal(rec0[k][0].numpy(), np.asarray(jrec0[k[4:]]),
                                      err_msg=f"{ctx} rec0 {k}")
    for k in FLOAT_REC:
        assert ys[k].dtype == pdec.dtype
        np.testing.assert_allclose(ys[k][:, 0].numpy(), np.asarray(jys[k]), rtol=0, atol=tol,
                                   err_msg=f"{ctx} {k}")
    return rp, ys


def _pair(jart, part, **kw):
    return (TpuDecoder(jart, TpuDecoderConfig(**kw)),
            TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu"))


@pytest.mark.parametrize("row", range(len(CONFIG_ROWS)))
def test_float64_fuzz_parity(tmp_path, row):
    """All six rows of the JAX fuzz matrix in float64 (beams, binding
    binned histograms, the two sort-merge rows), on small random networks
    for even rows and large ones for odd rows, two score draws each."""
    prune, extra = CONFIG_ROWS[row]
    extra = {k: v for k, v in extra.items() if k != "scan_unroll"}  # the JAX scan's
    net_seed = row + 6 * (row % 2)
    rng, models, jart, part, big = _case(tmp_path, net_seed)
    jdec, pdec = _pair(jart, part, dtype="float64", **_budgets(big), **prune, **extra)
    assert pdec.dtype == torch.float64 and pdec.merge_strategy == jdec.merge_strategy
    assert pdec.tab["ent_score"].dtype == torch.float64
    for draw in range(2):
        T = int(rng.integers(4, 40))
        assert_same_decode(jdec, pdec, scores_matrix(models, T, seed=net_seed * 100 + draw),
                           (row, net_seed, draw))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exact_histogram_parity(tmp_path, dtype):
    """histogram_mode="exact" with a binding maxHyps: the k-th best score
    thresholds the next frame, and it really prunes (some decode differs
    from the unpruned one)."""
    changed = 0
    for net_seed, max_hyps in ((3, 3), (7, 5)):
        rng, models, jart, part, big = _case(tmp_path, net_seed)
        kw = dict(dtype=dtype, histogram_mode="exact", max_emit_hyps=max_hyps, **_budgets(big))
        jdec, pdec = _pair(jart, part, **kw)
        free = TorchDecoder(part, TorchDecoderConfig(**dict(kw, max_emit_hyps=0)), device="cpu")
        for draw in range(2):
            sc = scores_matrix(models, int(rng.integers(10, 40)), seed=net_seed * 10 + draw)
            r, _ = assert_same_decode(jdec, pdec, sc, (dtype, net_seed, draw))
            r0 = free.decode_scores(sc)
            changed += r.words != r0.words or r.score != r0.score
    assert changed > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sort_merge_numbers_slots_as_jax(tmp_path, dtype):
    """The sort merge's records equal the JAX sort strategy's slot for
    slot; the dense merge gives the same words with other record ids, so
    the comparison sees the numbering."""
    renumbered = 0
    rng, models, jart, part, big = _case(tmp_path, 10)
    kw = dict(dtype=dtype, merge_strategy="sort", **_budgets(big),
              emit_prune_win=50.0, phone_end_prune_win=40.0)
    jdec, pdec = _pair(jart, part, **kw)
    dense = TorchDecoder(part, TorchDecoderConfig(**dict(kw, merge_strategy="dense")),
                         device="cpu")
    assert (pdec.merge_strategy, dense.merge_strategy) == ("sort", "dense")
    for draw in range(2):
        sc = scores_matrix(models, int(rng.integers(10, 40)), seed=100 + draw)
        r, ys = assert_same_decode(jdec, pdec, sc, (dtype, draw))
        rd = dense.decode_scores(sc)
        assert rd.words == r.words and abs(rd.score - r.score) < TOL[dtype]
        _, ys_d, _ = _records(dense, sc)
        renumbered += not torch.equal(ys["rec_prev"], ys_d["rec_prev"])
    assert renumbered > 0


def test_auto_merge_takes_sort_above_the_threshold(tmp_path, monkeypatch):
    """"auto" resolves as the JAX engine's does: the dense merge up to
    E = 32768, the sort merge above it (here with the threshold lowered so
    a fuzz network crosses it, and the records equal the sort merge's)."""
    assert core.SORT_ABOVE_E == 32768
    rng, models, jart, part, _ = _case(tmp_path, 6)
    kw = dict(max_insts=256, expand_budget=1024, final_budget=256)
    auto = TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")
    assert auto.merge_strategy == TpuDecoder(jart, TpuDecoderConfig(**kw)).merge_strategy == "dense"
    monkeypatch.setattr(core, "SORT_ABOVE_E", 128)
    auto = TorchDecoder(part, TorchDecoderConfig(**kw), device="cpu")
    sort = TorchDecoder(part, TorchDecoderConfig(merge_strategy="sort", **kw), device="cpu")
    assert auto.E > 128 and auto.merge_strategy == "sort"
    sc = scores_matrix(models, 30, seed=3)
    _, ys_a, _ = _records(auto, sc)
    _, ys_s, _ = _records(sort, sc)
    for k in INT_REC + FLOAT_REC:
        assert torch.equal(ys_a[k], ys_s[k]), k
    assert "merge_strategy 'auto' takes the sort merge" in fused_scan.why_not_fused(auto)


def test_all_options_together_in_a_batch(tmp_path):
    """float64 + exact + sort through `BatchDecoder` (the plain loop on a
    CPU decoder under "auto") with padded lengths: each utterance equals
    the JAX decode of it alone."""
    rng, models, jart, part, big = _case(tmp_path, 8)
    kw = dict(dtype="float64", histogram_mode="exact", max_emit_hyps=6,
              merge_strategy="sort", **_budgets(big))
    jdec, pdec = _pair(jart, part, **kw)
    utts = [scores_matrix(models, T, seed=40 + T) for T in (25, 12, 31)]
    Tmax = max(len(u) for u in utts)
    batch = np.stack([np.pad(u, ((0, Tmax - len(u)), (0, 0)), mode="edge") for u in utts])
    got = BatchDecoder(pdec).decode_scores_batch(batch, [len(u) for u in utts])
    assert any(r.words for r in got)
    # a nested list reads as the array does
    assert BatchDecoder(pdec).decode_scores_batch(batch.tolist(), [len(u) for u in utts]) == got
    for u, r in zip(utts, got):
        want = jdec.decode_scores(u)
        assert r.words == want.words and r.n_frames == len(u)
        assert [h.end_frame for h in r.word_hyps] == [h.end_frame for h in want.word_hyps]
        if not want.empty:
            assert abs(r.score - want.score) < 1e-9
    with pytest.raises(ValueError, match="dtype 'float64'"):
        BatchDecoder(pdec, use_fused=True).decode_scores_batch(batch)


def test_float64_compact_records_keep_float64(tmp_path):
    """`compact_records` of float64 planes gives int64 words that carry
    the float64 bits; `expand_records` gives the planes back exactly, and
    the traceback reads the compact form to the dense form's result."""
    rng, models, jart, part, big = _case(tmp_path, 0)
    dec = TorchDecoder(part, TorchDecoderConfig(dtype="float64", **_budgets(big)), device="cpu")
    sc = dec.scores_tensor(scores_matrix(models, 30, seed=5))
    carry, ys, rec0 = dec.run(sc[None])
    compact = compact_records(ys)
    assert compact["records"].dtype == torch.int64
    n = int(compact["rec_count"][-1, 0])
    assert n > 0
    floats = core.float_view(compact["records"][0, :n])
    assert floats.dtype == torch.float64
    landed = ys["rec_seq"][:, 0] != 0
    assert torch.equal(floats[:, 3], ys["rec_score"][:, 0][landed])
    back = expand_records(compact, dec.K)
    for k in INT_REC + FLOAT_REC:
        assert back[k].dtype == ys[k].dtype and torch.equal(back[k], ys[k]), k
    dense = dec.traceback(core.host_batch(carry, ys, rec0), 0, 30)
    via = dec.traceback(core.host_batch(carry, compact, rec0), 0, 30)
    assert dense == via and dense.words
    with pytest.raises(ValueError, match="no compact form"):
        compact_records(dict(ys, rec_score=ys["rec_score"].half()))


def test_float64_reads_numpy_scores_whole(tmp_path):
    """numpy scores reach a float64 decoder in float64, as the JAX engine
    reads them; `decode_features` scores and decodes."""
    rng, models, jart, part, big = _case(tmp_path, 0)
    dec = TorchDecoder(part, TorchDecoderConfig(dtype="float64", **_budgets(big)), device="cpu")
    sc = scores_matrix(models, 20, seed=8) + 1e-12
    assert torch.equal(dec.scores_tensor(sc), torch.from_numpy(sc))
    want = dec.decode_scores(sc)
    got = dec.decode_features(np.zeros((20, 3)), lambda feats: sc[: len(feats)])
    assert got == want


def test_route_rule_names_each_configuration(tmp_path):
    """`why_not_fused` names each configuration outside the kernel, the
    stream takes the same switch, and a CPU decoder decodes them all in the
    plain loop under "auto"."""
    _, models, _, part, big = _case(tmp_path, 1)
    base = TorchDecoderConfig(**_budgets(big))
    assert fused_scan.why_not_fused(TorchDecoder(part, base, device="cpu")) is None
    sc = scores_matrix(models, 15, seed=2)
    for kw, reason in ((dict(dtype="float64"), "dtype 'float64'"),
                       (dict(histogram_mode="exact", max_emit_hyps=3), "histogram_mode 'exact'"),
                       (dict(merge_strategy="sort"), "merge_strategy 'sort'"),
                       (dict(gen_lattice=True), "gen_lattice")):
        dec = TorchDecoder(part, dataclasses.replace(base, **kw), device="cpu")
        why = fused_scan.why_not_fused(dec)
        assert why is not None and reason in why, why
        assert not fused_scan.fused_eligible(dec)
        with pytest.raises(ValueError, match="outside the fused scan"):
            fused_scan.FusedDecodeScan(dec, 1)
        assert dec.decode_scores(sc) == dec.decode_scores(sc, use_fused=False)
        stream = dec.stream()
        stream.feed(sc)
        assert stream.finish().words == dec.decode_scores(sc).words
    with pytest.raises(ValueError, match="use_fused"):
        dec.stream(use_fused="yes")
