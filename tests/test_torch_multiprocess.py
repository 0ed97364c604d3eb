"""Decoding over several processes (`juicer_tpu_torch.parallel.multihost_demo`)
against the JAX package's single-process decode, on the CPU.

The counterpart of `tests/test_multiprocess.py`: two `gloo` ranks each
build the synthetic task, decode their round-robin share of its corpus
through `BatchDecoder` and sum [words, frames, utterances] with
`all_reduce`. Every utterance's words must equal `TpuDecoder`'s on the
same features, its score within 1e-4, and both ranks' totals must equal
the single-process sums. Skips only where a loopback port cannot be
bound.
"""

import json

import numpy as np
import pytest
import torch

from juicer_tpu.decoder.tpu_core import TpuDecoder, TpuDecoderConfig
from juicer_tpu.ops.gmm import make_gmm_scorer as jax_gmm_scorer
from juicer_tpu.utils.synth import make_synth_task as jax_make_synth_task

from juicer_tpu_torch.parallel import multihost_demo as demo

from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)

SCORE_TOL = 1e-4


def parse(outs):
    results, aggs = {}, []
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
        for line in out.splitlines():
            if line.startswith("WORKER_RESULT "):
                r = json.loads(line[len("WORKER_RESULT "):])
                assert r["utt"] not in results
                results[r["utt"]] = r
            elif line.startswith("WORKER_AGG "):
                aggs.append(json.loads(line[len("WORKER_AGG "):]))
    return results, aggs


def test_two_process_gloo_decode_matches_jax():
    if demo.free_port() is None:
        pytest.skip("no loopback port can be bound")
    outs = demo.launch(2, task="synth", device="cpu", timeout=300.0)
    results, aggs = parse(outs)
    assert "MULTIHOST OK: 2 processes" in outs[0][1]

    import jax.numpy as jnp

    jtask = jax_make_synth_task(**demo.SYNTH)
    jdec = TpuDecoder(jtask.artifact, TpuDecoderConfig(**demo.SYNTH_BUDGETS))
    scorer = jax_gmm_scorer(jtask.models.flat_params())
    corpus = demo.synth_corpus(jtask)
    assert sorted(results) == list(range(len(corpus)))
    n_words = n_frames = 0
    for u, (_, feats) in enumerate(corpus):
        ref = jdec.decode_scores(np.asarray(scorer(jnp.asarray(feats))))
        got = results[u]
        assert ref.words, u
        assert got["words"] == list(ref.words), (u, got["words"], ref.words)
        assert abs(got["score"] - float(ref.score)) < SCORE_TOL, (u, got["score"], ref.score)
        assert got["end_frames"] == [h.end_frame for h in ref.word_hyps], u
        assert got["n_frames"] == ref.n_frames and not got["overflow"], u
        n_words += len(ref.words)
        n_frames += ref.n_frames
    # both ranks hold the all-reduced totals, equal to the single-process sums
    assert sorted(a["rank"] for a in aggs) == [0, 1]
    for a in aggs:
        assert (a["words"], a["frames"], a["utts"]) == (n_words, n_frames, len(corpus)), a


def test_launch_reports_a_failed_worker(monkeypatch, capsys):
    """A worker that fails (here: asked for a card where none is visible)
    has a non-zero exit code in `launch`, and the launcher exits non-zero."""
    if demo.free_port() is None:
        pytest.skip("no loopback port can be bound")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    outs = demo.launch(1, task="synth", device="cuda", timeout=300.0)
    assert outs[0][0] != 0 and "no CUDA device" in outs[0][2]
    assert demo.main(["1", "--device", "cuda"]) == 1
    assert "MULTIHOST OK" not in capsys.readouterr().out
