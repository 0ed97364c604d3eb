"""The port's own spans and counters (`juicer_tpu_torch.utils.trace`) on
the CPU: recorded only under `torch.profiler`, nested where the work
happens, with counters equal to sums computed apart from them, in a
buffer of bounded length; and what `harness/profile_decode.py` reads of
them.

The task is `test_torch_parallel.py`'s word loop, decoded on both routes
that file builds: the fused scan's plain version and `TorchDecoder.run`.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from juicer_tpu.decoder import DecoderNetwork as JaxNetwork
from juicer_tpu.decoder.artifact import DecoderArtifact as JaxArtifact
from juicer_tpu.fst import Fst, LOG

from juicer_tpu_torch.decoder import TorchDecoder, TorchDecoderConfig
from juicer_tpu_torch.decoder import fused_scan
from juicer_tpu_torch.decoder.core import host_batch
from juicer_tpu_torch.decoder.fused_scan import FusedDecodeScan
from juicer_tpu_torch.harness.profile_decode import busy_us, entry_spans
from juicer_tpu_torch.ops import gmm_cuda, probe_cuda
from juicer_tpu_torch.ops.gmm import make_gmm_scorer
from juicer_tpu_torch.parallel import BatchDecoder, make_mesh
from juicer_tpu_torch.utils import trace

from test_decoder import make_models, scores_matrix
from test_torch_records import path_ids
from test_torch_decoder import _one_torch_thread, carry_across  # noqa: F401 (fixture)

BUDGETS = dict(max_insts=64, expand_budget=256, final_budget=64)
ROUTES = [True, False]
LENGTHS = [7, 12, 9]


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """The word loop of `test_torch_parallel.task` on the port, with its
    models and a batch of padded scores."""
    models = make_models(6, seed=3)
    f = Fst(LOG)
    s0 = f.add_state()
    f.set_start(s0)
    for w in range(6):
        f.add_arc(s0, s0, w + 1, w + 1, 0.4)
    f.set_final(s0, 0.0)
    net = JaxNetwork(f)
    _, pmodels, part = carry_across(tmp_path_factory.mktemp("trace"), net, models,
                                    JaxArtifact(net, models))
    pdec = TorchDecoder(part, TorchDecoderConfig(**BUDGETS), device="cpu")
    T = max(LENGTHS)
    scores = np.stack([np.pad(scores_matrix(models, n, seed=40 + b), ((0, T - n), (0, 0)),
                              mode="edge") for b, n in enumerate(LENGTHS)])
    return pmodels, pdec, scores


def traced(fn):
    """fn() under a CPU profiler session, on an empty buffer: its result
    and the spans it recorded."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.spans()


def inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


@pytest.mark.parametrize("use_fused", ROUTES)
def test_nothing_recorded_without_a_profiler_and_results_alike(task, use_fused):
    _, pdec, scores = task
    bd = BatchDecoder(pdec, use_fused=use_fused)
    trace.clear()
    plain = bd.decode_scores_batch(scores, LENGTHS)
    assert trace.spans() == []
    got, records = traced(lambda: bd.decode_scores_batch(scores, LENGTHS))
    assert records and got == plain
    # off, every span is one shared context that hands no attributes out
    assert trace.span("entry") is trace.span("copy")
    with trace.span("copy") as attrs:
        assert attrs is None
    assert trace.spans() == records


@pytest.mark.parametrize("n_devices", [1, 2])
@pytest.mark.parametrize("use_fused", ROUTES)
def test_entry_holds_copy_and_traceback_and_score_stands_alone(task, use_fused, n_devices):
    pmodels, pdec, scores = task
    scorer = make_gmm_scorer(pmodels.flat_params(), device="cpu")
    feats = torch.as_tensor(np.random.default_rng(5).normal(size=(20, scorer.V.shape[0])),
                            dtype=torch.float32)
    bd = BatchDecoder(pdec, make_mesh(n_devices, "cpu"), use_fused=use_fused)

    def call():
        scorer(feats)
        return bd.decode_scores_batch(scores, LENGTHS)

    results, records = traced(call)
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    assert sorted(by_name) == ["copy", "entry", "score", "traceback"]
    (score,), (entry,) = by_name["score"], by_name["entry"]
    assert score.parent == 0 and entry.parent == 0 and score.end_ns <= entry.start_ns
    # the scoring's size: every GMM padded to the largest mixture
    n_comps = [len(m) for m in pmodels.gmm_means]
    assert score.attrs == {"frames": 20, "G": len(n_comps), "components": sum(n_comps),
                           "columns": len(n_comps) * max(n_comps)}
    # the kernel's layout on the fused route (its plain version on the CPU)
    dims = fused_scan._dims(pdec)
    layout = ({"staged": int(dims["hmm_words"] > 0), "smem": fused_scan.smem_bytes(**dims)}
              if use_fused else {"staged": 0, "smem": 0})
    assert entry.attrs == {"B": 3, "T": max(LENGTHS), "K": pdec.K, "S": pdec.S,
                           "route": "fused" if use_fused else "plain", "H": pdec.H, **layout}
    assert use_fused is False or layout["staged"] == 1 and layout["smem"] > 0
    # one copy and one traceback a share, each inside the entry
    assert len(by_name["copy"]) == len(by_name["traceback"]) == n_devices
    for r in by_name["copy"] + by_name["traceback"]:
        assert r.parent == entry.id and inside(r, entry)
    assert sum(r.attrs["utterances"] for r in by_name["traceback"]) == len(LENGTHS)
    for copy, tb in zip(by_name["copy"], by_name["traceback"]):
        assert copy.end_ns <= tb.start_ns
    assert len({r.id for r in records}) == len(records)
    assert len(results) == len(LENGTHS)


@pytest.mark.parametrize("use_fused", ROUTES)
def test_copy_counters_equal_sums_made_apart(task, use_fused):
    _, pdec, scores = task
    sc = pdec.scores_tensor(scores)
    if use_fused:
        fs = FusedDecodeScan(pdec, sc.shape[0])
        carry, ys = fs(sc.transpose(0, 1).contiguous())
        state = (carry, ys, fs.rec0)
        records = int(ys["rec_count"][-1].sum())
    else:
        state = pdec.run(sc)
        ys = state[1]
        records = int((ys["rec_seq"] != 0).sum())
    host, (rec,) = traced(lambda: host_batch(*state))
    assert rec.name == "copy" and rec.parent == 0
    nbytes = sum(a.nbytes for part in (host[0]["best_final"], host[1], host[2])
                 for a in part.values()) + host[0]["overflow"].nbytes
    assert rec.attrs == {"dtoh_bytes": nbytes, "records": records,
                         "candidates": int(ys["n_cand"].sum()),
                         "active_slot_frames": int(ys["n_active"].sum())}
    assert records > 0 and rec.attrs["candidates"] > 0


@pytest.mark.parametrize("cap", [None, 0])
def test_walked_copy_counters_equal_sums_made_apart(task, cap, monkeypatch):
    """The fused route's `copy` span (`assemble_results`: the walk and its
    copy) carries the counters of `host_batch`'s with their meanings, and
    `path_records`, the rows walked; `dtoh_bytes` counts the headers and
    first rows and, where a path passes the cap (0 rows: every path), the
    rest of the longest path, copied second. The results are the host
    lookup's."""
    _, pdec, scores = task
    if cap is not None:
        monkeypatch.setattr(fused_scan, "PATH_CAP", cap)
    B, T = scores.shape[:2]
    fs = FusedDecodeScan(pdec, B)
    carry, ys = fs(pdec.scores_tensor(scores).transpose(0, 1).contiguous())
    got, (copy, tb) = traced(lambda: fused_scan.assemble_results(pdec, fs, carry, ys, LENGTHS))
    assert (copy.name, tb.name, copy.parent, tb.parent) == ("copy", "traceback", 0, 0)
    host = host_batch(carry, ys, fs.rec0)
    assert got == [pdec.traceback(host, b, T, true_T=n) for b, n in enumerate(LENGTHS)]
    # each best path's length, followed through the host copy
    paths = [0 if got[b].empty else len(path_ids(host, b, T, n, pdec.K))
             for b, n in enumerate(LENGTHS)]
    rows = min(T + 1, fused_scan.PATH_CAP)
    words = B * fused_scan.HEAD_WORDS + (rows + max(0, max(paths) - rows)) * B * 8
    assert copy.attrs == {"dtoh_bytes": 4 * words, "records": int(ys["rec_count"][-1].sum()),
                          "candidates": int(ys["n_cand"].sum()),
                          "active_slot_frames": int(ys["n_active"].sum()),
                          "path_records": sum(paths)}
    assert tb.attrs == {"utterances": B}
    assert copy.attrs["candidates"] > 0 and sum(paths) > 0
    assert cap is None or max(paths) > rows  # the second copy ran


def test_a_span_that_raises_is_kept_and_closed(task):
    _, pdec, scores = task
    bd = BatchDecoder(pdec)

    def call():
        with pytest.raises(ValueError):
            bd.decode_scores_batch(scores, [1, 2])
        with trace.span("after"):
            pass

    _, (entry, after) = traced(call)
    assert entry.name == "entry" and entry.attrs == {} and entry.end_ns >= entry.start_ns
    assert after.parent == 0


def test_buffer_stays_at_its_maxlen():
    def call():
        for _ in range(trace.MAX_SPANS + 10):
            with trace.span("s"):
                pass

    _, records = traced(call)
    assert len(records) == trace.MAX_SPANS
    assert records[-1].id - records[0].id == trace.MAX_SPANS - 1
    trace.clear()
    assert trace.spans() == []


def test_launch_counters_live_in_the_trace_module():
    assert isinstance(gmm_cuda.counter, trace.LaunchCounter)
    assert isinstance(fused_scan.counter, trace.LaunchCounter)
    assert all(isinstance(c, trace.LaunchCounter) for c in probe_cuda.counters.values())
    assert gmm_cuda.counter.launches >= 0


def test_profile_decode_reads_union_and_entry_spans():
    # kernels [0, 2] and [1, 3] overlap; a copy [5, 6] holds a set [5.5, 5.7]
    assert busy_us([(5, 6), (0, 2), (1, 3), (5.5, 5.7)]) == 4.0
    Span = trace.Span
    records = [Span("entry", 1, 0, 0, 10_000_000),
               Span("copy", 2, 1, 1_000_000, 2_000_000, {"dtoh_bytes": 9}),
               Span("entry", 3, 0, 20_000_000, 30_000_000, {"H": 9, "staged": 0}),
               Span("copy", 4, 3, 21_000_000, 23_000_000, {"dtoh_bytes": 5, "records": 2}),
               Span("copy", 5, 3, 23_000_000, 24_000_000, {"dtoh_bytes": 6, "records": 1}),
               Span("traceback", 6, 3, 24_000_000, 29_500_000, {"utterances": 4}),
               Span("score", 7, 0, 30_000_000, 31_000_000)]
    assert entry_spans(records) == {"entry_ms": 10.0, "copy_ms": 3.0, "traceback_ms": 5.5,
                                    "entry_H": 9, "entry_staged": 0,
                                    "dtoh_bytes": 11, "records": 3, "utterances": 4}
