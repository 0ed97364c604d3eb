"""The reference-scale end-to-end bench of a WSJ-order task, on the card.

The counterpart of the JAX package's `scripts/wsj_bench.py`, over the
port's classes. It builds (or reads) a complete WSJ-order recognition
task through the port's offline pipeline and decodes synthesised
utterances whose scores really prune:

  1. a synthetic task at reference statistics: a random lexicon over 45
     phones drawn from a Zipf law, a synthetic bigram ARPA, G, L, the
     monophone C and `build_clg` (`gen_task_files`, `ensure_task`);
  2. generative GMM models (`build_models`; `ensure_models` for other
     centre spreads, `mismatch_models` for a decode-side model set whose
     means are perturbed); utterances sampled from the bigram, or as free
     text, and synthesised from the models (`wsj_task.sample_utterances`);
  3. `autotune_budgets` certifies the least budgets (K, E) at margin 1.4
     over the whole batch;
  4. word accuracy against the generating transcripts (`--lattice`: the
     word lattices too, their best path against the 1-best and whether
     they hold the transcript);
  5. `steady_bench`: a steady wave of the batch with diagnostics off, its
     overflow counted from that same wave;
  6. parity with the float64 oracle `RefDecoder` on two short held-out
     utterances: the float32 engine's words (reported), or with
     `--parity-only` the float64 engine's, words exact and score within
     1e-6.

The route is chosen in the open: the frame-step kernel where
`why_not_fused` of the decoder is None, else the plain frame loop
(`use_fused=False`) with the reason printed; every bench record carries
it as "route" ("frame_step" or "plain loop: <reason>"). Nothing falls
back: a kernel that does not build or launch ends the run, and a tuner
probe that leaves the kernel's scope raises with the reason.

Run as

    python -m juicer_tpu_torch.harness.wsj_bench [--quick] [--build-only]
        [--batch B] [--words N] [--bigrams M] [--beam W] [--end-beam W]
        [--maxhyps N] [--merge auto|dense|sort] [--frames T] [--cache DIR]
        [--no-tune] [--lattice] [--no-parity] [--parity-only] [--cpu]
        [--K K] [--E E]

on the card (`--cpu`: the plain PyTorch path on the CPU). The JAX
script's `--unroll` has no counterpart: the port's frame loop is not an
unrolled scan. The last line is the script's JSON line
(`wsj_e2e_frames_per_sec_chip`) with the route and the device added.

Tasks. A task directory holds `phones.lst`, `lex.dict`, `lm.arpa`,
`bigram.npz`, `clg.npz` and `models.npz`. The default is the checkout's
tracked `scripts/_wsj_cache_<N//1000>k` where it exists (2k and 20k), read
only; files derived from a tracked task (other model sets, the artifact)
are written under `juicer_tpu_torch/_cache/`, never under `scripts/`
(`wsj_task.writable_dir`). Any other task is built in
`juicer_tpu_torch/_cache/_wsj_cache_<N//1000>k` or in `--cache DIR`.

The tracked tasks are rebuilt byte for byte (every text file, every array
of `bigram.npz` and of the model files) by seed 7 over 45 phones with:

  - 2k: `--words 2000 --bigrams 100000` (`--quick`);
  - 20k: `--words 20000` and any `--bigrams` with `n_bigrams // 20001 == 5`
    (100,005 to 120,004, e.g. 120000): the successor sets are sized from
    `n_bigrams // (n_words + 1)` alone. The script's default 1,500,000
    builds a different, larger task (1,772,024 bigrams against the
    tracked `lm.arpa`'s 131,565).

The model sets of other centre spreads (`ensure_models`): `models_cs0.6`
and `_cs0.8` at 2k, `_cs0.35`, `_cs0.5` and `_cs0.7` at 20k, each equal to
its tracked file.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..am.mmf import MmfDef, MmfHmm, MmfMixture, MmfState, MmfTransMat
from ..am.models import AcousticModelSet
from ..decoder.autotune import autotune_budgets, decode_each, pad_batch
from ..decoder.core import TorchDecoder, TorchDecoderConfig
from ..decoder.fused_scan import device_wave, route_of
from ..decoder.network import DecoderNetwork
from . import card_line, wsj_task
from .editdist import EditDistance

def log10(p):
    return math.log10(max(p, 1e-30))


def gen_task_files(cache, n_words, n_bigrams, n_phones, seed):
    """Write lexicon/phones/ARPA files + bigram successor tables."""
    rng = np.random.default_rng(seed)
    os.makedirs(cache, exist_ok=True)
    phones = [f"p{i:02d}" for i in range(n_phones)]
    with open(os.path.join(cache, "phones.lst"), "w") as fd:
        for p in phones:
            fd.write(p + "\n")
        fd.write("sil\nsp\n")

    # pronunciations: English-like length profile and prefix sharing:
    # phones drawn from a Zipf law, so the det(L.G) lexicon tries compress
    # like a real dictionary's
    phone_p = 1.0 / (np.arange(1, n_phones + 1) ** 1.1)
    phone_p /= phone_p.sum()
    seen = set()
    prons = []
    while len(prons) < n_words:
        n = int(np.clip(rng.normal(6.0, 2.0), 2, 11))
        t = tuple(rng.choice(n_phones, size=n, p=phone_p).tolist())
        if t in seen:
            continue
        seen.add(t)
        prons.append(t)
    with open(os.path.join(cache, "lex.dict"), "w") as fd:
        for wi, pron in enumerate(prons):
            fd.write(f"w{wi} " + " ".join(phones[p] for p in pron) + "\n")
        fd.write("<s> sil\n</s> sil\n")

    # synthetic bigram LM: Zipf unigrams, per-word successor sets sized so
    # the total follows n_bigrams
    uni = 1.0 / (np.arange(1, n_words + 1) ** 0.9)
    uni /= uni.sum()
    order = rng.permutation(n_words)
    uni = uni[np.argsort(order)]  # random assignment of ranks to ids
    avg_succ = max(2, n_bigrams // (n_words + 1))
    succ_ids = {}
    succ_logp = {}
    total_bi = 0
    names = [f"w{i}" for i in range(n_words)] + ["<s>", "</s>"]
    SB, SE = n_words, n_words + 1  # <s>, </s> pseudo-ids

    def draw_successors(k):
        # frequent words are likelier successors (a Zipf-weighted sample)
        ids = rng.choice(n_words, size=min(k, n_words), replace=False, p=uni)
        return np.sort(ids)

    for w in list(range(n_words)) + [SB]:
        k = int(np.clip(rng.lognormal(math.log(avg_succ), 0.6), 2, n_words))
        ids = draw_successors(k)
        p = rng.dirichlet(np.ones(len(ids)) * 0.5) * 0.9
        # every word can end the sentence with the leftover mass
        succ_ids[w] = np.concatenate([ids, [SE]])
        succ_logp[w] = np.log10(np.concatenate([p, [0.1]]))
        total_bi += len(ids) + 1

    with open(os.path.join(cache, "lm.arpa"), "w") as fd:
        fd.write(f"\\data\\\nngram 1={n_words + 2}\nngram 2={total_bi}\n\n")
        fd.write("\\1-grams:\n")
        fd.write("-99 <s> -0.5\n")
        fd.write(f"{log10(0.02):.4f} </s>\n")
        for w in range(n_words):
            fd.write(f"{log10(uni[w] * 0.98):.4f} w{w} -0.5\n")
        fd.write("\n\\2-grams:\n")
        for w in list(range(n_words)) + [SB]:
            wn = names[w]
            for i, s in enumerate(succ_ids[w]):
                fd.write(f"{succ_logp[w][i]:.4f} {wn} {names[s]}\n")
        fd.write("\n\\end\\\n")

    np.savez_compressed(
        os.path.join(cache, "bigram.npz"),
        **{f"ids_{w}": succ_ids[w] for w in succ_ids},
        **{f"logp_{w}": succ_logp[w] for w in succ_logp},
    )
    return phones


def build_models(cache, phones, n_emit, n_comps, vec_size, center_scale, seed,
                 fname="models.npz"):
    """Left-to-right HMMs of `n_emit` emitting states for every phone, sil
    and sp (sp with a tee), each state a GMM of `n_comps` components around
    a per-phone centre drawn at `center_scale`; written to `cache/fname`
    through `AcousticModelSet.from_def` / `save_npz`."""
    rng = np.random.default_rng(seed + 1)
    d = MmfDef()
    d.global_opts.vec_size = vec_size
    n = n_emit + 2
    for name in phones + ["sil", "sp"]:
        probs = np.zeros((n, n))
        probs[0, 1] = 1.0
        if name == "sp":
            probs[0, 1] = 0.3
            probs[0, n - 1] = 0.7  # tee
        for i in range(1, n - 1):
            probs[i, i] = 0.6
            probs[i, i + 1] = 0.4
        center = rng.normal(scale=center_scale, size=vec_size)
        states = [
            MmfState(mixtures=[
                MmfMixture(1.0 / n_comps,
                           center + rng.normal(scale=1.0, size=vec_size),
                           np.abs(rng.normal(size=vec_size)) * 0.5 + 0.8)
                for _ in range(n_comps)])
            for _ in range(n_emit)
        ]
        d.hmms.append(MmfHmm(name, n, states, MmfTransMat(None, n, probs)))
    ms = AcousticModelSet.from_def(d)
    os.makedirs(cache, exist_ok=True)
    ms.save_npz(os.path.join(cache, fname))
    return ms


def ensure_models(cache, center_scale=1.2, n_emit=3, n_comps=8, vec_size=39, seed=7):
    """Models at another GMM separability, sharing the task's topology and
    transitions (so its network and artifact stay valid): `center_scale`
    scales how far apart the per-phone centres are drawn; lower is more
    confusable, harder acoustics. Read from `models_cs<S>.npz` of the task
    (or of its `wsj_task.writable_dir`), else built and written there."""
    if abs(center_scale - 1.2) < 1e-9:
        return AcousticModelSet.load_npz(os.path.join(cache, "models.npz"))
    fname = f"models_cs{center_scale:g}.npz"
    out = wsj_task.writable_dir(cache)
    for d in (cache, out):
        if os.path.exists(os.path.join(d, fname)):
            return AcousticModelSet.load_npz(os.path.join(d, fname))
    phones = []
    with open(os.path.join(cache, "phones.lst")) as fd:
        for line in fd:
            p = line.strip()
            if p and p not in ("sil", "sp"):
                phones.append(p)
    return build_models(out, phones, n_emit, n_comps, vec_size, center_scale, seed,
                        fname=fname)


def mismatch_models(models, sigma, seed=23):
    """Train/test mismatch: a decoding model set whose GMM means are the
    generating models' plus sigma * N(0, 1) (the mixtures' deviations are
    about 1). Features synthesised from the clean models then score noisily
    under these, so the true path is not always locally best and pruning
    costs words, the regime of the reference's accuracy-against-speed
    study. Topology and transitions are untouched."""
    if sigma <= 0:
        return models
    rng = np.random.default_rng(seed)
    m2 = copy.copy(models)
    m2.gmm_means = [np.asarray(mu) + rng.normal(scale=sigma, size=np.shape(mu))
                    for mu in models.gmm_means]
    return m2


def ensure_artifact(cache, net, models, verbose=True):
    """The decode artifact of the task's network and models: read from
    `wsj_task.artifact_file(cache)` (for a tracked task `load_task`'s cache
    in `juicer_tpu_torch/_cache/`), else built and written there."""
    t0 = time.time()
    art, costs = wsj_task.cached_artifact(cache, net, models)
    if verbose:
        how = "cached" if "load_s" in costs else "built"
        print(f"[artifact] {art} ({how}, {time.time() - t0:.1f}s)", flush=True)
    return art


def ensure_task(cache, n_words, n_bigrams, n_phones=45, n_emit=3, n_comps=8,
                vec_size=39, center_scale=1.2, seed=7):
    """Build (or load) the task in `cache`: CLG network, models, bigrams."""
    net_npz = os.path.join(cache, "clg.npz")
    if os.path.exists(net_npz):
        print(f"[task] loading cached network {net_npz}", flush=True)
        net = DecoderNetwork.load_npz(net_npz)
        models = AcousticModelSet.load_npz(os.path.join(cache, "models.npz"))
        return net, models
    if wsj_task.under_scripts(cache):
        raise ValueError(f"{cache} lies under scripts/ and has no clg.npz; the port "
                         f"builds tasks elsewhere (--cache)")

    t0 = time.time()
    phones = gen_task_files(cache, n_words, n_bigrams, n_phones, seed)
    print(f"[task] files written ({time.time() - t0:.1f}s)", flush=True)
    t0 = time.time()
    clg = wsj_task.build_task_clg(wsj_task.task_lexicon(cache),
                                  os.path.join(cache, "lm.arpa"), verbose=True)
    print(f"[task] CLG: {clg.num_states} states {clg.num_arcs} arcs "
          f"({time.time() - t0:.1f}s)", flush=True)
    net = DecoderNetwork(clg, clg.isyms, clg.osyms)
    net.save_npz(net_npz)
    models = build_models(cache, phones, n_emit, n_comps, vec_size, center_scale, seed)
    return net, models


def default_cache(n_words: int) -> str:
    """The task directory of `n_words`: the tracked `scripts/_wsj_cache_<k>k`
    where it holds a network, else `juicer_tpu_torch/_cache/_wsj_cache_<k>k`."""
    name = f"{n_words // 1000}k"
    tracked = wsj_task.task_dir(name)
    if os.path.exists(os.path.join(tracked, "clg.npz")):
        return tracked
    return os.path.join(wsj_task.ARTIFACT_CACHE, f"_wsj_cache_{name}")


def score_utterances(scorer, utts, device):
    """One scorer call (one GMM launch on the card) an utterance."""
    return [scorer(torch.as_tensor(f, device=device)) for _, f in utts]


def first_and_steady(wave, device):
    """Run `wave` once, synchronise, then once more on the host clock.
    Returns (the second wave's carry, the first wave's seconds, the second
    wave's seconds)."""
    t0 = time.perf_counter()
    wave()
    synchronize(device)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    carry = wave()
    synchronize(device)
    return carry, first_s, time.perf_counter() - t0


def steady_bench(art, cfg, db, batch_sizes, g_network=None, device="cuda"):
    """Steady batched throughput at `cfg`, diagnostics off. `db` is a
    (B, T, n_gmms) score batch; each batch size tiles it. Each size runs
    one wave (its seconds are "compile_s"), synchronises, then times a
    second wave, whose own output gives the overflow count, so an
    uncertified row cannot pass silently. The wave is `device_wave`: the
    decoder's device route (the frame-step kernel, or the plain frame loop
    where the kernel does not cover the decoder: a G, float64, ...).
    Returns {B: {"fps", "overflow", "compile_s", "route"}}."""
    fast = TorchDecoder(art, dataclasses.replace(cfg, emit_diagnostics=False),
                        device=device, g_network=g_network)
    route, _ = route_of(fast)
    db = fast.scores_tensor(db)
    B, Tmax = db.shape[0], db.shape[1]
    out = {}
    for Bs in batch_sizes:
        dbs = db[torch.arange(Bs, device=db.device) % B]
        carry, compile_s, dt = first_and_steady(device_wave(fast, dbs), fast.device)
        out[Bs] = {"fps": round(Bs * Tmax / dt, 1),
                   "overflow": int(carry["overflow"].sum()),
                   "compile_s": round(compile_s, 3), "route": route}
    return out


def synchronize(device):
    """Wait for the device's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def accuracy(results, utts, labels, markers):
    """EditDistance of the 1-best words (sentence markers stripped) against
    the generating transcripts."""
    ed = EditDistance()
    for r, (words, _) in zip(results, utts):
        ed.distance([w for w in r.words if w not in markers], [labels[w] for w in words])
    return ed


def oracle(net, models, cfg, scores, g_network=None):
    """The float64 oracle's decode of each utterance's scores at `cfg`'s
    beams: `RefDecoder`, or `RefOtfDecoder` with a G (one decoder for all:
    it copies the network into Python lists once). Returns [(result,
    seconds)]."""
    from ..decoder.otf import RefOtfDecoder
    from ..decoder.ref_core import RefDecoder

    beams = dict(phone_start_prune_win=0.0, emit_prune_win=cfg.emit_prune_win,
                 phone_end_prune_win=cfg.phone_end_prune_win,
                 word_prune_win=cfg.word_prune_win, max_emit_hyps=cfg.max_emit_hyps)
    ref = (RefDecoder(net, models, **beams) if g_network is None
           else RefOtfDecoder(net, g_network, models, **beams))
    out = []
    for sc in scores:
        sc = np.asarray(sc.cpu() if isinstance(sc, torch.Tensor) else sc)
        t0 = time.time()
        r = ref.decode(score_fn=lambda t, g: float(sc[t, g]), n_frames=sc.shape[0])
        out.append((r, time.time() - t0))
    return out


def parity_f64(art, net, models, base, par_scores, device):
    """The float64 engine against the float64 oracle on the held-out
    utterances: words exact and score within 1e-6 (raises otherwise)."""
    pdec = TorchDecoder(art, dataclasses.replace(base, dtype="float64", emit_diagnostics=True),
                        device=device)
    route, fused = route_of(pdec)
    print(f"[parity-f64] route: {route}", flush=True)
    par64 = [sc.to(torch.float64) for sc in par_scores]
    for i, (sc, (r_ref, t_ref)) in enumerate(zip(par64, oracle(net, models, base, par64))):
        r_dec = pdec.decode_scores(sc, use_fused=fused)
        if r_ref.words != r_dec.words:
            raise RuntimeError(f"PARITY FAIL utt {i}: oracle {r_ref.words}, engine {r_dec.words}")
        if not abs(r_ref.score - r_dec.score) < 1e-6:
            raise RuntimeError(f"PARITY FAIL utt {i}: oracle score {r_ref.score}, engine "
                               f"{r_dec.score}")
        print(f"[parity-f64] utt {i}: {len(r_ref.words)} words exact, score diff "
              f"{abs(r_ref.score - r_dec.score):.2e} (oracle {t_ref:.1f}s)", flush=True)


def lattice_report(art, tuned, utts, scores, cache, device):
    """Word lattices of the batch at the tuned point (`--lattice`): records,
    host assembly seconds, best path against the 1-best and transcript
    coverage. The kernel writes no lattice records, so this is the plain
    frame loop on any device; each utterance is decoded at its own length
    (the JAX script pads to a 128-frame bucket to share compiled
    programs). Returns the totals."""
    from ..decoder.core import host_batch
    from ..decoder.lattice import build_lattice, contains_cost, shortest_path

    lat_dec = TorchDecoder(art, dataclasses.replace(tuned, gen_lattice=True,
                                                    emit_diagnostics=True), device=device)
    labels, _ = wsj_task.word_labels(cache)
    vocab = wsj_task.task_lexicon(cache).vocab
    sb, se = vocab.sent_start_index + 1, vocab.sent_end_index + 1
    tot = dict(events=0, edges=0, states=0, arcs=0, dev_s=0.0, host_s=0.0, covered=0,
               best_ok=0)
    for i, ((words, _), sc) in enumerate(zip(utts, scores)):
        T = int(sc.shape[0])
        t0 = time.time()
        host = host_batch(*lat_dec.run(lat_dec.scores_tensor(sc)[None]))
        t_dev = time.time() - t0
        res = lat_dec.traceback(host, 0, T)
        ys = {k: v[:, 0] for k, v in host[1].items()}
        rec0 = {k: v[0] for k, v in host[2].items()}
        t0 = time.time()
        lat = build_lattice(art, ys, rec0, T)
        t_host = time.time() - t0
        n_ev = int(np.sum(rec0["ev_arc"] >= 0)) + int(np.sum(ys["ev_arc"] >= 0))
        n_edge = int(np.sum(ys["lat_valid"]))
        cost, labs = shortest_path(lat)
        words_ok = labs == list(res.words)
        # lattice costs are absolute cumulative (ac + lm); float32 sums over
        # ~10^3 frames wobble in the last digits: the tolerance scales with T
        abs_best = res.acoustic_score + res.lm_score
        best_ok = words_ok and abs(-cost - abs_best) < 1e-4 * max(T, 1)
        ccost = contains_cost(lat, [sb] + [labels[w] for w in words] + [se])
        covered = bool(np.isfinite(ccost))
        print(f"[lattice] utt {i}: T={T} events={n_ev} edges={n_edge} -> {lat.num_states} "
              f"states / {lat.num_arcs} arcs; decode {t_dev:.1f}s, host assembly "
              f"{t_host:.1f}s; best-path {'OK' if best_ok else 'MISMATCH'} (words "
              f"{'ok' if words_ok else 'DIFF'}, cost {cost:.1f} vs 1-best {-abs_best:.1f}); "
              f"transcript {'covered (cost %.1f)' % ccost if covered else 'NOT COVERED'}",
              flush=True)
        for k, v in (("events", n_ev), ("edges", n_edge), ("states", lat.num_states),
                     ("arcs", lat.num_arcs), ("dev_s", t_dev), ("host_s", t_host),
                     ("covered", int(covered)), ("best_ok", int(best_ok))):
            tot[k] += v
    B = len(utts)
    print(f"[lattice] TOTAL {B} utts: {tot['events']} events, {tot['edges']} edges, "
          f"{tot['states']} states / {tot['arcs']} arcs; decode {tot['dev_s']:.1f}s, host "
          f"{tot['host_s']:.1f}s; best-path {tot['best_ok']}/{B}, coverage "
          f"{tot['covered']}/{B}", flush=True)
    return tot


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Reference-scale end-to-end bench of a "
                                 "WSJ-order task on the card.")
    ap.add_argument("--quick", action="store_true", help="small-scale run (2k words)")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--words", type=int, default=20000)
    ap.add_argument("--bigrams", type=int, default=1_500_000,
                    help="the tracked 20k task is any value with bigrams // 20001 == 5")
    ap.add_argument("--beam", type=float, default=85.0)
    ap.add_argument("--end-beam", type=float, default=60.0)
    ap.add_argument("--maxhyps", type=int, default=800)
    ap.add_argument("--merge", type=str, default="auto", help="merge_strategy: auto|dense|sort")
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--cache", type=str, default=None)
    ap.add_argument("--no-tune", action="store_true",
                    help="use --K/--E as the exact budgets (certified elsewhere)")
    ap.add_argument("--lattice", action="store_true",
                    help="word lattices at the tuned point for every eval utterance")
    ap.add_argument("--no-parity", action="store_true")
    ap.add_argument("--parity-only", action="store_true",
                    help="only the float64 engine against the float64 oracle")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--K", type=int, default=4096,
                    help="autotune base frontier budget (probe start)")
    ap.add_argument("--E", type=int, default=8192,
                    help="autotune base expansion budget (probe start)")
    args = ap.parse_args(argv)
    if args.quick:
        args.words, args.bigrams = 2000, 100_000
        args.frames = min(args.frames, 300)
        args.batch = min(args.batch, 4)
    return args


def run(args, net, models, art, cache, bench_sizes=None) -> dict:
    """The bench after the task and artifact are loaded (`main`'s body; the
    chip smoke calls it on a task it already holds). `bench_sizes` are the
    steady bench's batch sizes (default [--batch]). Returns what was
    measured: "json" (the last line), "tuned", "route", "results",
    "accuracy", "bench", "oracles" (the oracle's [(result, seconds)] of
    each held-out utterance), "parity_exact" (the float32 engine's words
    equal the oracle's, for each), "utts", "scores"."""
    from ..ops.gmm import make_gmm_scorer

    device = resolve_device("cpu" if args.cpu else "cuda")
    card = card_line(device)
    # the eval batch, plus two naturally short utterances for the oracle
    # parity: they end near </s>, so the final state is reached
    utts = wsj_task.sample_utterances(cache, models, n_utts=args.batch,
                                      target_frames=args.frames, seed=11)
    utts += wsj_task.sample_utterances(cache, models, n_utts=2, target_frames=150, seed=12)
    scorer = make_gmm_scorer(models.flat_params(), device=device)
    scores = score_utterances(scorer, utts, device)
    print(f"[utts] {len(utts)} utterances, T={[int(s.shape[0]) for s in scores]}", flush=True)
    B = args.batch
    base = TorchDecoderConfig(
        emit_prune_win=args.beam, phone_end_prune_win=args.end_beam,
        word_prune_win=args.end_beam, max_emit_hyps=args.maxhyps,
        max_insts=args.K, expand_budget=args.E, final_budget=1024, merge_strategy=args.merge)
    out = dict(utts=utts, scores=scores)

    if args.parity_only:
        parity_f64(art, net, models, base, scores[B:], device)
        return out

    t0 = time.time()
    if args.no_tune:
        tuned = base
        print(f"[budgets] K={tuned.max_insts} E={tuned.expand_budget} (--no-tune; overflow "
              f"still counted downstream)", flush=True)
    else:
        # certify over the whole batch: two samples were not enough
        tune_route, tune_fused = route_of(TorchDecoder(art, base, device=device))
        print(f"[autotune] route from K={base.max_insts} E={base.expand_budget}: "
              f"{tune_route}", flush=True)
        tuned = autotune_budgets(art, scores[:B], base, margin=1.4, device=device,
                                 use_fused=tune_fused, verbose=True)
        print(f"[autotune] K={tuned.max_insts} E={tuned.expand_budget} "
              f"({time.time() - t0:.1f}s)", flush=True)

    labels, markers = wsj_task.word_labels(cache)
    dec = TorchDecoder(art, dataclasses.replace(tuned, emit_diagnostics=True), device=device)
    route, fused = route_of(dec)
    print(f"[route] {route}", flush=True)
    results = decode_each(dec, scores[:B], use_fused=fused)
    ed = accuracy(results, utts[:B], labels, markers)
    avg_act = np.mean([r.avg_active for r in results])
    max_act = max(r.max_active for r in results)
    summ = ed.summary().replace(chr(10), "; ")
    print(f"[accuracy] {summ}; avg active {avg_act:.0f}, peak {max_act}, overflow "
          f"{sum(r.overflow for r in results)}/{len(results)}", flush=True)

    if args.lattice:
        out["lattice"] = lattice_report(art, tuned, utts[:B], scores[:B], cache, device)

    sb = steady_bench(art, tuned, pad_batch(scores[:B]), bench_sizes or [B], device=device)
    for Bs, rec in sb.items():
        print(f"[bench] steady batch={Bs}: {rec['fps']:.0f} frames/s = "
              f"{rec['fps'] / 100:.1f}x RT (first wave {rec['compile_s']}s, overflow "
              f"{rec['overflow']}/{Bs}, route {rec['route']}) | {card}", flush=True)
    fps = sb[(bench_sizes or [B])[0]]["fps"]

    if not args.no_parity:
        # the float32 engine against the float64 oracle: float32 sums can
        # flip near-ties on a 20k-word network, so a difference is reported;
        # the exact check is --parity-only (the float64 engine)
        oracles = oracle(net, models, tuned, scores[B:])
        out["parity_exact"] = []
        for i, (sc, (r_ref, t_ref)) in enumerate(zip(scores[B:], oracles)):
            r_dec = dec.decode_scores(sc, use_fused=fused)
            out["parity_exact"].append(r_ref.words == r_dec.words)
            if r_ref.words == r_dec.words:
                print(f"[parity] utt {i}: {len(r_ref.words)} words exact (f32 engine vs f64 "
                      f"oracle; oracle {t_ref:.1f}s)", flush=True)
            else:
                print(f"[parity] utt {i}: f32 engine diverges from f64 oracle ({r_dec.words} "
                      f"vs {r_ref.words}) — run --parity-only for the f64 check", flush=True)
        out["oracles"] = oracles

    out.update(tuned=tuned, route=route, results=results, accuracy=ed, bench=sb)
    out["json"] = {
        "metric": "wsj_e2e_frames_per_sec_chip", "value": round(fps, 1),
        "unit": "frames/s/chip", "n_arcs": int(net.n_arcs),
        "K": tuned.max_insts, "E": tuned.expand_budget,
        "accuracy": round(ed.accuracy, 4), "xRT": round(fps / 100, 1),
        "route": route, "device": card,
    }
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    cache = args.cache or default_cache(args.words)
    net, models = ensure_task(cache, args.words, args.bigrams)
    print(f"[net] {net.n_states} states, {net.n_arcs} arcs; {models.n_hmms} hmms / "
          f"{models.n_gmms} gmms", flush=True)
    if args.build_only:
        return 0
    art = ensure_artifact(cache, net, models)
    out = run(args, net, models, art, cache)
    if "json" in out:
        print(json.dumps(out["json"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
