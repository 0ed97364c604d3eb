"""The cached WSJ-order tasks of `scripts/_wsj_cache_*`, for the port.

Reads the task files the JAX package's offline pipeline wrote (`clg.npz`,
`cl.npz`, `models.npz`, `bigram.npz`, `lm.arpa`, `phones.lst`,
`lex.dict`; data only, no code of `scripts/` is imported) and holds
copies of what the reference bench drives them with: the operating point
`WSJ_POINT` (`bench.py`), the on-the-fly composition script's point
`OTF_POINT` (`scripts/wsj_otf.py`) and the utterance sampler
`sample_utterances` (`scripts/wsj_bench.py`), which random-walks the
task's bigram and synthesises features from the models, so every
utterance has a known transcript.

The decode artifact is derived from the network and models. By default
it is read from this package's `_cache/<task>_artifact.npz`, or built and
written there uncompressed; `cache=False` builds it in memory and reads
and writes no file. `load_otf_task` builds the on-the-fly composition
pair in memory: the artifact of CL (`cl.npz`) and G from `lm.arpa`.
"""

from __future__ import annotations

import os
import re
import resource
import time
from dataclasses import dataclass, field

import numpy as np

from ..am.models import AcousticModelSet
from ..decoder.artifact import DecoderArtifact
from ..decoder.core import TorchDecoderConfig
from ..compile import arpa_grammar
from ..decoder.network import DecoderNetwork
from ..decoder.otf import GNetwork
from ..lexicon import Vocabulary, load_vocabulary

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(_PKG)
ARTIFACT_CACHE = os.path.join(_PKG, "_cache")

# The reference bench's certified operating point (bench.py WSJ_POINT):
# beam 70 / end-beam 50 / maxHyps 500, budgets K=1024 / E=1408, 8 distinct
# ~1000-frame utterances tiled to a batch of 16. ("unroll" is the JAX
# scan's unroll factor; the port's frame loop has none.)
WSJ_POINT = dict(beam=70.0, end_beam=50.0, maxhyps=500, K=1024, E=1408,
                 unroll=8, batch=16, n_utts=8, frames=1000)


# The on-the-fly composition script's point (scripts/wsj_otf.py defaults):
# beam 85 / end-beam 60 / maxHyps 800, the tuner started at K=4096 /
# E=8192 (F=1024) with margin 1.4, 8 utterances of ~1000 frames sampled
# with seed 11 (the static 20k point's 8) decoded as one batch.
OTF_POINT = dict(beam=85.0, end_beam=60.0, maxhyps=800, K=4096, E=8192, margin=1.4,
                 n_utts=8, frames=1000, seed=11)


def task_dir(name: str = "2k") -> str:
    """`scripts/_wsj_cache_<name>` of this checkout."""
    return os.path.join(ROOT, "scripts", f"_wsj_cache_{name}")


@dataclass
class WsjTask:
    name: str
    cache: str
    net: DecoderNetwork
    models: AcousticModelSet
    artifact: DecoderArtifact
    # seconds of each step of `load_task` (network, build or load, save)
    # and the process's peak resident set after it, in bytes
    costs: dict = field(default_factory=dict)


def load_task(name: str = "2k", verbose: bool = True, cache: bool = True) -> WsjTask:
    """The task `scripts/_wsj_cache_<name>` with its decode artifact.

    cache=True reads `_cache/<name>_artifact.npz`, or builds the artifact
    and writes it there; cache=False builds it in memory and reads and
    writes no file (for a caller that reads the artifact once)."""
    cache_dir = task_dir(name)
    costs = {}
    t0 = time.perf_counter()
    net = DecoderNetwork.load_npz(os.path.join(cache_dir, "clg.npz"))
    models = AcousticModelSet.load_npz(os.path.join(cache_dir, "models.npz"))
    costs["network_s"] = time.perf_counter() - t0
    path = os.path.join(ARTIFACT_CACHE, f"{name}_artifact.npz")
    t0 = time.perf_counter()
    if cache and os.path.exists(path):
        art = DecoderArtifact.load_npz(path, net, models)
        costs["load_s"] = time.perf_counter() - t0
    else:
        art = DecoderArtifact(net, models)
        costs["build_s"] = time.perf_counter() - t0
        if cache:
            t0 = time.perf_counter()
            os.makedirs(ARTIFACT_CACHE, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            art.save_npz(tmp)
            os.replace(tmp, path)
            costs["save_s"] = time.perf_counter() - t0
    # the process's peak resident set so far (`ru_maxrss`, KiB on Linux)
    costs["peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if verbose:
        steps = ", ".join(f"{k[:-2]} {v:.1f}s" for k, v in costs.items() if k.endswith("_s"))
        print(f"[task] {name}: {net.n_arcs} arcs; {art}; {steps}; peak host RSS "
              f"{costs['peak_rss_bytes'] / 2**30:.1f} GiB", flush=True)
    return WsjTask(name, cache_dir, net, models, art, costs)


@dataclass
class OtfTask:
    name: str
    cache: str
    net: DecoderNetwork  # CL
    models: AcousticModelSet
    artifact: DecoderArtifact  # of CL
    vocab: Vocabulary
    g: GNetwork
    # seconds of each step of `load_otf_task`
    costs: dict = field(default_factory=dict)


def load_otf_task(name: str = "20k", verbose: bool = True) -> OtfTask:
    """The on-the-fly composition pair of `scripts/_wsj_cache_<name>`, built
    in memory: the artifact of CL (`cl.npz`, C o closure(det(L))) and G,
    the ARPA grammar of `lm.arpa` over the vocabulary of `lex.dict` (with
    `<s>` and `</s>`, as `scripts/wsj_otf.py` loads its lexicon)."""
    cache_dir = task_dir(name)
    costs = {}
    t0 = time.perf_counter()
    net = DecoderNetwork.load_npz(os.path.join(cache_dir, "cl.npz"))
    models = AcousticModelSet.load_npz(os.path.join(cache_dir, "models.npz"))
    costs["network_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = DecoderArtifact(net, models)
    costs["artifact_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vocab = load_vocabulary(os.path.join(cache_dir, "phones.lst"),
                            os.path.join(cache_dir, "lex.dict"), "<s>", "</s>")
    G = arpa_grammar(vocab, os.path.join(cache_dir, "lm.arpa"))
    costs["grammar_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = GNetwork(G)
    costs["gnetwork_s"] = time.perf_counter() - t0
    if verbose:
        ex = art.expansion
        steps = ", ".join(f"{k[:-2]} {v:.2f}s" for k, v in costs.items())
        print(f"[otf task] {name}: CL {net.n_arcs} arcs, {art.n_hmm_arcs} HMM arcs, "
              f"{len(ex.arc)} closure entries, {len(ex.f_score)} final entries, largest "
              f"fan-out {int(np.diff(ex.row_ptr).max(initial=0))}; G {g.n_states} states, "
              f"{len(g.arc_il)} word arcs ({G.num_arcs} arcs), max_backoff {g.max_backoff}, "
              f"W {g.W}; {steps}", flush=True)
    return OtfTask(name, cache_dir, net, models, art, vocab, g, costs)


def decoder_config(point=WSJ_POINT, emit_diagnostics=True) -> TorchDecoderConfig:
    """The decoder configuration of an operating point."""
    return TorchDecoderConfig(
        emit_prune_win=point["beam"], phone_end_prune_win=point["end_beam"],
        word_prune_win=point["end_beam"], max_emit_hyps=point["maxhyps"],
        max_insts=point["K"], expand_budget=point["E"], final_budget=1024,
        emit_diagnostics=emit_diagnostics,
    )


def word_labels(cache: str):
    """(label of word id w, sentence-marker labels). Output labels are
    vocabulary index + 1 over the sorted unique words of `lex.dict` (the
    JAX package's `Vocabulary`), which lists `<s>` and `</s>` too."""
    words = set()
    with open(os.path.join(cache, "lex.dict"), errors="replace") as fd:
        for line in fd:
            if line.startswith("(") or line.startswith("#"):
                continue
            parts = line.split()
            if parts:
                word = re.split(r"[(]", parts[0])[0]
                if word:
                    words.add(word)
    words.update(("<s>", "</s>"))
    index = {w: i + 1 for i, w in enumerate(sorted(words))}
    n = sum(1 for w in index if re.fullmatch(r"w\d+", w))
    return ([index[f"w{i}"] for i in range(n)],
            {index["<s>"], index["</s>"]})


def sample_utterances(cache, models, n_utts, target_frames, seed,
                      frames_per_state=3):
    """Random-walk the bigram, synthesise features from the models; a copy
    of `scripts/wsj_bench.py:sample_utterances` (LM-sampled text). Returns
    [(word ids, (T, D) float32 features)]."""
    rng = np.random.default_rng(seed)
    bz = np.load(os.path.join(cache, "bigram.npz"))
    phone_index = {}
    with open(os.path.join(cache, "phones.lst")) as fd:
        for i, line in enumerate(fd):
            phone_index[line.strip()] = i
    prons = {}
    with open(os.path.join(cache, "lex.dict")) as fd:
        for line in fd:
            parts = line.split()
            prons[parts[0]] = [phone_index[p] for p in parts[1:]]
    hmm_of_phone = {p: models.get_hmm_index(name)
                    for name, p in phone_index.items()}

    n_words_total = len(prons) - 2
    SB, SE = n_words_total, n_words_total + 1

    def frames_of(w):
        return (len(prons[f"w{w}"]) * (models.get_num_states(0) - 2)
                * frames_per_state)

    def sample_sentence():
        # ONE sentence <s> w... </s>: the grammar has no sentence loop
        words, w, frames_est = [], SB, 0
        while True:
            ids = bz[f"ids_{w}"]
            p = 10.0 ** bz[f"logp_{w}"]
            p /= p.sum()
            w = int(rng.choice(ids, p=p))
            if w == SE:
                return words, frames_est
            words.append(w)
            frames_est += frames_of(w)

    utts = []
    for _ in range(n_utts):
        best = None
        for _try in range(300):
            words, frames_est = sample_sentence()
            if not words:
                continue
            err = abs(frames_est - target_frames)
            if best is None or err < best[0]:
                best = (err, words)
            if target_frames * 0.6 <= frames_est <= target_frames * 1.5:
                break
        words = best[1]
        # features: sil + words + sil
        frames = []
        phone_seq = prons["<s>"] + sum((prons[f"w{w}"] for w in words), []) \
            + prons["</s>"]
        for p in phone_seq:
            h = hmm_of_phone[p]
            n = models.get_num_states(h)
            for j in range(1, n - 1):
                g = int(models.hmm_gmm_inds[h][j - 1])
                c = rng.integers(len(models.gmm_means[g]))
                mu = models.gmm_means[g][c]
                sd = np.sqrt(models.gmm_vars[g][c])
                for _ in range(max(1, frames_per_state + int(rng.integers(-1, 2)))):
                    frames.append(mu + rng.normal(size=len(mu)) * sd)
        utts.append((words, np.asarray(frames, dtype=np.float32)))
    return utts
