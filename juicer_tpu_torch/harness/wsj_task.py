"""The cached WSJ-order tasks of `scripts/_wsj_cache_*`, for the port.

Reads the task files the JAX package's offline pipeline wrote (`clg.npz`,
`cl.npz`, `models.npz`, `bigram.npz`, `lm.arpa`, `phones.lst`,
`lex.dict`; data only, no code of `scripts/` is imported) and holds
copies of what the reference bench drives them with: the operating point
`WSJ_POINT` (`bench.py`), the on-the-fly composition script's point
`OTF_POINT` (`scripts/wsj_otf.py`) and the utterance sampler
`sample_utterances` (`scripts/wsj_bench.py`), which random-walks the
task's bigram (or, with `free_text`, draws the words uniformly) and
synthesises features from the models, so every utterance has a known
transcript. `sample_audio` makes wav-front-end
input the same way: audio of a sampled sentence whose MFCC features
follow the models' means, with exactly the frame counts asked for.

The decode artifact is derived from the network and models. By default
it is read from this package's `_cache/<task>_artifact.npz`, or built and
written there uncompressed; `cache=False` builds it in memory and reads
and writes no file (`cached_artifact`, which the reference-scale tools of
`harness/` share). The port reads the tracked task directories and never
writes into them: what it derives from one goes to `writable_dir`.
`load_otf_task` builds the on-the-fly composition
pair in memory: the artifact of CL (`cl.npz`) and G from `lm.arpa`.

`build_task` rebuilds a task's networks from its `phones.lst`, `lex.dict`
and `lm.arpa` with the port's toolchain, by the library calls that wrote
the tracked `cl.npz` and `clg.npz` (`scripts/wsj_otf.py`'s `ensure_cl`
and `scripts/wsj_bench.py`'s `ensure_task`), and holds each to its file
bit for bit. Run as

    python -m juicer_tpu_torch.harness.wsj_task --build 20k

it rebuilds CL, then CLG, prints each stage's states, arcs and seconds
and the peak host RSS, and exits non-zero on a difference, naming the
array and its first differing index.
"""

from __future__ import annotations

import argparse
import os
import re
import resource
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..am.models import AcousticModelSet
from ..decoder.artifact import DecoderArtifact
from ..decoder.core import TorchDecoderConfig
from ..compile import (CDGen, CDPhoneLookup, CDType, GramGen, GramType, LexGen,
                       arpa_grammar, build_clg)
from ..decoder.network import DecoderNetwork
from ..decoder.otf import GNetwork
from ..fst import algos
from ..lexicon import Lexicon, Vocabulary

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
    t0 = time.perf_counter()
    net = DecoderNetwork.load_npz(os.path.join(cache_dir, "clg.npz"))
    models = AcousticModelSet.load_npz(os.path.join(cache_dir, "models.npz"))
    costs = {"network_s": time.perf_counter() - t0}
    art, art_costs = cached_artifact(cache_dir, net, models, cache)
    costs.update(art_costs)
    costs["peak_rss_bytes"] = peak_rss_bytes()
    if verbose:
        steps = ", ".join(f"{k[:-2]} {v:.1f}s" for k, v in costs.items() if k.endswith("_s"))
        print(f"[task] {name}: {net.n_arcs} arcs; {art}; {steps}; peak host RSS "
              f"{costs['peak_rss_bytes'] / 2**30:.1f} GiB", flush=True)
    return WsjTask(name, cache_dir, net, models, art, costs)


def under_scripts(cache_dir: str) -> bool:
    """Whether a task directory lies under the checkout's `scripts/` (the
    tracked tasks), which the port reads and never writes to."""
    scripts = os.path.join(ROOT, "scripts")
    return os.path.commonpath([os.path.abspath(cache_dir), scripts]) == scripts


def writable_dir(cache_dir: str) -> str:
    """Where files derived from the task in `cache_dir` are written: that
    directory, or for a task under `scripts/` `_cache/<its name>`."""
    cache_dir = os.path.abspath(cache_dir)
    if under_scripts(cache_dir):
        return os.path.join(ARTIFACT_CACHE, os.path.basename(cache_dir))
    return cache_dir


def artifact_file(cache_dir: str) -> str:
    """The decode artifact's cache of the task in `cache_dir`:
    `_cache/<name>_artifact.npz` for a tracked `scripts/_wsj_cache_<name>`,
    else `artifact.npz` beside the task's network."""
    if under_scripts(cache_dir):
        name = os.path.basename(os.path.abspath(cache_dir)).replace("_wsj_cache_", "")
        return os.path.join(ARTIFACT_CACHE, f"{name}_artifact.npz")
    return os.path.join(cache_dir, "artifact.npz")


def cached_artifact(cache_dir: str, net: DecoderNetwork, models: AcousticModelSet,
                    cache: bool = True):
    """(artifact, {step: seconds}): read from `artifact_file(cache_dir)`, or
    built and, with cache=True, written there uncompressed; cache=False
    builds it in memory and reads and writes no file."""
    costs = {}
    path = artifact_file(cache_dir)
    t0 = time.perf_counter()
    if cache and os.path.exists(path):
        art = DecoderArtifact.load_npz(path, net, models)
        costs["load_s"] = time.perf_counter() - t0
    else:
        art = DecoderArtifact(net, models)
        costs["build_s"] = time.perf_counter() - t0
        if cache:
            t0 = time.perf_counter()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            art.save_npz(tmp)
            os.replace(tmp, path)
            costs["save_s"] = time.perf_counter() - t0
    return art, costs


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
    vocab = task_lexicon(cache_dir).vocab
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


def task_lexicon(cache: str) -> Lexicon:
    """The lexicon of task directory `cache` as the offline pipeline loads
    it: sil and sp, the sentence markers `<s>` and `</s>`, no special-word
    character."""
    return Lexicon.load(os.path.join(cache, "phones.lst"), os.path.join(cache, "lex.dict"),
                        sil_phone="sil", pause_phone="sp", sent_start_word="<s>",
                        sent_end_word="</s>", spec_word_char="")


def _monophone_c(lexicon: Lexicon, n_aux: int):
    """The monophone C over every phone of the lexicon's phone list."""
    phones = list(lexicon.phone_set.phones)
    lookup = CDPhoneLookup(lexicon.phone_set)
    lookup.add_phones(phones)
    lookup.bind_models(phones)
    return CDGen(CDType.MONOPHONE, lookup, phones, n_aux_syms=n_aux).build()


def build_cl(lexicon: Lexicon):
    """C o closure(min(det(L))), the CL of on-the-fly composition, as an
    `Fst` with C's input and L's output symbols (`ensure_cl`)."""
    lexgen = LexGen(lexicon)
    L = lexgen.build(output_aux_phones=True)
    L = algos.minimize(algos.determinize(algos.arcsort(L)))
    C = _monophone_c(lexicon, lexgen.n_aux)
    cl = algos.compose(C, algos.closure(algos.arcsort(L)))
    cl.isyms, cl.osyms = C.isyms, L.osyms
    return cl


def build_task_clg(lexicon: Lexicon, lm_fname: str, verbose: bool = True):
    """The static CLG of the NGRAM grammar of `lm_fname` (`ensure_task`):
    `build_clg` of G, L with aux phones and the monophone C; verbose
    prints each stage's states, arcs and seconds."""
    G = GramGen(lexicon.vocab, GramType.NGRAM, lm_fname=lm_fname).build()
    lexgen = LexGen(lexicon)
    L = lexgen.build(output_aux_phones=True)
    C = _monophone_c(lexicon, lexgen.n_aux)
    return build_clg(G, L, C, verbose=verbose).clg


NETWORK_ARRAYS = ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight", "row_ptr",
                  "final_weight")
NETWORK_SCALARS = ("n_states", "init_state", "word_end_marker", "sil_marker", "sp_marker")


def require_same_network(what: str, got: DecoderNetwork, want: DecoderNetwork) -> None:
    """Raise unless two networks are equal bit for bit: every array's dtype,
    shape and bits (the first differing index is named) and the scalars."""
    for k in NETWORK_ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise RuntimeError(f"{what}: {k} is {a.dtype} {a.shape}, the file's "
                               f"{b.dtype} {b.shape}")
        bits = f"u{a.dtype.itemsize}"
        diff = np.flatnonzero(a.view(bits) != b.view(bits))
        if len(diff):
            i = int(diff[0])
            raise RuntimeError(f"{what}: {k} differs at index {i} ({a[i]!r} against the "
                               f"file's {b[i]!r}; {len(diff)} entries differ)")
    for k in NETWORK_SCALARS:
        if getattr(got, k) != getattr(want, k):
            raise RuntimeError(f"{what}: {k} is {getattr(got, k)}, the file's "
                               f"{getattr(want, k)}")


def peak_rss_bytes() -> int:
    """The process's peak resident set (`ru_maxrss`, KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def build_task(name: str = "2k", networks=("cl", "clg"), verbose: bool = True) -> dict:
    """Rebuild `networks` of task `name` ("cl": C o closure(det(L)), against
    `cl.npz`; "clg": the static CLG, against `clg.npz`) with the port's
    toolchain and hold each to its tracked file bit for bit (raises
    RuntimeError naming the array and index that differ). Returns
    {network: DecoderNetwork}, and "seconds" {stage: s}."""
    cache = task_dir(name)
    out, seconds = {}, {}

    def done(stage, f, t0):
        seconds[stage] = time.perf_counter() - t0
        if verbose:
            print(f"[build {name}] {stage}: {f.num_states} states, {f.num_arcs} arcs, "
                  f"{seconds[stage]:.1f}s; peak host RSS {peak_rss_bytes() / 2**30:.2f} GiB",
                  flush=True)

    lexicon = task_lexicon(cache)
    for which in networks:
        t0 = time.perf_counter()
        if which == "cl":
            f = build_cl(lexicon)
            done("CL", f, t0)
            net = DecoderNetwork(f, f.isyms, f.osyms, remove_aux="input")
        elif which == "clg":
            f = build_task_clg(lexicon, os.path.join(cache, "lm.arpa"), verbose)
            done("CLG", f, t0)
            net = DecoderNetwork(f, f.isyms, f.osyms)
        else:
            raise ValueError(f"unknown network {which!r}")
        del f
        require_same_network(f"[build {name}] {which}", net,
                             DecoderNetwork.load_npz(os.path.join(cache, f"{which}.npz")))
        if verbose:
            print(f"[build {name}] {which}: {net.n_states} states, {net.n_arcs} arcs, equal to "
                  f"{which}.npz bit for bit (every array and {', '.join(NETWORK_SCALARS)})",
                  flush=True)
        out[which] = net
    out["seconds"] = seconds
    return out


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


class _Sentences:
    """A task's bigram, pronunciations and phone models, and its sentence
    sampler (`scripts/wsj_bench.py`'s random walk)."""

    def __init__(self, cache, models):
        self.bz = np.load(os.path.join(cache, "bigram.npz"))
        phone_index = {}
        with open(os.path.join(cache, "phones.lst")) as fd:
            for i, line in enumerate(fd):
                phone_index[line.strip()] = i
        self.prons = {}
        with open(os.path.join(cache, "lex.dict")) as fd:
            for line in fd:
                parts = line.split()
                self.prons[parts[0]] = [phone_index[p] for p in parts[1:]]
        self.hmm_of_phone = {p: models.get_hmm_index(name) for name, p in phone_index.items()}
        n_words_total = len(self.prons) - 2
        self.SB, self.SE = n_words_total, n_words_total + 1

    def sample_sentence(self, rng, frames_of, target_frames, free_text=False):
        """ONE sentence <s> w... </s> (the grammar has no sentence loop):
        its words and the sum of frames_of(w). A bigram walk, or with
        free_text words drawn uniformly until 0.9x the target frames
        (decodable: G backs off to the unigram for any pair)."""
        words, w, frames_est = [], self.SB, 0
        if free_text:
            while frames_est < target_frames * 0.9:
                w = int(rng.integers(self.SB))
                words.append(w)
                frames_est += frames_of(w)
            return words, frames_est
        while True:
            ids = self.bz[f"ids_{w}"]
            p = 10.0 ** self.bz[f"logp_{w}"]
            p /= p.sum()
            w = int(rng.choice(ids, p=p))
            if w == self.SE:
                return words, frames_est
            words.append(w)
            frames_est += frames_of(w)

    def sample_close(self, rng, frames_of, target_frames, free_text=False):
        """The first of up to 300 sentences within 0.6-1.5x the target
        frames, else the closest non-empty one."""
        best = None
        for _try in range(300):
            words, frames_est = self.sample_sentence(rng, frames_of, target_frames, free_text)
            if not words:
                continue
            err = abs(frames_est - target_frames)
            if best is None or err < best[0]:
                best = (err, words)
            if target_frames * 0.6 <= frames_est <= target_frames * 1.5:
                break
        return best[1]

    def phone_seq(self, words):
        """sil + the words' phones + sil."""
        return (self.prons["<s>"] + sum((self.prons[f"w{w}"] for w in words), [])
                + self.prons["</s>"])


def sample_utterances(cache, models, n_utts, target_frames, seed,
                      frames_per_state=3, free_text=False):
    """Random-walk the bigram, synthesise features from the models; a copy
    of `scripts/wsj_bench.py:sample_utterances`. `free_text=True` draws the
    words uniformly instead: LM-likely transcripts make the LM an ally of
    the truth, free text puts it in tension with the acoustics, where
    pruning costs words. Returns [(word ids, (T, D) float32 features)]."""
    rng = np.random.default_rng(seed)
    task = _Sentences(cache, models)

    def frames_of(w):
        return (len(task.prons[f"w{w}"]) * (models.get_num_states(0) - 2)
                * frames_per_state)

    utts = []
    for _ in range(n_utts):
        words = task.sample_close(rng, frames_of, target_frames, free_text)
        # features: sil + words + sil
        frames = []
        for p in task.phone_seq(words):
            h = task.hmm_of_phone[p]
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


def sample_audio(cache, models, lengths, seed):
    """16 kHz S16LE audio for the task's models, whose MFCC front end
    (`harness/frontend.py`, the default configuration) makes exactly
    lengths[i] frames for utterance i. Returns [(word ids, int16
    samples)].

    Each utterance is a bigram-sampled sentence (sil, words, sil) of about
    three frames a state; its HMM states share the T frames
    equally (one frame more for a random few). A state is held as a
    periodic signal of period one frame shift (100 Hz), so every frame
    inside it sees the same waveform, whose spectral envelope (the
    pre-emphasis undone) has the static cepstra c1..c12 and c0 of one
    component mean of the state's GMM. The statics follow the models'
    means within about 1; the deltas are the front end's (near 0 inside
    a held state), while the models' dynamic means are as large as their
    static ones, so many GMMs score alike: the audio exercises the front
    end and the decoder, but its likelihoods are flat and the sentence it
    was made from is not a transcript a decoder recovers."""
    from .frontend import FrontendConfig, _Tables

    cfg = FrontendConfig()
    rng = np.random.default_rng(seed)
    task = _Sentences(cache, models)
    tabs = _Tables(cfg, torch.device("cpu"))
    dct, lift, fb = tabs.dct.numpy(), tabs.lift.numpy(), tabs.fb.numpy()
    centers = (fb * np.arange(fb.shape[1])).sum(1) / fb.sum(1)  # in rfft bins
    P = cfg.frame_shift
    harmonics = np.arange(P // 2 + 1) * cfg.n_fft / P  # the period's harmonics, in bins
    pre = np.abs(1 - cfg.preemphasis * np.exp(-2j * np.pi * harmonics / cfg.n_fft))

    def held(mu, n):
        ceps = np.concatenate([[mu[12]], mu[:12]]) / lift
        ceps[0] *= 0.5  # row 0 of the DCT has twice the others' norm
        amp = np.exp(np.interp(harmonics, centers, ceps @ dct) / 2) / pre
        amp[0] = 0.0
        period = np.fft.irfft(amp * np.exp(2j * np.pi * rng.random(len(amp))), P)
        return np.tile(period, -(-n // P))[:n]

    out = []
    for T in lengths:
        def frames_of(w):
            return sum(models.get_num_states(task.hmm_of_phone[p]) - 2
                       for p in task.prons[f"w{w}"]) * 3

        words = task.sample_close(rng, frames_of, T)
        gmms = [int(g) for p in task.phone_seq(words)
                for g in models.hmm_gmm_inds[task.hmm_of_phone[p]]]
        if len(gmms) > T:
            raise ValueError(f"{len(gmms)} states do not fit {T} frames")
        hold = np.full(len(gmms), T // len(gmms))
        hold[rng.choice(len(gmms), T - int(hold.sum()), replace=False)] += 1
        pieces = []
        for g, n in zip(gmms, hold):
            mu = models.gmm_means[g][int(rng.integers(len(models.gmm_means[g])))]
            pieces.append(held(mu, P * int(n)))
        pieces.append(held(mu, cfg.frame_len - P))  # the last frame's window
        x = np.concatenate(pieces)
        x *= 6000.0 / np.abs(x).max()
        out.append((words, np.round(x).astype("<i2")))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Rebuild a task's networks with the port's "
                                 "toolchain and hold them to the tracked npz files.")
    ap.add_argument("--build", required=True, help="task name: 2k or 20k")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        build_task(args.build)
    except RuntimeError as e:
        print(f"[build {args.build}] FAILED: {e}", flush=True)
        return 1
    print(f"[build {args.build}] done in {time.perf_counter() - t0:.1f}s; peak host RSS "
          f"{peak_rss_bytes() / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
