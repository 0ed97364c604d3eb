"""Batch decoding harness, a copy of `juicer_tpu/harness/batch.py`.

Rebuild of `DecoderBatchTest` / `DecoderSingleTest`
(`DecoderBatchTest.{h,cpp}`, `DecoderSingleTest.{h,cpp}`):

  - extended-filename specs "name=file[s,e]" (`DecoderSingleTest.cpp:60-150`);
  - per-utterance decode with CPU timing, aggregate decode-time / speech
    time / real-time factor (`DecoderBatchTest.cpp:764-777`);
  - per-word results: index = label-1, end time = word-boundary frame,
    per-word acoustic/LM score deltas, start = previous end
    (`extractResultsFromHypWordMode`, `DecoderSingleTest.cpp:404-468`);
  - optional removal of sentence-mark words (`-removeSentMarks`);
  - output formats ref / trans / mlf / xmlf / verbose
    (`outputResult`, `DecoderBatchTest.cpp:264-459`), xmlf with HTK 100 ns
    timestamps and per-word summed scores;
  - WER via weighted edit distance with HTK costs 7/7/10
    (`printStatistics`, `:148-201`).

Feature files are htk, lna or npy, read on the host; or wav audio
(`factory`), which the MFCC front end (`harness/frontend.py`) turns into
features on the tester's `device`, a batch's files (or an utterance
alone) in one pass of `frontend.wavs_to_features`. Features made on a
device stay there, and
speaker transforms apply to them there. Besides the decode time, the
tester adds up the seconds it spends reading features or running the
front end (`load_time`, the device synchronised) and the whole run
(`run_time`).
"""

from __future__ import annotations

import os
import re
import sys
import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional, TextIO, Union

import numpy as np
import torch

from .editdist import EditDistance
from .features import read_htk, read_lna


class OutputFormat(Enum):
    REF = "ref"
    TRANS = "trans"
    MLF = "mlf"
    XMLF = "xmlf"
    VERBOSE = "verbose"


@dataclass
class UtteranceSpec:
    name: str
    path: Optional[str] = None
    start_frame: int = -1
    end_frame: int = -1

    @classmethod
    def parse(cls, line: str) -> "UtteranceSpec":
        """Parse "name=file[s,e]" / "file[s,e]" / "file" extended filenames."""
        line = line.strip()
        name, eq, rest = line.partition("=")
        if not eq:
            rest, name = line, ""
        m = re.match(r"(.*)\[(\d+),(\d+)\]$", rest)
        if m:
            path, s, e = m.group(1), int(m.group(2)), int(m.group(3))
        else:
            path, s, e = rest, -1, -1
        if not name:
            name = os.path.splitext(os.path.basename(path))[0]
        return cls(name=name, path=path, start_frame=s, end_frame=e)


@dataclass
class WordResult:
    index: int  # vocabulary index (label - 1)
    start_time: int
    end_time: int
    acoustic_score: float
    lm_score: float


@dataclass
class UtteranceResult:
    spec: UtteranceSpec
    words: list[WordResult]
    total_score: float
    total_acoustic: float
    total_lm: float
    n_frames: int
    decode_time: float
    expected: Optional[list[int]] = None
    avg_active: float = 0.0


class BatchTester:
    def __init__(
        self,
        decode_fn: Callable[[np.ndarray], "DecodeResult"],
        word_names: list[str],  # index -> word string (vocab order)
        output_format: OutputFormat = OutputFormat.VERBOSE,
        output_file: Union[str, TextIO, None] = None,
        frames_per_sec: float = 100.0,
        remove_sent_marks: bool = False,
        sent_start_index: int = -1,
        sent_end_index: int = -1,
        feature_kind: str = "htk",  # htk | lna | npy | factory
        lna_outputs: int = 0,
        lattice_dir: Optional[str] = None,
        speaker_xforms=None,  # am.xform.SpeakerXforms
        device="cuda",  # where the front end runs (factory)
    ):
        self.decode_fn = decode_fn
        self.word_names = word_names
        self.output_format = output_format
        self.output_file = output_file
        self.frames_per_sec = frames_per_sec
        self.remove_sent_marks = remove_sent_marks
        self.sent_start_index = sent_start_index
        self.sent_end_index = sent_end_index
        self.feature_kind = feature_kind
        self.lna_outputs = lna_outputs
        self.lattice_dir = lattice_dir
        self.speaker_xforms = speaker_xforms
        self.device = device
        self.results: list[UtteranceResult] = []
        self.decode_time = 0.0
        self.speech_time = 0.0
        self.load_time = 0.0
        self.run_time = 0.0

    # -- inputs ------------------------------------------------------------

    @staticmethod
    def read_input_list(path: str) -> list[UtteranceSpec]:
        specs = []
        with open(path) as fd:
            for line in fd:
                line = line.strip()
                if line:
                    specs.append(UtteranceSpec.parse(line))
        return specs

    def load_features(self, spec: UtteranceSpec):
        return self.load_batch([spec])[0]

    def load_batch(self, specs: list[UtteranceSpec]) -> list:
        """The features of `specs`: (T, D) host arrays, or (T, D) float32
        tensors on the device for wav audio (one front-end pass)."""
        t0 = time.perf_counter()
        if self.feature_kind == "factory":
            from .frontend import wavs_to_features

            feats = wavs_to_features([s.path for s in specs], device=self.device)
        else:
            feats = [self._read(s.path) for s in specs]
        feats = [self._finish(s, f) for s, f in zip(specs, feats)]
        if any(isinstance(f, torch.Tensor) and f.is_cuda for f in feats):
            torch.cuda.synchronize()
        self.load_time += time.perf_counter() - t0
        return feats

    def _read(self, path: str) -> np.ndarray:
        if self.feature_kind == "htk":
            return read_htk(path)[0]
        if self.feature_kind == "lna":
            return read_lna(path, self.lna_outputs)
        if self.feature_kind == "npy":
            return np.load(path)
        raise ValueError(f"unknown feature kind {self.feature_kind}")

    def _finish(self, spec: UtteranceSpec, feats):
        """The spec's frame range and its speaker's transform."""
        if spec.start_frame >= 0:
            feats = feats[spec.start_frame : spec.end_frame + 1]
        if self.speaker_xforms is not None:
            xf = self.speaker_xforms.for_utterance(spec.name)
            if xf is not None:
                feats = xf.apply(feats)
                if isinstance(feats, np.ndarray):
                    feats = feats.astype(np.float32)
        return feats

    @staticmethod
    def read_references(path: str, specs: list[UtteranceSpec], vocab_index) -> dict[str, list[int]]:
        """Reference transcriptions: HTK MLF (keyed by name) or plain text
        (one line per utterance, in list order). OOV words map to -1 with a
        warning (`DecoderBatchTest.cpp:852-938`)."""
        refs: dict[str, list[int]] = {}

        def to_ids(words):
            ids = []
            for w in words:
                i = vocab_index(w)
                if i < 0:
                    print(f"warning: reference word {w!r} not in vocabulary", file=sys.stderr)
                ids.append(i)
            return ids

        with open(path) as fd:
            first = fd.readline()
            if first.startswith("#!MLF!#"):
                name = None
                words: list[str] = []
                for line in fd:
                    line = line.strip()
                    if line.startswith('"'):
                        name = os.path.splitext(os.path.basename(line.strip('"')))[0]
                        words = []
                    elif line == ".":
                        if name is not None:
                            refs[name] = to_ids(words)
                        name = None
                    elif line:
                        # MLF lines may carry times/scores; word is the
                        # 3rd field if numeric times present
                        parts = line.split()
                        w = parts[2] if len(parts) >= 3 and parts[0].lstrip("-").isdigit() else parts[0]
                        words.append(w)
            else:
                lines = [first] + fd.readlines()
                for spec, line in zip(specs, lines):
                    refs[spec.name] = to_ids(line.split())
        return refs

    # -- decoding ----------------------------------------------------------

    def run(
        self,
        specs: list[UtteranceSpec],
        refs: Optional[dict[str, list[int]]] = None,
        batch_fn: Optional[Callable] = None,
        batch_size: int = 1,
    ) -> EditDistance:
        """Decode all utterances. With `batch_fn` (a list-of-features ->
        list-of-DecodeResult callable) and batch_size > 1, utterances are
        decoded in device batches (padded to the batch max length; exact
        per-utterance results via the per-frame best-final snapshot)."""
        t_run = time.perf_counter()
        out, close = self._open_output()
        try:
            if self.output_format in (OutputFormat.MLF, OutputFormat.XMLF):
                out.write("#!MLF!#\n")
            if batch_fn is not None and batch_size > 1:
                for i in range(0, len(specs), batch_size):
                    group = specs[i : i + batch_size]
                    feats = self.load_batch(group)
                    t0 = time.perf_counter()
                    results = batch_fn(feats)
                    dt = time.perf_counter() - t0
                    self.decode_time += dt
                    per = dt / max(len(group), 1)
                    for spec, res in zip(group, results):
                        self.speech_time += res.n_frames / self.frames_per_sec
                        ur = self._to_result(spec, res, per)
                        if refs is not None:
                            ur.expected = refs.get(spec.name)
                        self.results.append(ur)
                        self._output_result(out, ur)
                return self._statistics(out)
            for spec in specs:
                feats = self.load_features(spec)
                t0 = time.perf_counter()
                res = self.decode_fn(feats)
                dt = time.perf_counter() - t0
                if isinstance(res, tuple):
                    res, lattice = res
                    if self.lattice_dir is not None and lattice is not None:
                        from ..fst import write_fsm

                        os.makedirs(self.lattice_dir, exist_ok=True)
                        write_fsm(
                            lattice,
                            os.path.join(self.lattice_dir, f"{spec.name}.lat.fsm"),
                        )
                self.decode_time += dt
                self.speech_time += res.n_frames / self.frames_per_sec
                ur = self._to_result(spec, res, dt)
                if refs is not None:
                    ur.expected = refs.get(spec.name)
                self.results.append(ur)
                self._output_result(out, ur)
            stats = self._statistics(out)
            return stats
        finally:
            if close:
                out.close()
            self.run_time += time.perf_counter() - t_run

    def _open_output(self):
        of = self.output_file
        if of is None or of == "stdout" or of == "":
            return sys.stdout, False
        if of == "stderr":
            return sys.stderr, False
        if isinstance(of, str):
            return open(of, "w"), True
        return of, False

    def _to_result(self, spec, res, dt) -> UtteranceResult:
        words: list[WordResult] = []
        prev_end = 0
        prev_ac = 0.0
        prev_lm = 0.0
        for h in res.word_hyps:
            idx = h.word - 1  # label 0 is epsilon
            if self.remove_sent_marks and idx in (self.sent_start_index, self.sent_end_index):
                continue
            words.append(
                WordResult(
                    index=idx,
                    start_time=prev_end,
                    end_time=h.end_frame,
                    acoustic_score=h.acoustic - prev_ac,
                    lm_score=h.lm - prev_lm,
                )
            )
            prev_end = h.end_frame
            prev_ac = h.acoustic
            prev_lm = h.lm
        return UtteranceResult(
            spec=spec,
            words=words,
            total_score=res.score,
            total_acoustic=res.acoustic_score,
            total_lm=res.lm_score,
            n_frames=res.n_frames,
            decode_time=dt,
            avg_active=getattr(res, "avg_active", 0.0),
        )

    # -- output formats ----------------------------------------------------

    def _output_result(self, out: TextIO, ur: UtteranceResult) -> None:
        fmt = self.output_format
        names = self.word_names

        def wname(i):
            return names[i] if 0 <= i < len(names) else "<OOV>"

        if fmt == OutputFormat.REF:
            out.write(" ".join(wname(w.index) for w in ur.words) + " \n")
        elif fmt == OutputFormat.TRANS:
            out.write(
                " ".join(wname(w.index) for w in ur.words)
                + f" (trans-{len(ur.words)})\n"
            )
        elif fmt in (OutputFormat.MLF, OutputFormat.XMLF):
            base = os.path.splitext(os.path.basename(ur.spec.name))[0]
            out.write(f'"*/{base}.rec"\n')
            if fmt == OutputFormat.MLF:
                for w in ur.words:
                    out.write(wname(w.index) + "\n")
            else:
                scale = 1.0e7 / self.frames_per_sec
                for w in ur.words:
                    st = scale * w.start_time
                    if st > 0:
                        st += scale
                    et = scale * w.end_time
                    if et > 0:
                        et += scale
                    out.write(
                        f"{st:.0f} {et:.0f} {wname(w.index)} "
                        f"{w.acoustic_score + w.lm_score:f}\n"
                    )
            out.write(".\n")
        else:
            pass
        # mirror results into the log with per-word times and score
        # decomposition (`DecoderBatchTest.cpp:431-455`)
        from ..utils.log import LogFile

        LogFile.puts("\nRecognition result:\n\n")
        for w in ur.words:
            LogFile.printf(
                "    %s  start=%d end=%d acousticScore=%.4f lmScore=%.4f\n",
                wname(w.index), w.start_time, w.end_time,
                w.acoustic_score, w.lm_score,
            )
        LogFile.printf(
            "\ntotal scores: lm=%.3f ac=%.3f\n\n", ur.total_lm, ur.total_acoustic
        )
        if ur.avg_active:
            LogFile.printf(
                "Statistics: nFrames=%d avgActiveModels=%.2f\n",
                ur.n_frames, ur.avg_active,
            )
        if fmt == OutputFormat.VERBOSE:
            out.write(f"{ur.spec.path or ur.spec.name}\n")
            if ur.expected is not None:
                out.write("\tExpected :  ")
                out.write(" ".join(wname(i) if i >= 0 else "<OOV>" for i in ur.expected))
                out.write(" \n")
            out.write("\tActual :    ")
            out.write(" ".join(wname(w.index) for w in ur.words))
            out.write("   [ ")
            out.write(" ".join(str(w.end_time + 1) for w in ur.words))
            out.write(f" ({ur.n_frames}) ]\n")
        out.flush()

    def _statistics(self, out: TextIO) -> EditDistance:
        total = EditDistance(7, 7, 10)  # HTK costs
        have_refs = any(ur.expected is not None for ur in self.results)
        for ur in self.results:
            if ur.expected is None:
                continue
            total.distance([w.index for w in ur.words], ur.expected)
        if self.output_format == OutputFormat.VERBOSE:
            out.write(f"\nTotal time spent decoding = {self.decode_time:.2f} secs\n")
            out.write(f"Total amount of speech    = {self.speech_time:.2f} secs\n")
            rtf = self.decode_time / self.speech_time if self.speech_time > 0 else 0.0
            out.write(f"Real-time (RT) factor     = {rtf:.2f}\n")
            if have_refs:
                out.write(total.summary() + "\n")
        return total
