"""Acoustic feature file IO, a copy of `juicer_tpu/harness/features.py`.

The reference pulls frames through the Tracter front-end (`HTKSource`,
`LNASource`; `FrontEnd.h:24-135`). Equivalents:

  - HTK parameter files: 12-byte big-endian header (nSamples int32,
    sampPeriod int32 in 100 ns units, sampSize int16 bytes, parmKind
    int16), then float32 big-endian frames.
  - LNA posterior files (hybrid HMM/ANN mode): per frame one flag byte
    (0x80 marks the LAST frame of the utterance, 0x00 otherwise) followed
    by n_outputs bytes b encoding posteriors as p = exp(-(b + 0.5) / 24);
    we return *log* posteriors, matching what the hybrid scorer consumes
    (posterior - log prior, `HTKFlatModels.cpp:196-220`).
"""

from __future__ import annotations

import struct

import numpy as np


def read_htk(path: str):
    """Read an HTK parameter file -> (features (T, D) float32, sample_period_100ns, parm_kind)."""
    with open(path, "rb") as fd:
        hdr = fd.read(12)
        n_samples, samp_period, samp_size, parm_kind = struct.unpack(">iihh", hdr)
        data = fd.read(n_samples * samp_size)
    if samp_size % 4 != 0:
        raise ValueError(f"{path}: non-float HTK sample size {samp_size}")
    dim = samp_size // 4
    feats = np.frombuffer(data, dtype=">f4", count=n_samples * dim).reshape(
        n_samples, dim
    ).astype(np.float32)
    return feats, samp_period, parm_kind


# what `write_htk` puts in the header: a 10 ms frame period (in 100 ns
# units) and parmKind 9 (USER), as the JAX writer's defaults
HTK_SAMP_PERIOD = 100000
HTK_PARM_KIND = 9


def write_htk(path: str, feats: np.ndarray):
    feats = np.asarray(feats, dtype=np.float32)
    T, D = feats.shape
    with open(path, "wb") as fd:
        fd.write(struct.pack(">iihh", T, HTK_SAMP_PERIOD, D * 4, HTK_PARM_KIND))
        fd.write(feats.astype(">f4").tobytes())


def read_lna(path: str, n_outputs: int):
    """Read an LNA8 posterior file -> log posteriors (T, n_outputs) float32.

    Returns the frames of the FIRST utterance segment (flag byte 0x80 ends
    it), like a per-utterance source.
    """
    raw = np.fromfile(path, dtype=np.uint8)
    stride = n_outputs + 1
    if len(raw) % stride != 0:
        raise ValueError(f"{path}: size not a multiple of n_outputs+1")
    raw = raw.reshape(-1, stride)
    flags = raw[:, 0]
    vals = raw[:, 1:].astype(np.float32)
    logp = -(vals + 0.5) / 24.0
    ends = np.nonzero(flags & 0x80)[0]
    end = int(ends[0]) + 1 if len(ends) else logp.shape[0]
    return logp[:end]


def write_lna(path: str, log_posteriors: np.ndarray):
    lp = np.asarray(log_posteriors)
    b = np.clip(np.round(-lp * 24.0 - 0.5), 0, 255).astype(np.uint8)
    T = b.shape[0]
    flags = np.zeros((T, 1), np.uint8)
    flags[-1, 0] = 0x80
    np.concatenate([flags, b], axis=1).tofile(path)
