"""Speaker-adaptation input transforms (feature-space / CMLLR).

A copy of `juicer_tpu/am/xform.py`, the rebuild of the reference's
HTKLib-backed speaker adaptation (`HModels.h:14-120`; CLI flags
-inputXformDir/-inputXformExt/-speakerNamePattern,
`juicer.cpp:200-216,676-760`): per-speaker feature-space transforms
x' = A x + b loaded from HTK transform files and applied to the feature
stream before scoring, with parent input-transform cascades through the
`parent` chain (x -> parent(x) -> child(...)). Model-space MLLRMEAN
transforms (`juicer_tpu/am/regtree.py`) are not ported yet.

The parser accepts the HTK ascii transform-set layout: <BIAS> vectors and
block-diagonal <XFORM>/<BLOCK> matrices inside a <LINXFORM>; everything
else (adapt kinds, base classes, regression trees) is skipped tolerantly.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class InputXform:
    A: np.ndarray  # (D, D) block-diagonal linear transform
    b: np.ndarray  # (D,) bias
    logdet: float = 0.0

    def apply(self, feats: np.ndarray) -> np.ndarray:
        return feats @ self.A.T + self.b[None, :]

    def compose(self, parent: "InputXform") -> "InputXform":
        """Cascade: parent transform applied FIRST, then self, HTKLib's
        parent-xform semantics (`xfInfo.paXFormDir`, `juicer.cpp:743-750`):
        x' = A (Ap x + bp) + b."""
        return InputXform(
            A=self.A @ parent.A,
            b=self.A @ parent.b + self.b,
            logdet=self.logdet + parent.logdet,
        )


_TOKEN_RE = re.compile(r"<[^>]*>|\"[^\"]*\"|~[a-zA-Z]|\S+")


def parse_xform(path: str) -> InputXform:
    with open(path, "r", errors="replace") as fd:
        toks = _TOKEN_RE.findall(fd.read())
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else None

    def kw(t):
        return t.strip("<>").upper() if t and t.startswith("<") else None

    vec_size = 0
    bias = None
    blocks: list[np.ndarray] = []
    logdet = 0.0
    while pos < len(toks):
        k = kw(toks[pos])
        if k == "VECSIZE":
            vec_size = int(toks[pos + 1])
            pos += 2
        elif k == "BIAS":
            n = int(toks[pos + 1])
            bias = np.array([float(x) for x in toks[pos + 2 : pos + 2 + n]])
            pos += 2 + n
        elif k == "LOGDET":
            logdet = float(toks[pos + 1])
            pos += 2
        elif k == "XFORM":
            r = int(toks[pos + 1])
            c = int(toks[pos + 2])
            vals = [float(x) for x in toks[pos + 3 : pos + 3 + r * c]]
            blocks.append(np.array(vals).reshape(r, c))
            pos += 3 + r * c
        else:
            pos += 1

    if not blocks:
        raise ValueError(f"{path}: no <XFORM> block found")
    D = vec_size or sum(b.shape[0] for b in blocks)
    A = np.zeros((D, D))
    off = 0
    for blk in blocks:
        n = blk.shape[0]
        A[off : off + n, off : off + n] = blk
        off += n
    if off != D:
        raise ValueError(f"{path}: block sizes {off} do not cover vec size {D}")
    if bias is None:
        bias = np.zeros(D)
    return InputXform(A=A, b=bias, logdet=logdet)


class SpeakerXforms:
    """Per-speaker transform lookup.

    speaker_pattern: regex with one capture group applied to the utterance
    name (the reference forwards an HTK-style mask to HTKLib; a regex is
    the Python-native equivalent). The transform file is
    <dir>/<speaker><ext>.
    """

    def __init__(self, xform_dir: str, ext: str = ".xform",
                 speaker_pattern: Optional[str] = None,
                 parent: Optional["SpeakerXforms"] = None):
        self.dir = xform_dir
        self.ext = ext if ext.startswith(".") or not ext else "." + ext
        self.pattern = re.compile(speaker_pattern) if speaker_pattern else None
        self.parent = parent  # parent-xform cascade (applied first)
        self._cache: dict[str, Optional[InputXform]] = {}

    def speaker_of(self, utt_name: str) -> str:
        if self.pattern is None:
            return utt_name
        m = self.pattern.search(utt_name)
        return m.group(1) if m else utt_name

    def for_utterance(self, utt_name: str) -> Optional[InputXform]:
        spk = self.speaker_of(utt_name)
        if spk not in self._cache:
            path = os.path.join(self.dir, spk + self.ext)
            x = parse_xform(path) if os.path.exists(path) else None
            if self.parent is not None:
                p = self.parent.for_utterance(utt_name)
                if p is not None:
                    x = x.compose(p) if x is not None else p
            self._cache[spk] = x
        return self._cache[spk]
