"""Decode results: `WordHyp` and `DecodeResult`, as in
`juicer_tpu/decoder/ref_core.py`."""

from __future__ import annotations

from dataclasses import dataclass

LOG_ZERO = -1e30


@dataclass
class WordHyp:
    word: int
    end_frame: int
    score: float
    acoustic: float
    lm: float


@dataclass
class DecodeResult:
    words: list[int]  # output label ids (1-based network labels)
    word_hyps: list[WordHyp]
    score: float
    acoustic_score: float
    lm_score: float
    n_frames: int
    avg_active: float = 0.0  # mean active insts per frame
    max_active: int = 0  # peak frontier occupancy
    max_cand: int = 0  # peak per-frame expansion candidates
    overflow: bool = False  # a frontier/expansion budget bound somewhere

    @property
    def empty(self) -> bool:
        return self.score <= LOG_ZERO
