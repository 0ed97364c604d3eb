"""Weighted edit distance for WER scoring, a copy of
`juicer_tpu/harness/editdist.py`.

Equivalent of Torch3 `EditDistance` as used by the reference harness
(`DecoderBatchTest::printStatistics`, `DecoderBatchTest.cpp:148-201`):
weighted Levenshtein with configurable insertion/deletion/substitution
costs; the harness uses the HTK settings (7, 7, 10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EditDistance:
    i_cost: int = 7
    d_cost: int = 7
    s_cost: int = 10
    n_ref: int = 0
    n_ins: int = 0
    n_del: int = 0
    n_sub: int = 0
    n_sent: int = 0
    n_sent_correct: int = 0

    def distance(self, hyp: list, ref: list) -> tuple[int, int, int]:
        """Align hyp vs ref; accumulate counts; returns (ins, dele, sub)."""
        ins, dele, sub = align(hyp, ref, self.i_cost, self.d_cost, self.s_cost)
        self.n_ref += len(ref)
        self.n_ins += ins
        self.n_del += dele
        self.n_sub += sub
        self.n_sent += 1
        if ins == 0 and dele == 0 and sub == 0:
            self.n_sent_correct += 1
        return ins, dele, sub

    def add(self, other: "EditDistance") -> None:
        self.n_ref += other.n_ref
        self.n_ins += other.n_ins
        self.n_del += other.n_del
        self.n_sub += other.n_sub
        self.n_sent += other.n_sent
        self.n_sent_correct += other.n_sent_correct

    @property
    def n_correct(self) -> int:
        return self.n_ref - self.n_del - self.n_sub

    @property
    def accuracy(self) -> float:
        """HTK word accuracy: (N - D - S - I) / N."""
        if self.n_ref == 0:
            return 0.0
        return (self.n_ref - self.n_del - self.n_sub - self.n_ins) / self.n_ref

    @property
    def wer(self) -> float:
        if self.n_ref == 0:
            return 0.0
        return (self.n_del + self.n_sub + self.n_ins) / self.n_ref

    def summary(self) -> str:
        return (
            f"N={self.n_ref} Corr={self.n_correct} Ins={self.n_ins} "
            f"Del={self.n_del} Sub={self.n_sub}\n"
            f"Word accuracy = {100.0 * self.accuracy:.2f}%  "
            f"WER = {100.0 * self.wer:.2f}%  "
            f"Sentence correct = {self.n_sent_correct}/{self.n_sent}"
        )


def align(hyp: list, ref: list, i_cost: int = 7, d_cost: int = 7, s_cost: int = 10):
    """Minimum-cost alignment counts (insertions, deletions, substitutions).

    Insertions are hypothesis words with no reference counterpart.
    """
    H, R = len(hyp), len(ref)
    # dp[i][j]: cost aligning hyp[:i] with ref[:j]
    dp = np.zeros((H + 1, R + 1), dtype=np.int64)
    dp[:, 0] = np.arange(H + 1) * i_cost
    dp[0, :] = np.arange(R + 1) * d_cost
    for i in range(1, H + 1):
        prev = dp[i - 1]
        cur = dp[i]
        for j in range(1, R + 1):
            m = prev[j - 1] + (0 if hyp[i - 1] == ref[j - 1] else s_cost)
            d = cur[j - 1] + d_cost
            ins = prev[j] + i_cost
            cur[j] = min(m, d, ins)
    # backtrace for counts
    i, j = H, R
    n_ins = n_del = n_sub = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + (
            0 if hyp[i - 1] == ref[j - 1] else s_cost
        ):
            if hyp[i - 1] != ref[j - 1]:
                n_sub += 1
            i -= 1
            j -= 1
        elif j > 0 and dp[i][j] == dp[i][j - 1] + d_cost:
            n_del += 1
            j -= 1
        else:
            n_ins += 1
            i -= 1
    return n_ins, n_del, n_sub
