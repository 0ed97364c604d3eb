"""Word alignment counts for the accuracy line and the comparison.

A frozen copy of `align` in `juicer_tpu_torch/harness/editdist.py`
(commit 103de7f): the minimum-cost alignment of a hypothesis against a
reference with the HTK costs (insertion 7, deletion 7, substitution 10),
returning (insertions, deletions, substitutions).
"""

from __future__ import annotations

import numpy as np


def align(hyp: list, ref: list, i_cost: int = 7, d_cost: int = 7, s_cost: int = 10):
    H, R = len(hyp), len(ref)
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


def errors(hyp: list, ref: list) -> int:
    """Insertions, deletions and substitutions of the alignment, summed."""
    return sum(align(hyp, ref))
