"""The frame step's work for one wave, from counts alone.

A frozen copy of `frame_step_bound` in `chip_smoke.py` (commit e55e34a,
lines 627-645), less its second number (the earlier contract's dense
record planes): every input read once (the scores, the carry, the 32-byte
metadata row of each active slot, the four entry-table columns of each
candidate), every output written once (the landed records, the count and
the eight snapshots of every frame); per active slot and frame S * S adds
and compares of the propagation and a few per state after it, per
candidate a handful. It counts the work a wave's search needs, whatever
implements the step.
"""

from __future__ import annotations


def frame_step_work(B: int, T: int, K: int, S: int, G: int, n_cand: int, n_active: int,
                    n_rec: int) -> tuple[float, float]:
    """(operations, bytes) of a wave of B utterances over T padded frames,
    frontier K, S states an HMM, G GMM scores a frame, with n_cand
    candidates, n_active active slot-frames and n_rec landed records."""
    carry_bytes = B * (K * (8 + S * 16) + 17)
    touched = 4.0 * T * B * G + 2 * carry_bytes + 24.0 * n_cand
    nbytes = touched + 32.0 * n_active + 32.0 * n_rec + 4.0 * T * B * 9
    ops = float(n_active) * (2 * S * S + 12 * S) + 20.0 * n_cand
    return ops, nbytes


def frame_step_bound_s(B, T, K, S, G, n_cand, n_active, n_rec, peaks: dict) -> float:
    """The least time the card could take for the wave (`opcount.PEAKS`)."""
    ops, nbytes = frame_step_work(B, T, K, S, G, n_cand, n_active, n_rec)
    return max(ops / peaks["f32_flops"], nbytes / peaks["bytes_per_s"])
