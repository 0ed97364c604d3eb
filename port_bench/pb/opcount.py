"""Peaks of the card and the work of the GMM scorer, from shapes alone.

The operation and byte count is a frozen copy of `gmm_phase` in
`chip_smoke.py` (commit 103de7f, lines 553-557): every real (frame, GMM,
component) costs a multiply and an add over 2D inputs, 4 * D operations;
each input byte is read once and each output byte written once: the
features, the (2D, G*C) weights and the (G*C) bias of the expanded form,
and the scores, all float32.

Peaks: NVIDIA's data sheet for the H100 SXM part (dense, no sparsity),
float32 outside the tensor cores and HBM3 bandwidth, at the 700 W power
limit. A card not in the table has no peak, and no share of one is
reported for it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def peaks_of(kind: str):
    return PEAKS.get(kind)


def gmm_flops(n_frames: int, components: int, D: int) -> float:
    """Operations of scoring n_frames frames against `components` real
    Gaussian components of dimension D."""
    return 4.0 * n_frames * components * D


def gmm_bytes(n_frames: int, components: int, G: int, D: int) -> float:
    """Bytes one scorer call over n_frames frames must move."""
    return 4.0 * (n_frames * D + 2 * D * components + components + n_frames * G)


def gmm_bound_s(n_frames: int, components: int, G: int, D: int, peaks: dict) -> float:
    """The least time the card could take for one call."""
    return max(gmm_flops(n_frames, components, D) / peaks["f32_flops"],
               gmm_bytes(n_frames, components, G, D) / peaks["bytes_per_s"])
