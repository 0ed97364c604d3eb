"""Batch decoding on one device.

Single-device counterpart of `BatchDecoder` in
`juicer_tpu/parallel/mesh.py`: where the JAX package vmaps the
per-utterance scan and shards the batch over a mesh, the port's frame
step already carries the batch axis. Utterances are padded to a common
frame count (repeat the last frame); each result is read at its true
length from the per-frame best-final snapshots, so padded decodes are
exact.

Two routes, as the JAX class has (`use_pallas` there, `use_fused` here):
the fused scan (`decoder/fused_scan.py`: on the card one launch of the
frame-step kernel per batch, on the CPU its plain version) and the plain
frame loop `TorchDecoder.run`. The mesh is not ported.
"""

from __future__ import annotations

import numpy as np

from ..decoder.core import TorchDecoder, check_use_fused, host_batch
from ..decoder.fused_scan import (FusedDecodeScan, assemble_results,
                                  why_not_covered)
from ..decoder.results import DecodeResult


class BatchDecoder:
    """`use_fused`: "auto" and True take the fused scan and raise ValueError
    when the decoder or the batch is outside its scope (`fused_eligible`;
    frames in (0, `max_scan_T`]); False takes `TorchDecoder.run`. On a CUDA
    decoder the plain frame loop is therefore reached only by asking for it;
    on a CPU decoder, where both routes are the plain version, "auto" takes
    `TorchDecoder.run` for what the kernel would not cover."""

    def __init__(self, decoder: TorchDecoder, use_fused="auto"):
        check_use_fused(use_fused)
        self.decoder = decoder
        self.use_fused = use_fused
        self._fs: dict[int, FusedDecodeScan] = {}  # batch size -> scan

    def _fused_ok(self, T: int) -> bool:
        if self.use_fused is False:
            return False
        dec = self.decoder
        why = why_not_covered(dec, T)
        if why is None:
            return True
        if self.use_fused == "auto" and dec.device.type == "cpu":
            return False
        raise ValueError(
            f"use_fused={self.use_fused!r}: the fused scan does not cover this decode "
            f"({why}); pass use_fused=False for the plain frame loop")

    def decode_scores_batch(self, gmm_scores, lengths=None) -> list[DecodeResult]:
        """gmm_scores: (B, T, n_gmms), optionally padded to a common T with
        per-utterance true `lengths`. Returns one DecodeResult each."""
        dec = self.decoder
        B, T = np.shape(gmm_scores)[:2]  # an array, a tensor or nested lists
        fused = self._fused_ok(T)
        if lengths is not None:
            if len(lengths) != B or min(int(n) for n in lengths) <= 0 or max(
                    int(n) for n in lengths) > T:
                raise ValueError(f"lengths {list(lengths)} do not fit a batch of {B} x {T}")
            # the fused scan always writes the per-frame snapshots
            if not fused and not dec.cfg.emit_diagnostics and min(int(n) for n in lengths) < T:
                raise ValueError("padded lengths need emit_diagnostics=True")
        gmm_scores = dec.scores_tensor(gmm_scores)
        if fused:
            fs = self._fs.get(B)
            if fs is None:
                fs = self._fs[B] = FusedDecodeScan(dec, B)
            carry, ys = fs(gmm_scores.transpose(0, 1).contiguous())
            return assemble_results(dec, fs, carry, ys,
                                    lengths if lengths is not None else [T] * B)
        carry, ys, rec0 = dec.run(gmm_scores)
        host = host_batch(carry, ys, rec0)
        return [
            dec.traceback(host, b, T,
                          true_T=int(lengths[b]) if lengths is not None else None)
            for b in range(B)
        ]
