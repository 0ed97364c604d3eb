"""Batch decoding on one device.

Single-device counterpart of `BatchDecoder` in
`juicer_tpu/parallel/mesh.py`: where the JAX package vmaps the
per-utterance scan and shards the batch over a mesh, the port's frame
step already carries the batch axis. Utterances are padded to a common
frame count (repeat the last frame); with `emit_diagnostics` on, each
result is read at its true length from the per-frame best-final
snapshots, so padded decodes are exact. The fused Pallas route and the
mesh are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decoder.core import TorchDecoder, host_batch
from ..decoder.results import DecodeResult


class BatchDecoder:
    def __init__(self, decoder: TorchDecoder):
        self.decoder = decoder

    def decode_scores_batch(self, gmm_scores, lengths=None) -> list[DecodeResult]:
        """gmm_scores: (B, T, n_gmms), optionally padded to a common T with
        per-utterance true `lengths`. Returns one DecodeResult each."""
        dec = self.decoder
        if not isinstance(gmm_scores, torch.Tensor):
            gmm_scores = torch.from_numpy(np.array(gmm_scores, np.float32))
        B, T = gmm_scores.shape[:2]
        if lengths is not None:
            if len(lengths) != B or min(int(n) for n in lengths) <= 0 or max(
                    int(n) for n in lengths) > T:
                raise ValueError(f"lengths {list(lengths)} do not fit a batch of {B} x {T}")
            if not dec.cfg.emit_diagnostics and min(int(n) for n in lengths) < T:
                raise ValueError("padded lengths need emit_diagnostics=True")
        carry, ys, rec0 = dec.run(gmm_scores.to(dec.device, torch.float32))
        host = host_batch(carry, ys, rec0)
        return [
            dec.traceback(host, b, T,
                          true_T=int(lengths[b]) if lengths is not None else None)
            for b in range(B)
        ]
