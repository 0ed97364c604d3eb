"""The system under test: the PyTorch and CUDA port, `juicer_tpu_torch`.

The only module of the benchmark that imports the program. It builds what
a user of the batch entry point builds, from the configuration's files:
the network and the models, the decode artifact (in memory, no cache
written), the decoder at the configuration's operating point with the
CLI's other defaults, the GMM scorer and `BatchDecoder(use_fused=True)`.
`wave` is one call of the entry a wave: the host features, padded, go to
the card, are scored in one `GmmScorer` call and decoded by
`BatchDecoder.decode_scores_batch`.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


class Program:
    def __init__(self, task_dir: str, point: dict, device: str, spans: dict):
        from juicer_tpu_torch.am.models import AcousticModelSet
        from juicer_tpu_torch.decoder.artifact import DecoderArtifact
        from juicer_tpu_torch.decoder.core import TorchDecoder, TorchDecoderConfig
        from juicer_tpu_torch.decoder.network import DecoderNetwork
        from juicer_tpu_torch.ops.gmm import make_gmm_scorer
        from juicer_tpu_torch.parallel.mesh import BatchDecoder

        t0 = time.perf_counter()
        net = DecoderNetwork.load_npz(os.path.join(task_dir, "clg.npz"))
        models = AcousticModelSet.load_npz(os.path.join(task_dir, "models.npz"))
        spans["network_models_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = DecoderArtifact(net, models)
        spans["artifact_build_s"] = time.perf_counter() - t0
        cfg = TorchDecoderConfig(
            max_insts=point["K"], expand_budget=point["E"], final_budget=point["F"],
            emit_prune_win=point["beam"], phone_end_prune_win=point["end_beam"],
            word_prune_win=point["end_beam"], max_emit_hyps=point["maxhyps"])
        t0 = time.perf_counter()
        self.device = torch.device(device)
        self.decoder = TorchDecoder(art, cfg, device=self.device)
        self.scorer = make_gmm_scorer(models.flat_params(), device=self.device)
        self.entry = BatchDecoder(self.decoder, use_fused=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        spans["tables_s"] = time.perf_counter() - t0
        self.G = self.scorer.n_gmms
        self.K = self.decoder.K

    def wave(self, feats: np.ndarray, lengths, span):
        """Decode one wave of (B, T_pad, D) padded host features with true
        `lengths`: [DecodeResult] on the host, and the (B, T_pad, G)
        scores on the card. `span(name)` opens the benchmark's host span
        around each call into the program."""
        B, T, D = feats.shape
        with span("score"):
            x = torch.from_numpy(feats).to(self.device).view(B * T, D)
            scores = self.scorer(x).view(B, T, self.G)
        with span("decode"):
            results = self.entry.decode_scores_batch(scores, lengths)
        return results, scores
