"""PyTorch/CUDA port of juicer_tpu for NVIDIA Hopper (H100).

The JAX package `juicer_tpu` is the reference this package is held
against; nothing here imports it, or JAX. The port's slices so far:

  - `ops.gmm`: all-GMM acoustic scoring; on the card a hand-written CUDA
    kernel (`csrc/gmm_logsumexp.cu`, the counterpart of the Pallas kernel
    in `juicer_tpu/ops/gmm_pallas.py`), on the CPU its plain PyTorch form;
  - `decoder.core`: the frame-synchronous beam search
    (`juicer_tpu/decoder/tpu_core.py`) with a leading batch axis, in
    float32 or float64, with the binned or the exact histogram, the dense
    or the sort merge, with or without lattice records, over a static
    network or by on-the-fly composition with a grammar
    (`decoder.otf.GNetwork`, built from an ARPA LM by
    `compile.arpa_grammar` over `lexicon.Vocabulary`, its parser in
    `lm.arpa`), with or without label-and-weight pushing;
  - `decoder.lattice` and `fst`: word lattices from those records
    (`decode_scores_lattice`), with the FST utilities they need;
  - `decoder.fused_scan`: the fused frame-step scan; on the card a
    persistent hand-written CUDA kernel (`csrc/frame_step.cu`, the
    counterpart of `juicer_tpu/decoder/pallas_scan.py`), on the CPU the
    plain frame loop of `decoder.core`;
  - `parallel.mesh`: batch decoding with padded lengths, on one device or
    split over a mesh of devices (`make_mesh`, one replica of the
    decoder a device), through the fused scan where it applies;
    `parallel.multihost_demo`: the corpus split over processes, its
    statistics summed with a `torch.distributed` collective;
  - `decoder.autotune`: the budget autotuner (`autotune_budgets`), through
    the fused scan on the card;
  - `decoder.stream`: the streaming decoder with partial results, one
    launch of the fused scan a chunk on the card;
  - `cli.juicer`: the decoder CLI (`jtpu-juicer-torch`, or `python -m
    juicer_tpu_torch.cli.juicer`), with its readers: AT&T FSM and symbol
    files (`fst.io`, the native parser), HTK MMF models (`am.mmf`),
    hybrid model sets, CMLLR input transforms (`am.xform`), model-space
    MLLR with regression classes (`am.regtree`, float64 on the device),
    HTK and LNA features, wav audio through the MFCC front end on the
    device (`harness.frontend`, a batch of files in one pass), live PCM
    through the streaming front end (`harness.capture`, `-loop
    -audioDevice`), and the batch tester with WER (`harness`). It takes
    every flag of `jtpu-juicer`; both refuse the HTKLib-backed ones
    (-useHModels, -htkConfig, -parentXformDir);
  - `decoder.ref_core` and `decoder.otf.RefOtfDecoder`: the oracle token
    passing on the host (`-refCore`), independent of both kernels;
  - `cli.gramgen` and `compile.gram.GramGen`: the grammar generator
    (`jtpu-gramgen-torch`: word loops, sil-wordloop-sil, ARPA n-grams
    with `<unk>`, `#phi` backoffs, sil/sp loops, normalisation, the LM
    scale and insertion penalty, gzip and npz-cached LMs (`lm.arpa`),
    BBN word pairs (`lm.wordpair`));
  - `harness.wsj_task`: the cached WSJ-order tasks (2k and 20k words),
    their on-the-fly composition pairs (`load_otf_task`), the reference
    bench's operating point and the on-the-fly script's (`OTF_POINT`).

Precision: the expanded GMM quadratic form cancels strongly when x is
close to a mean, and TF32 (or bf16) products perturb scores by ~1e-3,
which flips Viterbi ties. Both TF32 switches are therefore pinned off
here, for every user of the package:

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

Entry points take `device=` and default to "cuda". Without a card they
raise instead of running on the CPU; tests pass `device="cpu"`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch device for an entry point. A CUDA device without a card
    raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "juicer_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:N"; an index-less device would compare unequal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
