"""Frontier/expansion budget autotuning.

Counterpart of `juicer_tpu/decoder/autotune.py` (`autotune_budgets`) over
`TorchDecoder`. The decoder's capacities are static: the frontier slots K
(`max_insts`), the expansion budget E (`expand_budget`) and the final
budget F (`final_budget`). The tuner picks them from the peak occupancy
measured on sample utterances, with a safety margin, and certifies
exactness: the decoder raises its `overflow` flag whenever any budget
binds, so a decode without overflow is the decode with unbounded budgets.

The same doubling probe, margin, 128-rounding and verification as the
JAX tuner, which decodes one sample at a time. Here the samples of a
probe are one padded wave of `BatchDecoder` (the last frame repeated),
each result read at the sample's length; a sample whose wave result
overflows is decoded again alone, since the overflow flag also covers
the padding. Each result is thus the sample's own decode (`decode_each`,
which the reference-scale tools of `harness/` decode with too). What
decodes the samples follows `BatchDecoder`'s rule
(`use_fused`): on a CUDA decoder "auto" and True decode through the
frame-step kernel and raise `ProbeOutOfScope` (a `ValueError`) with
the reason when a probe lies outside its scope (a doubled probe past E
= 32768 takes the sort merge); only `use_fused=False` takes the plain frame loop
`TorchDecoder.run`, the counterpart of the JAX tuner's XLA decoder. A CPU
decoder always runs the plain loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .core import TorchDecoder, TorchDecoderConfig, check_use_fused
from .fused_scan import why_not_covered


class BudgetsNotFound(RuntimeError):
    """No probe within `max_rounds` doublings decodes every sample without
    overflow."""


class ProbeOutOfScope(ValueError):
    """A probe the tuner was asked to decode through the frame-step kernel
    lies outside the kernel's scope (`why_not_covered`)."""


def _round_up(x: int, m: int) -> int:
    return max(m, ((int(x) + m - 1) // m) * m)


def pad_batch(scores: Sequence) -> torch.Tensor:
    """(B, Tmax, n_gmms) of (T_i, n_gmms) score tensors, each edge-padded
    to the longest (its last frame repeated)."""
    n_frames = max(int(s.shape[0]) for s in scores)
    return torch.stack([torch.cat([s, s[-1:].expand(n_frames - s.shape[0], -1)])
                        for s in scores])


def decode_each(dec: TorchDecoder, score_samples: Sequence, use_fused="auto") -> list:
    """Each (T_i, n_gmms) sample's own decode, as `decode_scores` gives it:
    the samples go as one padded `BatchDecoder` wave (the last frame
    repeated; on a CUDA decoder through the route `use_fused` names, on a
    CPU decoder the plain loop), each result read at the sample's length;
    a sample whose wave result overflows is decoded again alone, since the
    overflow flag also covers the padding."""
    # imported here: `parallel` imports this package
    from ..parallel.mesh import BatchDecoder

    lengths = [int(s.shape[0]) for s in score_samples]
    n_frames = max(lengths)
    sc = [dec.scores_tensor(s) for s in score_samples]
    wave = pad_batch(sc)
    route = use_fused if dec.device.type == "cuda" else False
    results = BatchDecoder(dec, use_fused=route).decode_scores_batch(wave, lengths)
    return [dec.decode_scores(s, use_fused=use_fused) if r.overflow and len(s) < n_frames
            else r for s, r in zip(sc, results)]


def autotune_budgets(
    artifact,
    score_samples: Sequence,
    cfg: Optional[TorchDecoderConfig] = None,
    margin: float = 1.5,
    max_rounds: int = 6,
    verify: bool = True,
    device="cuda",
    use_fused="auto",
    verbose: bool = False,
    g_network=None,
) -> TorchDecoderConfig:
    """Pick minimal safe (max_insts, expand_budget) for this workload.

    score_samples: (T, n_gmms) GMM log-likelihood matrices of
    representative utterances (numpy arrays or tensors; use the scorer of
    production). Starts from ``cfg`` (or its defaults), doubles K, E and F
    until no sample overflows, then shrinks K and E to the measured peak
    * margin (multiples of 128). With verify=True the tuned config is run
    again; where a sample overflows there, the probe's budgets are
    returned, and where its words or score differ it raises. With
    `g_network` (on-the-fly composition) the budgets are (arc, G state)
    slots and their candidates; the kernel does not cover such a decoder,
    so on the card only `use_fused=False` tunes it."""
    check_use_fused(use_fused)
    base = cfg or TorchDecoderConfig()
    probe = dataclasses.replace(base, emit_diagnostics=True)
    n_frames = max(int(s.shape[0]) for s in score_samples)

    def decode_all(c):
        dec = TorchDecoder(artifact, c, device=device, g_network=g_network)
        if dec.device.type == "cuda" and use_fused is not False:
            # refuse before any decode when the kernel would not cover it
            why = why_not_covered(dec, n_frames)
            if why is not None:
                raise ProbeOutOfScope(
                    f"autotune: the probe K={c.max_insts}, E={c.expand_budget}, "
                    f"F={c.final_budget} lies outside the fused scan's scope ({why}); "
                    f"pass use_fused=False for the plain frame loop")
        return dec, decode_each(dec, score_samples, use_fused)

    ref_results = None
    for _round in range(max_rounds):
        dec, results = decode_all(probe)
        if verbose:
            route = ("frame-step kernel" if dec.device.type == "cuda" and use_fused is not False
                     else "plain frame loop")
            print(f"[autotune] probe K={probe.max_insts} "
                  f"E={probe.expand_budget}: overflow "
                  f"{sum(r.overflow for r in results)}/{len(results)}, "
                  f"peak {max(r.max_active for r in results)}/"
                  f"{max(r.max_cand for r in results)} ({route} on {dec.device})", flush=True)
        if not any(r.overflow for r in results):
            ref_results = results
            break
        probe = dataclasses.replace(
            probe,
            max_insts=probe.max_insts * 2,
            expand_budget=probe.expand_budget * 2,
            final_budget=probe.final_budget * 2,
        )
    if ref_results is None:
        raise BudgetsNotFound(
            f"autotune: still overflowing at max_insts={probe.max_insts}, "
            f"expand_budget={probe.expand_budget} after {max_rounds} doublings"
        )

    max_active = max(r.max_active for r in ref_results)
    max_cand = max(r.max_cand for r in ref_results)
    at_probe = dataclasses.replace(
        base, max_insts=probe.max_insts, expand_budget=probe.expand_budget,
        final_budget=probe.final_budget)
    tuned = dataclasses.replace(
        base,
        max_insts=min(_round_up(max_active * margin, 128), probe.max_insts),
        expand_budget=min(_round_up(max_cand * margin, 128), probe.expand_budget),
        final_budget=probe.final_budget,
    )
    if tuned.max_insts >= probe.max_insts and tuned.expand_budget >= probe.expand_budget:
        return at_probe

    if verify:
        _, got_all = decode_all(dataclasses.replace(tuned, emit_diagnostics=True))
        for got, ref in zip(got_all, ref_results):
            if got.overflow:
                # margin too thin for this sample: the probe's size
                return at_probe
            if got.words != ref.words or abs(got.score - ref.score) >= 1e-6:
                raise RuntimeError(
                    "autotune: the tuned budgets decode differently without overflow "
                    "(overflow tracking should make this impossible)")
    return tuned
