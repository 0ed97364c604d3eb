"""Batch decoding over a mesh of devices.

Counterpart of `juicer_tpu/parallel/mesh.py`. The reference scaled by
manual cluster job-splitting (`juicer_userman.tex:584`); the JAX package
shards the utterance batch over a 1-D `jax.sharding.Mesh`. Here a mesh
is a tuple of torch devices (`make_mesh`) and the batch is split into
one contiguous share a device. The search network, the expansion tables
and (through the caller's `ops.gmm.GmmScorer` on each device) the GMM
parameters are replicated on every device; per-utterance decode state
never crosses devices, so the only communication is the scores going
out and the results coming back. This is the embarrassingly parallel
regime the decoder lives in. Across processes the same split is made by
`parallel.multihost_demo`, with the statistics summed by a collective.

The frame step already carries the batch axis, so a share is one batch
of its device's decoder. Utterances are padded to a common frame count
(repeat the last frame); each result is read at its true length from
the per-frame best-final snapshots, so padded decodes are exact.

Two routes, as the JAX class has (`use_pallas` there, `use_fused` here):
the fused scan (`decoder/fused_scan.py`: on the card one launch of the
frame-step kernel a share, on the CPU its plain version) and the plain
frame loop `TorchDecoder.run`.

What one process with several devices overlaps: every share is launched
before any result is read back (the first sync is the first share's copy
to the host: `fused_scan.read_paths` on the fused route, `core.host_batch`
on the plain one), and each launch goes to its own device's current
stream. Shares on distinct cards therefore run concurrently; shares on
one device serialize on its stream. The traceback of each share then
runs on the host, one share after another.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..decoder.core import TorchDecoder, check_use_fused, host_batch
from ..decoder.fused_scan import (FusedDecodeScan, assemble_results, smem_bytes,
                                  why_not_covered)
from ..decoder.results import DecodeResult
from ..utils import trace


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> tuple[torch.device, ...]:
    """The devices a `BatchDecoder` shards its batch over. "cuda": the
    first `n_devices` visible cards, or all of them; asking for more than
    are visible raises, since a short mesh would hide missing devices.
    "cpu": `n_devices` (default 1) entries of the CPU device, each a
    replica, as the JAX tests' virtual host devices are. A caller may
    also pass its own tuple to `BatchDecoder`, with a device repeated."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"make_mesh: {n} devices asked for")
        return (torch.device("cpu"),) * n
    if kind != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if not 1 <= n <= have:
        raise ValueError(f"make_mesh: {n} CUDA devices asked for, {have} visible")
    return tuple(torch.device("cuda", i) for i in range(n))


def shares(B: int, n: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of n contiguous shares of a batch of B, in order;
    their sizes differ by at most one, the larger first. A share is empty
    when B < n."""
    q, r = divmod(B, n)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(n)])
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n)]


class BatchDecoder:
    """Batch of utterances decoded on one device or data-parallel over a
    mesh (`make_mesh`, or any tuple of devices).

    With `mesh=None` the whole batch is one share on the decoder's device.
    With a mesh the batch splits into `len(mesh)` contiguous shares
    (`shares`; an empty one is not launched), share i on `mesh[i]`. Each
    distinct device has one replica of the decoder, made from the same
    artifact, config and G; the given decoder serves its own device. The
    tables are cached on the artifact per device, so replicas on one
    device share one copy of them. There is no batch-size rule: the kernel
    runs one block an utterance.

    `use_fused`: "auto" and True take the fused scan and raise ValueError
    when a share's decoder or frames are outside its scope
    (`fused_eligible`; frames in (0, `max_scan_T`]); False takes
    `TorchDecoder.run`. On a CUDA decoder the plain frame loop is therefore
    reached only by asking for it; on a CPU decoder, where both routes are
    the plain version, "auto" takes `TorchDecoder.run` for what the kernel
    would not cover."""

    def __init__(self, decoder: TorchDecoder, mesh=None, use_fused="auto"):
        check_use_fused(use_fused)
        self.decoder = decoder
        self.use_fused = use_fused
        self.mesh = (decoder.device,) if mesh is None else tuple(
            resolve_device(d) for d in mesh)
        if not self.mesh:
            raise ValueError("BatchDecoder: an empty mesh")
        self.replicas = {decoder.device: decoder}
        for d in self.mesh:
            if d not in self.replicas:
                self.replicas[d] = TorchDecoder(decoder.art, decoder.cfg, device=d,
                                                g_network=decoder.g)
        self._fs: dict[tuple[torch.device, int], FusedDecodeScan] = {}  # (device, B) -> scan

    def _fused_ok(self, dec: TorchDecoder, T: int) -> bool:
        if self.use_fused is False:
            return False
        why = why_not_covered(dec, T)
        if why is None:
            return True
        if self.use_fused == "auto" and dec.device.type == "cpu":
            return False
        raise ValueError(
            f"use_fused={self.use_fused!r}: the fused scan does not cover this decode "
            f"({why}); pass use_fused=False for the plain frame loop")

    def _scan(self, dec: TorchDecoder, B: int) -> FusedDecodeScan:
        fs = self._fs.get((dec.device, B))
        if fs is None:
            fs = self._fs[dec.device, B] = FusedDecodeScan(dec, B)
        return fs

    def decode_scores_batch(self, gmm_scores, lengths=None) -> list[DecodeResult]:
        """gmm_scores: (B, T, n_gmms), optionally padded to a common T with
        per-utterance true `lengths`. Returns one DecodeResult each, in
        batch order. Traced as the span `entry` (`utils.trace`)."""
        with trace.span("entry") as attrs:
            return self._decode(gmm_scores, lengths, attrs)

    def _decode(self, gmm_scores, lengths, attrs) -> list[DecodeResult]:
        B, T = np.shape(gmm_scores)[:2]  # an array, a tensor or nested lists
        if lengths is not None:
            lengths = [int(n) for n in lengths]
            if len(lengths) != B or min(lengths) <= 0 or max(lengths) > T:
                raise ValueError(f"lengths {lengths} do not fit a batch of {B} x {T}")
        # every route is chosen, and refused, before anything is launched
        plan = []
        for d, (lo, hi) in zip(self.mesh, shares(B, len(self.mesh))):
            if hi == lo:
                continue
            dec = self.replicas[d]
            fused = self._fused_ok(dec, T)
            # the fused scan always writes the per-frame snapshots
            if (not fused and lengths is not None and not dec.cfg.emit_diagnostics
                    and min(lengths[lo:hi]) < T):
                raise ValueError("padded lengths need emit_diagnostics=True")
            plan.append((dec, lo, hi, fused))
        if attrs is not None and plan:
            dec, lo, hi, fused = plan[0]
            # the frame-step kernel's layout: whether the HMM tables ride in
            # shared memory, and the bytes of it a block takes
            d = self._scan(dec, hi - lo).dims if fused else None
            attrs.update(B=int(B), T=int(T), K=dec.K, S=dec.S,
                         route="fused" if fused else "plain", H=dec.H,
                         staged=int(d is not None and d["hmm_words"] > 0),
                         smem=smem_bytes(**d) if d is not None else 0)
        # launch every share, then read them back one by one
        launched = []
        for dec, lo, hi, fused in plan:
            sc = dec.scores_tensor(gmm_scores[lo:hi])
            if fused:
                fs = self._scan(dec, hi - lo)
                launched.append((fs, fs(sc.transpose(0, 1).contiguous())))
            else:
                launched.append((None, dec.run(sc)))
        out = []
        for (dec, lo, hi, _), (fs, state) in zip(plan, launched):
            lens = lengths[lo:hi] if lengths is not None else None
            if fs is not None:
                carry, ys = state
                out += assemble_results(dec, fs, carry, ys, lens or [T] * (hi - lo))
            else:
                host = host_batch(*state)
                with trace.span("traceback") as tb:
                    if tb is not None:
                        tb["utterances"] = hi - lo
                    out += [dec.traceback(host, b, T, true_T=lens[b] if lens else None)
                            for b in range(hi - lo)]
        return out
