"""Streaming decode with partial-result emission.

Counterpart of `juicer_tpu/decoder/stream.py` (`StreamingDecoder`), the
reference's `PARTIAL_DECODING`: frames are fed in chunks, the decoder's
carry persists between them, and after each chunk the converged common
prefix of all live paths is traced back and its words emitted once.

Each `feed` on a CUDA decoder is one launch of the frame-step kernel
(`FusedDecodeScan(dec, 1)` with `carry=` and `t0=`); a decoder outside the
kernel's scope raises when the session starts, unless `use_fused=False`
asks for the plain frame loop. On a CPU decoder, or with
`use_fused=False`, each `feed` is the plain frame loop
`TorchDecoder.run(carry=, t0=)`, its dense records made compact by
`compact_records` (int64 words for a float64 decoder, so its scores keep
float64). Either way the session keeps
only the records that landed, chunk by chunk on the host, and looks a
record up by its id `t*K + slot`. The ids of the records whose words were
emitted are kept here (the JAX class tags its hypotheses instead).
With on-the-fly composition (a decoder with a G, which the kernel does
not cover: `use_fused=False` on the card) words carry their records'
landing values, with no remainders, as in the JAX class's `otf` branch;
a lattice decoder streams its 1-best words (lattices are
`decode_scores_lattice`'s).
"""

from __future__ import annotations

import bisect

import numpy as np

from .core import (NEG, REC_FIELDS, TorchDecoder, check_use_fused, float_view,
                   written_records)
from .fused_scan import FusedDecodeScan, compact_records, max_scan_T, why_not_fused
from .results import DecodeResult, WordHyp

_CONV = (int, int, float, float, float, int, int)  # REC_FIELDS' types


class StreamingDecoder:
    def __init__(self, decoder: TorchDecoder, use_fused="auto"):
        check_use_fused(use_fused)
        self.dec = decoder
        self._fs = None
        if decoder.device.type == "cuda" and use_fused is not False:
            # on the card: the kernel at B=1, or the reason it does not apply
            why = why_not_fused(decoder)
            if why is not None:
                raise ValueError(f"stream: the fused scan does not cover this decoder "
                                 f"({why}); pass use_fused=False for the plain frame loop")
            self._fs = FusedDecodeScan(decoder, 1)
        self.carry = None
        self.t = 0
        self._starts: list[int] = []  # first frame of each chunk
        self._pieces: list[np.ndarray] = []  # each chunk's landed records (N, 8)
        self._rec0 = None
        self._emitted_pids: set[int] = set()
        self._emitted: list[WordHyp] = []

    # -- feeding -----------------------------------------------------------

    def feed(self, gmm_scores) -> list[WordHyp]:
        """Process a chunk of (T_chunk, n_gmms) scores; returns the NEWLY
        converged word hypotheses (stable partial results)."""
        dec = self.dec
        sc = dec.scores_tensor(gmm_scores)
        T = int(sc.shape[0])
        if T == 0:
            return []
        if self.t + T > max_scan_T(dec):
            raise ValueError(
                f"stream: frames {self.t}..{self.t + T} exceed the int32 record ids "
                f"t*K + slot at K={dec.K} (at most {max_scan_T(dec)} frames)")
        if self.carry is None:
            if self._fs is not None:
                self.carry, rec0 = self._fs.init, self._fs.rec0
            else:
                self.carry, rec0 = dec._init_carry(1)
            self._rec0 = {k: rec0[k][0].cpu().numpy() for k in REC_FIELDS}
        if self._fs is not None:
            self.carry, ys = self._fs(sc[:, None, :].contiguous(), carry=self.carry, t0=self.t)
        else:
            self.carry, ys, _ = dec.run(sc[None], carry=self.carry, t0=self.t)
            ys = compact_records(ys, self.t)
        rows, _ = written_records(ys["records"], ys["rec_count"][-1])
        self._starts.append(self.t)
        self._pieces.append(rows.cpu().numpy())
        self.t += T
        return self._trace_partial()

    # -- records -----------------------------------------------------------

    def _record(self, pid: int) -> tuple:
        """REC_FIELDS of record `pid`: an id t*K + slot of a landed record,
        or an initial-propagation record in [-K, 0)."""
        K = self.dec.K
        if pid < 0:
            return tuple(conv(self._rec0[k][pid + K]) for k, conv in zip(REC_FIELDS, _CONV))
        rows = self._pieces[bisect.bisect_right(self._starts, pid // K) - 1]
        i = int(np.searchsorted(rows[:, 0], pid))
        if i >= len(rows) or rows[i, 0] != pid:
            raise RuntimeError(f"stream: no record {pid}")
        f = float_view(rows[i])
        return (int(rows[i, 1]), int(rows[i, 2]), float(f[3]), float(f[4]),
                float(f[5]), int(rows[i, 6]), int(rows[i, 7]))

    def _chain(self, pid: int) -> list[int]:
        out = []
        while pid != -1:
            out.append(pid)
            pid = self._record(pid)[0]
            if len(out) > 1000000:
                raise RuntimeError("path chain loop")
        return out

    # -- partial traceback -------------------------------------------------

    def _trace_partial(self) -> list[WordHyp]:
        fr = self.carry["fr"]
        score = fr["score"][0].cpu().numpy()
        path = fr["path"][0].cpu().numpy()
        pids = np.unique(path[score > NEG / 2])
        pids = pids[pids >= -1]
        # also the live best-final token's path
        bf = self.carry["best_final"]
        if float(bf["score"][0]) > NEG / 2:
            pids = np.unique(np.concatenate([pids, [int(bf["path"][0])]]))
        if len(pids) == 0:
            return []
        # common ancestor: intersect the chains
        chains = [self._chain(int(p)) for p in pids if p != -1]
        if any(p == -1 for p in pids) or not chains:
            common = []  # some token has an empty history: nothing converged
        else:
            common_set = set(chains[0])
            for c in chains[1:]:
                common_set &= set(c)
            common = [p for p in chains[0] if p in common_set]
        # emit what was not emitted yet, oldest first (chains run newest first)
        K = self.dec.K
        new: list[WordHyp] = []
        for pid in reversed(common):
            if pid in self._emitted_pids:
                continue
            self._emitted_pids.add(pid)
            _, seq_id, s, a, l, src, arc = self._record(pid)
            frame = pid // K if pid >= 0 else 0  # init words report frame 0
            rem = (self.dec.art.remainders(src, arc, seq_id)
                   if src >= 0 and arc >= 0 and not self.dec.otf else None)
            for j, lab in enumerate(self.dec.art.seqs[seq_id]):
                if rem is not None and j < len(rem):
                    rs, rl, ra = rem[j]
                    new.append(WordHyp(lab, frame, s - rs, a - ra, l - rl))
                else:
                    new.append(WordHyp(lab, frame, s, a, l))
        self._emitted.extend(new)
        return new

    # -- finishing ---------------------------------------------------------

    def finish(self) -> DecodeResult:
        """Final 1-best result for the whole stream: `TorchDecoder.traceback`
        over the carry and every chunk's records."""
        if self.carry is None:
            raise ValueError("stream: finish before any frame was fed")
        carry_h = {
            "best_final": {f: v.cpu().numpy() for f, v in self.carry["best_final"].items()},
            "overflow": self.carry["overflow"].cpu().numpy(),
        }
        records = np.concatenate(self._pieces)
        ys_h = {"records": records, "rec_offsets": np.array([0, len(records)])}
        rec0_h = {k: v[None] for k, v in self._rec0.items()}
        return self.dec.traceback((carry_h, ys_h, rec0_h), 0, self.t)
