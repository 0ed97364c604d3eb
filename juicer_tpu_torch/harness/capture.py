"""Live audio capture: PCM source -> streaming MFCC front end, in PyTorch.

The counterpart of `juicer_tpu/harness/capture.py`, the rebuild of the
Tracter `ASRFactory` capture chain behind the reference's `-loop`
microphone mode (`FrontEnd.h:24-135`):

- `PcmSource`: raw signed 16-bit little-endian mono PCM from an ALSA
  capture device (through an `arecord` subprocess; without the binary it
  raises) or from any binary file object (stdin, a pipe, a file). A
  torn final sample at the end of the stream is dropped.

- `StreamingFrontend`: the incremental `frontend.mfcc` on the caller's
  device, with the same statics code (`frontend._Tables`): frames over a
  rolling sample buffer, a lookahead of 2 x the delta window held back so
  the deltas of every emitted frame use HTK's exact regression window,
  and a running cepstral mean (a live source cannot see the future).
  Fed the whole signal and flushed, it makes the frames of the batch
  `mfcc`; without CMN they are equal within float64 rounding of the
  products, chunk for chunk.

- `capture_features`: pull PCM from a source, yield feature chunks.
"""

from __future__ import annotations

import subprocess
from typing import BinaryIO, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from .frontend import FrontendConfig, _Tables, config_for_rate


class PcmSource:
    """Raw S16LE mono PCM from an ALSA device or a binary stream."""

    def __init__(self, device: Optional[str] = None, stream: Optional[BinaryIO] = None,
                 sample_rate: int = 16000):
        if (device is None) == (stream is None):
            raise ValueError("give exactly one of device= or stream=")
        self.sample_rate = sample_rate
        self._proc: Optional[subprocess.Popen] = None
        if device is not None:
            try:
                self._proc = subprocess.Popen(
                    ["arecord", "-q", "-t", "raw", "-f", "S16_LE", "-c", "1",
                     "-r", str(sample_rate), "-D", device],
                    stdout=subprocess.PIPE)
            except FileNotFoundError as e:
                raise RuntimeError("audio capture needs the `arecord` binary (alsa-utils); "
                                   "pipe raw S16LE PCM into stdin instead") from e
            self._stream = self._proc.stdout
        else:
            self._stream = stream

    def read(self, n_samples: int) -> np.ndarray:
        """Up to n_samples as float64; an empty array at the end of the stream."""
        data = self._stream.read(2 * n_samples)
        if not data:
            return np.empty(0)
        if len(data) % 2:  # torn final sample at EOF
            data = data[:-1]
        return np.frombuffer(data, dtype="<i2").astype(np.float64)

    def close(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            self._proc.wait()


class StreamingFrontend:
    """Incremental waveform -> MFCC(+deltas, running CMN) on a device.

    feed(samples) -> (n, D) float32 tensor of newly completed frames (n may
    be 0); flush() -> the frames held back for the delta lookahead."""

    def __init__(self, cfg: FrontendConfig = FrontendConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.flen, self.shift = cfg.frame_len, cfg.frame_shift
        self._tables = _Tables(cfg, self.device)
        d = cfg.n_ceps + 1
        self._samples = torch.empty(0, dtype=torch.float64, device=self.device)
        # a delta-delta at frame t reads the statics of [t - 2w, t + 2w]:
        # 2w frames of lookahead are held back, 2w emitted ones kept
        self._look = 2 * cfg.delta_window if cfg.deltas else 0
        self._pending = torch.empty(0, d, dtype=torch.float64, device=self.device)
        self._hist = torch.empty(0, d, dtype=torch.float64, device=self.device)
        self._cmn_sum: Optional[torch.Tensor] = None
        self._cmn_n = 0
        self._started = False  # a static frame has been extracted

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def _reg(self, x: torch.Tensor) -> torch.Tensor:
        """Regression deltas with clipped indices: edge-padded at both ends
        of x (the stream's start and, when final, its end)."""
        w = self.cfg.delta_window
        denom = 2.0 * sum(t * t for t in range(1, w + 1))
        n = x.shape[0]
        idx = torch.arange(n, device=x.device)
        out = torch.zeros_like(x)
        for t in range(1, w + 1):
            out = out + t * (x[torch.clamp(idx + t, max=n - 1)]
                             - x[torch.clamp(idx - t, min=0)])
        return out / denom

    def _emit(self, final: bool) -> torch.Tensor:
        avail = self._pending.shape[0]
        n_out = avail if final else max(0, avail - self._look)
        if n_out == 0:
            return torch.empty(0, self.dim, dtype=torch.float32, device=self.device)
        if self.cfg.deltas:
            ctx = torch.cat([self._hist, self._pending])
            start = self._hist.shape[0]
            d1 = self._reg(ctx)
            d2 = self._reg(d1)
            sl = slice(start, start + n_out)
            out = torch.cat([ctx[sl], d1[sl], d2[sl]], dim=1)
            self._hist = torch.cat([self._hist, self._pending[:n_out]])[-self._look:]
        else:
            out = self._pending[:n_out]
        self._pending = self._pending[n_out:]
        if self.cfg.cmn:
            if self._cmn_sum is None:
                self._cmn_sum = torch.zeros(out.shape[1], dtype=torch.float64,
                                            device=self.device)
            self._cmn_sum = self._cmn_sum + out.sum(dim=0)
            self._cmn_n += n_out
            out = out - self._cmn_sum[None, :] / self._cmn_n
        return out.to(torch.float32)

    def feed(self, samples) -> torch.Tensor:
        x = torch.as_tensor(samples, dtype=torch.float64).to(self.device)
        self._samples = torch.cat([self._samples, x])
        if self._samples.shape[0] >= self.flen:
            n_frames = 1 + (self._samples.shape[0] - self.flen) // self.shift
            statics = self._tables.statics(
                self._samples.unfold(0, self.flen, self.shift)[:n_frames])
            self._samples = self._samples[n_frames * self.shift:]
            self._pending = torch.cat([self._pending, statics])
            self._started = True
        return self._emit(final=False)

    def flush(self) -> torch.Tensor:
        """The frames held back for lookahead (end of stream)."""
        n = self._samples.shape[0]
        if n > 0 and not self._started:
            # the whole stream is shorter than a frame: zero-pad it as the
            # batch front end does
            pad = torch.cat([self._samples, self._samples.new_zeros(self.flen - n)])
            self._pending = self._tables.statics(pad[None, :])
        self._samples = self._samples[:0]
        return self._emit(final=True)


def capture_features(source: PcmSource, cfg: Optional[FrontendConfig] = None,
                     chunk_samples: int = 1600, device="cuda") -> Iterator[torch.Tensor]:
    """Pull PCM from `source` and yield (n, D) float32 feature chunks on
    `device` (at the source's sample rate)."""
    cfg = config_for_rate(cfg or FrontendConfig(sample_rate=source.sample_rate),
                          source.sample_rate)
    fe = StreamingFrontend(cfg, device)
    while True:
        x = source.read(chunk_samples)
        if x.size == 0:
            break
        out = fe.feed(x)
        if out.shape[0]:
            yield out
    tail = fe.flush()
    if tail.shape[0]:
        yield tail
