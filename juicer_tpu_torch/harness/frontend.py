"""Acoustic feature front end: waveform -> MFCC(+deltas)(+CMN), in PyTorch.

The counterpart of `juicer_tpu/harness/frontend.py` (the rebuild of the
reference's Tracter `ASRFactory` MFCC chain, `FrontEnd.h:24-135`), in
HTK's conventions:

  - log energy of the raw frame, then pre-emphasis (0.97), 25 ms frames
    at 10 ms shift, the symmetric Hamming window;
  - the power spectrum of an rfft zero-padded to the next power of two
    (512 for 400-sample frames), the HTK mel filterbank, log;
  - DCT-II cepstra with HTK liftering (CEPLIFTER 22); C0 or the log
    energy goes last (c1..cN, c0/E);
  - deltas and delta-deltas by HTK's regression formula (window 2), the
    utterance edge-padded;
  - per-utterance cepstral mean normalisation (the _Z qualifier).

Everything after the wav file is read runs in float64 on the caller's
device and is cast to float32 at the end, as the reference casts its
numpy result. The filterbank's integer bins and the DCT and lifter
tables are built with the reference's numpy float64 arithmetic (a bin
that moves by one moves a whole filter) and copied to the device once.

`mfcc` takes one utterance and is the plain version of `mfcc_batch`,
which takes B waveforms of different lengths and returns one (B, Tmax,
D) tensor and the lengths: frames of the zero-padded batch, the deltas
edge-padded at each utterance's own last frame, each utterance's mean
over its own frames, rows past an utterance's length zero. The
streaming front end (`harness/capture.py`) uses the same statics code.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import resolve_device


@dataclass
class FrontendConfig:
    sample_rate: int = 16000
    frame_len_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 0.97
    n_mels: int = 26
    n_ceps: int = 12
    ceplifter: int = 22
    low_freq: float = 0.0
    high_freq: float = 0.0  # 0 -> Nyquist
    use_energy: bool = False  # False -> C0
    deltas: bool = True
    delta_window: int = 2
    cmn: bool = True

    @property
    def frame_len(self) -> int:
        return int(round(self.sample_rate * self.frame_len_ms / 1000.0))

    @property
    def frame_shift(self) -> int:
        return int(round(self.sample_rate * self.frame_shift_ms / 1000.0))

    @property
    def n_fft(self) -> int:
        return 1 << (self.frame_len - 1).bit_length()

    @property
    def dim(self) -> int:
        return 3 * (self.n_ceps + 1) if self.deltas else self.n_ceps + 1


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Samples of a mono wav file as float64 (8-bit unsigned centred on
    0, 16- and 32-bit signed) and its sample rate."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        data = w.readframes(n)
    if width == 2:
        x = np.frombuffer(data, dtype="<i2").astype(np.float64)
    elif width == 1:
        x = np.frombuffer(data, dtype=np.uint8).astype(np.float64) - 128.0
    elif width == 4:
        x = np.frombuffer(data, dtype="<i4").astype(np.float64)
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    return x, rate


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_mels, n_fft, rate, low, high, device="cpu") -> torch.Tensor:
    """(n_mels, n_fft // 2 + 1) float64 triangular filters on `device`,
    their bins floor((n_fft + 1) * hz / rate) in numpy float64."""
    high = high or rate / 2.0
    pts = _mel_to_hz(np.linspace(_hz_to_mel(low), _hz_to_mel(high), n_mels + 2))
    bins = np.floor((n_fft + 1) * pts / rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(n_mels):
        a, b, c = bins[m], bins[m + 1], bins[m + 2]
        for k in range(a, b):
            fb[m, k] = (k - a) / (b - a)
        for k in range(b, c):
            fb[m, k] = (c - k) / (c - b)
    return torch.as_tensor(fb, device=resolve_device(device))


class _Tables:
    """The constant tables of one configuration on one device: window,
    filterbank, DCT and lifter."""

    def __init__(self, cfg: FrontendConfig, device: torch.device):
        self.cfg = cfg
        self.window = torch.hamming_window(cfg.frame_len, periodic=False,
                                           dtype=torch.float64, device=device)
        self.fb = mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.low_freq,
                                 cfg.high_freq, device)
        n = cfg.n_mels
        dct = np.cos(np.pi * np.arange(cfg.n_ceps + 1)[:, None]
                     * (np.arange(n)[None, :] + 0.5) / n) * np.sqrt(2.0 / n)
        self.dct = torch.as_tensor(dct, device=device)
        L = cfg.ceplifter
        lift = (1.0 + (L / 2.0) * np.sin(np.pi * np.arange(cfg.n_ceps + 1) / L) if L > 0
                else np.ones(cfg.n_ceps + 1))
        self.lift = torch.as_tensor(lift, device=device)

    def statics(self, frames: torch.Tensor) -> torch.Tensor:
        """(..., frame_len) float64 raw frames -> (..., n_ceps + 1) static
        cepstra in HTK order (c1..cN, c0 or log energy)."""
        cfg = self.cfg
        energy = torch.log(torch.clamp((frames * frames).sum(-1), min=1e-10))
        pre = torch.cat([frames[..., :1] * (1.0 - cfg.preemphasis),
                         frames[..., 1:] - cfg.preemphasis * frames[..., :-1]], dim=-1)
        spec = torch.fft.rfft(pre * self.window, n=cfg.n_fft).abs() ** 2
        logmel = torch.log(torch.clamp(spec @ self.fb.T, min=1e-10))
        ceps = (logmel @ self.dct.T) * self.lift
        c0 = energy if cfg.use_energy else ceps[..., 0]
        return torch.cat([ceps[..., 1:], c0[..., None]], dim=-1)


def _deltas_edge(x: torch.Tensor, window: int) -> torch.Tensor:
    """HTK regression deltas of (T, d) with the utterance edge-padded (the
    reference's `_deltas`, same order of float64 operations)."""
    T = x.shape[0]
    denom = 2.0 * sum(t * t for t in range(1, window + 1))
    idx = torch.arange(T, device=x.device)
    out = torch.zeros_like(x)
    for t in range(1, window + 1):
        out = out + t * (x[torch.clamp(idx + t, max=T - 1)] - x[torch.clamp(idx - t, min=0)])
    return out / denom


def mfcc(signal, cfg: FrontendConfig = FrontendConfig(), device="cuda") -> torch.Tensor:
    """One waveform (float samples, numpy or a tensor) -> (T, D) float32
    features on `device`."""
    dev = resolve_device(device)
    x = torch.as_tensor(signal, dtype=torch.float64).to(dev)
    flen, shift = cfg.frame_len, cfg.frame_shift
    if x.shape[0] < flen:
        x = torch.cat([x, x.new_zeros(flen - x.shape[0])])
    n_frames = 1 + (x.shape[0] - flen) // shift
    idx = (torch.arange(flen, device=dev)[None, :]
           + shift * torch.arange(n_frames, device=dev)[:, None])
    feats = _Tables(cfg, dev).statics(x[idx])
    if cfg.deltas:
        d1 = _deltas_edge(feats, cfg.delta_window)
        feats = torch.cat([feats, d1, _deltas_edge(d1, cfg.delta_window)], dim=1)
    if cfg.cmn:
        feats = feats - feats.mean(dim=0, keepdim=True)
    return feats.to(torch.float32)


def n_frames_of(n_samples: int, cfg: FrontendConfig) -> int:
    """Frames `mfcc` makes of n_samples (one for a signal shorter than a
    frame, which is zero-padded)."""
    return 1 + (max(n_samples, cfg.frame_len) - cfg.frame_len) // cfg.frame_shift


def _deltas_clamped(x: torch.Tensor, last: torch.Tensor, window: int) -> torch.Tensor:
    """Deltas of (B, T, d) with row b edge-padded at its own last frame
    `last[b]` (and at 0)."""
    B, T, d = x.shape
    denom = 2.0 * sum(t * t for t in range(1, window + 1))
    idx = torch.arange(T, device=x.device)[None, :]
    out = torch.zeros_like(x)
    for t in range(1, window + 1):
        hi = torch.minimum(idx + t, last[:, None]).clamp(min=0)
        lo = torch.clamp(torch.minimum(idx - t, last[:, None]), min=0)
        out = out + t * (torch.gather(x, 1, hi[..., None].expand(B, T, d))
                         - torch.gather(x, 1, lo[..., None].expand(B, T, d)))
    return out / denom


def mfcc_batch(signals, cfg: FrontendConfig = FrontendConfig(), device="cuda"
               ) -> tuple[torch.Tensor, list[int]]:
    """B waveforms of different lengths -> ((B, Tmax, D) float32 features
    on `device`, the B frame counts). Row b equals `mfcc(signals[b])` in
    its first lengths[b] frames (within float64 rounding of a batched
    product) and is zero after them."""
    dev = resolve_device(device)
    flen, shift = cfg.frame_len, cfg.frame_shift
    lengths = [n_frames_of(len(s), cfg) for s in signals]
    n_max = max(max(len(s) for s in signals), flen)
    x = torch.zeros(len(signals), n_max, dtype=torch.float64)
    for b, s in enumerate(signals):
        x[b, :len(s)] = torch.as_tensor(s, dtype=torch.float64)
    x = x.to(dev)
    t_max = max(lengths)
    frames = x.unfold(1, flen, shift)[:, :t_max]  # (B, Tmax, flen)
    feats = _Tables(cfg, dev).statics(frames)
    L = torch.as_tensor(lengths, device=dev)
    valid = (torch.arange(t_max, device=dev)[None, :] < L[:, None])[..., None]
    if cfg.deltas:
        d1 = _deltas_clamped(feats, L - 1, cfg.delta_window)
        feats = torch.cat([feats, d1, _deltas_clamped(d1, L - 1, cfg.delta_window)], dim=2)
    if cfg.cmn:
        mean = torch.where(valid, feats, 0.0).sum(dim=1, keepdim=True) / L[:, None, None]
        feats = feats - mean
    return torch.where(valid, feats, 0.0).to(torch.float32), lengths


def config_for_rate(cfg: FrontendConfig, rate: int) -> FrontendConfig:
    """`cfg` at a file's sample rate, as `wav_to_features` takes it."""
    return cfg if rate == cfg.sample_rate else replace(cfg, sample_rate=rate)


def wav_to_features(path: str, cfg: FrontendConfig = FrontendConfig(),
                    device="cuda") -> torch.Tensor:
    x, rate = read_wav(path)
    return mfcc(x, config_for_rate(cfg, rate), device)


def wavs_to_features(paths, cfg: FrontendConfig = FrontendConfig(), device="cuda"
                     ) -> list[torch.Tensor]:
    """The features of several wav files, each (T_i, D) on `device`: the
    files of one sample rate go through `mfcc_batch` together; each
    tensor is a view of its batch."""
    waves = [read_wav(p) for p in paths]
    out: list = [None] * len(paths)
    for rate in dict.fromkeys(r for _, r in waves):
        sel = [i for i, (_, r) in enumerate(waves) if r == rate]
        feats, lengths = mfcc_batch([waves[i][0] for i in sel], config_for_rate(cfg, rate),
                                    device)
        for k, i in enumerate(sel):
            out[i] = feats[k, :lengths[k]]
    return out
