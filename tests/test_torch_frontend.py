"""The port's wav front end and live capture against the JAX package.

Signals come from a seed (numpy); the same numpy input goes through
`juicer_tpu.harness.{frontend,capture}` and the port's
`juicer_tpu_torch.harness.{frontend,capture}` on `device="cpu"`:

  - `read_wav` (sample widths 1, 2 and 4) and `mel_filterbank` exactly;
  - `mfcc` within ATOL (1e-5) of the JAX float32 features (both compute
    in float64 and cast once; on this CPU they agree bit for bit, and
    the tolerance leaves room for another FFT or product order), in
    every configuration below;
  - `mfcc_batch` on utterances of different lengths: each row within
    ATOL of the JAX `mfcc` of that utterance alone (its own CMN and
    delta edges) and zero past its length;
  - `StreamingFrontend` chunk for chunk (chunks of 1, 777 and the whole
    signal, and ragged ones) within ATOL of the JAX class's chunks,
    with and without running CMN; without CMN the chunks concatenated
    equal the batch `mfcc` within ATOL, as `tests/test_capture.py`
    holds the JAX class;
  - `PcmSource` (a stream, a torn final sample, the argument checks, a
    device without `arecord`) and `capture_features`.
"""

import io
import shutil
import wave

import numpy as np
import pytest
import torch

from juicer_tpu.harness import capture as jax_capture
from juicer_tpu.harness import frontend as jax_frontend

from juicer_tpu_torch.harness import capture, frontend

ATOL = 1e-5
CONFIGS = {
    "default": {},
    "no_cmn": dict(cmn=False),
    "energy_no_deltas": dict(use_energy=True, deltas=False),
    "band_lifter0_window3": dict(low_freq=100.0, high_freq=6000.0, ceplifter=0,
                                 delta_window=3, n_mels=20, n_ceps=10),
    "rate8k": dict(sample_rate=8000),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return 3000 * np.sin(2 * np.pi * 440 * t / 16000) + 500 * rng.normal(size=n)


def cfgs(name):
    kw = CONFIGS[name]
    return jax_frontend.FrontendConfig(**kw), frontend.FrontendConfig(**kw)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_read_wav_equals_jax(tmp_path, width):
    rng = np.random.default_rng(width)
    dt = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    hi = {1: 255, 2: 32767, 4: 2 ** 31 - 1}[width]
    lo = 0 if width == 1 else -hi - 1
    x = rng.integers(lo, hi, size=3001, endpoint=True).astype(dt)
    p = str(tmp_path / "a.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(11025)
        w.writeframes(x.tobytes())
    got, want = frontend.read_wav(p), jax_frontend.read_wav(p)
    assert got[1] == want[1] == 11025
    assert got[0].dtype == np.float64 and np.array_equal(got[0], want[0])


def test_read_wav_rejects_width_3(tmp_path):
    p = str(tmp_path / "a.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(16000)
        w.writeframes(b"\0" * 30)
    with pytest.raises(ValueError, match="width 3"):
        frontend.read_wav(p)


@pytest.mark.parametrize("args", [(26, 512, 16000, 0.0, 0.0), (20, 512, 16000, 100.0, 6000.0),
                                  (40, 256, 8000, 0.0, 0.0), (26, 1024, 44100, 64.0, 0.0)])
def test_mel_filterbank_equals_jax(args):
    got = frontend.mel_filterbank(*args, device="cpu")
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), jax_frontend.mel_filterbank(*args))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("n", [16000, 8000, 399, 100])
def test_mfcc_equals_jax(name, n):
    jcfg, cfg = cfgs(name)
    x = signal(n, seed=n)
    got = frontend.mfcc(x, cfg, device="cpu")
    want = jax_frontend.mfcc(x, jcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape[1] == cfg.dim
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_mfcc_of_silence_is_finite():
    got = frontend.mfcc(np.zeros(8000), frontend.FrontendConfig(cmn=False), device="cpu")
    want = jax_frontend.mfcc(np.zeros(8000), jax_frontend.FrontendConfig(cmn=False))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mfcc_batch_equals_each_utterance_alone(name):
    """Three (and a shorter-than-a-frame fourth) utterances of different
    lengths: each row equals the JAX `mfcc` of its utterance alone, and
    the rows past its length are zero."""
    jcfg, cfg = cfgs(name)
    sigs = [signal(n, seed=k) for k, n in enumerate((16000, 5123, 9001, 250))]
    feats, lengths = frontend.mfcc_batch(sigs, cfg, device="cpu")
    assert lengths == [frontend.n_frames_of(len(s), cfg) for s in sigs]
    assert feats.shape == (len(sigs), max(lengths), cfg.dim) and feats.dtype == torch.float32
    for b, s in enumerate(sigs):
        want = jax_frontend.mfcc(s, jcfg)
        assert lengths[b] == want.shape[0]
        np.testing.assert_allclose(feats[b, :lengths[b]].numpy(), want, rtol=0, atol=ATOL)
        assert not feats[b, lengths[b]:].any()


def test_wav_files_to_features_in_one_pass(tmp_path):
    """`wavs_to_features` (files of two sample rates) and
    `wav_to_features` against the JAX `wav_to_features` of each file."""
    paths = []
    for k, (n, rate) in enumerate(((12000, 16000), (7000, 8000), (9000, 16000))):
        p = str(tmp_path / f"u{k}.wav")
        with wave.open(p, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(np.clip(signal(n, k), -32768, 32767).astype("<i2").tobytes())
        paths.append(p)
    got = frontend.wavs_to_features(paths, device="cpu")
    for p, f in zip(paths, got):
        want = jax_frontend.wav_to_features(p)
        np.testing.assert_allclose(f.numpy(), want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(frontend.wav_to_features(p, device="cpu").numpy(), want,
                                   rtol=0, atol=ATOL)


def _pieces(x, chunk):
    if chunk == "ragged":
        return np.split(x, [130, 131, 1000, 1700, 4096, 9000])
    if chunk == "whole":
        return [x]
    return [x[i:i + chunk] for i in range(0, len(x), chunk)]


@pytest.mark.parametrize("chunk", [1, 777, "whole", "ragged"])
@pytest.mark.parametrize("cmn", [False, True])
def test_streaming_front_end_equals_jax_chunk_for_chunk(chunk, cmn):
    x = signal(12000)
    jfe = jax_capture.StreamingFrontend(jax_frontend.FrontendConfig(cmn=cmn))
    fe = capture.StreamingFrontend(frontend.FrontendConfig(cmn=cmn), device="cpu")
    outs = []
    for piece in _pieces(x, chunk):
        got, want = fe.feed(piece), jfe.feed(piece)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        outs.append(got)
    got, want = fe.flush(), jfe.flush()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    outs.append(got)
    assert fe.dim == jfe.dim == 39
    if not cmn:  # the stream's frames are the batch front end's
        ref = frontend.mfcc(x, frontend.FrontendConfig(cmn=False), device="cpu")
        np.testing.assert_allclose(torch.cat(outs).numpy(), ref.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(deltas=False, cmn=False), dict(cmn=False)])
def test_streaming_front_end_short_streams(kw):
    """A stream shorter than one frame is zero-padded to one frame; one
    without deltas holds nothing back."""
    for n in (100, 4000):
        x = signal(n, seed=n)
        jfe = jax_capture.StreamingFrontend(jax_frontend.FrontendConfig(**kw))
        fe = capture.StreamingFrontend(frontend.FrontendConfig(**kw), device="cpu")
        got = torch.cat([fe.feed(x), fe.flush()])
        want = np.concatenate([jfe.feed(x), jfe.flush()])
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_pcm_source_stream_and_torn_sample():
    x = (1000 * np.sin(np.arange(500))).astype("<i2")
    src = capture.PcmSource(stream=io.BytesIO(x.tobytes()))
    got = np.concatenate([src.read(123) for _ in range(6)])
    np.testing.assert_array_equal(got, x.astype(np.float64))
    assert src.read(10).size == 0
    src.close()
    assert capture.PcmSource(stream=io.BytesIO(b"\x01\x00\x02")).read(10).tolist() == [1.0]
    assert jax_capture.PcmSource(stream=io.BytesIO(b"\x01\x00\x02")).read(10).tolist() == [1.0]


def test_pcm_source_argument_checks():
    for kw in ({}, dict(device="hw:0", stream=io.BytesIO())):
        with pytest.raises(ValueError, match="exactly one"):
            capture.PcmSource(**kw)


@pytest.mark.skipif(shutil.which("arecord") is not None,
                    reason="arecord exists here; the missing-binary path is not taken")
def test_pcm_source_device_without_arecord():
    with pytest.raises(RuntimeError, match="arecord"):
        capture.PcmSource(device="hw:0")


@pytest.mark.parametrize("rate", [16000, 8000])
def test_capture_features_equals_jax(rate):
    pcm = np.clip(signal(6000), -32768, 32767).astype("<i2")
    got = list(capture.capture_features(
        capture.PcmSource(stream=io.BytesIO(pcm.tobytes()), sample_rate=rate),
        chunk_samples=777, device="cpu"))
    want = list(jax_capture.capture_features(
        jax_capture.PcmSource(stream=io.BytesIO(pcm.tobytes()), sample_rate=rate),
        chunk_samples=777))
    assert [g.shape[0] for g in got] == [w.shape[0] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


def test_front_end_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frontend.mfcc(signal(1000))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture.StreamingFrontend()
