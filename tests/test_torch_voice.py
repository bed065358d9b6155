"""Voice cloning of the port against the JAX package and the float64
reference: the log-mel front end, the ECAPA-TDNN speaker encoder (tiny
config and full width), the pipeline's embedding of a clip beyond the
largest speaker bucket, and WAV read/write and resampling. The greedy codes
of ``synthesize_with_voice`` are held against the JAX fused path in
tests/test_torch_io.py, beside the default voice's."""

from __future__ import annotations

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_impl as ref
from qwen3tts_tpu import pipeline as jpipeline
from qwen3tts_tpu.audio import mel as jmel
from qwen3tts_tpu.audio import wav as jwav
from qwen3tts_tpu.config import RuntimeConfig
from qwen3tts_tpu.config import SpeakerEncoderConfig as JSpeakerConfig
from qwen3tts_tpu.config import tiny_pipeline_config as jax_tiny
from qwen3tts_tpu.models import speaker_encoder as jse
from qwen3tts_tpu.runtime.buckets import pick_bucket
from qwen3tts_tpu_torch.audio import mel, wav
from qwen3tts_tpu_torch.config import SamplingConfig
from qwen3tts_tpu_torch.config import tiny_pipeline_config as port_tiny
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.models import speaker_encoder as se
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.tools import hf_fixture

JCFG, PCFG = jax_tiny(), port_tiny()
FULL = JSpeakerConfig()
SR = 24000


def _audio(n, seed=0):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=n)).astype(np.float32)


def _jax_mel(x, cfg, bucket):
    """JAX log_mel on x zero-padded to its bucket, cut to its valid frames."""
    buf = np.zeros((bucket,), np.float32)
    buf[:len(x)] = x
    m, n = jax.jit(jmel.log_mel, static_argnums=2)(jnp.asarray(buf), jnp.int32(len(x)), cfg,
                        jnp.asarray(jmel.slaney_mel_filterbank(cfg)),
                        jnp.asarray(jmel.centered_hann(cfg)))
    return np.asarray(m)[:int(n)]


def _port_mel(x, cfg):
    return mel.log_mel(torch.from_numpy(x), cfg, torch.from_numpy(mel.slaney_mel_filterbank(cfg)),
                       torch.from_numpy(mel.centered_hann(cfg))).numpy()


@pytest.mark.parametrize("which,n", [("tiny", 600), ("tiny", 385), ("full", 2 * SR)])
def test_log_mel_matches_jax_and_reference(which, n):
    """On exactly n samples against JAX's bucketed log_mel (600 and 385
    samples lie below their buckets, 1024 and 512) and mel_ref: 1e-5."""
    cfg = JCFG.speaker_encoder if which == "tiny" else FULL
    x = _audio(n)
    got = _port_mel(x, cfg)
    buckets = (JCFG.runtime if which == "tiny" else RuntimeConfig()).speaker_buckets
    want = _jax_mel(x, cfg, pick_bucket(n, buckets))
    assert got.shape == want.shape == (mel.n_mel_frames(n, cfg), cfg.n_mels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref.mel_ref(x, cfg), rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_speaker_encoder_matches_jax_and_reference(which):
    """speaker_encoder_forward on the same mel and weights as the JAX
    package's masked, bucketed forward and speaker_encoder_ref (float64):
    1e-4 relative to the embedding's largest entry; full width on 2 s."""
    cfg, n = (JCFG.speaker_encoder, 600) if which == "tiny" else (FULL, 2 * SR)
    jp = jse.init_speaker_encoder_params(jax.random.PRNGKey(5), cfg)
    m = _port_mel(_audio(n, 1), cfg)
    Tb = m.shape[0] + 5
    padded = np.zeros((Tb, cfg.n_mels), np.float32)
    padded[:m.shape[0]] = m
    forward = jax.jit(jse.speaker_encoder_forward, static_argnums=1)
    want = np.asarray(forward(jp, cfg, jnp.asarray(padded), jnp.int32(m.shape[0])))
    got = se.speaker_encoder_forward(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)),
                                     cfg, torch.from_numpy(m)).numpy()
    r = ref.speaker_encoder_ref(jax.tree_util.tree_map(np.asarray, jp), cfg, m)
    assert got.shape == (cfg.embedding_dim,)
    scale = np.abs(r).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got - r).max() <= 1e-4 * scale


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """The port's and the JAX package's Qwen3TTS at the tiny config, both
    after load_models of the port's fixture directory."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    hf_fixture.write_checkpoint_dir(root, PCFG)
    port, jax_tts = Qwen3TTS(PCFG, device="cpu"), jpipeline.Qwen3TTS(JCFG)
    assert port.load_models(root) and jax_tts.load_models(root)
    return port, jax_tts


@pytest.mark.parametrize("n", [700, 1500])
def test_extract_speaker_embedding_matches_jax(loaded, capsys, n):
    """The pipeline's embedding equals the JAX pipeline's (1e-4 relative):
    inside the largest bucket (1024 samples) and beyond it, where both
    truncate with the same warning."""
    port, jax_tts = loaded
    x = _audio(n, 2)
    got = port.extract_speaker_embedding(x)
    err = capsys.readouterr().err
    want = jax_tts.extract_speaker_embedding(x)
    assert ("exceeds the largest speaker bucket" in err) == (n > 1024)
    if n > 1024:
        assert err == capsys.readouterr().err
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert port.speaker_params is not None


def _write_wav(path, samples, sr, fmt, channels):
    """A RIFF WAV of interleaved samples: fmt 1 (PCM16) or 3 (float32)."""
    data = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes() if fmt == 1 \
        else samples.astype("<f4").tobytes()
    bits = 16 if fmt == 1 else 32
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, sr,
                                      sr * channels * bits // 8, channels * bits // 8, bits))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("kind", ["pcm16_jax_save_wav", "float32", "stereo_pcm16"])
def test_load_wav_matches_jax(tmp_path, kind):
    x = _audio(1000, 3)
    path = str(tmp_path / "a.wav")
    if kind == "pcm16_jax_save_wav":
        jwav.save_wav(path, x, 16000)
    elif kind == "float32":
        _write_wav(path, x, 22050, 3, 1)
    else:
        _write_wav(path, np.stack([x, -0.5 * x], axis=1).reshape(-1), 44100, 1, 2)
    got, sr = wav.load_wav(path)
    want, want_sr = jwav.load_wav(path)
    assert sr == want_sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_save_wav_is_read_by_jax_and_matches_its_bytes(tmp_path):
    x = _audio(999, 4) * 4.0   # clamps
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    wav.save_wav(a, x, SR)
    jwav.save_wav(b, x, SR)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got, sr = jwav.load_wav(a)
    assert sr == SR and len(got) == 999


@pytest.mark.parametrize("rates", [(44100, 24000), (16000, 24000), (24000, 24000)])
def test_resample_linear_matches_jax(rates):
    x = _audio(4410, 5)
    np.testing.assert_array_equal(wav.resample_linear(x, *rates), jwav.resample_linear(x, *rates))


def test_synthesize_with_voice_resamples_the_reference(loaded, tmp_path):
    """A reference at 16 kHz, as a WAV path or as samples with their rate,
    is resampled to 24 kHz before its embedding, as in the JAX pipeline:
    the same codes as the resampled samples given at 24 kHz."""
    port, _ = loaded
    path = str(tmp_path / "ref.wav")
    wav.save_wav(path, _audio(600, 6), 16000)
    x16, _ = wav.load_wav(path)
    sp = SamplingConfig(temperature=0.0, max_audio_tokens=3)
    rs = [port.synthesize_with_voice("Hello.", path, sp),
          port.synthesize_with_voice("Hello.", x16, sp, reference_sample_rate=16000),
          port.synthesize_with_voice("Hello.", wav.resample_linear(x16, 16000, SR), sp)]
    assert all(r.success and r.timings.t_encode_ms > 0 for r in rs)
    for r in rs[1:]:
        np.testing.assert_array_equal(r.codes, rs[0].codes)
