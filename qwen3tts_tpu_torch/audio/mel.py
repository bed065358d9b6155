"""Log-mel front end for the speaker encoder (voice cloning); counterpart of
``qwen3tts_tpu/audio/mel.py``.

Semantics match the reference host-side DSP exactly
(src/audio_tokenizer_encoder.cpp:14-125, 288-371):

- reflect padding of (n_fft - hop) / 2 samples on both sides, by index
- periodic Hann window of win_length centered in the n_fft frame
- magnitude spectrum sqrt(re^2 + im^2 + 1e-9)
- slaney-normalized mel filterbank (librosa convention, linear < 1 kHz)
- dynamic-range compression log(clamp(x, 1e-5))

computed with ``torch.fft.rfft`` over the frames. The filterbank and the
window are numpy constants, as in the JAX package. The port runs on exactly
the request's samples: the JAX package's sample buckets are compile-cache
keys and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def slaney_mel_filterbank(cfg) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] float32, computed once on host (constant)."""
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(hz):
        hz = np.asarray(hz, np.float64)
        return np.where(hz < min_log_hz, hz / f_sp,
                        min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep)

    def mel_to_hz(mel):
        mel = np.asarray(mel, np.float64)
        return np.where(mel < min_log_mel, f_sp * mel,
                        min_log_hz * np.exp(logstep * (mel - min_log_mel)))

    n_bins = cfg.n_fft // 2 + 1
    mel_min = hz_to_mel(cfg.f_min)
    mel_max = hz_to_mel(cfg.f_max)
    mel_points = mel_min + (mel_max - mel_min) * np.arange(cfg.n_mels + 2) / (cfg.n_mels + 1)
    hz = mel_to_hz(mel_points)
    freqs = np.arange(n_bins) * cfg.sample_rate / cfg.n_fft

    fb = np.zeros((cfg.n_mels, n_bins), np.float64)
    for m in range(cfg.n_mels):
        left, center, right = hz[m], hz[m + 1], hz[m + 2]
        enorm = 2.0 / (right - left)
        up = (freqs - left) / max(center - left, 1e-10)
        down = (right - freqs) / max(right - center, 1e-10)
        tri = np.where((freqs >= left) & (freqs <= center), up,
                       np.where((freqs > center) & (freqs <= right), down, 0.0))
        fb[m] = enorm * np.clip(tri, 0.0, None)
    return fb.astype(np.float32)


def centered_hann(cfg) -> np.ndarray:
    """Periodic Hann of win_length zero-centered inside an n_fft window."""
    w = np.zeros(cfg.n_fft, np.float32)
    offset = (cfg.n_fft - cfg.win_length) // 2
    n = cfg.win_length
    w[offset:offset + n] = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
    return w


def n_mel_frames(n_samples: int, cfg) -> int:
    pad = (cfg.n_fft - cfg.hop_length) // 2
    return (n_samples + 2 * pad - cfg.n_fft) // cfg.hop_length + 1


def log_mel(samples: torch.Tensor, cfg, filterbank: torch.Tensor,
            window: torch.Tensor) -> torch.Tensor:
    """samples [n] float32 -> log-mel [n_mel_frames(n), n_mels] float32, on
    samples' device. The reflection indices are the JAX package's
    (``audio/mel.py:96-101``), which also cover a pad longer than n."""
    n = samples.shape[0]
    pad = (cfg.n_fft - cfg.hop_length) // 2
    if n_mel_frames(n, cfg) < 1:
        raise ValueError(f"{n} samples give no mel frame (n_fft {cfg.n_fft})")
    idx = torch.arange(-pad, n + pad, device=samples.device)
    src = torch.where(idx < 0, -idx, idx)
    src = torch.where(src >= n, 2 * n - 2 - src, src).clamp(0, n - 1)
    frames = samples[src].float().unfold(0, cfg.n_fft, cfg.hop_length) * window
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(torch.square(spec.real) + torch.square(spec.imag) + 1e-9)
    return torch.log(torch.clamp(mag @ filterbank.T, min=1e-5))
