"""WAV read/write and linear resampling (reference src/qwen3_tts.cpp:84-102,
449-641); counterpart of ``qwen3tts_tpu/audio/wav.py``, pure numpy (the JAX
package's optional native path is not ported).
"""

from __future__ import annotations

import struct

import numpy as np


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a RIFF WAV (PCM16, PCM32, or float32); returns (mono float32
    samples in [-1, 1], sample_rate). Multi-channel input is averaged."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")

    pos = 12
    fmt = None
    samples = None
    sample_rate = 0
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8: pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            audio_format, n_channels, sr, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
            fmt = (audio_format, n_channels, bits)
            sample_rate = sr
        elif chunk_id == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            audio_format, n_channels, bits = fmt
            if audio_format == 1 and bits == 16:
                raw = np.frombuffer(body, dtype="<i2").astype(np.float32) / 32768.0
            elif audio_format == 1 and bits == 32:
                raw = np.frombuffer(body, dtype="<i4").astype(np.float32) / 2147483648.0
            elif audio_format == 3 and bits == 32:
                raw = np.frombuffer(body, dtype="<f4").astype(np.float32)
            else:
                raise ValueError(f"unsupported WAV format {audio_format}/{bits}-bit")
            if n_channels > 1:
                raw = raw[: len(raw) - len(raw) % n_channels]
                raw = raw.reshape(-1, n_channels).mean(axis=1)
            samples = raw.astype(np.float32)
            break
        pos += 8 + chunk_size + (chunk_size & 1)
    if samples is None:
        raise ValueError(f"no data chunk found in {path}")
    return samples, sample_rate


def save_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono 16-bit PCM, clamping to [-1, 1] (qwen3_tts.cpp:591-641)."""
    samples = np.asarray(samples, np.float32)
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    data_size = pcm.nbytes
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(pcm.tobytes())


def resample_linear(samples: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Linear-interpolation resampler (qwen3_tts.cpp:84-102 semantics)."""
    if in_rate == out_rate:
        return np.asarray(samples, np.float32)
    samples = np.asarray(samples, np.float32)
    ratio = in_rate / out_rate
    out_len = int(len(samples) / ratio)
    src = np.arange(out_len, dtype=np.float64) * ratio
    idx0 = src.astype(np.int64)
    frac = (src - idx0).astype(np.float32)
    idx1 = np.minimum(idx0 + 1, len(samples) - 1)
    out = (1.0 - frac) * samples[idx0] + frac * samples[idx1]
    # match the reference's tail behavior: clamp reads past the end
    tail = idx0 + 1 >= len(samples)
    out[tail] = samples[-1]
    return out.astype(np.float32)
