"""ctypes bindings of the port's native host library (counterpart of
``qwen3tts_tpu/io/native.py``): the GGUF reader under ``io/gguf_checkpoint``,
and the PCM16 WAV writer and linear resampler beside it.

The source is ``native/qwen3tts_native.cpp``, the JAX package's C++ copied
with the same entry points and arithmetic. It is compiled by ``g++`` at
first use into ``_build/`` beside the package (listed in ``.gitignore``),
under a name that hashes the source and the flags, as ``_kernels.py``
builds the CUDA sources; nothing is built when this module is imported.
There is no quiet fallback: a failed build raises ``OSError`` with the
compiler's message, a file the parser refuses raises ``ValueError`` with
the parser's (``gguf_last_error``), a failed read ``IOError``. The
pure-Python ``io.gguf.GGUFReader`` stays for the writer, the tests and the
timing beside this reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_HERE, "native", "qwen3tts_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-ffp-contract=off", "-shared"]
GGML_Q8_0 = 8

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_FP, _I8P, _I64P = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int8),
                    ctypes.POINTER(ctypes.c_int64))
# name -> (restype, argtypes)
SIGNATURES = {
    "gguf_last_error": (ctypes.c_char_p, []),
    "gguf_open": (_P, [ctypes.c_char_p]),
    "gguf_close": (None, [_P]),
    "gguf_n_tensors": (_I64, [_P]),
    "gguf_tensor_name": (ctypes.c_char_p, [_P, _I64]),
    "gguf_tensor_info": (_I32, [_P, _I64, _I64P, ctypes.POINTER(_I32), _I64P]),
    "gguf_read_tensor_f32": (_I32, [_P, _I64, _FP]),
    "gguf_read_tensor_q8": (_I32, [_P, _I64, _I8P, _FP]),
    "wav_write_pcm16": (_I32, [ctypes.c_char_p, _FP, _I64, _I32]),
    "resample_linear": (None, [_FP, _I64, _I32, _FP, _I64, _I32]),
}


def build() -> str:
    """Compile the source into _build/libqwen3tts_native_<hash>.so (if not
    there yet); return its path. Raises OSError with g++'s message."""
    global build_seconds
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libqwen3tts_native_{h}.so")
    if os.path.exists(out):
        build_seconds = 0.0
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *CXXFLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise OSError(f"building the native library: {e}") from e
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise OSError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _error(lib) -> str:
    return lib.gguf_last_error().decode(errors="replace")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeGGUF:
    """GGUF reader over the C++ parser: ``tensor(name)`` gives float32 numpy
    arrays (F16 widened, Q8_0 and Q4_K dequantized, each value as
    ``io.gguf.GGUFReader`` computes it); ``tensors[name]`` is (index,
    shape, ggml type, element count)."""

    def __init__(self, path: str):
        lib = get_lib()
        self._lib = lib
        self.path = path
        self._h = lib.gguf_open(path.encode())
        if not self._h:
            raise ValueError(f"failed to parse GGUF {path}: {_error(lib)}")
        self.tensors = {}
        shape = (ctypes.c_int64 * 8)()
        ttype, n = ctypes.c_int32(), ctypes.c_int64()
        for i in range(lib.gguf_n_tensors(self._h)):
            name = lib.gguf_tensor_name(self._h, i).decode()
            nd = lib.gguf_tensor_info(self._h, i, shape, ctypes.byref(ttype), ctypes.byref(n))
            self.tensors[name] = (i, tuple(shape[:nd]), int(ttype.value), int(n.value))

    def keys(self):
        return self.tensors.keys()

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.tensors[name][1]

    def tensor_type(self, name: str) -> int:
        return self.tensors[name][2]

    def tensor(self, name: str) -> np.ndarray:
        i, shape, _, n = self.tensors[name]
        out = np.empty(n, np.float32)
        if self._lib.gguf_read_tensor_f32(self._h, i, _ptr(out, ctypes.c_float)) != 0:
            raise IOError(f"gguf_read_tensor_f32({name}): {_error(self._lib)}")
        return out.reshape(shape)

    def tensor_q8(self, name: str):
        """(int8 values, float32 scales [.., N/32]) of a Q8_0 tensor, None
        for any other type."""
        i, shape, ttype, n = self.tensors[name]
        if ttype != GGML_Q8_0:
            return None
        q, d = np.empty(n, np.int8), np.empty(n // 32, np.float32)
        if self._lib.gguf_read_tensor_q8(self._h, i, _ptr(q, ctypes.c_int8),
                                         _ptr(d, ctypes.c_float)) != 0:
            raise IOError(f"gguf_read_tensor_q8({name}): {_error(self._lib)}")
        return q.reshape(shape), d.reshape(shape[:-1] + (shape[-1] // 32,))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.gguf_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def wav_write_pcm16(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Mono 16-bit PCM WAV of samples clamped to [-1, 1] (the bytes of
    ``audio.wav.save_wav``'s header; samples truncated toward zero, as the
    JAX package's native writer does). Raises OSError if the file cannot
    be written."""
    samples = np.ascontiguousarray(samples, np.float32)
    if get_lib().wav_write_pcm16(path.encode(), _ptr(samples, ctypes.c_float),
                                 len(samples), sample_rate) != 0:
        raise OSError(f"cannot write {path}")


def resample_linear(samples: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Linear-interpolation resampler in float64 positions
    (qwen3_tts.cpp:84-102 semantics): int(n / (in_rate / out_rate))
    samples."""
    samples = np.ascontiguousarray(samples, np.float32)
    out = np.empty(int(len(samples) / (in_rate / out_rate)), np.float32)
    get_lib().resample_linear(_ptr(samples, ctypes.c_float), len(samples), in_rate,
                              _ptr(out, ctypes.c_float), len(out), out_rate)
    return out
