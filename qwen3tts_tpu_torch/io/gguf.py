"""GGUF v3 reader/writer of the port (counterpart of ``qwen3tts_tpu/io/gguf.py``,
pure Python and numpy; checkpoints are read through the native reader,
``io/native.py``, and this reader stays for the writer, the metadata, the
tests and the timing beside it).

The reference's weight format is GGUF (components #8/#10/#11, SURVEY.md §2):
its loader streams tensors with fseek/fread (src/gguf_loader.cpp:154-227) and
its converters emit F16/Q8_0 files with a selective-quantization policy
(scripts/convert_tts_to_gguf.py:244-270). This module implements the same
format from the spec, byte for byte as the JAX package's, so a file either
package writes loads in the other.

Only the value/tensor types the Qwen3-TTS files use are implemented:
F32, F16, Q8_0, Q4_K tensors; u32/i32/f32/u64/bool/string/array metadata.
Tensors come back as numpy arrays (F16 as float16, Q8_0 and Q4_K
dequantized to float32); ``shape(name)`` reads the tensor table only.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF"
GGUF_VERSION = 3
DEFAULT_ALIGNMENT = 32

# value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, T_U64, T_I64, T_F64 = range(13)

# tensor types (ggml)
GGML_F32, GGML_F16 = 0, 1
GGML_Q8_0 = 8
GGML_Q4_K = 12

Q8_BLOCK = 32
Q8_BLOCK_BYTES = 2 + Q8_BLOCK  # fp16 scale + 32 int8

QK_K = 256                      # Q4_K super-block
Q4K_BLOCK_BYTES = 2 + 2 + 12 + QK_K // 2  # d, dmin, packed 6-bit scales, 4-bit qs


# ---------------------------------------------------------------------------
# Q8_0 quantization (bit-parity with ggml's quantize_row_q8_0_ref)
# ---------------------------------------------------------------------------

def quantize_q8_0(x: np.ndarray) -> bytes:
    """Row-major f32 array -> Q8_0 blocks. Last dim must be a multiple of 32."""
    flat = np.ascontiguousarray(x, np.float32).reshape(-1, Q8_BLOCK)
    amax = np.abs(flat).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.round(flat * inv[:, None]).astype(np.int8)
    out = np.zeros((flat.shape[0], Q8_BLOCK_BYTES), np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def dequantize_q8_0(buf: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    blocks = np.frombuffer(buf, np.uint8).reshape(-1, Q8_BLOCK_BYTES)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    q = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(shape)


def q8_0_arrays(buf: bytes, shape: Tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Return (int8 values [.., N], f16 scales [.., N/32]) without dequant —
    feeds the on-device int8 matmul path (ops/quant.py)."""
    blocks = np.frombuffer(buf, np.uint8).reshape(-1, Q8_BLOCK_BYTES)
    d = blocks[:, :2].copy().view(np.float16).reshape(shape[:-1] + (shape[-1] // Q8_BLOCK,))
    q = blocks[:, 2:].copy().view(np.int8).reshape(shape)
    return q, d


# ---------------------------------------------------------------------------
# Q4_K quantization (ggml k-quant super-block format, QK_K = 256)
#
# On-disk layout (ggml-common.h block_q4_K): f16 d (scale-of-scales), f16
# dmin (scale-of-mins), 12 bytes of packed 6-bit per-32-sub-block
# (scale, min) pairs, 128 bytes of 4-bit quants (low nibbles = values
# [64j, 64j+32), high nibbles = values [64j+32, 64j+64) within each 64-value
# chunk). Dequant: y = d*sc6[i]*q - dmin*m6[i]. The reference converter
# offers this type (scripts/convert_tts_to_gguf.py); the quantizer here is
# format-faithful (requantizes against the packed 6-bit scales) but uses a
# direct min/max fit rather than ggml's iterative search — any valid
# quantizer produces files every GGUF consumer reads identically.
# ---------------------------------------------------------------------------

def _pack_scales_q4k(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """ls/lm: [N, 8] uint8 in [0, 63] -> [N, 12] packed (get_scale_min_k4
    inverse)."""
    n = ls.shape[0]
    out = np.zeros((n, 12), np.uint8)
    out[:, 0:4] = ls[:, 0:4] | ((ls[:, 4:8] >> 4) << 6)
    out[:, 4:8] = lm[:, 0:4] | ((lm[:, 4:8] >> 4) << 6)
    out[:, 8:12] = (ls[:, 4:8] & 0xF) | ((lm[:, 4:8] & 0xF) << 4)
    return out


def _unpack_scales_q4k(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[N, 12] -> (ls [N, 8], lm [N, 8]) per ggml get_scale_min_k4."""
    ls = np.zeros(packed.shape[:1] + (8,), np.uint8)
    lm = np.zeros_like(ls)
    ls[:, 0:4] = packed[:, 0:4] & 63
    lm[:, 0:4] = packed[:, 4:8] & 63
    ls[:, 4:8] = (packed[:, 8:12] & 0xF) | ((packed[:, 0:4] >> 6) << 4)
    lm[:, 4:8] = (packed[:, 8:12] >> 4) | ((packed[:, 4:8] >> 6) << 4)
    return ls, lm


def quantize_q4_k(x: np.ndarray) -> bytes:
    """Row-major f32 array -> Q4_K super-blocks. Last dim must be % 256."""
    flat = np.ascontiguousarray(x, np.float32).reshape(-1, 8, 32)
    n = flat.shape[0]
    # per-32 affine fit: q in [0,15], y = scale*q - min_pos
    sub_min = np.minimum(flat.min(axis=2), 0.0)          # [N, 8] <= 0
    sub_max = np.maximum(flat.max(axis=2), 0.0)
    mins_raw = -sub_min                                  # >= 0
    scales_raw = (sub_max - sub_min) / 15.0              # >= 0
    d = (scales_raw.max(axis=1) / 63.0).astype(np.float16).astype(np.float32)
    dmin = (mins_raw.max(axis=1) / 63.0).astype(np.float16).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = np.where(d[:, None] > 0, np.rint(scales_raw / d[:, None]), 0)
        lm = np.where(dmin[:, None] > 0, np.rint(mins_raw / dmin[:, None]), 0)
    ls = np.clip(ls, 0, 63).astype(np.uint8)
    lm = np.clip(lm, 0, 63).astype(np.uint8)
    eff_scale = d[:, None] * ls                          # [N, 8]
    eff_min = dmin[:, None] * lm
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.rint((flat + eff_min[:, :, None]) / eff_scale[:, :, None])
        q = np.where(eff_scale[:, :, None] > 0, q, 0)
    q = np.clip(q, 0, 15).astype(np.uint8).reshape(n, 4, 64)
    qs = (q[:, :, :32] | (q[:, :, 32:] << 4)).reshape(n, 128)

    out = np.zeros((n, Q4K_BLOCK_BYTES), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_scales_q4k(ls, lm)
    out[:, 16:] = qs
    return out.tobytes()


def dequantize_q4_k(buf: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    blocks = np.frombuffer(buf, np.uint8).reshape(-1, Q4K_BLOCK_BYTES)
    n = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)      # [N,1]
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    ls, lm = _unpack_scales_q4k(blocks[:, 4:16])
    qs = blocks[:, 16:].reshape(n, 4, 32)
    q = np.empty((n, 4, 64), np.float32)
    q[:, :, :32] = qs & 0xF
    q[:, :, 32:] = qs >> 4
    q = q.reshape(n, 8, 32)
    scale = (d * ls).astype(np.float32)[:, :, None]                    # [N,8,1]
    minv = (dmin * lm).astype(np.float32)[:, :, None]
    return (scale * q - minv).reshape(shape)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class GGUFReader:
    def __init__(self, path: str):
        import mmap as _mmap

        self.path = path
        f = open(path, "rb")
        # mmap: tensor reads stay lazy (a full F16 model is ~1.8 GB on disk)
        data = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        f.close()
        self._data = data
        off = 0

        def u32():
            nonlocal off
            (v,) = struct.unpack_from("<I", data, off)
            off += 4
            return v

        def u64():
            nonlocal off
            (v,) = struct.unpack_from("<Q", data, off)
            off += 8
            return v

        def s():
            n = u64()
            nonlocal off
            v = data[off:off + n].decode("utf-8")
            off += n
            return v

        def value(t):
            nonlocal off
            if t == T_U8:
                v = data[off]; off += 1
            elif t == T_I8:
                (v,) = struct.unpack_from("<b", data, off); off += 1
            elif t == T_U16:
                (v,) = struct.unpack_from("<H", data, off); off += 2
            elif t == T_I16:
                (v,) = struct.unpack_from("<h", data, off); off += 2
            elif t == T_U32:
                v = u32()
            elif t == T_I32:
                (v,) = struct.unpack_from("<i", data, off); off += 4
            elif t == T_F32:
                (v,) = struct.unpack_from("<f", data, off); off += 4
            elif t == T_BOOL:
                v = bool(data[off]); off += 1
            elif t == T_STR:
                v = s()
            elif t == T_U64:
                v = u64()
            elif t == T_I64:
                (v,) = struct.unpack_from("<q", data, off); off += 8
            elif t == T_F64:
                (v,) = struct.unpack_from("<d", data, off); off += 8
            elif t == T_ARR:
                et = u32()
                n = u64()
                v = [value(et) for _ in range(n)]
            else:
                raise ValueError(f"unsupported gguf value type {t}")
            return v

        magic = u32()
        if magic != GGUF_MAGIC:
            raise ValueError(f"bad GGUF magic in {path}")
        version = u32()
        if version < 2:
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = u64()
        n_kv = u64()

        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = s()
            t = u32()
            self.metadata[key] = value(t)

        self.tensors: Dict[str, Tuple[Tuple[int, ...], int, int]] = {}
        order: List[str] = []
        for _ in range(n_tensors):
            name = s()
            n_dims = u32()
            ne = [u64() for _ in range(n_dims)]
            ttype = u32()
            toff = u64()
            # GGUF stores ne (column-major); numpy shape is the reverse.
            shape = tuple(reversed(ne))
            self.tensors[name] = (shape, ttype, toff)
            order.append(name)
        self.tensor_order = order

        align = int(self.metadata.get("general.alignment", DEFAULT_ALIGNMENT))
        self._data_start = (off + align - 1) // align * align

    def keys(self):
        return self.tensors.keys()

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.tensors[name][0]

    def _raw(self, name: str) -> Tuple[bytes, Tuple[int, ...], int]:
        shape, ttype, toff = self.tensors[name]
        n = int(np.prod(shape)) if shape else 1
        if ttype == GGML_F32:
            nbytes = n * 4
        elif ttype == GGML_F16:
            nbytes = n * 2
        elif ttype == GGML_Q8_0:
            nbytes = n // Q8_BLOCK * Q8_BLOCK_BYTES
        elif ttype == GGML_Q4_K:
            nbytes = n // QK_K * Q4K_BLOCK_BYTES
        else:
            raise ValueError(f"unsupported tensor type {ttype} for {name}")
        start = self._data_start + toff
        return self._data[start:start + nbytes], shape, ttype

    def tensor(self, name: str) -> np.ndarray:
        buf, shape, ttype = self._raw(name)
        if ttype == GGML_F32:
            return np.frombuffer(buf, "<f4").reshape(shape)
        if ttype == GGML_F16:
            return np.frombuffer(buf, "<f2").reshape(shape)
        if ttype == GGML_Q4_K:
            return dequantize_q4_k(buf, shape)
        return dequantize_q8_0(buf, shape)

    def tensor_q8(self, name: str):
        buf, shape, ttype = self._raw(name)
        if ttype != GGML_Q8_0:
            return None
        return q8_0_arrays(buf, shape)

    def tensor_type(self, name: str) -> int:
        return self.tensors[name][1]


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class GGUFWriter:
    def __init__(self, arch: str = "qwen3-tts"):
        self.metadata: List[Tuple[str, int, Any]] = [("general.architecture", T_STR, arch)]
        self.tensors: List[Tuple[str, Tuple[int, ...], int, bytes]] = []

    def add_meta(self, key: str, vtype: int, value: Any):
        self.metadata.append((key, vtype, value))

    def add_tensor(self, name: str, array: np.ndarray, *, ttype: int = GGML_F16):
        array = np.asarray(array)
        if ttype == GGML_F32:
            data = array.astype("<f4").tobytes()
        elif ttype == GGML_F16:
            data = array.astype("<f2").tobytes()
        elif ttype == GGML_Q8_0:
            if array.shape[-1] % Q8_BLOCK:
                raise ValueError(f"{name}: Q8_0 needs last dim % 32 == 0")
            data = quantize_q8_0(array.astype(np.float32))
        elif ttype == GGML_Q4_K:
            if array.shape[-1] % QK_K:
                raise ValueError(f"{name}: Q4_K needs last dim % 256 == 0")
            data = quantize_q4_k(array.astype(np.float32))
        else:
            raise ValueError(f"unsupported tensor type {ttype}")
        self.tensors.append((name, tuple(array.shape), ttype, data))

    def write(self, path: str):
        out = bytearray()

        def u32(v): out.extend(struct.pack("<I", v))
        def u64(v): out.extend(struct.pack("<Q", v))
        def s(v):
            b = v.encode("utf-8")
            u64(len(b))
            out.extend(b)

        def value(t, v):
            if t == T_U32: u32(int(v))
            elif t == T_I32: out.extend(struct.pack("<i", int(v)))
            elif t == T_F32: out.extend(struct.pack("<f", float(v)))
            elif t == T_U64: u64(int(v))
            elif t == T_BOOL: out.append(1 if v else 0)
            elif t == T_STR: s(v)
            elif isinstance(t, tuple) and t[0] == T_ARR:
                et = t[1]
                u32(et)
                u64(len(v))
                for el in v:
                    value(et, el)
            else:
                raise ValueError(f"unsupported meta type {t}")

        u32(GGUF_MAGIC)
        u32(GGUF_VERSION)
        u64(len(self.tensors))
        u64(len(self.metadata))
        for key, t, v in self.metadata:
            s(key)
            if isinstance(t, tuple):
                u32(T_ARR)
            else:
                u32(t)
            value(t, v)

        align = DEFAULT_ALIGNMENT
        offsets = []
        pos = 0
        for name, shape, ttype, data in self.tensors:
            pos = (pos + align - 1) // align * align
            offsets.append(pos)
            pos += len(data)
        for (name, shape, ttype, data), toff in zip(self.tensors, offsets):
            s(name)
            u32(len(shape))
            for d in reversed(shape):  # numpy shape -> ne order
                u64(d)
            u32(ttype)
            u64(toff)

        data_start = (len(out) + align - 1) // align * align
        out.extend(b"\0" * (data_start - len(out)))
        for (name, shape, ttype, data), toff in zip(self.tensors, offsets):
            target = data_start + toff
            out.extend(b"\0" * (target - len(out)))
            out.extend(data)

        with open(path, "wb") as f:
            f.write(bytes(out))
