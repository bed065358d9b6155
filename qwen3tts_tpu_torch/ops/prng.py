"""The JAX package's random streams: threefry2x32 keys, ``split``, 32-bit
``bits`` and ``categorical``, as ``jax.random`` computes them with
``jax_threefry_partitionable`` on (the default since JAX 0.5; JAX with x64
off, as the JAX package runs).

A key is a pair of uint32 (k0, k1). ``prng_key(seed)`` is (0, seed mod
2**32), as ``jax.random.PRNGKey`` with x64 off (``jax/_src/prng.py:802``;
the JAX scheduler's ``_host_prngkey``). With partitionable counters, the
i-th of n keys of ``split`` and the i-th word of a ``bits`` draw both hash
the counter pair (0, i): ``split`` keeps the two output words as a key,
``bits`` xors them (``prng.py:1156, 1184``).

Three forms of one function, ``threefry2x32``:
- host, one key: Python ints (the single-stream loop's five hashes a frame,
  cheaper than numpy on two words);
- host, over lanes: numpy uint32 arrays of keys [..., 2] (the batched and
  continuous loops' chains; uint32 arithmetic wraps by itself);
- device: torch int64 tensors holding uint32 values masked to 32 bits (torch
  has no uint32 arithmetic), on the CPU or the card: ``gumbel`` hashes a
  field of R keys x V counters there. No product is formed, so no value
  leaves int64's range (a 32-bit word shifted left by at most 29 bits).

``gumbel`` is ``jax.random.gumbel`` in its default "low" mode
(``jax/_src/random.py:434 _uniform``, ``:1722 _gumbel``): the bits'
top 23 as a float32 mantissa in [1, 2), minus 1, scaled into [tiny, 1),
then -log(-log(u)), all in float32. ``categorical`` is argmax(gumbel +
logits), the first index on ties (``random.py:1739``); each row draws with
its own key over counters 0..V-1, as the JAX package's vmapped
``sample_token`` does. Bits and uniforms are exact; the logs may differ
from XLA's in the last place.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the counter words (x0, x1) under the key
    (k0, k1), 20 rounds (the lowering at ``jax/_src/prng.py:883``). Operands
    are Python ints, numpy uint32 arrays or torch int64 tensors of uint32
    values, broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` with x64 off: (0, seed mod 2**32)."""
    return (0, int(seed) & MASK)


def key_array(keys) -> np.ndarray:
    """Keys as a numpy uint32 array [..., 2] (a pair, a list of pairs, a JAX
    key array or a numpy array)."""
    return np.asarray(keys, dtype=np.uint32)


def key_pair(key) -> tuple:
    """One key as a pair of Python ints (from a pair, a JAX key or numpy)."""
    k0, k1 = (int(v) for v in np.asarray(key, dtype=np.uint32).reshape(2))
    return (k0, k1)


def _is_pair(key) -> bool:
    return isinstance(key, tuple) and len(key) == 2 and isinstance(key[0], int)


def split(key, n: int = 2):
    """``jax.random.split(key, n)``: key i hashes the counters (0, i). A
    pair of Python ints gives a tuple of n pairs; keys [..., 2] (numpy)
    give [..., n, 2], each lane split on its own."""
    if _is_pair(key):
        return tuple(threefry2x32(key[0], key[1], 0, i) for i in range(n))
    k = key_array(key)[..., None, :]
    b0, b1 = threefry2x32(k[..., 0], k[..., 1], np.uint32(0), np.arange(n, dtype=np.uint32))
    return np.stack([b0, b1], axis=-1)


def bits32(key):
    """``jax.random.bits(key, (), "uint32")``: the two words of the counter
    (0, 0) xored. A pair gives an int; keys [..., 2] give uint32 [...]."""
    if _is_pair(key):
        b0, b1 = threefry2x32(key[0], key[1], 0, 0)
        return b0 ^ b1
    k = key_array(key)
    flat = k.reshape(-1, 2)
    b0, b1 = threefry2x32(flat[:, 0], flat[:, 1], np.uint32(0), np.uint32(0))
    return (b0 ^ b1).reshape(k.shape[:-1])


def seed32(key):
    """``bits32`` bitcast to int32, the seed the kernels take (the JAX
    loops' ``bitcast_convert_type(bits(k), int32)``): an int for a pair,
    int32 [...] for keys [..., 2]."""
    b = bits32(key)
    if isinstance(b, int):
        return b - (1 << 32) if b >= 1 << 31 else b
    return np.asarray(b, dtype=np.uint32).view(np.int32)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`; to a card from pinned memory,
    without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device is not None and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _device_keys(keys, device) -> torch.Tensor:
    """Keys [R, 2] as an int64 tensor on `device`."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64).reshape(-1, 2)
    return to_device(key_array(keys).reshape(-1, 2).astype(np.int64), device)


def uniform_bits(keys, V: int, device=None) -> torch.Tensor:
    """The float32 bit patterns of ``jax.random.uniform``'s draw of [V] in
    [1, 2) for each of R keys: (bits >> 9) | 0x3F800000 of the 32-bit
    draws at counters 0..V-1. Returns int32 [R, V]."""
    k = _device_keys(keys, device)
    col = torch.arange(V, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[:, :1], k[:, 1:], 0, col)
    return (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)


def gumbel(keys, V: int, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, (V,), float32)`` for each of R keys [R, 2]
    (numpy, pairs, or an int64 tensor): float32 [R, V] on `device` (a
    tensor's own device when keys is one)."""
    u = uniform_bits(keys, V, device).view(torch.float32) - 1.0
    u = torch.clamp_min(u * (1.0 - TINY) + TINY, TINY)
    return -torch.log(-torch.log(u))


def categorical(keys, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` of each row of logits [R, V] with its own
    key [R, 2]: argmax(gumbel + logits), the first index on ties. Returns
    int64 [R]."""
    return torch.argmax(gumbel(keys, logits.shape[-1], logits.device) + logits, dim=-1)
