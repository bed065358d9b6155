"""Decode attention: the kernel's plain version (``ops/decode_attention.py``)
against the JAX Pallas kernels ``decode_attention_pallas`` and
``decode_attention_pallas_layered`` in interpret mode, the port's XLA
semantics (``ops/attention.decode_attention``) against JAX's, and the
dispatch between them against the JAX package's."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.ops import attention as jattn
from qwen3tts_tpu.ops import pallas_attention as jpa
from qwen3tts_tpu_torch.ops import attention as pattn
from qwen3tts_tpu_torch.ops.decode_attention import (decode_attention_kernel,
                                                      decode_attention_kernel_plain)

L, Hq, Hkv, C, D = 2, 16, 8, 1024, 128


def _bf16_ulp(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def assert_within_ulp(got, want):
    """One bf16 ulp of each element, plus 1e-6 for outputs near 0, where the
    float32 sums' rounding (~1e-7 at these magnitudes) exceeds an ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.abs(got - want) > _bf16_ulp(want) + 1e-6
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


def _inputs(B, seed):
    """bf16 q [B, Hq, D] and the stacked cache [B, L, 2, Hkv, C, D], as numpy
    float32 holding bf16 values."""
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(B, Hq, D)), jnp.bfloat16)
    kv = jnp.asarray(rng.normal(size=(B, L, 2, Hkv, C, D)) * 0.7, jnp.bfloat16)
    return q, kv


def _t(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("n_valid", [1, 255, 256, 300, 1024])
def test_kernel_plain_matches_pallas_interpret(n_valid):
    """One stream: the sliced and the layered Pallas kernels agree bit for
    bit, and the plain version is within one bf16 ulp of them at layer 1.
    Three lanes: within one ulp of the layered kernel under vmap."""
    q, kv = _inputs(3, seed=n_valid)
    n = jnp.int32(n_valid)
    want = jpa.decode_attention_pallas_layered(q[0], kv[0], jnp.int32(1), n, interpret=True)
    sliced = jpa.decode_attention_pallas(q[0], kv[0, 1, 0], kv[0, 1, 1], n, interpret=True)
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  np.asarray(sliced.astype(jnp.float32)))
    got = decode_attention_kernel(_t(q[0]), _t(kv[0]), 1, n_valid)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (Hq, D)
    assert_within_ulp(got.float().numpy(), want.astype(jnp.float32))

    want_b = jax.vmap(lambda qi, kvi: jpa.decode_attention_pallas_layered(
        qi, kvi, jnp.int32(1), n, interpret=True))(q, kv)
    got_b = decode_attention_kernel(_t(q), _t(kv), 1, n_valid)
    assert tuple(got_b.shape) == (3, Hq, D)
    assert_within_ulp(got_b.float().numpy(), want_b.astype(jnp.float32))
    assert decode_attention_kernel.launches == 0   # CPU tensors run the plain version


def test_kernel_plain_ignores_rows_past_n_valid():
    q, kv = _inputs(1, seed=5)
    a = decode_attention_kernel_plain(_t(q[0]), _t(kv[0]), 0, 100)
    kv2 = _t(kv[0]).clone()
    kv2[:, :, :, 100:] = 1e4
    assert torch.equal(a, decode_attention_kernel_plain(_t(q[0]), kv2, 0, 100))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_valid", [1, 37, 256])
def test_xla_semantics_match_jax(dtype, n_valid):
    """decode_attention (probabilities cast to the cache dtype before p.V)
    against JAX's, one stream and three lanes (JAX under vmap). float32:
    1e-5. bf16: one bf16 ulp, plus what the rounding of the probabilities
    to bf16 can move: the two frameworks' float32 exp and sum differ in
    their last bits, so now and then a probability rounds to the
    neighbouring bf16 value, which moves the output by at most 2^-8 * p|v|
    summed over the rows."""
    rng = np.random.default_rng(n_valid)
    q = jnp.asarray(rng.normal(size=(3, Hq, D)), getattr(jnp, dtype))
    k = jnp.asarray(rng.normal(size=(3, Hkv, 256, D)) * 0.7, getattr(jnp, dtype))
    v = jnp.asarray(rng.normal(size=(3, Hkv, 256, D)), getattr(jnp, dtype))
    want = jax.vmap(lambda a, b, c: jattn.decode_attention(a, b, c, jnp.int32(n_valid)))(q, k, v)
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(  # noqa: E731
        getattr(torch, dtype))
    got = pattn.decode_attention(tt(q), tt(k), tt(v), n_valid)
    got1 = pattn.decode_attention(tt(q)[1], tt(k)[1], tt(v)[1], n_valid)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype)
    qf, kf, vf = (np.asarray(a.astype(jnp.float32), np.float64) for a in (q, k, v))
    s = np.einsum("bhgd,bhcd->bhgc", qf.reshape(3, Hkv, -1, D), kf[:, :, :n_valid]) / D ** 0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    flip = 2.0 ** -8 * np.einsum("bhgc,bhcd->bhgd", p, np.abs(vf[:, :, :n_valid])).reshape(
        want.shape)
    for g, w, f in ((got.float().numpy(), want, flip), (got1.float().numpy(), want[1], flip[1])):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert not (np.abs(g - w) > _bf16_ulp(w) + f).any()


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("capacity", [896, 1024, 1152])
def test_dispatch_matches_jax(monkeypatch, capacity, head_dim):
    """decode_attention_auto takes the kernel exactly where the JAX package
    takes its Pallas kernel on a TPU (decode_attention_layered and
    decode_attention_auto, with use_pallas_decode forced on): C >= 1024, C a
    multiple of 128, D a multiple of 128."""
    monkeypatch.setattr(jpa, "use_pallas_decode", lambda: True)
    monkeypatch.setattr(jpa, "decode_attention_pallas_layered", lambda *a, **k: "kernel")
    monkeypatch.setattr(jpa, "decode_attention_pallas", lambda *a, **k: "kernel")
    monkeypatch.setattr(jattn, "decode_attention", lambda *a, **k: "xla")
    monkeypatch.setattr(pattn, "decode_attention_kernel", lambda *a, **k: "kernel")
    monkeypatch.setattr(pattn, "decode_attention", lambda *a, **k: "xla")
    kv = np.zeros((L, 2, Hkv, capacity, head_dim), np.float32)
    q = np.zeros((Hq, head_dim), np.float32)
    want = jattn.decode_attention_layered(jnp.asarray(q), jnp.asarray(kv), jnp.int32(0),
                                          jnp.int32(5))
    assert jattn.decode_attention_auto(jnp.asarray(q), jnp.asarray(kv[0, 0]),
                                       jnp.asarray(kv[0, 1]), jnp.int32(5)) == want
    assert pattn.decode_attention_auto(torch.from_numpy(q), torch.from_numpy(kv), 0, 5) == want
    assert want == ("kernel" if capacity >= 1024 and head_dim == 128 else "xla")


def test_auto_at_large_capacity_runs_the_kernel_semantics():
    """At C = 1024 on the CPU the dispatch runs the kernel's plain version
    (float32 probabilities)."""
    q, kv = _inputs(1, seed=9)
    qt, kvt = _t(q[0]), _t(kv[0])
    got = pattn.decode_attention_auto(qt, kvt, 1, 700)
    assert torch.equal(got, decode_attention_kernel_plain(qt, kvt, 1, 700))
