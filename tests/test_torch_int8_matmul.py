"""The W8A16 GEMM's plain version (``ops/int8_matmul.py``) against the JAX
Pallas kernel ``int8_matmul_pallas`` in interpret mode, and the port's
``quant.matmul`` against the JAX package's ``quantized_matmul.matmul``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.ops import quantized_matmul as jqmm
from qwen3tts_tpu.ops.pallas_int8_matmul import int8_matmul_pallas
from qwen3tts_tpu_torch.ops import quant
from qwen3tts_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

SHAPES = [(128, 256), (512, 1536), (1024, 512)]   # (K, N), multiples of 128


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    scale = (rng.random((1, N)) * 0.02 + 1e-3).astype(np.float32)
    return x, q, scale


def _bf16_ulp(a):
    """The bf16 spacing at each |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def assert_close(got, want, dtype):
    """float32: 1e-5 relative. bf16: one bf16 ulp of each element. Both
    versions sum K float32 products in different orders; at outputs near 0
    that rounding is the larger term, so each also allows 1e-5 of the
    largest output's magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    floor = 1e-5 * np.abs(want).max()
    tol = 1e-5 * np.abs(want) if dtype == "float32" else _bf16_ulp(want)
    bad = np.abs(got - want) > tol + floor
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 2, 10, 64])
def test_plain_matches_pallas_interpret(M, dtype):
    for i, (K, N) in enumerate(SHAPES):
        x, q, scale = _operands(M, K, N, seed=M * 10 + i)
        xj = jnp.asarray(x, getattr(jnp, dtype))
        want = int8_matmul_pallas(xj, jnp.asarray(q), jnp.asarray(scale), interpret=True)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
        got = int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(scale))
        assert got.dtype == xt.dtype and tuple(got.shape) == (M, N)
        assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    assert int8_matmul.launches == 0   # CPU tensors run the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_matches_jax(dtype):
    """A 2-D QuantLinear product: the port's quant.matmul (the W8A16 plain
    version on the CPU) against the JAX package's convert+dot."""
    x, q, scale = _operands(9, 1024, 512, seed=3)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = jqmm.matmul(xj, jqmm.QuantLinear(jnp.asarray(q), jnp.asarray(scale)))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = quant.matmul(xt, quant.QuantLinear(torch.from_numpy(q), torch.from_numpy(scale)))
    assert got.dtype == xt.dtype
    assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


def test_quant_matmul_routes_2d_products_to_the_gemm(monkeypatch):
    """Every int8 product goes through int8_matmul, x's leading dimensions
    flattened into its rows; a plain weight does not, and an int8 weight
    that is not 2-D raises."""
    import qwen3tts_tpu_torch.ops.quant as pquant

    calls = []
    monkeypatch.setattr(pquant, "int8_matmul",
                        lambda x, q, s: calls.append(tuple(x.shape)) or int8_matmul_plain(x, q, s))
    x, q, scale = _operands(6, 128, 64, seed=4)
    w = pquant.QuantLinear(torch.from_numpy(q), torch.from_numpy(scale))
    pquant.matmul(torch.from_numpy(x[:3]), w)
    pquant.matmul(torch.from_numpy(x[:3]), torch.from_numpy(q.astype(np.float32)))
    y = pquant.matmul(torch.from_numpy(x).reshape(2, 3, 128), w)
    assert calls == [(3, 128), (6, 128)]
    np.testing.assert_array_equal(y.reshape(6, 64).numpy(),
                                  int8_matmul_plain(torch.from_numpy(x), w.q, w.scale).numpy())
    with pytest.raises(ValueError, match="2-D"):
        pquant.matmul(torch.from_numpy(x), pquant.QuantLinear(w.q[None], w.scale[None]))
