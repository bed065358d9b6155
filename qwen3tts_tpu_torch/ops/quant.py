"""Weight quantization of the decoder blocks: int8 with one scale per output
channel, and affine u4 with per-K-group scales and offsets.

Counterpart of ``qwen3tts_tpu/ops/quant.py`` and ``ops/quantized_matmul.py``.
Weights keep the JAX layout ``[..., K, N]`` (input rows, output columns).
``QuantLinear`` holds int8 ``q`` and scales ``[..., 1, N]``; ``QuantLinear4``
holds split-half nibbles ``q`` ``[..., K/2, N]`` and float32 ``scale`` and
``zero`` ``[..., G, N]``. The fused decode kernels read these leaves
themselves; every other product goes through ``matmul``: a 2-D int8 one to
the W8A16 kernel ``ops/int8_matmul.py``, a u4 one to the grouped product
below in PyTorch (the JAX package leaves it to XLA), a plain one to
``torch.matmul``.

The serving tiers (``quantize_talker_blocks``): "int8" all int8; "q4" the
attention projections int8 and the FFN u4; "q4pure" all u4. The code
predictor is int8 in every quantized tier.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .int8_matmul import int8_matmul

# Per-K-group width of the u4 scales (ggml Q4_K's 32-element sub-blocks);
# shrunk through gcd at shapes whose K/2 it does not divide.
W4_GROUP = 32


class QuantLinear(NamedTuple):
    """int8 weights + per-output-channel scales for an [..., K, N] weight."""

    q: torch.Tensor       # int8 [..., K, N]
    scale: torch.Tensor   # float32 [..., 1, N]


class QuantLinear4(NamedTuple):
    """Affine u4 weights for an [..., K, N] weight:
    w[k, n] = q[k, n] * scale[g(k), n] - zero[g(k), n], q in [0, 15].

    Byte [i, n] holds row i in its low nibble and row i + K/2 in its high
    nibble (split-half packing). Group g covers logical rows [g*gs,
    (g+1)*gs) with gs = K // G; groups [0, G/2) cover the low half."""

    q: torch.Tensor       # int8 [..., K/2, N] (two raw u4 nibbles per byte)
    scale: torch.Tensor   # float32 [..., G, N]
    zero: torch.Tensor    # float32 [..., G, N] (subtracted)


def quantize_per_channel(w: torch.Tensor) -> QuantLinear:
    """Symmetric per-output-channel (last axis) int8 quantization."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantLinear(q=q, scale=scale)


def dequantize(w: QuantLinear) -> torch.Tensor:
    return w.q.float() * w.scale.float()


def _w4_group_size(K: int, group_size: int = W4_GROUP) -> int:
    return math.gcd(K // 2, group_size)


def weight_in_dim(w) -> int:
    """Logical K (input dim) of a weight leaf; QuantLinear4 stores K/2 rows."""
    if isinstance(w, QuantLinear4):
        return 2 * w.q.shape[-2]
    if isinstance(w, QuantLinear):
        return w.q.shape[-2]
    return w.shape[-2]


def unpack4(q: torch.Tensor):
    """Packed [..., K/2, N] int8 -> (lo, hi) raw u4 halves in [0, 15], int8."""
    b = q.to(torch.int32)
    return (b & 15).to(torch.int8), ((b >> 4) & 15).to(torch.int8)


def quantize_w4(w: torch.Tensor, group_size: int = W4_GROUP) -> QuantLinear4:
    """Affine u4 with per-K-group, per-output-channel (scale, zero): w ~=
    q * scale - zero, from each group's min/max (both widened to include 0),
    packed split-half."""
    wf = w.float()
    K, N = wf.shape[-2], wf.shape[-1]
    gs = _w4_group_size(K, group_size)
    G = K // gs
    grouped = wf.reshape(*wf.shape[:-2], G, gs, N)
    wmin = torch.clamp(torch.amin(grouped, dim=-2), max=0.0)
    wmax = torch.clamp(torch.amax(grouped, dim=-2), min=0.0)
    rng = wmax - wmin
    scale = torch.where(rng > 0, rng / 15.0, torch.ones_like(rng))
    zero = -wmin
    q = torch.clamp(torch.round((grouped + zero[..., :, None, :]) / scale[..., :, None, :]),
                    0, 15).reshape(wf.shape).to(torch.int32)
    packed = (q[..., :K // 2, :] | (q[..., K // 2:, :] << 4)).to(torch.uint8)
    return QuantLinear4(q=packed.view(torch.int8), scale=scale, zero=zero)


def group_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Group rows [..., G, N] repeated to per-row [..., rows, N]."""
    return torch.repeat_interleave(t, rows // t.shape[-2], dim=-2)


def dequantize4(w: QuantLinear4) -> torch.Tensor:
    """float32 [..., K, N]: q * scale - zero, each product rounded before
    the subtraction."""
    lo, hi = unpack4(w.q)
    q = torch.cat([lo, hi], dim=-2).float()
    return q * group_rows(w.scale.float(), q.shape[-2]) - group_rows(w.zero.float(),
                                                                      q.shape[-2])


def quantize_block_params(blocks):
    """int8-quantize the four projection leaves of a (stacked) BlockParams;
    the norms stay as they are."""
    return blocks._replace(
        wqkv=quantize_per_channel(blocks.wqkv), wo=quantize_per_channel(blocks.wo),
        w_gateup=quantize_per_channel(blocks.w_gateup),
        w_down=quantize_per_channel(blocks.w_down))


def quantize_block_params_w4(blocks):
    """All four projections affine u4 (the "q4pure" tier)."""
    return blocks._replace(
        wqkv=quantize_w4(blocks.wqkv), wo=quantize_w4(blocks.wo),
        w_gateup=quantize_w4(blocks.w_gateup), w_down=quantize_w4(blocks.w_down))


def quantize_block_params_mixed(blocks):
    """The "q4" tier: the attention projections (wqkv, wo) int8, the FFN
    (w_gateup, w_down) affine u4."""
    return blocks._replace(
        wqkv=quantize_per_channel(blocks.wqkv), wo=quantize_per_channel(blocks.wo),
        w_gateup=quantize_w4(blocks.w_gateup), w_down=quantize_w4(blocks.w_down))


def quantize_talker_blocks(blocks, tier: str):
    """The serving tier's block policy: "int8", "q4" (mixed) or "q4pure"."""
    if tier == "int8":
        return quantize_block_params(blocks)
    if tier == "q4":
        return quantize_block_params_mixed(blocks)
    if tier == "q4pure":
        return quantize_block_params_w4(blocks)
    raise ValueError(f"unknown quant tier: {tier!r}")


def matmul4_f32(x: torch.Tensor, w: QuantLinear4) -> torch.Tensor:
    """x [..., K] @ a u4 weight with the grouped formula of
    ``quantized_matmul.py:84-105``: per half of K and per group g, p_g =
    x_g @ q_g and t_g = sum(x_g), then sum_g (p_g * s_g - t_g * z_g); the
    halves are added. Accumulates and returns float32."""
    lo, hi = unpack4(w.q)
    Kh, N = lo.shape[-2], lo.shape[-1]
    Gh = w.scale.shape[-2] // 2
    gs = Kh // Gh

    def half(xh, wh, sh, zh):
        xg = xh.float().reshape(*xh.shape[:-1], Gh, gs)
        p = torch.einsum("...gk,gkn->...gn", xg, wh.float().reshape(Gh, gs, N))
        t = torch.sum(xg, dim=-1)
        return torch.sum(p * sh.float(), dim=-2) - torch.matmul(t, zh.float())

    return (half(x[..., :Kh], lo, w.scale[:Gh], w.zero[:Gh])
            + half(x[..., Kh:], hi, w.scale[Gh:], w.zero[Gh:]))


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain, int8 or u4 weight, accumulated in float32 and cast
    back to x.dtype (the JAX package's ``preferred_element_type=f32`` dot,
    ``ops/quantized_matmul.py:68-106``). A 2-D int8 product goes to
    ``int8_matmul``: its kernel for CUDA tensors, its plain version for CPU
    tensors. x's leading dimensions are flattened into the product's rows;
    a quantized weight must be 2-D."""
    if isinstance(w, (QuantLinear, QuantLinear4)):
        if w.q.dim() != 2:
            raise ValueError(f"quant.matmul takes a 2-D quantized weight, "
                             f"got {tuple(w.q.shape)}")
        if isinstance(w, QuantLinear4):
            return matmul4_f32(x, w).to(x.dtype)
        y = int8_matmul(x.reshape(-1, x.shape[-1]), w.q, w.scale)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return torch.matmul(x.float(), w.float()).to(x.dtype)
