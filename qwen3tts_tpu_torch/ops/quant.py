"""Weight-only int8 quantization with one scale per output channel.

Counterpart of the int8 part of ``qwen3tts_tpu/ops/quant.py`` and
``ops/quantized_matmul.py``. Weights keep the JAX layout ``[..., K, N]``
(input rows, output columns) and scales are ``[..., 1, N]``. The decode hot
path reads these leaves inside the fused kernels; the prefill multiplies by
dequantized weights, as the JAX package leaves its prefill matmuls to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantLinear(NamedTuple):
    """int8 weights + per-output-channel scales for an [..., K, N] weight."""

    q: torch.Tensor       # int8 [..., K, N]
    scale: torch.Tensor   # float32 [..., 1, N]


def quantize_per_channel(w: torch.Tensor) -> QuantLinear:
    """Symmetric per-output-channel (last axis) int8 quantization."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantLinear(q=q, scale=scale)


def dequantize(w: QuantLinear) -> torch.Tensor:
    return w.q.float() * w.scale.float()


def quantize_block_params(blocks):
    """int8-quantize the four projection leaves of a (stacked) BlockParams;
    the norms stay as they are."""
    return blocks._replace(
        wqkv=quantize_per_channel(blocks.wqkv), wo=quantize_per_channel(blocks.wo),
        w_gateup=quantize_per_channel(blocks.w_gateup),
        w_down=quantize_per_channel(blocks.w_down))


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain or int8 weight, accumulated in float32 and cast back
    to x.dtype (the JAX package's ``preferred_element_type=f32`` dot)."""
    if isinstance(w, QuantLinear):
        y = torch.matmul(x.float(), w.q.to(x.dtype).float())
        return (y * w.scale.float()).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)
