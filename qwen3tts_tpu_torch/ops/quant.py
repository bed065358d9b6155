"""Weight-only int8 quantization with one scale per output channel.

Counterpart of the int8 part of ``qwen3tts_tpu/ops/quant.py`` and
``ops/quantized_matmul.py``. Weights keep the JAX layout ``[..., K, N]``
(input rows, output columns) and scales are ``[..., 1, N]``. The fused
decode kernels read these leaves themselves; every other 2-D int8 product
(the prefill, the unfused decode step) goes through ``matmul`` to the W8A16
kernel ``ops/int8_matmul.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .int8_matmul import int8_matmul


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
    to x.dtype (the JAX package's ``preferred_element_type=f32`` dot,
    ``ops/quantized_matmul.py:68-83``). A 2-D int8 product goes to
    ``int8_matmul``: its kernel for CUDA tensors, its plain version for CPU
    tensors. x's leading dimensions are flattened into the product's rows;
    an int8 weight must be 2-D."""
    if isinstance(w, QuantLinear):
        if w.q.dim() != 2:
            raise ValueError(f"quant.matmul takes a 2-D int8 weight, got {tuple(w.q.shape)}")
        y = int8_matmul(x.reshape(-1, x.shape[-1]), w.q, w.scale)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return torch.matmul(x.float(), w.float()).to(x.dtype)
