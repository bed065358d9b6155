"""The int8 KV cache (counterpart of ``qwen3tts_tpu/ops/kv_quant.py``).

With ``RuntimeConfig.kv_quant="int8"`` the fused talker step's cache is the
pair (q, scale):
  q     int8 [..., C, D]   (the leading axes of the bf16 cache)
  scale f32  [..., C]      (one per row: its absmax / 127, floored)
It holds 0.516 of the bf16 cache's bytes at D = 128 (one byte per value
plus four per row of 128). Rows are quantized outside the attention: the
step attends to its own new row in bf16 and then writes the row's (q,
scale) at n_past (``fused_talker_step``). On the read side K's scale
multiplies the score and V's folds into the probability, so the int8
values are only widened (layer.cuh, ``gqa_attention``).
"""

from __future__ import annotations

import torch

_EPS = 1e-8
# the float32 constant the JAX package multiplies by: float32(1/127)
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def quantize_kv(kv: torch.Tensor):
    """[..., C, D] float -> (int8 [..., C, D], float32 scale [..., C]), with
    the JAX package's bits: x = kv in float32, scale = max(amax, 1e-8) *
    float32(1/127) (a multiply, not a division by 127), q = clip(round half
    to even(x / scale), -127, 127) with an IEEE divide. An all-zero row (an
    unwritten slot) gives zeros and the floor scale."""
    x = kv.float()
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp(amax, min=_EPS) * _INV127.to(x.device)
    q = torch.clamp(torch.round(x / scale[..., None]), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_kv (tests)."""
    return (q.float() * scale[..., None]).to(dtype)


def is_quantized_kv(kv) -> bool:
    """True when kv is the (q, scale) pair rather than a dense tensor."""
    return isinstance(kv, tuple)


def quantize_cache(window: torch.Tensor, capacity: int):
    """The (q, scale) cache of `capacity` rows whose first P rows are the
    prefill window [..., P, D] and whose other rows are unwritten: the bits
    ``quantize_kv`` gives the whole zero-padded cache (an unwritten row is
    zeros with the floor scale), without a bf16 or float32 copy of it."""
    *lead, P, D = window.shape
    q = torch.zeros((*lead, capacity, D), dtype=torch.int8, device=window.device)
    scale = torch.full((*lead, capacity), _EPS, dtype=torch.float32, device=window.device)
    scale *= _INV127.to(window.device)
    q[..., :P, :], scale[..., :P] = quantize_kv(window)
    return q, scale
