"""NEOX-style rotary position embeddings (counterpart of
``qwen3tts_tpu/ops/rope.py``). Feature pairs ``(i, i + d/2)`` rotate by
``p * theta ** (-2 i / d)``."""

from __future__ import annotations

import torch


def inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """theta ** (-i / (d/2)) for i in [0, d/2), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def rope_angles(positions, head_dim: int, theta: float):
    """(cos, sin) of shape [..., head_dim/2] for integer positions (a tensor
    or an int), float32. A negative position rotates backwards: compaction
    re-rotates cached K rows by -shift (``runtime/continuous.compact``)."""
    positions = torch.as_tensor(positions)
    ang = positions.float()[..., None] * inv_freq(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """NEOX rope on x [..., n_heads, head_dim]; cos/sin broadcastable to
    [..., 1, head_dim/2]. Computed in float32, cast back to x.dtype."""
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_for_positions(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) shaped [..., 1, head_dim/2] for apply_rope on
    [..., n_heads, head_dim] activations."""
    cos, sin = rope_angles(positions, head_dim, theta)
    return cos[..., None, :], sin[..., None, :]
