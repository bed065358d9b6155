"""Shape buckets, copied from ``qwen3tts_tpu.runtime.buckets`` (whose package
import pulls in jax). The port keeps them to size the KV cache exactly as the
JAX package does: capacity follows the frame bucket of the request's budget.
"""

from __future__ import annotations

from typing import Sequence


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value (max bucket if value exceeds them all)."""
    for b in buckets:
        if value <= b:
            return b
    return max(buckets)
