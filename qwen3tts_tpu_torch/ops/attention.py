"""Attention in the XLA semantics, and the single-token decode dispatch
between it and the decode-attention kernel.

Counterpart of ``qwen3tts_tpu/ops/attention.py``. ``attend`` is the JAX
package's XLA path, for the prefill and the decode step alike: float32
scores and softmax, the probabilities cast to the cache dtype before p.V;
``decode_attention`` is its single-query form over a head-major cache (the
JAX function of that name, :53-142). ``decode_attention_auto`` dispatches as
``decode_attention_auto`` and ``decode_attention_layered`` do there: the
kernel (``ops/decode_attention.py``, Pallas semantics: float32
probabilities) where the JAX package runs its Pallas kernel on a TPU —
capacity C >= 1024, C a multiple of 128, head_dim a multiple of 128, the
query heads a multiple of the KV heads — and ``decode_attention`` everywhere
else. So each capacity gets the same numbers as in the JAX package on a TPU.
(On a CPU the JAX package always takes its XLA path; the port keeps the
TPU's split there too, where the kernel's plain version runs.)

``start`` is continuous serving's per-lane first valid cache row (a lane
refilled mid-session holds its previous occupant's rows below it,
``runtime/continuous.py``): rows below it are masked as the JAX package's
``decode_attention`` masks them. Given a start, the dispatch keeps the XLA
semantics at every capacity, as the JAX package takes its Pallas kernel only
when ``start is None`` (``qwen3tts_tpu/ops/attention.py:73, :101``): the
continuous path launches no decode-attention kernel.
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention_kernel
from .library import as_int

NEG_INF = -1e30
MIN_KERNEL_CAPACITY = 1024   # the JAX package's MIN_PALLAS_CAPACITY


def use_decode_kernel(capacity: int, head_dim: int, n_heads: int, n_kv_heads: int) -> bool:
    """Where the JAX package runs its Pallas decode attention on a TPU."""
    return (capacity >= MIN_KERNEL_CAPACITY and capacity % 128 == 0 and head_dim % 128 == 0
            and n_heads % n_kv_heads == 0)


def attend(q, k, v, mask=None):
    """The XLA semantics, for the prefill and the decode step: q [..., T, Hq,
    D]; k, v [..., S, Hkv, D]; mask [T, S] bool or None (every key). Scores
    and softmax in float32, probabilities cast to v's dtype before p.V.
    Returns [..., T, Hq, D] in v's dtype."""
    *lead, T, Hq, D = q.shape
    Hkv = k.shape[-2]
    G = Hq // Hkv
    # one [G*T, S] score matrix per KV head: batched products, no broadcast
    qg = q.float().reshape(*lead, T, Hkv, G, D).movedim(-4, -2).reshape(*lead, Hkv, G * T, D)
    kt = k.movedim(-3, -2).float().transpose(-1, -2)                    # [..., Hkv, D, S]
    s = (torch.matmul(qg, kt) * (1.0 / D ** 0.5)).reshape(*lead, Hkv, G, T, -1)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype).float().reshape(*lead, Hkv, G * T, -1)
    o = torch.matmul(p, v.movedim(-3, -2).float())                      # [..., Hkv, G*T, D]
    return o.reshape(*lead, Hkv, G, T, D).movedim(-2, -4).reshape(*lead, T, Hq, D).to(v.dtype)


def decode_attention(q, k_cache, v_cache, n_valid: int, start=None) -> torch.Tensor:
    """q [..., Hq, D]; k_cache, v_cache [..., Hkv, C, D] head-major; `attend`
    of the one query over rows [0, n_valid), and, when `start` is given (an
    int, or one per lane of q's leading dimension [B]), not below start.
    Returns [..., Hq, D] in the cache dtype. (JAX masks the rows past
    n_valid with -1e30, whose probabilities are exactly 0; reading only the
    rows below n_valid is the same. Rows below start are masked with -1e30,
    as JAX masks them.) n_valid may be a SymInt (torch.export)."""
    n = as_int(n_valid)
    k = k_cache[..., :n, :].transpose(-3, -2)   # [..., n, Hkv, D]
    v = v_cache[..., :n, :].transpose(-3, -2)
    mask = None
    if start is not None:
        st = torch.as_tensor(start, device=q.device).reshape(-1, 1, 1, 1, 1)
        mask = torch.arange(n, device=q.device) >= st         # [B|1, 1, 1, 1, n]
        if q.dim() == 2:
            mask = mask[0]
    return attend(q.unsqueeze(-3), k, v, mask).squeeze(-3)


def decode_attention_auto(q, kv, layer: int, n_valid: int, start=None) -> torch.Tensor:
    """Decode attention of q [(B,) Hq, D] over layer `layer` of the stacked
    cache kv [(B,) L, 2, Hkv, C, D], rows below `start` masked (see the
    module docstring)."""
    Hkv, C, D = kv.shape[-3:]
    if start is None and use_decode_kernel(C, D, q.shape[-2], Hkv):
        return decode_attention_kernel(q, kv, layer, n_valid)
    layer_kv = kv.select(-5, layer)
    return decode_attention(q, layer_kv.select(-4, 0), layer_kv.select(-4, 1), n_valid, start)
