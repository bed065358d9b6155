"""Single-query GQA decode attention over one layer of the stacked KV cache.

Counterpart of ``qwen3tts_tpu/ops/pallas_attention.py``: one wrapper,
``decode_attention_kernel``, replaces both Pallas kernels,
``decode_attention_pallas`` (:83) and ``decode_attention_pallas_layered``
(:201), with the split-K flash-decode in ``csrc/decode_attention.cu``. A
layer of the port's cache is a view with no copy, so the TPU's split between
a sliced and a layer-indexed kernel (an XLA copy-avoidance device) has no
counterpart here. An optional leading lane dimension stands for the Pallas
call under ``vmap`` in the JAX package's batched unfused loop.

Semantics are the Pallas kernels': float32 scores q.k * D^-0.5 and float32
probabilities (never rounded to the cache dtype) against float32 V, over
cache rows [0, n_valid); the sum is divided by max(l, 1e-30) at the end and
the result cast to q's dtype. The query and cache are bf16, or float32 in
the float32 tier (``RuntimeConfig(dtype="float32")`` with the unfused
step). ``ops/attention.py`` decides when this kernel runs.
"""

from __future__ import annotations

import torch

from .. import _kernels
from . import library
from .library import as_int


def _lanes(q, kv):
    """(q [B, Hq, D], kv [B, L, 2, Hkv, C, D], lanes given?)."""
    lanes = q.dim() == 3
    if kv.dim() != (6 if lanes else 5):
        raise ValueError(f"q {tuple(q.shape)} and kv {tuple(kv.shape)} disagree on lanes")
    return (q, kv, True) if lanes else (q[None], kv[None], False)


# csrc/decode_attention.cu's split rule: rows per ring tile, blocks that fill
# the H100 about twice, the largest cluster
SPLIT_TILE, SPLIT_BLOCK_TARGET, SPLIT_MAX = 64, 264, 16


def decode_attention_split(B: int, Hkv: int, n_valid: int):
    """(splits, rows per split) of the kernel's cluster over [0, n_valid)
    for B lanes and Hkv KV heads (decode_split in the source): split r takes
    rows [r * per, min(n_valid, (r + 1) * per)), rank 0 rescales and sums
    the splits' partials in rank order."""
    s = max(1, min(SPLIT_BLOCK_TARGET // (B * Hkv), -(-n_valid // SPLIT_TILE), SPLIT_MAX))
    per = -(-n_valid // s)
    return -(-n_valid // per), per


def decode_attention_kernel_plain(q, kv, layer: int, n_valid: int) -> torch.Tensor:
    """Plain version: q [Hq, D] and kv [L, 2, Hkv, C, D], or with a leading
    lane dimension each; attention of each query row over rows [0, n_valid)
    of layer `layer`. Returns [(B,) Hq, D] in q's dtype."""
    q3, kv6, lanes = _lanes(q, kv)
    B, Hq, D = q3.shape
    n = int(n_valid)
    k = kv6[:, layer, 0, :, :n].float()                     # [B, Hkv, n, D]
    v = kv6[:, layer, 1, :, :n].float()
    Hkv = k.shape[1]
    qg = q3.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.matmul(qg, k.transpose(-1, -2)) * (1.0 / D ** 0.5)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    l = torch.sum(p, dim=-1, keepdim=True)
    out = (torch.matmul(p, v) / torch.clamp(l, min=1e-30)).reshape(B, Hq, D).to(q.dtype)
    return out if lanes else out[0]


def launch_decode_attention(q, kv, layer: int, n_valid: int) -> torch.Tensor:
    """One cluster launch of decode attention (the decode_attention op's
    CUDA kernel), counted on ``decode_attention_kernel`` (and, over a
    float32 cache, in its ``operand_launches["f32"]``)."""
    lib = _kernels.load_library()
    _kernels.require_cuda(q, kv)
    q3, kv6, lanes = _lanes(q, kv)
    B, Hq, D = q3.shape
    L, _, Hkv, C, Dk = kv6.shape[1:]
    n = int(n_valid)
    if q3.dtype != kv6.dtype or kv6.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode_attention_kernel takes a bf16 or float32 query and cache "
                         f"of one dtype, got {q3.dtype} and {kv6.dtype}")
    f32 = kv6.dtype == torch.float32
    if D != 128 or Dk != D or Hq % Hkv or Hq // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention_kernel: q {tuple(q3.shape)}, kv {tuple(kv6.shape)}")
    if not (0 <= layer < L and 1 <= n <= C):
        raise ValueError(f"layer {layer} / n_valid {n} outside the cache {tuple(kv6.shape)}")
    layer_kv = kv6[:, layer]                                    # [B, 2, Hkv, C, D] view
    if not layer_kv[0].is_contiguous() or layer_kv.data_ptr() % 16 or kv6.stride(0) % 8:
        raise ValueError("decode_attention_kernel: each lane's cache must be contiguous "
                         "and 16-byte aligned")
    q3 = q3.contiguous()
    out = torch.empty((B, Hq, D), dtype=q3.dtype, device=q3.device)
    err = lib.qtts_decode_attention(
        q3.data_ptr(), layer_kv.data_ptr(), kv6.stride(0), B, Hq, Hkv, C, D, n,
        1.0 / D ** 0.5, int(f32), out.data_ptr(), _kernels.stream_ptr(q3.device))
    _kernels.check(err, "decode_attention_kernel")
    decode_attention_kernel.launches += 1
    if f32:
        ops = decode_attention_kernel.operand_launches
        ops["f32"] = ops.get("f32", 0) + 1
    return out if lanes else out[0]


def decode_attention_kernel(q, kv, layer: int, n_valid: int) -> torch.Tensor:
    """Decode attention of q over layer `layer` of the stacked cache kv
    (see decode_attention_kernel_plain for the shapes), through the op
    ``qwen3tts::decode_attention`` (``ops/library.py``); n_valid is an int
    (a SymInt under torch.export).

    CPU tensors run the plain version. CUDA tensors launch the kernel (bf16
    or float32 q and cache of one dtype, D = 128, Hq / Hkv in 1, 2, 4, 8,
    each lane's cache contiguous) or raise; there is no fallback."""
    return torch.ops.qwen3tts.decode_attention.default(q, kv, int(layer), as_int(n_valid))


decode_attention_kernel.launches = 0
# launches over a float32 cache ("f32")
decode_attention_kernel.operand_launches = {}
library.implement("decode_attention", cpu=decode_attention_kernel_plain,
                  cuda=launch_decode_attention)
