"""Qwen3-style decoder blocks, stacked over layers (counterpart of
``qwen3tts_tpu/models/transformer_core.py``).

One block = RMSNorm -> GQA attention with per-head q/k RMSNorm and NEOX RoPE
-> residual -> RMSNorm -> SwiGLU MLP -> residual. Linear weights are stored
[in, out]; q/k/v and gate/up are fused along the output axis; the KV cache is
head-major [L, 2, Hkv, C, D] — the JAX layouts, so tests compare like with
like. The single-token decode step runs in the fused kernels
(``ops/fused_talker_step.py``, ``ops/fused_code_predictor.py``);
``forward_step`` here is the plain dense step the tests hold them against.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.norms import rms_norm
from ..ops.quant import QuantLinear, matmul
from ..ops.rope import apply_rope, rope_for_positions

NEG_INF = -1e30


class BlockParams(NamedTuple):
    """Stacked decoder-block parameters; every leaf has leading axis L."""

    attn_norm: torch.Tensor   # [L, H]
    wqkv: object              # [L, H, (Hq + 2*Hkv) * D] (tensor or QuantLinear)
    wo: object                # [L, Hq*D, H]
    q_norm: torch.Tensor      # [L, D]
    k_norm: torch.Tensor      # [L, D]
    ffn_norm: torch.Tensor    # [L, H]
    w_gateup: object          # [L, H, 2*F]
    w_down: object            # [L, F, H]


def float32_norms(blocks: BlockParams) -> BlockParams:
    """The norm weights in float32, the dtype the fused kernels read (a bf16
    to float32 copy is exact, and every norm computes in float32)."""
    return blocks._replace(attn_norm=blocks.attn_norm.float(), q_norm=blocks.q_norm.float(),
                           k_norm=blocks.k_norm.float(), ffn_norm=blocks.ffn_norm.float())


def normal_init(gen: torch.Generator, device, dtype):
    """w(shape, fan_in): scaled-normal synthetic weights drawn from `gen`."""

    def w(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (t / math.sqrt(fan_in)).to(dtype)

    return w


def init_block_params(gen, cfg, hidden: int, ffn: int, dtype, device) -> BlockParams:
    """Deterministic synthetic init (scaled normal) at the configured shapes;
    cfg has n_layers, n_heads, n_kv_heads, head_dim."""
    L, Hq, Hkv, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = normal_init(gen, device, dtype)
    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)   # noqa: E731
    return BlockParams(
        attn_norm=ones(L, hidden),
        wqkv=w((L, hidden, (Hq + 2 * Hkv) * D), hidden),
        wo=w((L, Hq * D, hidden), Hq * D),
        q_norm=ones(L, D),
        k_norm=ones(L, D),
        ffn_norm=ones(L, hidden),
        w_gateup=w((L, hidden, 2 * ffn), hidden),
        w_down=w((L, ffn, hidden), ffn),
    )


def _layer_weights(blocks: BlockParams, l: int):
    def pick(w):
        return QuantLinear(w.q[l], w.scale[l]) if isinstance(w, QuantLinear) else w[l]

    return (pick(blocks.wqkv), pick(blocks.wo), pick(blocks.w_gateup),
            pick(blocks.w_down))


def _attend(q, k, v, mask):
    """q [T, Hq, D]; k, v [S, Hkv, D]; mask [T, S] bool. Scores and softmax
    in float32, probabilities cast to v's dtype. Returns [T, Hq, D]."""
    T, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.float().reshape(T, Hkv, G, D).permute(1, 2, 0, 3)        # [Hkv, G, T, D]
    kk = k.float().permute(1, 2, 0)                                 # [Hkv, D, S]
    s = torch.matmul(qg, kk[:, None]) * (1.0 / D ** 0.5)            # [Hkv, G, T, S]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.matmul(p, v.float().permute(1, 0, 2)[:, None])        # [Hkv, G, T, D]
    return o.permute(2, 0, 1, 3).reshape(T, Hq, D).to(v.dtype)


def _layer(blocks, cfg, l, x, cos, sin, attend):
    Hq, Hkv, D, eps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.rms_norm_eps
    T = x.shape[0]
    wqkv, wo, wgu, wd = _layer_weights(blocks, l)
    h = rms_norm(x, blocks.attn_norm[l], eps)
    qkv = matmul(h, wqkv)
    q = rms_norm(qkv[:, :Hq * D].reshape(T, Hq, D), blocks.q_norm[l], eps)
    k = rms_norm(qkv[:, Hq * D:(Hq + Hkv) * D].reshape(T, Hkv, D), blocks.k_norm[l], eps)
    v = qkv[:, (Hq + Hkv) * D:].reshape(T, Hkv, D)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attend(q, k, v)
    x = x + matmul(o.reshape(T, Hq * D), wo)
    h = rms_norm(x, blocks.ffn_norm[l], eps)
    gu = matmul(h, wgu)
    F = gu.shape[-1] // 2
    gate = torch.nn.functional.silu(gu[:, :F].float()).to(h.dtype)
    return x + matmul(gate * gu[:, F:], wd)


def forward_prefill(blocks: BlockParams, cfg, x: torch.Tensor, positions: torch.Tensor,
                    kv: torch.Tensor, n_past: int = 0) -> torch.Tensor:
    """Run the stack over a dense prefill window x [P, H], writing K/V into
    kv (in place) at [n_past, n_past+P). Causal attention over the window
    itself (prefill starts from an empty cache). Returns hidden [P, H]."""
    P = x.shape[0]
    cos, sin = rope_for_positions(positions, cfg.head_dim, cfg.rope_theta)
    idx = torch.arange(P, device=x.device)
    mask = idx[None, :] <= idx[:, None]
    for l in range(cfg.n_layers):
        def attend(q, k, v, l=l):
            kv[l, 0, :, n_past:n_past + P] = k.transpose(0, 1).to(kv.dtype)
            kv[l, 1, :, n_past:n_past + P] = v.transpose(0, 1).to(kv.dtype)
            return _attend(q, k, v, mask)

        x = _layer(blocks, cfg, l, x, cos, sin, attend)
    return x


def forward_step(blocks: BlockParams, cfg, x: torch.Tensor, n_past: int,
                 kv: torch.Tensor) -> torch.Tensor:
    """Single-token decode step on x [H]: K/V written into kv (in place) at
    n_past, attention over cache[0:n_past+1] in the cache dtype. Returns the
    pre-output-norm hidden [H]."""
    n = int(n_past)
    pos = torch.tensor([n], device=x.device)
    cos, sin = rope_for_positions(pos, cfg.head_dim, cfg.rope_theta)
    mask = torch.ones((1, n + 1), dtype=torch.bool, device=x.device)
    h = x[None]
    for l in range(cfg.n_layers):
        def attend(q, k, v, l=l):
            kv[l, 0, :, n] = k[0].to(kv.dtype)
            kv[l, 1, :, n] = v[0].to(kv.dtype)
            return _attend(q, kv[l, 0, :, :n + 1].transpose(0, 1),
                           kv[l, 1, :, :n + 1].transpose(0, 1), mask)

        h = _layer(blocks, cfg, l, h, cos, sin, attend)
    return h[0]
