"""Qwen3-style decoder blocks, stacked over layers (counterpart of
``qwen3tts_tpu/models/transformer_core.py``).

One block = RMSNorm -> GQA attention with per-head q/k RMSNorm and NEOX RoPE
-> residual -> RMSNorm -> SwiGLU MLP -> residual. Linear weights are stored
[in, out]; q/k/v and gate/up are fused along the output axis; the KV cache is
head-major [L, 2, Hkv, C, D] — the JAX layouts, so tests compare like with
like. The fused path runs the single-token decode step in the fused kernels
(``ops/fused_talker_step.py``, ``ops/fused_code_predictor.py``); the
unfused path runs ``forward_step`` here, whose projections go through
``quant.matmul`` (the W8A16 kernel for int8 weights, the grouped u4 product
or torch.matmul for the others) and whose attention at large capacities
goes to the decode-attention kernel. Tests also hold the fused kernels
against ``forward_step``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.attention import attend as attend_xla
from ..ops.attention import decode_attention_auto
from ..ops.library import as_int
from ..ops.norms import rms_norm
from ..ops.quant import QuantLinear, QuantLinear4, matmul
from ..ops.rope import apply_rope, rope_for_positions
from ..parallel.collectives import matmul_rows


class BlockParams(NamedTuple):
    """Stacked decoder-block parameters; every leaf has leading axis L."""

    attn_norm: torch.Tensor   # [L, H]
    wqkv: object              # [L, H, (Hq + 2*Hkv) * D]: tensor, QuantLinear(4)
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
        if isinstance(w, (QuantLinear, QuantLinear4)):
            return type(w)(*(t[l] for t in w))
        return w[l]

    return (pick(blocks.wqkv), pick(blocks.wo), pick(blocks.w_gateup),
            pick(blocks.w_down))


def _layer(blocks, cfg, l, x, cos, sin, attend):
    """One block on x [..., T, H]; the projections run as [rows, H] products
    (``quant.matmul`` flattens the leading dimensions into M); attend(q, k,
    v) stores K/V and returns the attention output [..., T, Hq, D].

    On a rank's tensor-parallel shard (``parallel/shardings.py``) cfg holds
    the rank's head counts, wqkv and w_gateup its heads' and FFN columns,
    and wo and w_down the matching input rows: their products are summed
    over "tp" (``collectives.matmul_rows``, a plain ``matmul`` otherwise)."""
    Hq, Hkv, D, eps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.rms_norm_eps
    lead = x.shape[:-1]
    wqkv, wo, wgu, wd = _layer_weights(blocks, l)
    h = rms_norm(x, blocks.attn_norm[l], eps)
    qkv = matmul(h, wqkv)
    q = rms_norm(qkv[..., :Hq * D].reshape(*lead, Hq, D), blocks.q_norm[l], eps)
    k = rms_norm(qkv[..., Hq * D:(Hq + Hkv) * D].reshape(*lead, Hkv, D), blocks.k_norm[l], eps)
    v = qkv[..., (Hq + Hkv) * D:].reshape(*lead, Hkv, D)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attend(q, k, v)
    x = x + matmul_rows(o.reshape(*lead, Hq * D), wo, blocks.wo)
    h = rms_norm(x, blocks.ffn_norm[l], eps)
    gu = matmul(h, wgu)
    F = gu.shape[-1] // 2
    gate = torch.nn.functional.silu(gu[..., :F].float()).to(h.dtype)
    return x + matmul_rows(gate * gu[..., F:], wd, blocks.w_down)


def forward_prefill(blocks: BlockParams, cfg, x: torch.Tensor, positions: torch.Tensor,
                    kv: torch.Tensor, n_past: int = 0) -> torch.Tensor:
    """Run the stack over a dense prefill window x [P, H] (or B lanes' windows
    [B, P, H] with kv [B, L, 2, Hkv, C, D]), writing K/V into kv (in place)
    at [n_past, n_past+P). Causal attention over the window itself (prefill
    starts from an empty cache). Returns hidden of x's shape."""
    P = x.shape[-2]
    kvl = kv if x.dim() == 3 else kv[None]
    cos, sin = rope_for_positions(positions, cfg.head_dim, cfg.rope_theta)
    idx = torch.arange(P, device=x.device)
    mask = idx[None, :] <= idx[:, None]
    for l in range(cfg.n_layers):
        def attend(q, k, v, l=l):
            kvl[:, l, 0, :, n_past:n_past + P] = k.transpose(-3, -2).to(kv.dtype)
            kvl[:, l, 1, :, n_past:n_past + P] = v.transpose(-3, -2).to(kv.dtype)
            return attend_xla(q, k, v, mask)

        x = _layer(blocks, cfg, l, x, cos, sin, attend)
    return x


def forward_step(blocks: BlockParams, cfg, x: torch.Tensor, n_past: int,
                 kv: torch.Tensor, start=None) -> torch.Tensor:
    """Single-token decode step (counterpart of ``forward_step`` in
    ``qwen3tts_tpu/models/transformer_core.py:182-255``) on x [H] with kv
    [L, 2, Hkv, C, D], or on B lanes x [B, H] with kv [B, L, 2, Hkv, C, D]
    (the lanes are the M = B rows of each projection). K/V are written into
    kv (in place) at n_past; attention over cache[0:n_past+1] goes through
    ``ops/attention.decode_attention_auto`` (the decode-attention kernel at
    capacities of 1024 rows and more, the XLA semantics below); the
    projections through ``quant.matmul``. `start` (an int, or [B] per lane)
    masks the cache rows below it: continuous serving splices a request
    mid-cache, and the rows below its splice belong to the lane's previous
    occupant (RoPE uses absolute positions, so the spliced request computes
    what a fresh run would). Returns the pre-output-norm hidden of x's
    shape. n_past is an int, or a SymInt under torch.export."""
    n = as_int(n_past)
    pos = torch.tensor([n], device=x.device)
    cos, sin = rope_for_positions(pos, cfg.head_dim, cfg.rope_theta)
    kvl = kv if x.dim() == 2 else kv[None]
    h = x.reshape(-1, x.shape[-1])
    for l in range(cfg.n_layers):
        def attend(q, k, v, l=l):
            # row n of layer l's K and V (select: n may be a SymInt)
            kvl[:, l, 0].select(-2, n).copy_(k.to(kv.dtype))
            kvl[:, l, 1].select(-2, n).copy_(v.to(kv.dtype))
            return decode_attention_auto(q, kvl, l, n + 1, start)

        h = _layer(blocks, cfg, l, h, cos, sin, attend)
    return h.reshape(x.shape)
