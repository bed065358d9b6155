"""K1 and K5: one talker frame through all layers, plus the codec head and
the sampling of the next frame's codebook-0 token, for one stream (K1) or
for B lockstep lanes (K5).

Counterpart of ``qwen3tts_tpu/ops/pallas_talker_step.py``. K1 replaces the
Pallas kernels ``fused_talker_step`` (:387) and ``fused_talker_step_hbm``
(:980) in their w8a8 mode. On the TPU the two differ in where the KV cache
lives; on the H100 it always lives in device memory, so one kernel
(``csrc/talker_step.cu``) serves every capacity. K5 replaces
``fused_talker_step_batched`` (:1604) in its batch-major w8a8 form
(``csrc/talker_step_batched.cu``). The sources say what bounds them (the
bytes of 28 layers of int8 weights per frame, read once for all lanes in
K5) and what this first design does about it.

Per layer: RMSNorm -> fused QKV -> q/k RMSNorm -> NEOX RoPE -> K/V row write
at n_past -> GQA attention over [0, n_past] (float32 probabilities; q cast
to the KV dtype, and in K1 the probabilities too) -> o_proj -> RMSNorm ->
SwiGLU -> residual. The w8a8 matmuls quantize the activation per token,
accumulate in int32 (exact and independent of order) and scale by
act_scale * w_scale. The float sums that feed an int8 rounding run in
float64 here and in the kernels (layer.cuh), so both get the same bits.
Then the output RMSNorm, the codec head, and, when ``seen`` is given, the
cb0 epilogue: suppress [suppress_start, V) except eos_id, repetition
penalty over ``seen``, and the counter-hash sampler.

The KV cache is updated IN PLACE: the new K/V row is written into ``kv`` at
``n_past`` (JAX aliases the kernel's KV operand to its output instead).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import _kernels
from .quant import QuantLinear
from .rope import rope_angles
from .sampling import sample_rows_plain

MAX_LANES = 128   # lanes of one batched step (the JAX package's decode_loop.py:49)


class StepOut(NamedTuple):
    hidden: torch.Tensor              # [H] ([B, H] batched) f32, output-normed
    logits: torch.Tensor              # [Vc] ([B, Vc]) f32, before suppression/penalty
    cb0: Optional[torch.Tensor]       # [1] ([B]) next frame's cb0 (when sampling)


def _rms(x, w, eps):
    """RMSNorm in float32 with the variance summed in float64 (then rounded
    to float32) and an IEEE reciprocal square root (1 / sqrt): torch.rsqrt
    on CUDA is approximate, and one ulp flips int8 activation roundings that
    then grow through 28 random-weight layers. The kernels (layer.cuh) sum
    in float64 too, so the result does not depend on summation order."""
    xd = x.double()
    var = (torch.sum(xd * xd, dim=-1, keepdim=True) / x.shape[-1]).float()
    return x * (1.0 / torch.sqrt(var + eps)) * w.float()


def mm_w8a8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] f32 @ int8 q [K, N] with scale [1, N]: the activation is
    quantized per row (s = max(amax, 1e-8) * (1/127), round half to even,
    clip to +-127); the integer dot runs in float64, where every partial sum
    of int8 products is exact, so it equals an int32 accumulation."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    s_act = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(x / s_act), -127.0, 127.0)
    acc = torch.matmul(xq.double(), q.double()).float()
    return acc * (s_act * scale.float())


def gqa_attention(q, K, V, p_dtype):
    """q [..., Hq, D] @ K [..., Hkv, S, D]^T * D^-0.5 -> softmax -> the
    probabilities rounded to float32, then to p_dtype -> @ V [..., Hkv, S,
    D]. Returns [..., Hq*D] float32. The dot products, exp and the softmax
    sum run in float64 and are rounded to float32 once, as in the kernels
    (layer.cuh), so that summation order cannot change a bit."""
    *lead, Hkv, _, D = K.shape
    s = torch.matmul(q.reshape(*lead, Hkv, -1, D).double(),
                     K.double().transpose(-1, -2)).float() * D ** -0.5
    e = torch.exp((s - torch.amax(s, dim=-1, keepdim=True)).double())
    p = (e / torch.sum(e, dim=-1, keepdim=True)).float().to(p_dtype)
    return torch.matmul(p.double(), V.double()).float().reshape(*lead, -1)


def w8a8_layer(blocks, cfg, l, x, cos, sin, attend):
    """One decoder layer of the plain K1/K2/K5/K6 on the tokens x [M, H]
    float32 (one per lane) with w8a8 projections. attend(q [M, Hq, D],
    k [M, Hkv, D], v [M, Hkv, D]) stores K/V and returns the attention
    output [M, Hq*D]."""
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F, eps, half = cfg.intermediate_size, cfg.rms_norm_eps, cfg.head_dim // 2

    def rope(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1)

    h = _rms(x, blocks.attn_norm[l], eps)
    heads = mm_w8a8(h, blocks.wqkv.q[l], blocks.wqkv.scale[l]).reshape(-1, Hq + 2 * Hkv, D)
    q = rope(_rms(heads[:, :Hq], blocks.q_norm[l], eps))
    k = rope(_rms(heads[:, Hq:Hq + Hkv], blocks.k_norm[l], eps))
    x = x + mm_w8a8(attend(q, k, heads[:, Hq + Hkv:]), blocks.wo.q[l], blocks.wo.scale[l])
    h = _rms(x, blocks.ffn_norm[l], eps)
    gu = mm_w8a8(h, blocks.w_gateup.q[l], blocks.w_gateup.scale[l])
    gate = gu[:, :F]
    gate = gate / (1.0 + torch.exp(-gate.double()).float())   # exp rounded once
    return x + mm_w8a8(gate * gu[:, F:], blocks.w_down.q[l], blocks.w_down.scale[l])


def talker_step_plain(blocks, cfg, step_embd, n_past, kv, *, p_dtype, output_norm,
                      codec_head, seen=None, seeds=None, temperature=1.0, top_p=1.0,
                      repetition_penalty=1.0, top_k=0, suppress_start=None, eos_id=-1,
                      greedy=False, use_top_p=True) -> StepOut:
    """Plain PyTorch version of K1 and K5 for B lanes: step_embd [B, H], kv
    [B, L, 2, Hkv, C, D] updated in place at n_past, seen [B, Vc] and seeds
    [B] when cb0 is sampled. q is rounded to the KV dtype, the softmax
    probabilities to p_dtype (the KV dtype in K1, float32 in K5)."""
    n = int(n_past)
    dev = kv.device
    B = step_embd.shape[0]
    cos, sin = _rope_row(n, cfg, dev, kv.shape[4])
    x = step_embd.float().reshape(B, cfg.hidden_size)
    for l in range(cfg.n_layers):
        def attend(q, k, v, l=l):
            kv[:, l, 0, :, n] = k.to(kv.dtype)
            kv[:, l, 1, :, n] = v.to(kv.dtype)
            return gqa_attention(q.to(kv.dtype).float(), kv[:, l, 0, :, :n + 1].float(),
                                 kv[:, l, 1, :, :n + 1].float(), p_dtype)

        x = w8a8_layer(blocks, cfg, l, x, cos, sin, attend)
    normed = _rms(x, output_norm, cfg.rms_norm_eps)
    logits = torch.matmul(normed.to(codec_head.dtype).float(), codec_head.float())
    cb0 = None
    if seen is not None:
        cb0 = sample_rows_plain(
            logits, torch.as_tensor(seeds, device=dev), 0,
            temperature=temperature, top_p=top_p, top_k=top_k, greedy=greedy,
            use_top_p=use_top_p,
            suppress_start=logits.shape[-1] if suppress_start is None else suppress_start,
            eos_id=eos_id, seen=seen, repetition_penalty=repetition_penalty)
    return StepOut(normed, logits, cb0)


def fused_talker_step_plain(blocks, cfg, step_embd, n_past, kv, *, seen=None, seed=0,
                            **kw) -> StepOut:
    """Plain PyTorch version of K1 (same semantics; kv updated in place):
    one lane of talker_step_plain, probabilities rounded to the KV dtype."""
    out = talker_step_plain(blocks, cfg, step_embd[None], n_past, kv[None], p_dtype=kv.dtype,
                            seen=None if seen is None else seen[None], seeds=[int(seed)],
                            **kw)
    return StepOut(out.hidden[0], out.logits[0], out.cb0)


@functools.lru_cache(maxsize=8)
def rope_table(n_pos: int, head_dim: int, theta: float, device):
    """cos/sin [n_pos, head_dim/2] for positions 0..n_pos-1, built once per
    shape and device (a row equals rope_angles of that one position: the
    same elementwise float32 ops)."""
    return rope_angles(torch.arange(n_pos, device=device), head_dim, theta)


def _rope_row(pos: int, cfg, device, capacity: int):
    """cos/sin [head_dim/2] of one position: row views of the cached table."""
    cos, sin = rope_table(capacity, cfg.head_dim, cfg.rope_theta, device)
    return cos[pos], sin[pos]


def check_w8a8_blocks(blocks):
    """The fused kernels are ported in their w8a8 mode only: other weight
    tiers (q4, q4pure, bf16) raise."""
    for w in (blocks.wqkv, blocks.wo, blocks.w_gateup, blocks.w_down):
        if not isinstance(w, QuantLinear):
            raise NotImplementedError("the fused kernels take int8 QuantLinear blocks "
                                      "(w8a8); other modes are not ported")


def _cuda_operands(blocks, cfg, kv, kv_shape, output_norm, codec_head):
    """Checks shared by K1 and K5, then the operands between (cos, sin) and
    the KV cache in their C signatures: the four norms (f32), the four
    projections' int8 q and f32 scales, the output norm (f32) and the codec
    head, contiguous."""
    if kv.dtype != torch.bfloat16 or codec_head.dtype != torch.bfloat16:
        raise NotImplementedError("the CUDA talker step takes a bf16 KV cache and codec head")
    if not kv.is_contiguous() or tuple(kv.shape) != tuple(kv_shape):
        raise ValueError(f"kv must be a contiguous {tuple(kv_shape)} cache, "
                         f"got {tuple(kv.shape)}")
    f32 = lambda t: t.float().contiguous()   # noqa: E731
    tensors = [f32(blocks.attn_norm), f32(blocks.q_norm), f32(blocks.k_norm),
               f32(blocks.ffn_norm)]
    for w in (blocks.wqkv, blocks.wo, blocks.w_gateup, blocks.w_down):
        tensors += [w.q.contiguous(), f32(w.scale)]
    return tensors + [f32(output_norm), codec_head.contiguous()]


def _dims(cfg, C, Vc):
    return (cfg.n_layers, cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.intermediate_size, C, Vc, float(cfg.rms_norm_eps))


def fused_talker_step(blocks, cfg, step_embd, n_past, kv, *, output_norm,
                      codec_head, seen=None, seed=0, temperature=1.0,
                      top_p=1.0, repetition_penalty=1.0, top_k=0,
                      suppress_start=None, eos_id=-1, greedy=False,
                      use_top_p=True) -> StepOut:
    """One talker decode step (see the module docstring).

    blocks: BlockParams with QuantLinear projections ([L, K, N] int8, scale
    [L, 1, N]); step_embd [H]; n_past: int; kv [L, 2, Hkv, C, D], written in
    place at n_past; codec_head [H, Vc]. When ``seen`` ([Vc] bool or int8)
    is given, the result's cb0 is next frame's codebook-0 token sampled with
    ``seed``. Norm weights and scales already in float32 and ``seen`` in
    int8 (as the pipeline and the decode loop keep them) are passed to the
    kernel without a copy.

    CPU tensors run the plain version. CUDA tensors launch the kernel (bf16
    KV cache and codec head) or raise; there is no fallback.
    """
    check_w8a8_blocks(blocks)
    if kv.device.type == "cpu":
        return fused_talker_step_plain(
            blocks, cfg, step_embd, n_past, kv, output_norm=output_norm,
            codec_head=codec_head, seen=seen, seed=seed,
            temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty, top_k=top_k,
            suppress_start=suppress_start, eos_id=eos_id, greedy=greedy,
            use_top_p=use_top_p)
    lib = _kernels.load_library()
    _kernels.require_cuda(kv, step_embd, codec_head, blocks.wqkv.q)
    H, L, Hkv, D = cfg.hidden_size, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    C, Vc = kv.shape[3], codec_head.shape[-1]
    tensors = _cuda_operands(blocks, cfg, kv, (L, 2, Hkv, C, D), output_norm, codec_head)
    n = int(n_past)
    if not 0 <= n < C:
        raise ValueError(f"n_past {n} outside the cache capacity {C}")
    dev = kv.device
    cos, sin = _rope_row(n, cfg, dev, C)
    x = step_embd.float().contiguous()
    hidden = torch.empty((H,), dtype=torch.float32, device=dev)
    logits = torch.empty((Vc,), dtype=torch.float32, device=dev)
    tok = torch.empty((1,), dtype=torch.int32, device=dev) if seen is not None else None
    seen8 = seen.to(torch.int8).contiguous() if seen is not None else None
    ws = torch.empty(lib.qtts_talker_ws_bytes(H, cfg.n_heads, Hkv, D, cfg.intermediate_size,
                                              C, Vc), dtype=torch.uint8, device=dev)
    err = lib.qtts_talker_step(
        x.data_ptr(), n, cos.data_ptr(), sin.data_ptr(), *[t.data_ptr() for t in tensors],
        kv.data_ptr(), *_dims(cfg, C, Vc),
        None if seen8 is None else seen8.data_ptr(), float(temperature),
        float(top_p), float(repetition_penalty), int(top_k), int(greedy),
        int(use_top_p), Vc if suppress_start is None else int(suppress_start),
        int(eos_id), int(seed), hidden.data_ptr(), logits.data_ptr(),
        None if tok is None else tok.data_ptr(), ws.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "fused_talker_step")
    fused_talker_step.launches += 1
    return StepOut(hidden, logits, tok)


fused_talker_step.launches = 0


def fused_talker_step_batched_plain(blocks, cfg, step_embd, n_past, kv,
                                    **kw) -> StepOut:
    """Plain PyTorch version of K5 (same semantics; kv updated in place):
    talker_step_plain with float32 probabilities."""
    return talker_step_plain(blocks, cfg, step_embd, n_past, kv, p_dtype=torch.float32, **kw)


def fused_talker_step_batched(blocks, cfg, step_embd, n_past, kv, *, output_norm,
                              codec_head, seen=None, seeds=None, temperature=1.0,
                              top_p=1.0, repetition_penalty=1.0, top_k=0,
                              suppress_start=None, eos_id=-1, greedy=False,
                              use_top_p=True) -> StepOut:
    """One talker decode step for B lockstep lanes (kernel K5; counterpart
    of the Pallas ``fused_talker_step_batched``, batch-major, w8a8).

    step_embd [B, H]; n_past: int, shared by the lanes; kv [B, L, 2, Hkv, C,
    D], each lane's row written in place at n_past. Returns StepOut with
    hidden [B, H] (output-normed, f32), logits [B, Vc] f32 and, when
    ``seen`` ([B, Vc] bool or int8) is given, cb0 [B]: each lane's next
    codebook-0 token sampled with seeds[b] (int32 [B]). Unlike K1, the
    attention keeps its probabilities in float32, as the batched Pallas
    kernel does. B <= 128.

    CPU tensors run the plain version. CUDA tensors launch the kernel (bf16
    KV cache and codec head) or raise; there is no fallback.
    """
    check_w8a8_blocks(blocks)
    B = step_embd.shape[0]
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"fused_talker_step_batched takes 1..{MAX_LANES} lanes, got {B}")
    if seen is not None and seeds is None:
        raise ValueError("sampling cb0 needs per-lane seeds")
    if kv.device.type == "cpu":
        return fused_talker_step_batched_plain(
            blocks, cfg, step_embd, n_past, kv, output_norm=output_norm,
            codec_head=codec_head, seen=seen, seeds=seeds, temperature=temperature,
            top_p=top_p, repetition_penalty=repetition_penalty, top_k=top_k,
            suppress_start=suppress_start, eos_id=eos_id, greedy=greedy,
            use_top_p=use_top_p)
    lib = _kernels.load_library()
    _kernels.require_cuda(kv, step_embd, codec_head, blocks.wqkv.q)
    H, L, Hkv, D = cfg.hidden_size, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    C, Vc = kv.shape[4], codec_head.shape[-1]
    tensors = _cuda_operands(blocks, cfg, kv, (B, L, 2, Hkv, C, D), output_norm, codec_head)
    n = int(n_past)
    if not 0 <= n < C:
        raise ValueError(f"n_past {n} outside the cache capacity {C}")
    dev = kv.device
    cos, sin = _rope_row(n, cfg, dev, C)
    x = step_embd.float().contiguous()
    hidden = torch.empty((B, H), dtype=torch.float32, device=dev)
    logits = torch.empty((B, Vc), dtype=torch.float32, device=dev)
    tok = seen8 = seeds32 = None
    if seen is not None:
        tok = torch.empty((B,), dtype=torch.int32, device=dev)
        seen8 = seen.to(torch.int8).contiguous()
        seeds32 = torch.as_tensor(seeds, dtype=torch.int32, device=dev).contiguous()
        if tuple(seen8.shape) != (B, Vc) or tuple(seeds32.shape) != (B,):
            raise ValueError("seen must be [B, Vc] and seeds [B]")
    ws = torch.empty(lib.qtts_talker_batched_ws_bytes(B, H, cfg.n_heads, Hkv, D,
                                                      cfg.intermediate_size, C, Vc),
                     dtype=torch.uint8, device=dev)
    err = lib.qtts_talker_step_batched(
        x.data_ptr(), B, n, cos.data_ptr(), sin.data_ptr(), *[t.data_ptr() for t in tensors],
        kv.data_ptr(), *_dims(cfg, C, Vc),
        None if seen8 is None else seen8.data_ptr(),
        None if seeds32 is None else seeds32.data_ptr(), float(temperature), float(top_p),
        float(repetition_penalty), int(top_k), int(greedy), int(use_top_p),
        Vc if suppress_start is None else int(suppress_start), int(eos_id),
        hidden.data_ptr(), logits.data_ptr(), None if tok is None else tok.data_ptr(),
        ws.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check(err, "fused_talker_step_batched")
    fused_talker_step_batched.launches += 1
    return StepOut(hidden, logits, tok)


fused_talker_step_batched.launches = 0
