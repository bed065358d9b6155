"""K2: the 15 residual codes of one frame (the code predictor's inner loop).

Counterpart of ``qwen3tts_tpu/ops/pallas_code_predictor.py``: replaces the
Pallas kernel ``fused_predict_codes`` (:260) in its w8a8 mode, with one
cooperative launch per frame of the persistent CUDA kernel in
``csrc/code_predictor_persistent.cuh`` (entry ``csrc/code_predictor.cu``,
whose source says what bounds it: the ~78.6 MB int8 block stack, re-read by
each of the 16 passes because it does not fit on chip).

Pass 0 runs the talker hidden through the layers (conditioning only). Pass
p = 1..15 feeds the cb0 embedding (p = 1) or embds[p-2][code_{p-2}], then
samples code p-1 from heads[p-1] at sampler step p with the frame's seed.
Returns (codes [15], rest_sum [H] f32) with rest_sum = sum_s
embds[s][code_s] summed in order of s. ``predict_codes_plain`` is the plain
version of this kernel and of its batched counterpart K6
(``fused_code_predictor_batched.py``).

The blocks are int8, as the Pallas kernel reads them; the heads and the
embedding tables are bf16, or float32 in the float32 tier
(``RuntimeConfig(dtype="float32", quant="int8")``), where the kernels take
them as they are (the Pallas kernel's ``astype`` to the embedding dtype is
then a no-op).
"""

from __future__ import annotations

import functools

import torch

from .. import _kernels
from . import library
from .fused_talker_step import (_rms, blocks_of, check_w8a8_blocks, gqa_attention, layer_plain,
                                rope_table)
from .library import as_int
from .kernel_prng import make_sampler
from .sampling import sample_rows


def _rope_tables(cfg, device):
    """cos/sin [max_ctx, head_dim/2] for positions 0..max_ctx-1."""
    return rope_table(cfg.max_ctx, cfg.head_dim, cfg.rope_theta, device)


def _xinit(cp_params, talker_hidden, cb0_embd):
    """[2, ..., H] float32: the talker hidden and the cb0 embedding, both
    rounded to the embedding dtype."""
    dt = cp_params.embds.dtype
    return torch.stack([talker_hidden.to(dt), cb0_embd.to(dt)]).float()


def predict_codes_plain(cp_params, cfg, talker_hidden, cb0_embd, seeds, *, kv_dtype,
                        temperature, top_k, top_p=1.0, greedy=False, use_top_p=True):
    """Plain PyTorch version of K2 and K6 for B lanes: talker_hidden and
    cb0_embd [B, H], seeds int [B], temperature and top_p scalars or [B]
    (``kernel_prng.per_row``). K/V rows are stored rounded to kv_dtype
    (float32 in K2, the embedding dtype in K6); attention rounds neither q
    nor p. Returns (codes [B, 15] int64, rest_sum [B, H] f32)."""
    L, S, V, eps = cfg.n_layers, cfg.n_steps, cfg.vocab_size, cfg.rms_norm_eps
    dev = cp_params.embds.device
    B = talker_hidden.shape[0]
    cos_t, sin_t = _rope_tables(cfg, dev)
    sample = make_sampler(top_k, V, greedy=greedy, use_top_p=use_top_p)
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=dev).reshape(B, 1)
    kc = [[] for _ in range(L)]      # K/V rows [B, Hkv, D] of positions 0..p, per layer
    vc = [[] for _ in range(L)]

    def layer_pass(x, p):
        for l in range(L):
            def attend(q, k, v, l=l):
                kc[l].append(k.to(kv_dtype).float())
                vc[l].append(v.to(kv_dtype).float())
                return gqa_attention(q, torch.stack(kc[l], dim=2), torch.stack(vc[l], dim=2),
                                     torch.float32)

            x = layer_plain(cp_params.blocks, cfg, l, x, cos_t[p], sin_t[p], attend)
        return x

    xinit = _xinit(cp_params, talker_hidden, cb0_embd)
    layer_pass(xinit[0], 0)
    rest_sum = torch.zeros((B, cfg.hidden_size), dtype=torch.float32, device=dev)
    codes = []
    for p in range(1, S + 1):
        if p == 1:
            emb = xinit[1]
        else:
            emb = cp_params.embds[p - 2, codes[-1]].float()
            rest_sum = rest_sum + emb
        x = layer_pass(emb, p)
        h = _rms(x, cp_params.output_norm, eps).to(cp_params.heads.dtype).float()
        logits = torch.matmul(h, cp_params.heads[p - 1].float())
        codes.append(sample(logits, temperature, top_p, seeds, p))
    rest_sum = rest_sum + cp_params.embds[S - 1, codes[-1]].float()
    return torch.stack(codes, dim=1), rest_sum


def fused_predict_codes_plain(cp_params, cfg, talker_hidden, cb0_embd, seed, *,
                              temperature, top_k, top_p=1.0, greedy=False,
                              use_top_p=True):
    """Plain PyTorch version of K2 (one lane, float32 KV)."""
    codes, rest_sum = predict_codes_plain(
        cp_params, cfg, talker_hidden[None], cb0_embd[None], [int(seed)],
        kv_dtype=torch.float32, temperature=temperature, top_k=top_k, top_p=top_p,
        greedy=greedy, use_top_p=use_top_p)
    return codes[0], rest_sum[0]


def emb_f32(cp_params) -> bool:
    """Whether the CUDA code predictors take float32 heads and embedding
    tables (else bf16); both must have one dtype, bf16 or float32."""
    dts = {cp_params.embds.dtype, cp_params.heads.dtype}
    if len(dts) != 1 or not dts <= {torch.bfloat16, torch.float32}:
        raise NotImplementedError(f"the CUDA code predictor takes bf16 or float32 heads and "
                                  f"embeddings of one dtype, got {sorted(map(str, dts))}")
    return cp_params.embds.dtype == torch.float32


def cuda_operands(cp_params, cfg):
    """The operands both CUDA code predictors (K2, K6) take after the
    activations: (tensors, dims) with tensors = [cos, sin, five norms (f32),
    the four projections' int8 q and f32 scales, heads, embds], contiguous,
    and dims = (L, H, Hq, Hkv, D, F, V, CTX, S, eps)."""
    blocks = cp_params.blocks
    _kernels.require_cuda(cp_params.embds, cp_params.heads, blocks.wqkv.q)
    emb_f32(cp_params)
    f32 = lambda t: t.float().contiguous()   # noqa: E731
    tensors = list(_rope_tables(cfg, cp_params.embds.device))
    tensors += [f32(blocks.attn_norm), f32(blocks.q_norm), f32(blocks.k_norm),
                f32(blocks.ffn_norm), f32(cp_params.output_norm)]
    for w in (blocks.wqkv, blocks.wo, blocks.w_gateup, blocks.w_down):
        tensors += [w.q.contiguous(), f32(w.scale)]
    tensors += [cp_params.heads.contiguous(), cp_params.embds.contiguous()]
    dims = (cfg.n_layers, cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.intermediate_size, cfg.vocab_size, cfg.max_ctx, cfg.n_steps,
            float(cfg.rms_norm_eps))
    return tensors, dims


def predictor_dims(cfg):
    """The op's dims of a code-predictor config: (n_layers, hidden_size,
    n_heads, n_kv_heads, head_dim, intermediate_size, vocab_size,
    n_codebooks)."""
    return (cfg.n_layers, cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.intermediate_size, cfg.vocab_size, cfg.n_codebooks)


@functools.lru_cache(maxsize=16)
def predictor_config(dims, eps, rope_theta):
    """A CodePredictorConfig of the op's dims (the fields the kernels read)."""
    from ..config import CodePredictorConfig
    L, H, Hq, Hkv, D, F, V, N = dims
    return CodePredictorConfig(n_layers=L, hidden_size=H, n_heads=Hq, n_kv_heads=Hkv,
                               head_dim=D, intermediate_size=F, vocab_size=V, n_codebooks=N,
                               rms_norm_eps=eps, rope_theta=rope_theta)


def _predict_args(talker_hidden, cb0_embd, *args):
    """(cp_params, cfg, keyword arguments) of the code-predictor op's
    operands."""
    from ..models.code_predictor import CodePredictorParams

    norms, output_norm, proj = args[:4], args[4], args[5:13]
    heads, embds, seed, temperature, top_p, top_k, greedy, use_top_p, dims, eps, theta = args[13:]
    blocks = blocks_of(list(norms) + [t for j in range(4) for t in (*proj[2 * j:2 * j + 2], None)])
    kw = dict(temperature=temperature, top_p=top_p, top_k=top_k, greedy=greedy,
              use_top_p=use_top_p)
    return (CodePredictorParams(blocks, output_norm, embds, heads),
            predictor_config(tuple(dims), eps, theta), seed, kw)


def _predict_codes_cpu(talker_hidden, cb0_embd, *args):
    """The code-predictor op's CPU kernel: the plain version, its codes in
    the kernel's int32."""
    cp_params, cfg, seed, kw = _predict_args(talker_hidden, cb0_embd, *args)
    codes, rest_sum = fused_predict_codes_plain(cp_params, cfg, talker_hidden, cb0_embd, seed,
                                                **kw)
    return codes.to(torch.int32), rest_sum


def _predict_codes_cuda(talker_hidden, cb0_embd, *args):
    """The code-predictor op's CUDA kernel: launch K2."""
    cp_params, cfg, seed, kw = _predict_args(talker_hidden, cb0_embd, *args)
    return launch_predict_codes(cp_params, cfg, talker_hidden, cb0_embd, seed, **kw)


def launch_predict_codes(cp_params, cfg, talker_hidden, cb0_embd, seed, *, temperature, top_k,
                         top_p, greedy, use_top_p):
    """One cooperative launch of K2 (the code-predictor op's CUDA kernel),
    counted on ``fused_predict_codes`` (and, with float32 heads and
    embeddings, in its ``operand_launches["f32"]``). The kernel's KV scratch
    [2, L, Hkv, 16, D] f32 is allocated here with torch.empty."""
    lib = _kernels.load_library()
    _kernels.require_cuda(talker_hidden, cb0_embd)
    tensors, dims = cuda_operands(cp_params, cfg)
    L, H, Hq, Hkv, D, F, V, CTX, S, _ = dims
    dev = cp_params.embds.device
    xinit = _xinit(cp_params, talker_hidden, cb0_embd).contiguous()
    codes = torch.empty((S,), dtype=torch.int32, device=dev)
    rest_sum = torch.empty((H,), dtype=torch.float32, device=dev)   # zeroed by the kernel
    kv = torch.empty((2, L, Hkv, CTX, D), dtype=torch.float32, device=dev)
    f32 = int(emb_f32(cp_params))
    ws = torch.empty(lib.qtts_cp_ws_bytes(H, Hq, Hkv, D, F, CTX, V, f32),
                     dtype=torch.uint8, device=dev)
    err = lib.qtts_code_predictor(
        xinit.data_ptr(), *[t.data_ptr() for t in tensors], f32, *dims,
        float(temperature), float(top_p), int(top_k), int(greedy),
        int(use_top_p), int(seed), codes.data_ptr(), rest_sum.data_ptr(),
        kv.data_ptr(), ws.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check(err, "fused_predict_codes")
    fused_predict_codes.launches += 1
    if f32:
        ops = fused_predict_codes.operand_launches
        ops["f32"] = ops.get("f32", 0) + 1
    sample_rows.site_rows["K2"] += S
    return codes, rest_sum


def predict_codes_operands(cp_params, cfg, talker_hidden, cb0_embd, seed, *, temperature,
                           top_k, top_p=1.0, greedy=False, use_top_p=True):
    """The operands of the op ``qwen3tts::predict_codes``
    (``ops/library.py``) for fused_predict_codes' arguments."""
    b = cp_params.blocks
    return (talker_hidden, cb0_embd, b.attn_norm, b.q_norm, b.k_norm, b.ffn_norm,
            cp_params.output_norm, b.wqkv.q, b.wqkv.scale, b.wo.q, b.wo.scale, b.w_gateup.q,
            b.w_gateup.scale, b.w_down.q, b.w_down.scale, cp_params.heads, cp_params.embds,
            as_int(seed), float(temperature), float(top_p), int(top_k), bool(greedy),
            bool(use_top_p), predictor_dims(cfg), float(cfg.rms_norm_eps), float(cfg.rope_theta))


def fused_predict_codes(cp_params, cfg, talker_hidden, cb0_embd, seed, **kw):
    """Returns (codes [15] int32, rest_sum [H] f32); see the module
    docstring. Runs the op ``qwen3tts::predict_codes`` (``ops/library.py``);
    seed is an int (a SymInt under torch.export); keywords: temperature,
    top_k, top_p, greedy, use_top_p (``predict_codes_operands``).

    CPU tensors run the plain version. CUDA tensors make one cooperative
    launch of the persistent kernel (bf16 or float32 heads and embedding
    tables) or raise, also when the grid cannot be co-resident or the device
    refuses the cooperative launch; there is no fallback.
    """
    check_w8a8_blocks(cp_params.blocks)
    return torch.ops.qwen3tts.predict_codes.default(
        *predict_codes_operands(cp_params, cfg, talker_hidden, cb0_embd, seed, **kw))


fused_predict_codes.launches = 0
# launches with float32 heads and embeddings ("f32")
fused_predict_codes.operand_launches = {}
library.implement("predict_codes", cpu=_predict_codes_cpu, cuda=_predict_codes_cuda)


def kernel_grid(cfg, B=None, f32=False):
    """The grid of one CUDA call of K2 (B None) or K6 for B lanes at cfg's
    shapes (f32: float32 heads and embeddings), on the current device:
    dict(blocks, barriers (grid barriers per call), blocks_per_sm, sms,
    smem_bytes (dynamic shared memory per block)). Raises as the launch
    would when the shapes are refused or the grid cannot be co-resident."""
    import ctypes

    lib = _kernels.load_library()
    out = (ctypes.c_int * 5)()
    dims = (cfg.n_layers, cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.intermediate_size, cfg.vocab_size, cfg.max_ctx, cfg.n_steps)
    if B is None:
        err = lib.qtts_cp_grid(*dims, int(f32), ctypes.addressof(out))
    else:
        err = lib.qtts_cp_batched_grid(int(B), *dims, int(f32), ctypes.addressof(out))
    _kernels.check(err, "code predictor grid")
    return dict(zip(("blocks", "barriers", "blocks_per_sm", "sms", "smem_bytes"), list(out)))
