"""K2: the 15 residual codes of one frame (the code predictor's inner loop).

Counterpart of ``qwen3tts_tpu/ops/pallas_code_predictor.py``: replaces the
Pallas kernel ``fused_predict_codes`` (:260) in its w8a8 mode, with the CUDA
kernel in ``csrc/code_predictor.cu`` (whose source says what bounds it: the
~78.5 MB int8 block stack, re-read by each of the 16 passes because it does
not fit on chip).

Pass 0 runs the talker hidden through the layers (conditioning only). Pass
p = 1..15 feeds the cb0 embedding (p = 1) or embds[p-2][code_{p-2}], then
samples code p-1 from heads[p-1] at sampler step p with the frame's seed.
Returns (codes [15], rest_sum [H] f32) with rest_sum = sum_s
embds[s][code_s] summed in order of s.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .fused_talker_step import _rms, check_w8a8_blocks, gqa_attention, rope_table, w8a8_layer
from .kernel_prng import make_sampler


def _rope_tables(cfg, device):
    """cos/sin [max_ctx, head_dim/2] for positions 0..max_ctx-1."""
    return rope_table(cfg.max_ctx, cfg.head_dim, cfg.rope_theta, device)


def _xinit(cp_params, talker_hidden, cb0_embd):
    dt = cp_params.embds.dtype
    return torch.stack([talker_hidden.to(dt), cb0_embd.to(dt)]).float()


def fused_predict_codes_plain(cp_params, cfg, talker_hidden, cb0_embd, seed, *,
                              temperature, top_k, top_p=1.0, greedy=False,
                              use_top_p=True):
    """Plain PyTorch version of K2."""
    L, S, V, eps = cfg.n_layers, cfg.n_steps, cfg.vocab_size, cfg.rms_norm_eps
    dev = cp_params.embds.device
    cos_t, sin_t = _rope_tables(cfg, dev)
    sample = make_sampler(top_k, V, greedy=greedy, use_top_p=use_top_p)
    kc = [[] for _ in range(L)]      # float32 K/V rows of positions 0..p, per layer
    vc = [[] for _ in range(L)]

    def layer_pass(x, p):
        for l in range(L):
            def attend(q, k, v, l=l):
                kc[l].append(k)
                vc[l].append(v)
                return gqa_attention(q, torch.stack(kc[l], dim=1),
                                     torch.stack(vc[l], dim=1), torch.float32)

            x = w8a8_layer(cp_params.blocks, cfg, l, x, cos_t[p], sin_t[p], attend)
        return x

    xinit = _xinit(cp_params, talker_hidden, cb0_embd)
    layer_pass(xinit[0:1], 0)
    rest_sum = torch.zeros((1, cfg.hidden_size), dtype=torch.float32, device=dev)
    codes = []
    for p in range(1, S + 1):
        if p == 1:
            emb = xinit[1:2]
        else:
            emb = cp_params.embds[p - 2, codes[-1]].float()[None]
            rest_sum = rest_sum + emb
        x = layer_pass(emb, p)
        h = _rms(x, cp_params.output_norm, eps).to(cp_params.heads.dtype).float()
        logits = torch.matmul(h, cp_params.heads[p - 1].float())
        codes.append(int(sample(logits, temperature, top_p, int(seed), p)[0]))
    rest_sum = rest_sum + cp_params.embds[S - 1, codes[-1]].float()[None]
    return torch.tensor(codes, dtype=torch.int64, device=dev), rest_sum[0]


def fused_predict_codes(cp_params, cfg, talker_hidden, cb0_embd, seed, *,
                        temperature, top_k, top_p=1.0, greedy=False,
                        use_top_p=True):
    """Returns (codes [15], rest_sum [H] f32); see the module docstring.

    CPU tensors run the plain version. CUDA tensors launch the kernel (bf16
    heads and embedding tables) or raise; there is no fallback. The kernel's
    KV scratch [2, L, Hkv, 16, D] f32 is allocated here with torch.empty.
    """
    check_w8a8_blocks(cp_params.blocks)
    if cp_params.embds.device.type == "cpu":
        return fused_predict_codes_plain(
            cp_params, cfg, talker_hidden, cb0_embd, seed,
            temperature=temperature, top_k=top_k, top_p=top_p, greedy=greedy,
            use_top_p=use_top_p)
    lib = _kernels.load_library()
    blocks = cp_params.blocks
    _kernels.require_cuda(cp_params.embds, cp_params.heads, talker_hidden,
                          cb0_embd, blocks.wqkv.q)
    if cp_params.embds.dtype != torch.bfloat16 or cp_params.heads.dtype != torch.bfloat16:
        raise NotImplementedError("the CUDA code predictor takes bf16 heads and embeddings")
    H, L = cfg.hidden_size, cfg.n_layers
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F, V, CTX, S = cfg.intermediate_size, cfg.vocab_size, cfg.max_ctx, cfg.n_steps
    dev = cp_params.embds.device
    cos_t, sin_t = _rope_tables(cfg, dev)
    f32 = lambda t: t.float().contiguous()   # noqa: E731
    xinit = _xinit(cp_params, talker_hidden, cb0_embd).contiguous()
    norms = [f32(blocks.attn_norm), f32(blocks.q_norm), f32(blocks.k_norm),
             f32(blocks.ffn_norm), f32(cp_params.output_norm)]
    wts = []
    for w in (blocks.wqkv, blocks.wo, blocks.w_gateup, blocks.w_down):
        wts += [w.q.contiguous(), f32(w.scale)]
    heads, embds = cp_params.heads.contiguous(), cp_params.embds.contiguous()
    codes = torch.empty((S,), dtype=torch.int32, device=dev)
    rest_sum = torch.zeros((H,), dtype=torch.float32, device=dev)
    kv = torch.empty((2, L, Hkv, CTX, D), dtype=torch.float32, device=dev)
    ws = torch.empty(lib.qtts_cp_ws_bytes(H, Hq, Hkv, D, F, CTX, V),
                     dtype=torch.uint8, device=dev)
    err = lib.qtts_code_predictor(
        xinit.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
        *[t.data_ptr() for t in norms], *[t.data_ptr() for t in wts],
        heads.data_ptr(), embds.data_ptr(),
        L, H, Hq, Hkv, D, F, V, CTX, S, float(cfg.rms_norm_eps),
        float(temperature), float(top_p), int(top_k), int(greedy),
        int(use_top_p), int(seed), codes.data_ptr(), rest_sum.data_ptr(),
        kv.data_ptr(), ws.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check(err, "fused_predict_codes")
    fused_predict_codes.launches += 1
    return codes, rest_sum


fused_predict_codes.launches = 0
