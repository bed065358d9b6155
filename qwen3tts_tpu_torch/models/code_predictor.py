"""The code predictor: the 5-layer transformer that emits codebooks 1..15 of
each frame (counterpart of ``qwen3tts_tpu/models/code_predictor.py``).

The fused path runs its per-frame loop in kernel K2
(``ops/fused_code_predictor.py``): a pass over the talker hidden, then one
pass per code with the per-step embedding tables ``embds[s]`` and LM heads
``heads[s]``. The unfused path runs ``predict_codes`` here: a 2-token
prefill and 14 single-token steps of ``transformer_core.forward_step``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import prng
from ..ops.kernel_prng import sampling_flags
from ..ops.norms import rms_norm
from ..ops.sampling import sample_token
from ..parallel.collectives import full_columns, gather_columns
from .transformer_core import (BlockParams, forward_prefill, forward_step, init_block_params,
                               normal_init)


class CodePredictorParams(NamedTuple):
    blocks: BlockParams         # stacked x 5
    output_norm: torch.Tensor   # [H]
    embds: torch.Tensor         # [15, V, H] code_pred_embd.{0..14}
    heads: torch.Tensor         # [15, H, V] lm_head.{0..14}


def init_code_predictor_params(gen: torch.Generator, cfg, dtype=torch.bfloat16,
                               device="cpu") -> CodePredictorParams:
    """Synthetic weights at the configured (full) widths, drawn from `gen`."""
    w = normal_init(gen, device, dtype)
    H, V, S = cfg.hidden_size, cfg.vocab_size, cfg.n_steps
    return CodePredictorParams(
        blocks=init_block_params(gen, cfg, H, cfg.intermediate_size, dtype, device),
        output_norm=torch.ones((H,), dtype=dtype, device=device),
        embds=w((S, V, H), H),
        heads=w((S, H, V), H),
    )


def code_keys(keys, n: int) -> np.ndarray:
    """The keys of a frame's n draws for each lane's key [B, 2] (numpy):
    ``key, k = split(key)`` before each draw, as the JAX package's
    ``predict_codes`` chains them (``code_predictor.py:93, 103``). Returns
    [B, n, 2]."""
    out = []
    for _ in range(n):
        s = prng.split(keys)
        keys = s[:, 0]
        out.append(s[:, 1])
    return np.stack(out, axis=1)


def predict_codes(params: CodePredictorParams, cfg, talker_hidden: torch.Tensor,
                  cb0_embd: torch.Tensor, key, *, temperature, top_k: int,
                  top_p=1.0, greedy=None, use_top_p=None) -> torch.Tensor:
    """The 15 residual codes of one frame, unfused (counterpart of
    ``predict_codes``, ``qwen3tts_tpu/models/code_predictor.py:68-108``).

    talker_hidden (output-normed) and cb0_embd are [H] with one key (a
    pair), or [B, H] lanes with keys [B, 2] (numpy); key may also be the
    frame's code keys already split, [B, 15, 2] (``code_keys``; numpy, or
    an int64 tensor as an exported program takes them). A 2-token prefill at
    positions 0, 1 gives code 0 from heads[0]; step s = 1..14 feeds
    embds[s-1][code s-1] at position s+1 and takes code s from heads[s]. The
    cache holds max_ctx = 16 rows, so attention takes the XLA semantics
    (ops/attention.py). Code s is drawn by sample_token with the Gumbel
    field of the lane's s-th key (``code_keys``), which is
    ``jax.random.categorical`` with that key. The keys of a frame are known
    before any logits, so its 15 fields (every code, every lane) come from
    one ``prng.gumbel`` pass. temperature and top_p are scalars, or per lane
    [B] (continuous serving; greedy and use_top_p then given). Returns
    int64 [15] (or [B, 15])."""
    if greedy is None or use_top_p is None:
        greedy, use_top_p = sampling_flags(temperature, top_p)
    lanes = talker_hidden.dim() == 2
    th = talker_hidden if lanes else talker_hidden[None]
    ce = cb0_embd if lanes else cb0_embd[None]
    B, dt, dev = th.shape[0], params.embds.dtype, params.embds.device
    S, V = cfg.n_steps, full_columns(params.heads)
    noise = None
    if not greedy:
        ks = (key if getattr(key, "ndim", 0) == 3
              else code_keys(prng.key_array(key).reshape(B, 2), S))
        noise = prng.gumbel(ks.reshape(B * S, 2), V, dev).reshape(B, S, V)
    kv = torch.zeros((B, cfg.n_layers, 2, cfg.n_kv_heads, cfg.max_ctx, cfg.head_dim),
                     dtype=dt, device=dev)

    def sample(hidden, s):
        h = rms_norm(hidden, params.output_norm, cfg.rms_norm_eps)
        logits = torch.matmul(h.float(), params.heads[s].float()).to(h.dtype).float()
        logits = gather_columns(logits, params.heads)
        return sample_token(logits, None if noise is None else noise[:, s],
                            temperature=temperature, top_k=top_k, top_p=top_p,
                            greedy=greedy, use_top_p=use_top_p)

    x = torch.stack([th, ce], dim=1).to(dt)                       # [B, 2, H]
    hidden = forward_prefill(params.blocks, cfg, x, torch.arange(2, device=dev), kv, 0)
    codes = [sample(hidden[:, -1], 0)]
    for s in range(1, S):
        emb = params.embds[s - 1, codes[-1]]
        codes.append(sample(forward_step(params.blocks, cfg, emb, s + 1, kv), s))
    out = torch.stack(codes, dim=1)
    return out if lanes else out[0]
