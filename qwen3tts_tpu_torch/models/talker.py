"""The talker: the 28-layer autoregressive codec-token transformer and its
prefill conditioning (counterpart of ``qwen3tts_tpu/models/talker.py``).

The prefill window has a fixed layout (10 rows, or 9 for "nothink"):

    pos 0..2   text_projection(im_start, assistant, newline)
    pos 3..6   tts_pad + codec_embedding(think, think_bos, lang, think_eos)
    pos 7      tts_pad + speaker embedding (zeros = default voice)
    pos 8      tts_bos + codec_embedding(codec_pad)
    pos 9      text_projection(first_text_token) + codec_embedding(codec_bos)

followed, one row per frame, by the trailing-text schedule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.norms import rms_norm
from ..parallel.collectives import gather_columns, matmul_rows
from .transformer_core import (BlockParams, forward_prefill, forward_step, init_block_params,
                               normal_init)


class TalkerParams(NamedTuple):
    text_embd: torch.Tensor        # [Vt, Et]
    text_proj_fc1_w: torch.Tensor  # [Et, Et]
    text_proj_fc1_b: torch.Tensor  # [Et]
    text_proj_fc2_w: torch.Tensor  # [Et, H]
    text_proj_fc2_b: torch.Tensor  # [H]
    codec_embd: torch.Tensor       # [Vc, H]
    blocks: BlockParams            # stacked x 28
    output_norm: torch.Tensor      # [H]
    codec_head: torch.Tensor       # [H, Vc]


class PrefillInputs(NamedTuple):
    prefill_embd: torch.Tensor     # [R, 10 (or 9), H]
    trailing: torch.Tensor         # [R, Trb, H]: text rows, tts_eos, then tts_pad
    trailing_len: torch.Tensor     # [R] (one request: the fields without R, an int)


def init_talker_params(gen: torch.Generator, cfg, dtype=torch.bfloat16,
                       device="cpu") -> TalkerParams:
    """Synthetic weights at the configured (full) widths, drawn from `gen`
    (a torch.Generator on `device`)."""
    w = normal_init(gen, device, dtype)
    Et, H = cfg.text_embd_dim, cfg.hidden_size
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)   # noqa: E731
    return TalkerParams(
        text_embd=w((cfg.text_vocab_size, Et), Et),
        text_proj_fc1_w=w((Et, Et), Et),
        text_proj_fc1_b=zeros(Et),
        text_proj_fc2_w=w((Et, H), Et),
        text_proj_fc2_b=zeros(H),
        codec_embd=w((cfg.codec_vocab_size, H), H),
        blocks=init_block_params(gen, cfg, H, cfg.intermediate_size, dtype, device),
        output_norm=torch.ones((H,), dtype=dtype, device=device),
        codec_head=w((H, cfg.codec_vocab_size), H),
    )


def _linear(x, w, b):
    """x @ w + b; w split over its input rows (fc2 on a tensor-parallel
    shard) sums the float32 products over "tp" before the cast and the
    (replicated) bias."""
    return matmul_rows(x, w, w) + b


def project_text_tokens(params: TalkerParams, tokens: torch.Tensor) -> torch.Tensor:
    """text_embedding -> fc1 -> SiLU -> fc2; tokens int [T] -> [T, H]."""
    x = params.text_embd[tokens]
    x = _linear(x, params.text_proj_fc1_w, params.text_proj_fc1_b)
    x = torch.nn.functional.silu(x.float()).to(params.text_proj_fc1_w.dtype)
    return _linear(x, params.text_proj_fc2_w, params.text_proj_fc2_b)


def build_prefill(params: TalkerParams, cfg, tokens: torch.Tensor, n_tokens,
                  speaker_embd: torch.Tensor, language_id, *,
                  nothink: bool = False) -> PrefillInputs:
    """The prefill windows and the per-frame trailing-text schedules of R
    requests at once (the JAX package's vmap): padded token ids tokens [R,
    Tb] with n_tokens [R] real ones, language_id [R] (or one int for all)
    and speaker_embd [R, H], giving [R, ...] fields, each row what the JAX
    package's single call computes. One request, tokens [Tb] and
    speaker_embd [H] with int n_tokens and language_id, is row 0 of R = 1."""
    if tokens.dim() == 1:
        pre = build_prefill(params, cfg, tokens[None], [int(n_tokens)], speaker_embd[None],
                            [int(language_id)], nothink=nothink)
        return PrefillInputs(pre.prefill_embd[0], pre.trailing[0], int(n_tokens) - 8)
    dev = params.codec_embd.device
    dtype = params.codec_embd.dtype
    R, Tb = tokens.shape
    tokens = tokens.to(device=dev, dtype=torch.int64)
    proj_all = project_text_tokens(params, tokens)              # [R, Tb, H]
    specials = project_text_tokens(params, torch.tensor(
        [cfg.tts_bos_token_id, cfg.tts_eos_token_id, cfg.tts_pad_token_id], device=dev))
    tts_bos, tts_eos, tts_pad = specials[0], specials[1], specials[2]
    role, first_text = proj_all[:, 0:3], proj_all[:, 3]
    if nothink:
        ids = torch.tensor([cfg.codec_nothink_id, cfg.codec_think_bos_id,
                            cfg.codec_think_eos_id], device=dev).expand(R, 3)
    else:
        lang = torch.as_tensor(language_id, dtype=torch.int64, device=dev).expand(R)
        ids = torch.stack([torch.full((R,), cfg.codec_think_id, device=dev),
                           torch.full((R,), cfg.codec_think_bos_id, device=dev), lang,
                           torch.full((R,), cfg.codec_think_eos_id, device=dev)], dim=-1)
    codec_prefill = params.codec_embd[ids]                      # [R, 3|4, H]
    H = codec_prefill.shape[-1]
    overlay = torch.cat([
        codec_prefill + tts_pad,
        (speaker_embd.to(device=dev, dtype=dtype) + tts_pad)[:, None],
        (params.codec_embd[cfg.codec_pad_id] + tts_bos).expand(R, 1, H),
    ], dim=1)
    last_row = (first_text + params.codec_embd[cfg.codec_bos_id])[:, None]
    prefill_embd = torch.cat([role, overlay, last_row], dim=1)

    # trailing schedule: proj(tokens[4 : n_tokens-5]) ++ [tts_eos], then tts_pad
    count = torch.as_tensor(n_tokens, device=dev).expand(R)[:, None, None] - 9
    Trb = Tb - 3
    idx = torch.arange(Trb, device=dev)[:, None]
    rows = proj_all[:, torch.clamp(4 + idx[:, 0], 0, Tb - 1)]
    trailing = torch.where(
        idx < count, rows, torch.where(idx == count, tts_eos, tts_pad))
    return PrefillInputs(prefill_embd, trailing, count[:, 0, 0] + 1)


def make_kv_cache(cfg, capacity: int, dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    return torch.zeros((cfg.n_layers, 2, cfg.n_kv_heads, capacity, cfg.head_dim),
                       dtype=dtype, device=device)


def talker_prefill(params: TalkerParams, cfg, prefill_embd: torch.Tensor, kv: torch.Tensor,
                   pos0: int = 0):
    """Dense prefill of the window prefill_embd [P, H] at absolute positions
    [pos0, pos0+P), K/V written into kv [L, 2, Hkv, C, D] (in place) at rows
    [0, P); or of R windows at once, [R, P, H] with kv [R, L, 2, Hkv, C, D]
    (the rows of each projection are R*P: one product per projection).
    Returns (normed last hidden [(R,) H], last logits [(R,) Vc] f32)."""
    P = prefill_embd.shape[-2]
    positions = pos0 + torch.arange(P, device=prefill_embd.device)
    hidden = forward_prefill(params.blocks, cfg, prefill_embd, positions, kv, 0)
    return _head(params, cfg, hidden[..., -1, :])


def talker_prefill_window(params: TalkerParams, cfg, prefill_embd: torch.Tensor, pos0: int):
    """Prefill at absolute positions [pos0, pos0+P) into a standalone window
    cache (counterpart of ``talker_prefill_window``,
    ``qwen3tts_tpu/models/talker.py:182-204``), the continuous-serving
    refill: the caller splices the window into a lane's cache at rows
    [pos0, pos0+P). RoPE is relative and the window attends only to itself,
    so a spliced request computes what a fresh run at [0, P) computes. R
    slots' windows [R, P, H] run as one prefill (``talker_prefill``).
    Returns (last hidden [(R,) H], last logits [(R,) Vc] f32, kv_window
    [(R,) L, 2, Hkv, P, D] in the embedding dtype)."""
    P = prefill_embd.shape[-2]
    kv_win = torch.zeros((*prefill_embd.shape[:-2], cfg.n_layers, 2, cfg.n_kv_heads, P,
                          cfg.head_dim), dtype=params.codec_embd.dtype,
                         device=prefill_embd.device)
    hidden, logits = talker_prefill(params, cfg, prefill_embd, kv_win, pos0)
    return hidden, logits, kv_win


def _head(params: TalkerParams, cfg, hidden):
    """(output-normed hidden, float32 logits): the codec head as a plain
    matmul in the hidden's dtype, as XLA leaves it; a head split over its
    vocab gives every rank the full logits (``gather_columns``)."""
    normed = rms_norm(hidden, params.output_norm, cfg.rms_norm_eps)
    logits = torch.matmul(normed.float(), params.codec_head.float()).to(normed.dtype).float()
    return normed, gather_columns(logits, params.codec_head)


def talker_step(params: TalkerParams, cfg, step_embd: torch.Tensor, n_past: int,
                kv: torch.Tensor, start=None):
    """One unfused talker frame step (counterpart of ``talker_step``,
    ``qwen3tts_tpu/models/talker.py:207-214``) on step_embd [H] with kv
    [L, 2, Hkv, C, D], or on B lanes [B, H] with kv [B, L, 2, Hkv, C, D];
    K/V written in place at n_past; `start` (int or [B]) masks the cache
    rows below a continuous-serving splice (``forward_step``). Returns
    (normed hidden, logits f32)."""
    return _head(params, cfg, forward_step(params.blocks, cfg, step_embd, n_past, kv, start))
