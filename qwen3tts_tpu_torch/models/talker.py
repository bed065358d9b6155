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
    prefill_embd: torch.Tensor     # [10 (or 9), H]
    trailing: torch.Tensor         # [Trb, H]: text rows, tts_eos, then tts_pad
    trailing_len: int


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
    return (torch.matmul(x.float(), w.float()).to(x.dtype) + b)


def project_text_tokens(params: TalkerParams, tokens: torch.Tensor) -> torch.Tensor:
    """text_embedding -> fc1 -> SiLU -> fc2; tokens int [T] -> [T, H]."""
    x = params.text_embd[tokens]
    x = _linear(x, params.text_proj_fc1_w, params.text_proj_fc1_b)
    x = torch.nn.functional.silu(x.float()).to(params.text_proj_fc1_w.dtype)
    return _linear(x, params.text_proj_fc2_w, params.text_proj_fc2_b)


def build_prefill(params: TalkerParams, cfg, tokens: torch.Tensor, n_tokens: int,
                  speaker_embd: torch.Tensor, language_id: int, *,
                  nothink: bool = False) -> PrefillInputs:
    """The prefill window and the per-frame trailing-text schedule for padded
    token ids tokens [Tb] with n_tokens real ones."""
    dev = params.codec_embd.device
    dtype = params.codec_embd.dtype
    Tb = tokens.shape[0]
    tokens = tokens.to(device=dev, dtype=torch.int64)
    proj_all = project_text_tokens(params, tokens)
    specials = project_text_tokens(params, torch.tensor(
        [cfg.tts_bos_token_id, cfg.tts_eos_token_id, cfg.tts_pad_token_id], device=dev))
    tts_bos, tts_eos, tts_pad = specials[0], specials[1], specials[2]
    role, first_text = proj_all[0:3], proj_all[3]
    if nothink:
        ids = [cfg.codec_nothink_id, cfg.codec_think_bos_id, cfg.codec_think_eos_id]
    else:
        ids = [cfg.codec_think_id, cfg.codec_think_bos_id, int(language_id),
               cfg.codec_think_eos_id]
    codec_prefill = params.codec_embd[torch.tensor(ids, device=dev)]
    overlay = torch.cat([
        codec_prefill + tts_pad[None, :],
        (speaker_embd.to(device=dev, dtype=dtype) + tts_pad)[None, :],
        (params.codec_embd[cfg.codec_pad_id] + tts_bos)[None, :],
    ], dim=0)
    last_row = (first_text + params.codec_embd[cfg.codec_bos_id])[None, :]
    prefill_embd = torch.cat([role, overlay, last_row], dim=0)

    # trailing schedule: proj(tokens[4 : n_tokens-5]) ++ [tts_eos], then tts_pad
    count = int(n_tokens) - 9
    Trb = Tb - 3
    idx = torch.arange(Trb, device=dev)
    rows = proj_all[torch.clamp(4 + idx, 0, Tb - 1)]
    trailing = torch.where(
        (idx < count)[:, None], rows,
        torch.where((idx == count)[:, None], tts_eos[None, :], tts_pad[None, :]))
    return PrefillInputs(prefill_embd, trailing, count + 1)


def make_kv_cache(cfg, capacity: int, dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    return torch.zeros((cfg.n_layers, 2, cfg.n_kv_heads, capacity, cfg.head_dim),
                       dtype=dtype, device=device)


def talker_prefill(params: TalkerParams, cfg, prefill_embd: torch.Tensor, kv: torch.Tensor):
    """Dense prefill (K/V written into kv in place); returns
    (normed last hidden [H], last logits [Vc] f32)."""
    P = prefill_embd.shape[0]
    positions = torch.arange(P, device=prefill_embd.device)
    hidden = forward_prefill(params.blocks, cfg, prefill_embd, positions, kv, 0)
    return _head(params, cfg, hidden[-1])


def _head(params: TalkerParams, cfg, hidden):
    """(output-normed hidden, float32 logits): the codec head as a plain
    matmul in the hidden's dtype, as XLA leaves it."""
    normed = rms_norm(hidden, params.output_norm, cfg.rms_norm_eps)
    logits = torch.matmul(normed.float(), params.codec_head.float()).to(normed.dtype).float()
    return normed, logits


def talker_step(params: TalkerParams, cfg, step_embd: torch.Tensor, n_past: int,
                kv: torch.Tensor):
    """One unfused talker frame step (counterpart of ``talker_step``,
    ``qwen3tts_tpu/models/talker.py:207-214``) on step_embd [H] with kv
    [L, 2, Hkv, C, D], or on B lanes [B, H] with kv [B, L, 2, Hkv, C, D];
    K/V written in place at n_past. Returns (normed hidden, logits f32)."""
    return _head(params, cfg, forward_step(params.blocks, cfg, step_embd, n_past, kv))
