"""The code predictor: the 5-layer transformer that emits codebooks 1..15 of
each frame (counterpart of ``qwen3tts_tpu/models/code_predictor.py``).

Its per-frame loop runs in the fused kernel K2
(``ops/fused_code_predictor.py``): a pass over the talker hidden, then one
pass per code with the per-step embedding tables ``embds[s]`` and LM heads
``heads[s]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .transformer_core import BlockParams, init_block_params, normal_init


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
