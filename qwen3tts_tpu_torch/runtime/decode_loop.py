"""The single-stream frame loop (counterpart of ``generate_from_tokens`` and
``_make_body`` in ``qwen3tts_tpu/runtime/decode_loop.py``, fused-kernel
path).

Prefill, then per frame:
  1. cb0 is the token the previous talker step's kernel epilogue sampled
     (frame 0: K4 ``sample_rows`` on the prefill logits, suppressed);
     stop on EOS;
  2. K2 predicts codes 1..15 and rest_sum = sum_s embds[s][code_s];
  3. step_embd = codec_embd[cb0] + rest_sum + trailing[min(frame, Trb-1)];
  4. K1 runs the talker step and samples the next frame's cb0 against the
     seen-set that includes this frame's cb0.

The loop is a Python loop; the EOS check reads cb0 back, one host sync per
frame. Seeds: where JAX derives the kernels' int32 seeds with threefry from
one key, the port draws them from a torch.Generator seeded by the request
seed (one for frame 0's cb0, then two per frame: code predictor, next cb0).
Greedy output therefore matches JAX exactly; sampled output matches only at
kernel level, given the same seeds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import talker as talker_model
from ..ops.fused_code_predictor import fused_predict_codes
from ..ops.fused_talker_step import fused_talker_step
from ..ops.kernel_prng import sampling_flags
from ..ops.sampling import sample_rows


class GenerateResult(NamedTuple):
    codes: torch.Tensor     # [n_frames, 16] int64
    n_frames: int
    hidden: torch.Tensor    # [n_frames, H] output-normed talker hidden (param dtype)


def draw_seeds(gen: torch.Generator, n: int) -> list:
    """n int32 seeds from a host torch.Generator."""
    return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                         dtype=torch.int64).tolist()


def generate_from_tokens(talker_params, cp_params, tokens, n_tokens: int,
                         speaker_embd, language_id: int, gen: torch.Generator, *,
                         talker_cfg, cp_cfg, max_frames: int, kv_capacity: int,
                         temperature: float, top_k: int, top_p: float = 1.0,
                         repetition_penalty: float = 1.05,
                         nothink: bool = False) -> GenerateResult:
    """Prefill + the frame loop for one request; see the module docstring.
    tokens [Tb] padded ids with n_tokens real ones; runs at most max_frames
    frames into a KV cache of kv_capacity rows."""
    tcfg, ccfg = talker_cfg, cp_cfg
    dev = talker_params.codec_embd.device
    dtype = talker_params.codec_embd.dtype
    Vc = tcfg.codec_vocab_size
    suppress_start = Vc - tcfg.n_suppressed_tail
    greedy, use_top_p = sampling_flags(temperature, top_p)
    samp = dict(temperature=temperature, top_p=top_p, top_k=top_k, greedy=greedy,
                use_top_p=use_top_p)

    with torch.no_grad():
        prefill = talker_model.build_prefill(
            talker_params, tcfg, torch.as_tensor(tokens), n_tokens, speaker_embd,
            language_id, nothink=nothink)
        Trb = prefill.trailing.shape[0]
        P = prefill.prefill_embd.shape[0]
        if P + max_frames > kv_capacity:
            raise ValueError(f"KV capacity {kv_capacity} < prefill {P} + frames {max_frames}")
        kv = talker_model.make_kv_cache(tcfg, kv_capacity, dtype, dev)
        last_hidden, logits = talker_model.talker_prefill(
            talker_params, tcfg, prefill.prefill_embd, kv)

        (seed0,) = draw_seeds(gen, 1)
        cb0_next = sample_rows(
            logits[None].float(), torch.tensor([seed0], dtype=torch.int32, device=dev), 0,
            suppress_start=suppress_start, eos_id=tcfg.codec_eos_id, **samp)
        # int8, the dtype the talker kernel reads: no per-frame conversion
        seen = torch.zeros((Vc,), dtype=torch.int8, device=dev)
        codes, hidden_out = [], []
        n_past = P
        for frame in range(max_frames):
            cb0 = cb0_next.reshape(1).to(torch.int64)
            if int(cb0) == tcfg.codec_eos_id:
                break
            seed_cp, seed_cb0 = draw_seeds(gen, 2)
            cb0_embd = talker_params.codec_embd[cb0[0]]
            rest, rest_sum = fused_predict_codes(
                cp_params, ccfg, last_hidden.to(dtype), cb0_embd, seed_cp, **samp)
            codes.append(torch.cat([cb0, rest.to(torch.int64)]))
            hidden_out.append(last_hidden.to(dtype))
            seen[cb0] = 1
            trailing_row = prefill.trailing[min(frame, Trb - 1)]
            step_embd = (cb0_embd.float() + rest_sum + trailing_row.float()).to(dtype)
            out = fused_talker_step(
                talker_params.blocks, tcfg, step_embd, n_past, kv,
                output_norm=talker_params.output_norm,
                codec_head=talker_params.codec_head, seen=seen, seed=seed_cb0,
                repetition_penalty=repetition_penalty, suppress_start=suppress_start,
                eos_id=tcfg.codec_eos_id, **samp)
            last_hidden = out.hidden.to(dtype)
            cb0_next = out.cb0
            n_past += 1
    H = tcfg.hidden_size
    if not codes:
        return GenerateResult(torch.zeros((0, tcfg.n_codebooks), dtype=torch.int64), 0,
                              torch.zeros((0, H), dtype=dtype))
    return GenerateResult(torch.stack(codes), len(codes), torch.stack(hidden_out))
