"""The frame loops: single-stream (counterpart of ``generate_from_tokens`` and
``_make_body`` in ``qwen3tts_tpu/runtime/decode_loop.py``) and batched
(``generate_from_tokens_batched``, counterpart of ``_generate_batched_fused``
there, and of its vmapped unfused loop).

Prefill, then frame 0's codebook-0 token from the suppressed prefill logits
with ``sample_token`` (exact top-k; the JAX package's ``_init_cb0``), then
per frame:
  1. cb0 is the token sampled at the end of the previous frame (frame 0:
     from the prefill logits); stop on EOS;
  2. codes 1..15 and rest_sum = sum_s embds[s][code_s]: kernel K2 (fused_cp)
     or ``code_predictor.predict_codes`` and ``_rest_embd_sum`` (unfused);
  3. step_embd = codec_embd[cb0] + rest_sum + trailing[min(frame, Trb-1)];
  4. the talker step and the next frame's cb0, sampled against the seen-set
     that includes this frame's cb0: kernel K1 with its sampling epilogue
     (fused_talker), or ``talker.talker_step`` and suppression, repetition
     penalty and ``sample_token`` on its logits (unfused).
``fused_talker`` and ``fused_cp`` take the JAX package's names; they
replace its ``QWEN3TTS_FUSED_*`` gates. Each is True, False or "auto" (the
default), resolved once per call as the JAX package's
``_resolve_fused_talker`` and ``_resolve_fused_cp`` resolve it
(``decode_loop.py:85-129``) without their TPU and sharding gates: the talker
kernel in every weight tier (int8, q4, q4pure and bf16: the kernels take
each tier's weight modes), the code-predictor kernel when its blocks are
int8 (every quantized tier; the bf16 tier runs ``predict_codes``). An
explicit fused_cp=True on bf16 code-predictor blocks raises ValueError. All
four combinations of the booleans run in every tier.

The loop is a Python loop; the EOS check reads cb0 back, one host sync per
frame. Seeds: where JAX derives the kernels' int32 seeds with threefry from
one key, the port draws them from a torch.Generator seeded by the request
seed (one for frame 0's cb0, then two per frame: code predictor, next cb0).
``sample_token`` takes the counter-hash Gumbel noise of (seed, step) for
its rows. Greedy output therefore matches JAX exactly; sampled output
matches only in distribution (and at kernel level, given the same seeds).

The batched loop runs B lanes in lockstep (one shared n_past: every lane's
prefill window has the same length); see ``generate_from_tokens_batched``.

``kv_quant="int8"`` (the int8-KV tier) stores the decode cache as the (q,
scale) pair of ``ops/kv_quant.py`` when the fused talker step runs, and
only then, as the JAX package's loops do (``decode_loop.py:249-252,
735-738``): the dense prefill writes a bf16 window of P rows, which is
quantized into a cache of kv_capacity rows whose unwritten rows hold zeros
and the floor scale (the bits ``quantize_kv`` gives the zero-padded cache;
they are never read). The unfused step ignores the setting.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import code_predictor as cp_model
from ..models import talker as talker_model
from ..ops.fused_code_predictor import fused_predict_codes
from ..ops.fused_code_predictor_batched import fused_predict_codes_batched
from ..ops.fused_talker_step import (check_w8a8_blocks, fused_talker_step,
                                     fused_talker_step_batched)
from ..ops.kernel_prng import gumbel_noise, sampling_flags
from ..ops.kv_quant import quantize_cache
from ..ops.quant import QuantLinear
from ..ops.sampling import apply_repetition_penalty, apply_suppression, sample_token


# lanes of one K6 call; larger batches run it in groups of this many
CP_KERNEL_MAX_LANES = 64


class GenerateResult(NamedTuple):
    codes: torch.Tensor     # [n_frames, 16] int64
    n_frames: int
    hidden: torch.Tensor    # [n_frames, H] output-normed talker hidden (param dtype)


class BatchedGenerateResult(NamedTuple):
    codes: torch.Tensor     # [B, max_frames, 16] int64; lane b's first n_frames[b] rows
    n_frames: list          # [B] frames each lane emitted


def resolve_fused_talker(fused_talker) -> bool:
    """True, False or "auto": auto takes the talker kernel (K1 / K5) in
    every weight tier, as ``_resolve_fused_talker`` does on a TPU."""
    return True if fused_talker == "auto" else bool(fused_talker)


def resolve_fused_cp(fused_cp, cp_params) -> bool:
    """True, False or "auto": auto takes the code-predictor kernel (K2 / K6)
    only for int8 blocks, as ``_resolve_fused_cp`` does on a TPU; True on
    other blocks raises ValueError naming their tier."""
    if fused_cp == "auto":
        return isinstance(cp_params.blocks.wqkv, QuantLinear)
    if fused_cp:
        check_w8a8_blocks(cp_params.blocks)
    return bool(fused_cp)


def int8_kv(kv_quant: str, fused_talker: bool) -> bool:
    """Whether a loop stores the int8 (q, scale) cache: kv_quant "int8" on
    the fused talker step (an unfused step ignores it); "none" keeps the
    compute dtype; any other value raises ValueError."""
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
    return kv_quant == "int8" and fused_talker


def draw_seeds(gen: torch.Generator, n: int) -> list:
    """n int32 seeds from a host torch.Generator."""
    return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                         dtype=torch.int64).tolist()


def sample_cb0(logits, seeds, *, suppress_start: int, eos_id: int, temperature, top_k: int,
               top_p, greedy: bool, use_top_p: bool, seen=None, repetition_penalty=1.0):
    """Codebook-0 tokens from talker logits [R, Vc] as the JAX package's
    XLA path draws them (``decode_loop.py:318-325``): suppression of
    [suppress_start, Vc) except eos_id, the repetition penalty over seen
    [R, Vc] when given (frame 0 has none: its seen-set is empty), then
    ``sample_token`` with row r's counter-hash noise of (seeds[r], 0).
    temperature, top_p and repetition_penalty are scalars or per-row [R]
    (continuous serving). Returns int64 [R]."""
    l = apply_suppression(logits.float(), suppress_start, eos_id)
    if seen is not None:
        l = apply_repetition_penalty(l, seen.bool(), repetition_penalty)
    noise = None if greedy else gumbel_noise(
        torch.as_tensor(seeds, dtype=torch.int64, device=l.device).reshape(-1, 1), 0,
        tuple(l.shape), l.device)
    return sample_token(l, noise, temperature=temperature, top_k=top_k, top_p=top_p,
                        greedy=greedy, use_top_p=use_top_p)


def _rest_embd_sum(cp_params, rest):
    """sum_s embds[s][rest_s] in float32 over the 15 codes of rest [15] (or
    [B, 15]): the code predictor's part of the next talker step's input
    (counterpart of ``_rest_embd_sum``, ``decode_loop.py:191-200``)."""
    idx = torch.arange(rest.shape[-1], device=rest.device)
    return cp_params.embds[idx, rest].float().sum(dim=-2)


def generate_from_tokens(talker_params, cp_params, tokens, n_tokens: int,
                         speaker_embd, language_id: int, gen: torch.Generator, *,
                         talker_cfg, cp_cfg, max_frames: int, kv_capacity: int,
                         temperature: float, top_k: int, top_p: float = 1.0,
                         repetition_penalty: float = 1.05, nothink: bool = False,
                         fused_talker="auto", fused_cp="auto",
                         allow_eos: bool = True, kv_quant: str = "none",
                         progress_cb=None) -> GenerateResult:
    """Prefill + the frame loop for one request; see the module docstring.
    tokens [Tb] padded ids with n_tokens real ones; runs at most max_frames
    frames into a KV cache of kv_capacity rows (kv_quant "int8": the int8
    pair on the fused talker step). fused_talker / fused_cp pick
    kernels K1 / K2 or the unfused talker step / code predictor.
    allow_eos=False also suppresses EOS, so the request runs all max_frames
    frames (the JAX package's benchmark mode). progress_cb, if given, is
    called with the frames emitted so far after each frame, as the JAX
    loop's io_callback (``decode_loop.py:423-425``); the count is a host
    integer, so it adds no sync to the loop's one per frame."""
    tcfg, ccfg = talker_cfg, cp_cfg
    fused_talker = resolve_fused_talker(fused_talker)
    fused_cp = resolve_fused_cp(fused_cp, cp_params)
    quant_kv = int8_kv(kv_quant, fused_talker)
    dev = talker_params.codec_embd.device
    dtype = talker_params.codec_embd.dtype
    Vc = tcfg.codec_vocab_size
    suppress_start = Vc - tcfg.n_suppressed_tail
    greedy, use_top_p = sampling_flags(temperature, top_p)
    samp = dict(temperature=temperature, top_p=top_p, top_k=top_k, greedy=greedy,
                use_top_p=use_top_p)
    cb0_kw = dict(samp, suppress_start=suppress_start,
                  eos_id=tcfg.codec_eos_id if allow_eos else -1)

    with torch.no_grad():
        prefill = talker_model.build_prefill(
            talker_params, tcfg, torch.as_tensor(tokens), n_tokens, speaker_embd,
            language_id, nothink=nothink)
        Trb = prefill.trailing.shape[0]
        P = prefill.prefill_embd.shape[0]
        if P + max_frames > kv_capacity:
            raise ValueError(f"KV capacity {kv_capacity} < prefill {P} + frames {max_frames}")
        kv = talker_model.make_kv_cache(tcfg, P if quant_kv else kv_capacity, dtype, dev)
        last_hidden, logits = talker_model.talker_prefill(
            talker_params, tcfg, prefill.prefill_embd, kv)
        if quant_kv:
            kv = quantize_cache(kv, kv_capacity)

        cb0_next = sample_cb0(logits[None], draw_seeds(gen, 1), **cb0_kw)
        # int8, the dtype the talker kernel reads: no per-frame conversion
        seen = torch.zeros((Vc,), dtype=torch.int8, device=dev)
        codes, hidden_out = [], []
        n_past = P
        for frame in range(max_frames):
            cb0 = cb0_next.reshape(1).to(torch.int64)
            if allow_eos and int(cb0) == tcfg.codec_eos_id:
                break
            seed_cp, seed_cb0 = draw_seeds(gen, 2)
            cb0_embd = talker_params.codec_embd[cb0[0]]
            if fused_cp:
                rest, rest_sum = fused_predict_codes(
                    cp_params, ccfg, last_hidden.to(dtype), cb0_embd, seed_cp, **samp)
            else:
                rest = cp_model.predict_codes(cp_params, ccfg, last_hidden.to(dtype), cb0_embd,
                                              seed_cp, **samp)
                rest_sum = _rest_embd_sum(cp_params, rest)
            codes.append(torch.cat([cb0, rest.to(torch.int64)]))
            hidden_out.append(last_hidden.to(dtype))
            if progress_cb is not None:
                progress_cb(frame + 1)
            seen[cb0] = 1
            trailing_row = prefill.trailing[min(frame, Trb - 1)]
            step_embd = (cb0_embd.float() + rest_sum + trailing_row.float()).to(dtype)
            if fused_talker:
                out = fused_talker_step(
                    talker_params.blocks, tcfg, step_embd, n_past, kv,
                    output_norm=talker_params.output_norm,
                    codec_head=talker_params.codec_head, seen=seen, seed=seed_cb0,
                    repetition_penalty=repetition_penalty, **cb0_kw)
                last_hidden, cb0_next = out.hidden.to(dtype), out.cb0
            else:
                last_hidden, logits = talker_model.talker_step(
                    talker_params, tcfg, step_embd, n_past, kv)
                cb0_next = sample_cb0(logits[None], [seed_cb0], seen=seen[None],
                                      repetition_penalty=repetition_penalty, **cb0_kw)
            n_past += 1
    H = tcfg.hidden_size
    if not codes:
        return GenerateResult(torch.zeros((0, tcfg.n_codebooks), dtype=torch.int64), 0,
                              torch.zeros((0, H), dtype=dtype))
    return GenerateResult(torch.stack(codes), len(codes), torch.stack(hidden_out))


def generate_from_tokens_batched(talker_params, cp_params, tokens, n_tokens, speaker_embd,
                                 language_ids, gen: torch.Generator, *, talker_cfg, cp_cfg,
                                 max_frames: int, kv_capacity: int, temperature: float,
                                 top_k: int, top_p: float = 1.0,
                                 repetition_penalty: float = 1.05, nothink: bool = False,
                                 budgets=None, fused_talker="auto", fused_cp="auto",
                                 allow_eos: bool = True,
                                 kv_quant: str = "none") -> BatchedGenerateResult:
    """Prefill + the frame loop for B requests in lockstep (counterpart of
    ``_generate_batched_fused``, fused kernels, every weight tier; with both
    flags off, of the vmapped unfused loop, ``decode_loop.py:651-667``).

    tokens [B, Tb] padded ids with n_tokens[b] real ones (one shared Tb, so
    every lane's prefill window has the same length and the lanes share
    n_past); speaker_embd [B, H]; language_ids [B]; budgets, when given,
    caps lane b at budgets[b] frames; allow_eos=False suppresses EOS, and
    kv_quant "int8" stores the int8 pair [B, ...], as in
    generate_from_tokens. The B prefill windows run as one prefill
    (``build_prefill`` and ``talker_prefill`` on [B, P, H], each projection
    one product of B*P rows, as continuous serving's refill runs them; every
    lane computes what its own prefill would); frame 0's cb0 from
    ``sample_cb0`` on the [B, Vc] prefill logits. Then per frame-set: K6 (in groups of
    CP_KERNEL_MAX_LANES lanes), or ``predict_codes`` on all B lanes as M = B
    rows, predicts codes 1..15 and rest_sum; the codes are written for
    emitting lanes only and their seen-sets updated; step_embd =
    codec_embd[cb0] + rest_sum + trailing[min(frame, Trb-1)]; K5, or
    ``talker_step`` on B lanes and ``sample_cb0``, steps every lane and
    samples its next cb0. EOS is latched per lane;
    finished lanes keep stepping with their emissions masked. The loop ends
    when every lane is done or after max_frames, with one host sync per
    frame-set.

    Seeds: B lane seeds are drawn from `gen`; lane b then draws from its own
    generator, seeded with its lane seed, exactly as generate_from_tokens
    draws from `gen`. So lane b reproduces generate_from_tokens run with a
    generator seeded with lane b's seed (the port's analog of
    jax.random.split(key, B)).
    """
    tcfg, ccfg = talker_cfg, cp_cfg
    fused_talker = resolve_fused_talker(fused_talker)
    fused_cp = resolve_fused_cp(fused_cp, cp_params)
    quant_kv = int8_kv(kv_quant, fused_talker)
    dev = talker_params.codec_embd.device
    dtype = talker_params.codec_embd.dtype
    B = int(tokens.shape[0])
    Vc = tcfg.codec_vocab_size
    suppress_start = Vc - tcfg.n_suppressed_tail
    eos = tcfg.codec_eos_id
    greedy, use_top_p = sampling_flags(temperature, top_p)
    samp = dict(temperature=temperature, top_p=top_p, top_k=top_k, greedy=greedy,
                use_top_p=use_top_p)
    cb0_kw = dict(samp, suppress_start=suppress_start, eos_id=eos if allow_eos else -1)
    # lane b's draws: 1 for frame 0's cb0, then (code predictor, next cb0)
    # per frame, as generate_from_tokens draws them
    lane_seeds = []
    for s in draw_seeds(gen, B):
        g = torch.Generator()
        g.manual_seed(s)
        lane_seeds.append(draw_seeds(g, 1 + 2 * max_frames))
    seeds = torch.tensor(lane_seeds, dtype=torch.int32).to(dev)      # [B, 1 + 2F]
    lanes = torch.arange(B, device=dev)

    with torch.no_grad():
        prefill = talker_model.build_prefill(
            talker_params, tcfg, torch.as_tensor(tokens), torch.as_tensor(n_tokens),
            speaker_embd, torch.as_tensor(language_ids), nothink=nothink)
        P = prefill.prefill_embd.shape[1]
        trailing = prefill.trailing                                  # [B, Trb, H]
        Trb = trailing.shape[1]
        if P + max_frames > kv_capacity:
            raise ValueError(f"KV capacity {kv_capacity} < prefill {P} + frames {max_frames}")
        kv = torch.zeros((B, tcfg.n_layers, 2, tcfg.n_kv_heads, P if quant_kv else kv_capacity,
                          tcfg.head_dim), dtype=dtype, device=dev)
        last_hidden, logits = talker_model.talker_prefill(talker_params, tcfg,
                                                          prefill.prefill_embd, kv)
        if quant_kv:
            kv = quantize_cache(kv, kv_capacity)
        cb0_next = sample_cb0(logits, seeds[:, 0], **cb0_kw)
        seen = torch.zeros((B, Vc), dtype=torch.int8, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        frame = torch.zeros((B,), dtype=torch.int64, device=dev)
        cap = (torch.full((B,), max_frames, dtype=torch.int64) if budgets is None
               else torch.as_tensor(budgets, dtype=torch.int64)).to(dev)
        codes = torch.zeros((B, max_frames, tcfg.n_codebooks), dtype=torch.int64, device=dev)
        n_past = P
        for it in range(max_frames):
            cb0 = cb0_next.to(torch.int64)
            if allow_eos:
                done = done | (cb0 == eos)
            emit = ~done
            if not bool(emit.any()):
                break
            cb0_embd = talker_params.codec_embd[cb0]                    # [B, H]
            if fused_cp:
                rest, rest_sum = [], []
                for o in range(0, B, CP_KERNEL_MAX_LANES):
                    r, rs = fused_predict_codes_batched(
                        cp_params, ccfg, last_hidden[o:o + CP_KERNEL_MAX_LANES],
                        cb0_embd[o:o + CP_KERNEL_MAX_LANES],
                        seeds[o:o + CP_KERNEL_MAX_LANES, 1 + 2 * it], **samp)
                    rest.append(r.to(torch.int64))
                    rest_sum.append(rs)
                rest, rest_sum = torch.cat(rest), torch.cat(rest_sum)
            else:
                rest = cp_model.predict_codes(cp_params, ccfg, last_hidden, cb0_embd,
                                              seeds[:, 1 + 2 * it], **samp)
                rest_sum = _rest_embd_sum(cp_params, rest)
            frame_codes = torch.cat([cb0[:, None], rest], dim=1)
            codes[:, it] = torch.where(emit[:, None], frame_codes, codes[:, it])
            seen[lanes, cb0] |= emit.to(torch.int8)
            trailing_row = trailing[lanes, torch.clamp(frame, max=Trb - 1)]
            step_embd = (cb0_embd.float() + rest_sum + trailing_row.float()).to(dtype)
            if fused_talker:
                out = fused_talker_step_batched(
                    talker_params.blocks, tcfg, step_embd, n_past, kv,
                    output_norm=talker_params.output_norm,
                    codec_head=talker_params.codec_head, seen=seen, seeds=seeds[:, 2 + 2 * it],
                    repetition_penalty=repetition_penalty, **cb0_kw)
                last_hidden, cb0_next = out.hidden.to(dtype), out.cb0
            else:
                last_hidden, logits = talker_model.talker_step(
                    talker_params, tcfg, step_embd, n_past, kv)
                cb0_next = sample_cb0(logits, seeds[:, 2 + 2 * it], seen=seen,
                                      repetition_penalty=repetition_penalty, **cb0_kw)
            frame = frame + emit.to(torch.int64)
            done = done | (frame >= cap)
            n_past += 1
    return BatchedGenerateResult(codes.cpu(), frame.cpu().tolist())
