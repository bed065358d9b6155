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
(``decode_loop.py:56-129``) without its TPU gate: the talker kernel in
every weight tier (int8, q4, q4pure and bf16: the kernels take each tier's
weight modes), the code-predictor kernel when its blocks are int8 (every
quantized tier; the bf16 tier runs ``predict_codes``), and neither on
params split over a mesh axis (``parallel/kernel_safety.py``: "auto" turns
the kernel off with one logged line, an explicit True raises ValueError).
An explicit fused_cp=True on bf16 code-predictor blocks raises ValueError.
All four combinations of the booleans run in every tier.

On a mesh (``parallel/``: one process per rank, the same global inputs
and the same global result on every rank) the params carry their
placements: a rank's tensor-parallel shard runs the unfused loops on its
heads (``shardings.local_config``), and the batched loop splits its lanes
over "dp" (see ``generate_from_tokens_batched``).

The loop is a Python loop; the EOS check reads cb0 back, one host sync per
frame. It runs in chunks (the JAX package's streaming entry points):
``generate_init`` prefills and draws frame 0's cb0 into a ``LoopState`` (the
cache, in place; the seen-set, codes and hidden rows on the device; the
request's key on the host), ``generate_chunk`` advances it by up to K
frames and ``generate_start`` is the two together; ``generate_from_tokens``
is ``generate_init`` then one chunk of max_frames, so a streamed request's
codes are ``synthesize``'s.

Randomness: the JAX package's threefry key chain (``ops/prng.py``), from
the caller's key (the pipeline's ``prng_key(params.seed)``), so a seed
gives the JAX package's sampled codes. Each frame splits the chain key
into (next key, k_cb0, k_cp) (``decode_loop.py:316``): the code predictor
draws from k_cp (K2's seed ``seed32(k_cp)``, or ``predict_codes``' own
chain), and the cb0 of a frame from its k_cb0. With the fused talker step
(the JAX package's in-kernel cb0), frame 0's cb0 is drawn at init from a
split of the key into 3 (``_init_cb0``) and K1's epilogue draws the next
frame's cb0 with seed ``seed32(k_cb0)`` of the frame that launches it;
unfused, frame f's cb0 is drawn with k_cb0 of frame f's own split (the JAX
body samples the carried logits at the top of the frame; the port samples
them at the end of the frame before, from the next split). The host
computes each frame's keys after its launches, while the card runs them.
``sample_token`` draws with the key's Gumbel field (``prng.gumbel``), as
``jax.random.categorical`` does.

The batched loop runs B lanes in lockstep (one shared n_past: every lane's
prefill window has the same length); see ``generate_from_tokens_batched``.
Its ``kv_layout="lane"`` (the JAX package's
``QWEN3TTS_BATCHED_KV_LAYOUT=lane``, ``decode_loop.py:726-739``) keeps the
fused talker step's cache lane-major, [L, 2, Hkv, C, B, D]: K5 then returns
logits and the loop draws each frame's cb0 with ``sample_cb0``, the key
chain of the unfused loop (``frame_draws`` with ``kernel_cb0`` False).

``kv_quant="int8"`` (the int8-KV tier) stores the decode cache as the (q,
scale) pair of ``ops/kv_quant.py`` when the fused talker step runs, and
only then, as the JAX package's loops do (``decode_loop.py:249-252,
735-738``): the dense prefill writes a bf16 window of P rows, which is
quantized into a cache of kv_capacity rows whose unwritten rows hold zeros
and the floor scale (the bits ``quantize_kv`` gives the zero-padded cache;
they are never read). The unfused step ignores the setting.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..models import code_predictor as cp_model
from ..models import talker as talker_model
from ..ops import prng
from ..ops.fused_code_predictor import fused_predict_codes
from ..ops.fused_code_predictor_batched import fused_predict_codes_batched
from ..ops.fused_talker_step import (KV_LAYOUTS, check_w8a8_blocks, fused_talker_step,
                                     fused_talker_step_batched, to_lane_major)
from ..ops.kernel_prng import sampling_flags
from ..ops.kv_quant import quantize_cache
from ..ops.quant import QuantLinear
from ..ops.sampling import apply_repetition_penalty, apply_suppression, sample_token
from ..parallel.collectives import gather_lanes, lane_range
from ..parallel.kernel_safety import dp_kernel_mesh, params_mesh, partitioned_axes
from ..parallel.shardings import local_config


# lanes of one K6 call; larger batches run it in groups of this many
CP_KERNEL_MAX_LANES = 64


class GenerateResult(NamedTuple):
    codes: torch.Tensor     # [n_frames, 16] int64
    n_frames: int
    hidden: torch.Tensor    # [n_frames, H] output-normed talker hidden (param dtype)


class BatchedGenerateResult(NamedTuple):
    codes: torch.Tensor     # [B, max_frames, 16] int64; lane b's first n_frames[b] rows
    n_frames: list          # [B] frames each lane emitted


# (kernel, axes) pairs whose fallback was logged (the JAX package's
# _SHARDED_FALLBACK_LOGGED)
_FALLBACK_LOGGED: set = set()


def _log_once(key, message: str) -> None:
    if key not in _FALLBACK_LOGGED:
        _FALLBACK_LOGGED.add(key)
        print(message, file=sys.stderr)


def _check_params_sharding(which: str, params, explicit: bool) -> bool:
    """True when no leaf of params is split over a mesh axis (counterpart of
    ``_check_params_sharding``, ``decode_loop.py:56-82``). Otherwise an
    explicit request raises ValueError, and "auto" logs once per (kernel,
    axes) and returns False."""
    axes = partitioned_axes(params)
    if not axes:
        return True
    if explicit:
        raise ValueError(
            f"fused_{which}=True but the {which} params are partitioned over mesh axes "
            f"{sorted(axes)}: the fused kernels are single-device programs. Replicate the "
            "weights (dp-only mesh; the batched path then keeps the kernels on each rank's "
            f"lanes) or pass fused_{which}='auto'/False.")
    _log_once((which, tuple(sorted(axes))),
              f"qwen3tts: fused {which} kernel off — params partitioned over mesh axes "
              f"{sorted(axes)}; using the unfused path (parallel/kernel_safety.py)")
    return False


def resolve_fused_talker(fused_talker, talker_params=None) -> bool:
    """True, False or "auto": auto takes the talker kernel (K1 / K5) in
    every weight tier, as ``_resolve_fused_talker`` does on a TPU, unless
    talker_params are split over a mesh axis (where True raises)."""
    if fused_talker == "auto":
        return talker_params is None or _check_params_sharding("talker", talker_params, False)
    if fused_talker and talker_params is not None:
        _check_params_sharding("talker", talker_params, True)
    return bool(fused_talker)


def resolve_fused_cp(fused_cp, cp_params) -> bool:
    """True, False or "auto": auto takes the code-predictor kernel (K2 / K6)
    only for int8 blocks not split over a mesh axis, as
    ``_resolve_fused_cp`` does on a TPU; True on other blocks raises
    ValueError naming their tier, or the axes they are split over."""
    if fused_cp == "auto":
        return (isinstance(cp_params.blocks.wqkv, QuantLinear)
                and _check_params_sharding("code-predictor", cp_params, False))
    if fused_cp:
        check_w8a8_blocks(cp_params.blocks)
        _check_params_sharding("code-predictor", cp_params, True)
    return bool(fused_cp)


def int8_kv(kv_quant: str, fused_talker: bool) -> bool:
    """Whether a loop stores the int8 (q, scale) cache: kv_quant "int8" on
    the fused talker step (an unfused step ignores it); "none" keeps the
    compute dtype; any other value raises ValueError."""
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
    return kv_quant == "int8" and fused_talker


def lane_kv_layout(kv_layout: str, fused_talker: bool, quant_kv: bool) -> bool:
    """Whether the batched loop keeps its cache lane-major (the JAX
    package's ``lane_kv``, ``decode_loop.py:733-734``): kv_layout "lane" on
    the fused talker step over a compute-dtype cache. Where "lane" is asked
    for and the loop keeps batch-major (the int8 KV cache, or the unfused
    step), it says why once on stderr; another value raises ValueError."""
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout!r}")
    if kv_layout != "lane":
        return False
    why = ("the int8 KV cache needs the batch-major layout" if quant_kv
           else None if fused_talker else "the unfused talker step has no lane-major form")
    if why is not None:
        _log_once(("kv_layout", why), f"qwen3tts: batched_kv_layout='lane' kept batch-major: "
                  f"{why}")
        return False
    return True


def sample_cb0(logits, keys, *, suppress_start: int, eos_id: int, temperature, top_k: int,
               top_p, greedy: bool, use_top_p: bool, seen=None, repetition_penalty=1.0):
    """Codebook-0 tokens from talker logits [R, Vc] as the JAX package's
    XLA path draws them (``decode_loop.py:318-325``): suppression of
    [suppress_start, Vc) except eos_id, the repetition penalty over seen
    [R, Vc] when given (frame 0 has none: its seen-set is empty), then
    ``sample_token`` with the Gumbel field of row r's key keys[r] (keys
    [R, 2]: pairs, numpy or an int64 tensor). temperature, top_p and
    repetition_penalty are scalars or per-row [R] (continuous serving).
    Returns int64 [R]."""
    l = apply_suppression(logits.float(), suppress_start, eos_id)
    if seen is not None:
        l = apply_repetition_penalty(l, seen.bool(), repetition_penalty)
    noise = None if greedy else prng.gumbel(keys, l.shape[-1], l.device)
    return sample_token(l, noise, temperature=temperature, top_k=top_k, top_p=top_p,
                        greedy=greedy, use_top_p=use_top_p)


def frame_draws(key, fused_cp: bool, kernel_cb0: bool):
    """One frame's split of the chain key (a pair, or lanes [B, 2]):
    (next key, k_cb0, k_cp), each of k_cb0 and k_cp as the int32 seed
    ``seed32`` where a kernel takes it (K1/K5 sampling cb0 for k_cb0, K2/K6
    for k_cp); k_cb0 stays a key where ``sample_cb0`` draws cb0 (the unfused
    step, and K5 over a lane-major cache)."""
    s = prng.split(key, 3)
    nxt, k_cb0, k_cp = s if isinstance(s, tuple) else (s[:, 0], s[:, 1], s[:, 2])
    return (nxt, prng.seed32(k_cb0) if kernel_cb0 else k_cb0,
            prng.seed32(k_cp) if fused_cp else k_cp)


def _rest_embd_sum(cp_params, rest):
    """sum_s embds[s][rest_s] in float32 over the 15 codes of rest [15] (or
    [B, 15]): the code predictor's part of the next talker step's input
    (counterpart of ``_rest_embd_sum``, ``decode_loop.py:191-200``)."""
    idx = torch.arange(rest.shape[-1], device=rest.device)
    return cp_params.embds[idx, rest].float().sum(dim=-2)


@dataclasses.dataclass
class LoopState:
    """The single-stream loop between chunks (counterpart of ``_LoopState``,
    ``qwen3tts_tpu/runtime/decode_loop.py``), updated in place by
    ``generate_chunk`` (JAX donates the state and returns a new one). The
    host keeps the counters; the device keeps the rest."""
    frame: int                  # frames emitted so far
    n_past: int                 # cache rows written (prefill + frames)
    cb0_next: torch.Tensor      # the next frame's codebook-0 token
    last_hidden: torch.Tensor   # [H] the talker's last output-normed hidden
    kv: object                  # the compute-dtype cache, or the int8 (q, scale) pair
    seen: torch.Tensor          # [Vc] int8: codebook-0 ids emitted so far
    codes: torch.Tensor         # [max_frames, 16] int64; rows [0, frame) written
    hidden_out: torch.Tensor    # [max_frames, H] the hidden state of each frame
    done: bool                  # EOS was drawn as a frame's cb0
    key: tuple                  # the chain key of the next frame (two uint32, host ints)


def generate_init(talker_params, cp_params, tokens, n_tokens: int, speaker_embd,
                  language_id: int, key, *, talker_cfg, cp_cfg,
                  max_frames: int, kv_capacity: int, temperature: float, top_k: int,
                  top_p: float = 1.0, repetition_penalty: float = 1.05,
                  nothink: bool = False, fused_talker="auto", kv_quant: str = "none",
                  allow_eos: bool = True):
    """Prefill, then frame 0's codebook-0 token from the prefill logits:
    returns (LoopState, prefill) ready for ``generate_chunk`` (counterpart
    of ``generate_init``, ``qwen3tts_tpu/runtime/decode_loop.py:943``).
    tokens [Tb] padded ids with n_tokens real ones; a cache of kv_capacity
    rows (kv_quant "int8": the int8 pair, on the fused talker step only);
    room for max_frames frames. The sampling arguments, allow_eos and
    fused_talker must be those the chunks use. key: the request's threefry
    key (``prng.prng_key(seed)``, or a JAX key); frame 0's cb0 draws with
    split(key, 3)[1], and the chain goes on from split(key, 3)[0] with the
    fused talker step, from key itself without (``_init_cb0``)."""
    tcfg = local_config(talker_cfg, talker_params.blocks)
    fused_talker = resolve_fused_talker(fused_talker, talker_params)
    quant_kv = int8_kv(kv_quant, fused_talker)
    key = prng.key_pair(key)
    key_next, k_cb0, _ = prng.split(key, 3)
    dev = talker_params.codec_embd.device
    dtype = talker_params.codec_embd.dtype
    Vc = tcfg.codec_vocab_size
    greedy, use_top_p = sampling_flags(temperature, top_p)
    with torch.no_grad():
        prefill = talker_model.build_prefill(
            talker_params, tcfg, torch.as_tensor(tokens), n_tokens, speaker_embd,
            language_id, nothink=nothink)
        P = prefill.prefill_embd.shape[0]
        if P + max_frames > kv_capacity:
            raise ValueError(f"KV capacity {kv_capacity} < prefill {P} + frames {max_frames}")
        kv = talker_model.make_kv_cache(tcfg, P if quant_kv else kv_capacity, dtype, dev)
        last_hidden, logits = talker_model.talker_prefill(
            talker_params, tcfg, prefill.prefill_embd, kv)
        if quant_kv:
            kv = quantize_cache(kv, kv_capacity)
        cb0_next = sample_cb0(
            logits[None], [k_cb0], suppress_start=Vc - tcfg.n_suppressed_tail,
            eos_id=tcfg.codec_eos_id if allow_eos else -1, temperature=temperature,
            top_k=top_k, top_p=top_p, greedy=greedy, use_top_p=use_top_p)
        state = LoopState(
            frame=0, n_past=P, cb0_next=cb0_next, last_hidden=last_hidden, kv=kv,
            # int8, the dtype the talker kernel reads: no per-frame conversion
            seen=torch.zeros((Vc,), dtype=torch.int8, device=dev),
            codes=torch.zeros((max_frames, tcfg.n_codebooks), dtype=torch.int64, device=dev),
            hidden_out=torch.zeros((max_frames, tcfg.hidden_size), dtype=dtype, device=dev),
            done=False, key=key_next if fused_talker else key)
    return state, prefill


def generate_chunk(talker_params, cp_params, prefill, state: LoopState, *, talker_cfg,
                   cp_cfg, chunk_frames: int, max_frames: int, temperature: float,
                   top_k: int, top_p: float = 1.0, repetition_penalty: float = 1.05,
                   allow_eos: bool = True, fused_cp="auto", fused_talker="auto",
                   progress_cb=None) -> LoopState:
    """Advance the loop by up to chunk_frames frames, in place: it stops
    early at EOS (state.done) or at max_frames (counterpart of
    ``generate_chunk``, ``qwen3tts_tpu/runtime/decode_loop.py:1008``). One
    host sync per frame (the EOS check reads cb0 back). progress_cb, if
    given, is called with the frames emitted so far after each frame (the
    JAX loop's io_callback, ``decode_loop.py:423-425``). The frames draw
    from state.key's chain (module docstring). Returns state."""
    tcfg = local_config(talker_cfg, talker_params.blocks)
    ccfg = local_config(cp_cfg, cp_params.blocks)
    fused_talker = resolve_fused_talker(fused_talker, talker_params)
    fused_cp = resolve_fused_cp(fused_cp, cp_params)
    dtype = talker_params.codec_embd.dtype
    greedy, use_top_p = sampling_flags(temperature, top_p)
    samp = dict(temperature=temperature, top_p=top_p, top_k=top_k, greedy=greedy,
                use_top_p=use_top_p)
    cb0_kw = dict(samp, suppress_start=tcfg.codec_vocab_size - tcfg.n_suppressed_tail,
                  eos_id=tcfg.codec_eos_id if allow_eos else -1)
    Trb = prefill.trailing.shape[0]
    target = min(state.frame + chunk_frames, max_frames, state.codes.shape[0])
    draws = frame_draws(state.key, fused_cp, fused_talker)
    with torch.no_grad():
        while not state.done and state.frame < target:
            frame = state.frame
            cb0 = state.cb0_next.reshape(1).to(torch.int64)
            if allow_eos and int(cb0) == tcfg.codec_eos_id:
                state.done = True
                break
            state.key, cb0_draw, cp_draw = draws
            if not fused_talker:
                # the next frame's cb0 draws with its own split's k_cb0
                draws = frame_draws(state.key, fused_cp, fused_talker)
                cb0_draw = [draws[1]]
            state.hidden_out[frame] = state.last_hidden.to(dtype)
            _, state.last_hidden, state.cb0_next = frame_step(
                talker_params, cp_params, tcfg, ccfg, state.last_hidden, cb0, state.kv,
                state.seen, prefill.trailing[min(frame, Trb - 1)], state.n_past, cb0_draw,
                cp_draw, fused_talker=fused_talker, fused_cp=fused_cp, samp=samp,
                cb0_kw=cb0_kw, repetition_penalty=repetition_penalty,
                codes_out=state.codes[frame])
            if fused_talker:
                # the next frame's keys, while the card runs this one
                draws = frame_draws(state.key, fused_cp, fused_talker)
            if progress_cb is not None:
                progress_cb(frame + 1)
            state.frame += 1
            state.n_past += 1
    return state


def frame_step(talker_params, cp_params, tcfg, ccfg, last_hidden, cb0, kv, seen,
               trailing_row, n_past, cb0_draw, cp_draw, *, fused_talker: bool, fused_cp: bool,
               samp: dict, cb0_kw: dict, repetition_penalty, codes_out=None):
    """One frame of the single-stream loop after its EOS check: the body of
    ``generate_chunk``, and the exported ``frame`` program
    (``tools/export_aot.py``). cb0 [1] int64 is the frame's codebook-0
    token; the code predictor (K2 with seed cp_draw, or ``predict_codes``
    with the key cp_draw) gives codes 1..15; seen [Vc] int8 takes cb0; the
    step embedding codec_embd[cb0] + rest_sum + trailing_row runs the
    talker step at n_past over kv (in place), and the next frame's cb0 is
    drawn by K1 with seed cb0_draw (fused talker), else by ``sample_cb0``
    with the keys cb0_draw [1, 2] (the next frame's k_cb0). The seeds and
    n_past may be SymInts and the keys int64 tensors (torch.export).
    Returns (codes [16] int64, written into codes_out when given, the
    talker's output-normed hidden in the weights' dtype, the next cb0)."""
    dtype = talker_params.codec_embd.dtype
    cb0_embd = talker_params.codec_embd[cb0][0]
    if fused_cp:
        rest, rest_sum = fused_predict_codes(cp_params, ccfg, last_hidden.to(dtype), cb0_embd,
                                             cp_draw, **samp)
    else:
        rest = cp_model.predict_codes(cp_params, ccfg, last_hidden.to(dtype), cb0_embd,
                                      cp_draw, **samp)
        rest_sum = _rest_embd_sum(cp_params, rest)
    codes = torch.cat([cb0, rest.to(torch.int64)], out=codes_out)
    seen[cb0] = 1
    step_embd = (cb0_embd.float() + rest_sum + trailing_row.float()).to(dtype)
    if fused_talker:
        out = fused_talker_step(
            talker_params.blocks, tcfg, step_embd, n_past, kv,
            output_norm=talker_params.output_norm, codec_head=talker_params.codec_head,
            seen=seen, seed=cb0_draw, repetition_penalty=repetition_penalty, **cb0_kw)
        return codes, out.hidden.to(dtype), out.cb0
    hidden, logits = talker_model.talker_step(talker_params, tcfg, step_embd, n_past, kv)
    return codes, hidden, sample_cb0(logits[None], cb0_draw, seen=seen[None],
                                     repetition_penalty=repetition_penalty, **cb0_kw)


def generate_start(talker_params, cp_params, tokens, n_tokens: int, speaker_embd,
                   language_id: int, key, *, talker_cfg, cp_cfg,
                   chunk_frames: int, max_frames: int, kv_capacity: int, temperature: float,
                   top_k: int, top_p: float = 1.0, repetition_penalty: float = 1.05,
                   nothink: bool = False, allow_eos: bool = True, fused_cp="auto",
                   fused_talker="auto", kv_quant: str = "none"):
    """Prefill and the first chunk of up to chunk_frames frames: returns
    (LoopState, prefill), as ``generate_init`` then ``generate_chunk``
    (counterpart of ``generate_start``,
    ``qwen3tts_tpu/runtime/decode_loop.py:1072``; the JAX package fuses
    them into one dispatch, a single round trip of its device)."""
    samp = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty, allow_eos=allow_eos)
    state, prefill = generate_init(
        talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id, key,
        talker_cfg=talker_cfg, cp_cfg=cp_cfg, max_frames=max_frames, kv_capacity=kv_capacity,
        nothink=nothink, fused_talker=fused_talker, kv_quant=kv_quant, **samp)
    generate_chunk(talker_params, cp_params, prefill, state, talker_cfg=talker_cfg,
                   cp_cfg=cp_cfg, chunk_frames=chunk_frames, max_frames=max_frames,
                   fused_cp=fused_cp, fused_talker=fused_talker, **samp)
    return state, prefill


def generate_from_tokens(talker_params, cp_params, tokens, n_tokens: int,
                         speaker_embd, language_id: int, key, *,
                         talker_cfg, cp_cfg, max_frames: int, kv_capacity: int,
                         temperature: float, top_k: int, top_p: float = 1.0,
                         repetition_penalty: float = 1.05, nothink: bool = False,
                         fused_talker="auto", fused_cp="auto",
                         allow_eos: bool = True, kv_quant: str = "none",
                         progress_cb=None) -> GenerateResult:
    """Prefill + the frame loop for one request; see the module docstring:
    ``generate_init``, then one ``generate_chunk`` of max_frames frames.
    tokens [Tb] padded ids with n_tokens real ones; runs at most max_frames
    frames into a KV cache of kv_capacity rows (kv_quant "int8": the int8
    pair on the fused talker step). fused_talker / fused_cp pick
    kernels K1 / K2 or the unfused talker step / code predictor.
    allow_eos=False also suppresses EOS, so the request runs all max_frames
    frames (the JAX package's benchmark mode). progress_cb, if given, is
    called with the frames emitted so far after each frame, as the JAX
    loop's io_callback (``decode_loop.py:423-425``); the count is a host
    integer, so it adds no sync to the loop's one per frame."""
    samp = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty, allow_eos=allow_eos)
    state, prefill = generate_init(
        talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id, key,
        talker_cfg=talker_cfg, cp_cfg=cp_cfg, max_frames=max_frames, kv_capacity=kv_capacity,
        nothink=nothink, fused_talker=fused_talker, kv_quant=kv_quant, **samp)
    generate_chunk(talker_params, cp_params, prefill, state, talker_cfg=talker_cfg,
                   cp_cfg=cp_cfg, chunk_frames=max_frames, max_frames=max_frames,
                   fused_cp=fused_cp, fused_talker=fused_talker, progress_cb=progress_cb,
                   **samp)
    n = state.frame
    if n == 0:
        return GenerateResult(torch.zeros((0, talker_cfg.n_codebooks), dtype=torch.int64), 0,
                              torch.zeros((0, talker_cfg.hidden_size),
                                          dtype=state.hidden_out.dtype))
    return GenerateResult(state.codes[:n], n, state.hidden_out[:n])


def generate_from_tokens_batched(talker_params, cp_params, tokens, n_tokens, speaker_embd,
                                 language_ids, keys, *, talker_cfg, cp_cfg,
                                 max_frames: int, kv_capacity: int, temperature: float,
                                 top_k: int, top_p: float = 1.0,
                                 repetition_penalty: float = 1.05, nothink: bool = False,
                                 budgets=None, fused_talker="auto", fused_cp="auto",
                                 allow_eos: bool = True, kv_quant: str = "none",
                                 kv_layout: str = "batch") -> BatchedGenerateResult:
    """Prefill + the frame loop for B requests in lockstep (counterpart of
    ``_generate_batched_fused``, fused kernels, every weight tier; with both
    flags off, of the vmapped unfused loop, ``decode_loop.py:651-667``).

    tokens [B, Tb] padded ids with n_tokens[b] real ones (one shared Tb, so
    every lane's prefill window has the same length and the lanes share
    n_past); speaker_embd [B, H]; language_ids [B]; budgets, when given,
    caps lane b at budgets[b] frames; allow_eos=False suppresses EOS, and
    kv_quant "int8" stores the int8 pair [B, ...], as in
    generate_from_tokens; kv_layout "lane" keeps the fused step's
    compute-dtype cache lane-major (``lane_kv_layout``; the module
    docstring). The B prefill windows run as one prefill
    (``build_prefill`` and ``talker_prefill`` on [B, P, H], each projection
    one product of B*P rows, as continuous serving's refill runs them; every
    lane computes what its own prefill would); frame 0's cb0 from
    ``sample_cb0`` on the [B, Vc] prefill logits. Then per frame-set: K6 (in groups of
    CP_KERNEL_MAX_LANES lanes), or ``predict_codes`` on all B lanes as M = B
    rows, predicts codes 1..15 and rest_sum; the codes are written for
    emitting lanes only and their seen-sets updated; step_embd =
    codec_embd[cb0] + rest_sum + trailing[min(frame, Trb-1)]; K5, or
    ``talker_step`` on B lanes and ``sample_cb0``, steps every lane and
    samples its next cb0 (over a lane-major cache K5 returns logits and
    ``sample_cb0`` draws cb0 with the lane's k_cb0, as the unfused step's
    loop does; frame 0 too). EOS is latched per lane;
    finished lanes keep stepping with their emissions masked. The loop ends
    when every lane is done or after max_frames, with one host sync per
    frame-set.

    Keys: keys [B, 2] (the pipeline's split(prng_key(seed), B), or JAX
    keys); lane b's chain is the single stream's chain from keys[b], split
    per frame-set on the host over all lanes at once (numpy) after the
    frame-set's launches, its kernel seeds uploaded once a frame-set (one
    [2, B] int32 tensor). So lane b reproduces generate_from_tokens run
    with keys[b], whatever group of lanes it runs in.

    On a mesh (counterpart of the resolution at ``decode_loop.py:529-559``
    and of ``_generate_batched_shard_map``, :561-584), every rank calls this
    with the same global inputs and gets the global result. The kernels
    resolve on the params' placements (``resolve_fused_*``): a rank's
    tensor-parallel shard runs the unfused loop. When the mesh's "dp" axis
    divides B, dp rank r runs lanes [r B/dp, (r+1) B/dp) with their keys
    and budgets (the fused loop, K5, K6 and the W8A16 prefill, when the
    weights are replicated: ``kernel_safety.dp_kernel_mesh``), and the codes
    and frame counts are gathered over "dp" in lane order on the host. On a
    multi-device mesh whose "dp" does not divide B, every rank runs every
    lane, and replicated weights run unfused, as the JAX package's do
    (logged once).
    """
    fused_talker = resolve_fused_talker(fused_talker, talker_params)
    fused_cp = resolve_fused_cp(fused_cp, cp_params)
    B = int(tokens.shape[0])
    mesh = params_mesh(talker_params) or params_mesh(cp_params)
    if ((fused_cp or fused_talker) and params_mesh(talker_params) is not None
            and dp_kernel_mesh(talker_params, cp_params, B) is None):
        _log_once(("batched", B), f"qwen3tts: fused kernels off — weights on a "
                  f"{mesh.dp}x{mesh.tp} mesh whose dp does not divide the batch of {B}; "
                  "using the unfused path (parallel/kernel_safety.py)")
        fused_cp = fused_talker = False
    kw = dict(talker_cfg=talker_cfg, cp_cfg=cp_cfg, max_frames=max_frames,
              kv_capacity=kv_capacity, temperature=temperature, top_k=top_k, top_p=top_p,
              repetition_penalty=repetition_penalty, nothink=nothink, fused_talker=fused_talker,
              fused_cp=fused_cp, allow_eos=allow_eos, kv_quant=kv_quant, kv_layout=kv_layout)
    keys = prng.key_array(keys).reshape(B, 2)
    if mesh is None or mesh.dp == 1 or B % mesh.dp:
        return _generate_batched(talker_params, cp_params, tokens, n_tokens, speaker_embd,
                                 language_ids, keys, budgets=budgets, **kw)
    lo, hi = lane_range(mesh, B)

    def mine(x):
        return None if x is None else torch.as_tensor(x)[lo:hi]

    res = _generate_batched(talker_params, cp_params, mine(tokens), mine(n_tokens),
                            mine(speaker_embd), mine(language_ids), keys[lo:hi],
                            budgets=mine(budgets), **kw)
    frames = gather_lanes(torch.tensor(res.n_frames, dtype=torch.int64), mesh)
    return BatchedGenerateResult(gather_lanes(res.codes, mesh), frames.tolist())


def _generate_batched(talker_params, cp_params, tokens, n_tokens, speaker_embd, language_ids,
                      keys, *, talker_cfg, cp_cfg, max_frames: int, kv_capacity: int,
                      temperature: float, top_k: int, top_p: float, repetition_penalty: float,
                      nothink: bool, budgets, fused_talker: bool, fused_cp: bool,
                      allow_eos: bool, kv_quant: str, kv_layout: str) -> BatchedGenerateResult:
    """The batched loop of ``generate_from_tokens_batched`` on this rank's
    lanes (keys [B, 2]), with the kernels resolved."""
    tcfg = local_config(talker_cfg, talker_params.blocks)
    ccfg = local_config(cp_cfg, cp_params.blocks)
    quant_kv = int8_kv(kv_quant, fused_talker)
    lane = lane_kv_layout(kv_layout, fused_talker, quant_kv)
    # K5 samples cb0 in its epilogue over a batch-major cache only (the JAX
    # package's kernel_cb0 = ... and not lane_kv, decode_loop.py:747)
    kernel_cb0 = fused_talker and not lane
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
    init = prng.split(keys, 3)                                        # [B, 3, 2]
    chain = init[:, 0] if kernel_cb0 else keys
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
        elif lane:
            kv = to_lane_major(kv)
        cb0_next = sample_cb0(logits, init[:, 1], **cb0_kw)
        draws = frame_draws(chain, fused_cp, kernel_cb0)
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
            chain, cb0_draw, cp_draw = draws
            if fused_cp or kernel_cb0:
                # the kernels' seeds of this frame-set: [0] K6, [1] K5
                seeds = prng.to_device(np.stack([
                    cp_draw if fused_cp else np.zeros(B, np.int32),
                    cb0_draw if kernel_cb0 else np.zeros(B, np.int32)]), dev)
            cb0_embd = talker_params.codec_embd[cb0]                    # [B, H]
            if fused_cp:
                rest, rest_sum = [], []
                for o in range(0, B, CP_KERNEL_MAX_LANES):
                    r, rs = fused_predict_codes_batched(
                        cp_params, ccfg, last_hidden[o:o + CP_KERNEL_MAX_LANES],
                        cb0_embd[o:o + CP_KERNEL_MAX_LANES],
                        seeds[0, o:o + CP_KERNEL_MAX_LANES], **samp)
                    rest.append(r.to(torch.int64))
                    rest_sum.append(rs)
                rest, rest_sum = torch.cat(rest), torch.cat(rest_sum)
            else:
                rest = cp_model.predict_codes(cp_params, ccfg, last_hidden, cb0_embd,
                                              cp_draw, **samp)
                rest_sum = _rest_embd_sum(cp_params, rest)
            frame_codes = torch.cat([cb0[:, None], rest], dim=1)
            codes[:, it] = torch.where(emit[:, None], frame_codes, codes[:, it])
            seen[lanes, cb0] |= emit.to(torch.int8)
            trailing_row = trailing[lanes, torch.clamp(frame, max=Trb - 1)]
            step_embd = (cb0_embd.float() + rest_sum + trailing_row.float()).to(dtype)
            if kernel_cb0:
                out = fused_talker_step_batched(
                    talker_params.blocks, tcfg, step_embd, n_past, kv,
                    output_norm=talker_params.output_norm,
                    codec_head=talker_params.codec_head, seen=seen, seeds=seeds[1],
                    repetition_penalty=repetition_penalty, **cb0_kw)
                last_hidden, cb0_next = out.hidden.to(dtype), out.cb0
                # the next frame-set's keys, while the card runs this one
                draws = frame_draws(chain, fused_cp, kernel_cb0)
            else:
                if fused_talker:   # K5 over the lane-major cache: logits out
                    out = fused_talker_step_batched(
                        talker_params.blocks, tcfg, step_embd, n_past, kv,
                        output_norm=talker_params.output_norm,
                        codec_head=talker_params.codec_head, kv_layout="lane")
                    last_hidden, logits = out.hidden.to(dtype), out.logits
                else:
                    last_hidden, logits = talker_model.talker_step(
                        talker_params, tcfg, step_embd, n_past, kv)
                draws = frame_draws(chain, fused_cp, kernel_cb0)
                cb0_next = sample_cb0(logits, draws[1], seen=seen,
                                      repetition_penalty=repetition_penalty, **cb0_kw)
            frame = frame + emit.to(torch.int64)
            done = done | (frame >= cap)
            n_past += 1
    return BatchedGenerateResult(codes.cpu(), frame.cpu().tolist())
