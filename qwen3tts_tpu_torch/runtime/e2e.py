"""The time-to-first-audio path (counterpart of ``start_and_vocode`` in
``qwen3tts_tpu/runtime/e2e.py``): the prefill, the first chunk of frames
and the vocoder over that chunk, for ``Qwen3TTS.synthesize_streaming``.

The JAX package runs the three as one jitted program, so that the first
audio costs one dispatch of its remote device; the port runs them one after
another on one stream, which enqueues the vocoder behind the chunk without
a host round trip between them (the loop's per-frame EOS check is the only
sync). ``generate_and_vocode`` (``RuntimeConfig.fused_dispatch``) is not
ported.
"""

from __future__ import annotations

import torch

from ..models import vocoder as vocoder_model
from . import decode_loop


def start_and_vocode(talker_params, cp_params, vocoder_params, tokens, n_tokens: int,
                     speaker_embd, language_id: int, key, *, talker_cfg,
                     cp_cfg, vocoder_cfg, chunk_frames: int, max_frames: int,
                     kv_capacity: int, temperature: float, top_k: int, top_p: float = 1.0,
                     repetition_penalty: float = 1.05, nothink: bool = False,
                     allow_eos: bool = True, fused_cp="auto", fused_talker="auto",
                     kv_quant: str = "none"):
    """``decode_loop.generate_start`` (prefill + up to chunk_frames frames),
    then the vocoder over exactly the frames that chunk emitted. Returns
    (audio [n0 * samples_per_frame] float32 on the weights' device, the
    LoopState, the prefill), n0 = min(state.frame, chunk_frames); continue
    with ``decode_loop.generate_chunk``. key: the request's threefry key, as
    ``generate_init`` takes it. The JAX package vocodes the chunk
    padded to chunk_frames rows and masks the padding: the stack is causal,
    so its first n0 frames' samples are these."""
    state, prefill = decode_loop.generate_start(
        talker_params, cp_params, tokens, n_tokens, speaker_embd, language_id, key,
        talker_cfg=talker_cfg, cp_cfg=cp_cfg, chunk_frames=chunk_frames,
        max_frames=max_frames, kv_capacity=kv_capacity, temperature=temperature,
        top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty, nothink=nothink,
        allow_eos=allow_eos, fused_cp=fused_cp, fused_talker=fused_talker, kv_quant=kv_quant)
    n0 = min(state.frame, chunk_frames)
    if n0 == 0:
        audio = torch.zeros((0,), dtype=torch.float32, device=state.codes.device)
    else:
        audio = vocoder_model.vocoder_decode(vocoder_params, vocoder_cfg, state.codes[:n0], n0)
    return audio, state, prefill
