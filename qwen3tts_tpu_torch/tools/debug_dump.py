#!/usr/bin/env python3
"""Dump the port's per-stage intermediate tensors for debugging numerics
(counterpart of ``tools/debug_dump.py``: the same flags and the same .npy
file names, so a dump of each package diffs stage by stage; the tool to
reach for when a stage fails its verify_stage bar).

    python3 qwen3tts_tpu_torch/tools/debug_dump.py --out dump/ \\
        [--model <dir>|--synthetic] [--text "Hello."] \\
        [--reference-audio ref.wav] [--tiny] [--device cpu]

Files: text_tokens, mel (with --reference-audio), speaker_embedding,
prefill_embedding, trailing_text_hidden, tts_pad_embed,
first_frame_logits, prefill_last_hidden, speech_codes, vq_latent,
decoded_audio. Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qwen3tts_tpu_torch.audio import mel as mel_mod  # noqa: E402
from qwen3tts_tpu_torch.audio.wav import load_wav, resample_linear  # noqa: E402
from qwen3tts_tpu_torch.config import SamplingConfig  # noqa: E402
from qwen3tts_tpu_torch.models import talker as talker_model  # noqa: E402
from qwen3tts_tpu_torch.ops.precision import full_float32  # noqa: E402
from qwen3tts_tpu_torch.pipeline import LANGUAGE_IDS  # noqa: E402
from qwen3tts_tpu_torch.tools import goldens as gl  # noqa: E402

# the JAX tool's prefill cache
KV_CAPACITY = 256


def debug_dump(tts, out: str, *, text: str = "Hello.", language: str = "en",
               reference_audio=None, max_frames: int = 16, tiny: bool = False,
               verbose: bool = True) -> list:
    """Write every stage's tensor of tts on text as out/<name>.npy; returns
    the names in the order written."""
    os.makedirs(out, exist_ok=True)
    cfg = tts.config
    names = []

    def dump(name, arr):
        arr = gl.host(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
        np.save(os.path.join(out, name + ".npy"), arr)
        names.append(name)
        if verbose:
            print(f"  {name:<28} {str(arr.shape):<18} {arr.dtype}")

    lang_id = LANGUAGE_IDS[language.lower()]
    tokens = np.array(tts.tokenizer.encode_for_tts(text), np.int32)
    dump("text_tokens", tokens)

    if reference_audio:
        samples, sr = load_wav(reference_audio)
        secfg = cfg.speaker_encoder
        if sr != secfg.sample_rate:
            samples = resample_linear(samples, sr, secfg.sample_rate)
        samples = samples[:max(cfg.runtime.speaker_buckets)]
        x = torch.as_tensor(samples, device=tts.device)
        fb = torch.from_numpy(mel_mod.slaney_mel_filterbank(secfg)).to(tts.device)
        win = torch.from_numpy(mel_mod.centered_hann(secfg)).to(tts.device)
        with full_float32(), torch.no_grad():
            dump("mel", mel_mod.log_mel(x, secfg, fb, win))
        speaker = tts.extract_speaker_embedding(samples)
    else:
        speaker = np.zeros((cfg.talker.hidden_size,), np.float32)
    dump("speaker_embedding", speaker)

    pre, pad = gl.build_prefill(tts, tokens.astype(np.int64), speaker, lang_id, tiny)
    dump("prefill_embedding", pre.prefill_embd)
    dump("trailing_text_hidden", pre.trailing[:int(pre.trailing_len)])
    dump("tts_pad_embed", pad)

    tp = tts.talker_params
    with torch.no_grad(), full_float32():
        kv = talker_model.make_kv_cache(cfg.talker, KV_CAPACITY, tp.codec_embd.dtype,
                                        tts.device)
        hidden, logits = talker_model.talker_prefill(tp, cfg.talker, pre.prefill_embd, kv)
    dump("first_frame_logits", logits)
    dump("prefill_last_hidden", hidden)

    params = SamplingConfig(temperature=0.0, top_k=0, language_id=lang_id,
                            max_audio_tokens=max_frames)
    r = tts._synthesize_internal(text, speaker, params, 0.0)
    if not r.success:
        raise RuntimeError(r.error_msg)
    dump("speech_codes", r.codes)

    vp, vcfg = tts.vocoder_params, cfg.vocoder
    codes = torch.as_tensor(r.codes, dtype=torch.int64, device=tts.device)
    with torch.no_grad(), full_float32():
        first = vp.vq_first_cb[codes[:, 0]]
        rest = vp.vq_rest_cb[torch.arange(vcfg.n_codebooks - 1, device=tts.device),
                             codes[:, 1:]]
        latent = first @ vp.vq_first_proj + torch.sum(rest, dim=1) @ vp.vq_rest_proj
    dump("vq_latent", latent)
    dump("decoded_audio", r.audio)
    return names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    gl.add_model_args(ap)
    ap.add_argument("--text", default="Hello.")
    ap.add_argument("--language", default="en")
    ap.add_argument("--reference-audio", default=None)
    ap.add_argument("--max-frames", type=int, default=16)
    args = ap.parse_args(argv)
    try:
        tts = gl.load_pipeline(args)
        debug_dump(tts, args.out, text=args.text, language=args.language,
                   reference_audio=args.reference_audio, max_frames=args.max_frames,
                   tiny=args.tiny)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"dumped to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
