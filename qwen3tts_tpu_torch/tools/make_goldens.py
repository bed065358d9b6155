#!/usr/bin/env python3
"""Generate deterministic golden fixtures (det_*.bin + det_metadata.json)
from a checkpoint with the port (counterpart of ``tools/make_goldens.py``,
the same flags and files, so either package's ``verify_stage`` reads the
other's goldens).

Runs the full pipeline in float32 with greedy decoding on "Hello." and
dumps the intermediate artifacts with shapes and sha256 into
det_metadata.json: the speaker embedding, the text tokens, the prefill
embedding, the trailing text schedule, tts_pad's embedding, the speech
codes, the per-frame hidden states, the decoded audio and a WAV of it.

    python3 qwen3tts_tpu_torch/tools/make_goldens.py --model <dir> --out reference/ \\
        [--text "Hello."] [--reference-audio clone.wav] [--device cpu]

--synthetic (or no --model) uses the port's seeded synthetic weights, a
self-test of the harness only. Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from qwen3tts_tpu_torch.audio.wav import load_wav, resample_linear, save_wav  # noqa: E402
from qwen3tts_tpu_torch.config import SamplingConfig  # noqa: E402
from qwen3tts_tpu_torch.pipeline import LANGUAGE_IDS  # noqa: E402
from qwen3tts_tpu_torch.tools import goldens  # noqa: E402


def _dump(out_dir: str, meta: dict, name: str, array: np.ndarray, dtype):
    array = np.ascontiguousarray(np.asarray(array).astype(dtype))
    array.tofile(os.path.join(out_dir, name))
    meta["outputs"][name] = {
        "path": name,
        "shape": list(array.shape),
        "dtype": str(array.dtype),
        "size_bytes": array.nbytes,
        "sha256": hashlib.sha256(array.tobytes()).hexdigest(),
    }


def make_goldens(tts, out: str, *, text: str = "Hello.", language: str = "en",
                 reference_audio=None, max_frames: int = 64, tiny: bool = False,
                 synthetic_seed=None) -> dict:
    """Write the goldens of tts's greedy run on text into out; returns the
    metadata (raises RuntimeError when the synthesis fails)."""
    cfg = tts.config
    os.makedirs(out, exist_ok=True)
    lang_id = LANGUAGE_IDS[language.lower()]
    meta = {
        "synthesis_text": text,
        "language": language,
        "dtype": cfg.runtime.dtype,
        "synthetic_seed": synthetic_seed,
        "generation": {"max_new_tokens": max_frames, "do_sample": False},
        "token_ids": {
            "tts_bos_token_id": cfg.talker.tts_bos_token_id,
            "tts_eos_token_id": cfg.talker.tts_eos_token_id,
            "tts_pad_token_id": cfg.talker.tts_pad_token_id,
            "codec_bos_id": cfg.talker.codec_bos_id,
            "codec_eos_token_id": cfg.talker.codec_eos_id,
            "codec_pad_id": cfg.talker.codec_pad_id,
            "language_id": lang_id,
        },
        "outputs": {},
    }
    if reference_audio:
        samples, sr = load_wav(reference_audio)
        if sr != cfg.speaker_encoder.sample_rate:
            samples = resample_linear(samples, sr, cfg.speaker_encoder.sample_rate)
        speaker = tts.extract_speaker_embedding(samples)
    else:
        speaker = np.zeros((cfg.talker.hidden_size,), np.float32)
    _dump(out, meta, "det_speaker_embedding.bin", speaker, np.float32)

    tokens = np.array(tts.tokenizer.encode_for_tts(text), np.int64)
    _dump(out, meta, "det_text_tokens.bin", tokens[None, :], np.int64)

    pre, pad = goldens.build_prefill(tts, tokens, speaker, lang_id, tiny)
    _dump(out, meta, "det_prefill_embedding.bin", goldens.host(pre.prefill_embd)[None],
          np.float32)
    _dump(out, meta, "det_trailing_text.bin",
          goldens.host(pre.trailing[:int(pre.trailing_len)])[None], np.float32)
    _dump(out, meta, "det_tts_pad_embed.bin", goldens.host(pad)[None, None], np.float32)

    params = SamplingConfig(temperature=0.0, top_k=0,
                            repetition_penalty=goldens.REPETITION_PENALTY,
                            max_audio_tokens=max_frames, language_id=lang_id)
    result = tts._synthesize_internal(text, speaker, params, 0.0)
    if not result.success:
        raise RuntimeError(result.error_msg)
    _dump(out, meta, "det_speech_codes.bin", result.codes, np.int64)
    if result.hidden_states is not None:
        _dump(out, meta, "det_hidden_states.bin", result.hidden_states[:result.n_frames],
              np.float32)
    _dump(out, meta, "det_decoded_audio.bin", result.audio, np.float32)
    save_wav(os.path.join(out, "det_output.wav"), result.audio, result.sample_rate)
    meta["wav"] = {
        "path": "det_output.wav",
        "sample_rate": result.sample_rate,
        "num_samples": int(len(result.audio)),
        "duration_seconds": result.audio_seconds,
    }
    with open(os.path.join(out, "det_metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    goldens.add_model_args(ap)
    ap.add_argument("--text", default="Hello.")
    ap.add_argument("--language", default="en")
    ap.add_argument("--reference-audio", default=None)
    ap.add_argument("--max-frames", type=int, default=64)
    ap.add_argument("--out", default="reference")
    args = ap.parse_args(argv)
    synthetic = args.synthetic or args.model is None
    try:
        tts = goldens.load_pipeline(args)
        meta = make_goldens(tts, args.out, text=args.text, language=args.language,
                            reference_audio=args.reference_audio,
                            max_frames=args.max_frames, tiny=args.tiny,
                            synthetic_seed=args.seed if synthetic else None)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {len(meta['outputs'])} fixtures + det_metadata.json to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
