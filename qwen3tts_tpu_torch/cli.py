"""qwen3-tts CLI of the port (counterpart of ``qwen3tts_tpu/cli.py``): the
JAX package's 17 flags with the same defaults, plus ``--device``.

    python -m qwen3tts_tpu_torch.cli -m <model_dir> -t "Hello, world!" -o out.wav
    python -m qwen3tts_tpu_torch.cli -m <model_dir> -t "Hello!" -r ref.wav -o c.wav
    python -m qwen3tts_tpu_torch.cli -m <model_dir> -t "Hello!" --device cpu

The model directory holds HF safetensors checkpoints or the reference's GGUF
files (``Qwen3TTS.load_models``). It runs on the CUDA device unless
``--device`` names another (``cpu``: every kernel's plain PyTorch version);
there is no fallback from a missing GPU. ``--quant`` picks the weight tier
(``int8``: the kernels' serving tier), ``--synthetic`` random weights at the
0.6B widths. ``-j`` is accepted for parity with the reference and unused.
"""

from __future__ import annotations

import argparse
import sys

from .config import RuntimeConfig, SamplingConfig
from .pipeline import LANGUAGE_IDS, Qwen3TTS, save_wav


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3-tts", description="Qwen3-TTS text-to-speech on an NVIDIA GPU (PyTorch/CUDA)")
    p.add_argument("-m", "--model", default=None, help="Model directory (HF checkpoints)")
    p.add_argument("-t", "--text", required=True, help="Text to synthesize")
    p.add_argument("-o", "--output", default="output.wav", help="Output WAV file")
    p.add_argument("-r", "--reference", default=None, help="Reference audio for voice cloning")
    p.add_argument("--temperature", type=float, default=0.9,
                   help="Sampling temperature (0=greedy)")
    p.add_argument("--top-k", type=int, default=50, help="Top-k sampling (0=disabled)")
    p.add_argument("--top-p", type=float, default=1.0, help="Top-p (nucleus) sampling")
    p.add_argument("--max-tokens", type=int, default=4096, help="Maximum audio frames")
    p.add_argument("--repetition-penalty", type=float, default=1.05)
    p.add_argument("-l", "--language", default="en",
                   help="Language: " + ",".join(sorted(k for k in LANGUAGE_IDS if len(k) == 2)))
    p.add_argument("--seed", type=int, default=0, help="Sampling PRNG seed")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--quant", choices=["none", "int8", "q4", "q4pure"], default="none",
                   help="Weight quantization (int8 = Q8_0-parity serving mode; q4 = mixed "
                        "attn-int8/ffn-4bit talker; q4pure = all-4bit talker)")
    p.add_argument("--synthetic", action="store_true",
                   help="Run with deterministic synthetic weights (no checkpoint needed)")
    p.add_argument("--progress", action="store_true", help="Print per-frame progress")
    p.add_argument("--no-timing", action="store_true", help="Suppress the timing report")
    # accepted for flag parity with the reference
    p.add_argument("-j", "--threads", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the plain versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    lang = args.language.lower()
    if lang not in LANGUAGE_IDS:
        print(f"Error: unknown language '{args.language}'. Supported: "
              + ",".join(sorted(k for k in LANGUAGE_IDS if len(k) == 2)), file=sys.stderr)
        return 1

    from .io.config_io import config_from_model_dir
    cfg = config_from_model_dir(
        None if args.synthetic else args.model,
        RuntimeConfig(dtype=args.dtype, quant=None if args.quant == "none" else args.quant))
    tts = Qwen3TTS(cfg, device=args.device)

    print(f"Loading models from: {args.model or '<synthetic>'}", file=sys.stderr)
    if not tts.load_models(args.model, synthetic=args.synthetic or args.model is None,
                           seed=args.seed):
        print(f"Error: {tts.error_msg}", file=sys.stderr)
        return 1

    if args.progress:
        tts.set_progress_callback(
            lambda frames, total: print(f"\rGenerating: {frames}/{total} frames",
                                        end="", file=sys.stderr))

    params = SamplingConfig(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        max_audio_tokens=args.max_tokens, language_id=LANGUAGE_IDS[lang], seed=args.seed)

    if args.reference:
        print(f'Synthesizing with voice cloning: "{args.text}"', file=sys.stderr)
        result = tts.synthesize_with_voice(args.text, args.reference, params)
    else:
        print(f'Synthesizing: "{args.text}"', file=sys.stderr)
        result = tts.synthesize(args.text, params)

    if args.progress:
        print(file=sys.stderr)
    if not result.success:
        print(f"Error: {result.error_msg}", file=sys.stderr)
        return 1

    save_wav(args.output, result.audio, result.sample_rate)
    print(f"Output saved to: {args.output}", file=sys.stderr)
    print(f"Audio duration: {result.audio_seconds:.2f} seconds", file=sys.stderr)
    if not args.no_timing:
        result.timings.report(result.audio_seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
