#!/usr/bin/env python3
"""Full-scale loader self-check of the port (counterpart of
``tools/selfcheck_fullsize.py``): write a checkpoint at the real 0.6B
shapes (``hf_fixture.write_checkpoint_dir`` at ``PipelineConfig()``: BF16
main model, float32 tokenizer, config.json, vocab.json and merges.txt),
load it through the complete pipeline (config inference, tokenizer, all
four loaders), audit the loaded talker's shapes against the configured
ones, synthesize a few greedy frames (``len(audio) == frames * 1920``) and
run the voice-cloning path.

Catches full-size-only problems (layout mistakes, memory, shape
mismatches) before real weights are available. Writes 2.29 GB and loads it
on the card (--device cpu to load on the host).

    python3 qwen3tts_tpu_torch/tools/selfcheck_fullsize.py [--dir DIR] [--keep] \\
        [--frames 2] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from qwen3tts_tpu_torch.config import PipelineConfig, RuntimeConfig, SamplingConfig  # noqa: E402
from qwen3tts_tpu_torch.models import talker as talker_model  # noqa: E402
from qwen3tts_tpu_torch.pipeline import Qwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.tools import hf_fixture, inspect_checkpoint  # noqa: E402


def selfcheck(root: str, cfg: PipelineConfig, *, frames: int = 2, device="cuda",
              runtime=None, log=print) -> dict:
    """The checks under root (a fresh directory); raises AssertionError on
    the first that fails. Returns the figures (parameters, seconds,
    frames)."""
    out = {}
    t0 = time.perf_counter()
    tts_dir, tok_dir = hf_fixture.write_checkpoint_dir(root, cfg)
    out["write_s"] = time.perf_counter() - t0
    log(f"  checkpoint written in {out['write_s']:.1f} s")

    runtime = runtime or RuntimeConfig(dtype="bfloat16", frame_buckets=(8,),
                                       vocoder_buckets=(8,), speaker_buckets=(24000,))
    tts = Qwen3TTS(dataclasses.replace(cfg, runtime=runtime), device)
    t0 = time.perf_counter()
    assert tts.load_models(root), tts.error_msg
    out["load_s"] = time.perf_counter() - t0
    log(f"loaded the full-size checkpoint in {out['load_s']:.1f} s")

    ref = talker_model.init_talker_params(None, cfg.talker, tts.dtype, "meta")
    errors = inspect_checkpoint.shape_errors("talker", tts.talker_params, ref)
    assert not errors, f"shape audit failed: {errors}"
    log("talker shape audit vs configured shapes: OK")

    greedy = SamplingConfig(temperature=0.0, top_k=0, max_audio_tokens=frames)
    t0 = time.perf_counter()
    r = tts.synthesize("hello world", greedy)
    assert r.success, r.error_msg
    assert len(r.audio) == r.n_frames * 1920, (len(r.audio), r.n_frames)
    out.update(frames=r.n_frames, samples=len(r.audio), synth_s=time.perf_counter() - t0)
    log(f"synthesized {r.n_frames} frames ({len(r.audio)} samples) in {out['synth_s']:.1f} s")

    t0 = time.perf_counter()
    voice = (np.random.default_rng(0).normal(size=24000) * 0.1).astype(np.float32)
    r2 = tts.synthesize_with_voice("hello", voice, greedy)
    assert r2.success, r2.error_msg
    assert len(r2.audio) == r2.n_frames * 1920
    out["voice_s"] = time.perf_counter() - t0
    log(f"voice-clone path OK in {out['voice_s']:.1f} s")
    out["parameters"] = sum(inspect_checkpoint.count_params(tree) for tree in (
        tts.talker_params, tts.cp_params, tts.vocoder_params, tts.speaker_params))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=None, help="where to write (default: a new temporary "
                                                "directory)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = args.dir or tempfile.mkdtemp(prefix="qwen3tts_fullsize_")
    os.makedirs(root, exist_ok=True)
    try:
        out = selfcheck(root, PipelineConfig(), frames=args.frames, device=args.device)
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    print(f"{out['parameters']:,} parameters loaded")
    print("fullsize selfcheck PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
