#!/usr/bin/env python3
"""End-to-end comparison of the port against golden fixtures with the
reference's acceptance gates (counterpart of ``tools/compare_e2e.py``, the
same flags and ``GATES``; scripts/compare_e2e.py:33-38, 255-270):

  - both waveforms RMS > 0.001
  - duration ratio within (0.5, 1.5)
  - > 1000 samples (any count with --tiny)
  - waveform correlation, CB0 and frame-exact code matches reported
    (informational: AR divergence under reduced precision is expected,
    README.md:257-262)

    python3 qwen3tts_tpu_torch/tools/compare_e2e.py --goldens reference/ \\
        [--model <dir>|--synthetic] [--device cpu]

Prints the report as JSON; exits 1 when a gate fails. Runs on the card
unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from qwen3tts_tpu_torch.config import SamplingConfig  # noqa: E402
from qwen3tts_tpu_torch.tools import goldens as gl  # noqa: E402

GATES = {"min_rms": 0.001, "dur_ratio": (0.5, 1.5), "min_samples": 1000}


def compare_waveforms(a: np.ndarray, b: np.ndarray, min_samples=None) -> dict:
    n = min(len(a), len(b))
    a_, b_ = a[:n].astype(np.float64), b[:n].astype(np.float64)
    rms_a = float(np.sqrt(np.mean(a_ ** 2))) if n else 0.0
    rms_b = float(np.sqrt(np.mean(b_ ** 2))) if n else 0.0
    corr = 0.0
    if n > 1 and rms_a > 0 and rms_b > 0:
        corr = float(np.corrcoef(a_, b_)[0, 1])
    ratio = len(a) / max(len(b), 1)
    min_n = GATES["min_samples"] if min_samples is None else min_samples
    return {
        "rms_a": rms_a,
        "rms_b": rms_b,
        "duration_ratio": ratio,
        "correlation": corr,
        "n_samples": n,
        "pass": (rms_a > GATES["min_rms"] and rms_b > GATES["min_rms"]
                 and GATES["dur_ratio"][0] < ratio < GATES["dur_ratio"][1]
                 and n > min_n),
    }


def compare(tts, goldens: gl.Goldens, tiny: bool = False) -> dict:
    """The gates' report of tts's greedy synthesis (default voice) of the
    goldens' text against their audio and codes. Raises RuntimeError when
    the synthesis fails."""
    meta = goldens.meta
    golden_audio = goldens.bin("det_decoded_audio.bin", np.float32)
    golden_codes = goldens.codes()
    params = SamplingConfig(
        temperature=0.0, top_k=0, repetition_penalty=gl.REPETITION_PENALTY,
        max_audio_tokens=meta["generation"]["max_new_tokens"],
        language_id=meta["token_ids"]["language_id"])
    result = tts.synthesize(meta["synthesis_text"], params)
    if not result.success:
        raise RuntimeError(result.error_msg)
    n = min(len(golden_codes), len(result.codes))
    report = compare_waveforms(result.audio, golden_audio, min_samples=0 if tiny else None)
    report["cb0_exact_match"] = (float((result.codes[:n, 0] == golden_codes[:n, 0]).mean())
                                 if n else 0.0)
    report["frame_exact_match"] = (float((result.codes[:n] == golden_codes[:n]).all(axis=1)
                                         .mean()) if n else 0.0)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--goldens", required=True)
    gl.add_model_args(ap)
    args = ap.parse_args(argv)
    try:
        tts = gl.load_pipeline(args)
        report = compare(tts, gl.Goldens(args.goldens), args.tiny)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
