#!/usr/bin/env python3
"""Per-stage verification of the port against deterministic golden fixtures
(counterpart of ``tools/verify_stage.py``: the same flags, stages and
bars). Each stage of the live pipeline is compared against the det_*.bin
artifacts of a goldens directory, written by either package's
make_goldens.py or by the reference's generate_deterministic_reference.py
(the binary formats match).

    python3 qwen3tts_tpu_torch/tools/verify_stage.py --goldens reference/ \\
        --model <dir> [--stage tokenizer|prefill|transformer|decoder|all] \\
        [--teacher-forced] [--device cpu]

Bars (the JAX tool's, ``verify_stage.py:107-138``): exact token ids;
prefill-embedding cosine > 0.9999; per-codebook code match rates, CB0 >=
81% and CB1-4 >= 80% (the reference's parity bars, README.md:260-261);
decoded waveform correlation > 0.95 or RMS error < 0.01. Exits 1 when a
bar fails. --teacher-forced adds two [INFO] lines, not bars: the golden
codes fed to the talker and code predictor (the share of frames whose
greedy next code equals the golden one, per codebook), and the golden
codes vocoded (maximum and RMS error against det_decoded_audio.bin).
Runs on the card unless --device cpu.
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

STAGES = ("tokenizer", "prefill", "transformer", "decoder", "all")
BARS = dict(prefill_cosine=0.9999, cb0_match=0.81, cb1_4_match=0.80,
            audio_correlation=0.95, audio_rms_err=0.01)


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom > 0 else 0.0


def verify(tts, goldens: gl.Goldens, stage: str = "all", tiny: bool = False) -> list:
    """The bars of `stage` on tts: a list of dicts (stage, ok, detail, and
    the figures the bar reads). Raises RuntimeError when the synthesis
    fails."""
    cfg, meta = tts.config, goldens.meta
    text = meta["synthesis_text"]
    lang_id = meta["token_ids"]["language_id"]
    out = []

    def report(name, ok, detail, **figures):
        out.append(dict(stage=name, ok=bool(ok), detail=detail, **figures))

    want_tokens = goldens.bin("det_text_tokens.bin", np.int64)
    tokens = np.array(tts.tokenizer.encode_for_tts(text), np.int64)
    if stage in ("tokenizer", "all") and want_tokens is not None:
        ok = np.array_equal(tokens, want_tokens.ravel())
        report("tokenizer", ok, f"{tokens.tolist()} vs {want_tokens.ravel().tolist()}")

    speaker = goldens.speaker(cfg.talker.hidden_size)
    if stage in ("prefill", "all"):
        want = goldens.bin("det_prefill_embedding.bin", np.float32)
        if want is not None:
            pre, _ = gl.build_prefill(tts, tokens, speaker, lang_id, tiny)
            cos = _cosine(gl.host(pre.prefill_embd), want)
            report("prefill_embedding", cos > BARS["prefill_cosine"], f"cosine {cos:.8f}",
                   cosine=cos)

    if stage == "tokenizer" or stage == "prefill":
        return out
    params = SamplingConfig(temperature=0.0, top_k=0, repetition_penalty=gl.REPETITION_PENALTY,
                            max_audio_tokens=meta["generation"]["max_new_tokens"],
                            language_id=lang_id)
    result = tts._synthesize_internal(text, speaker, params, 0.0)
    if not result.success:
        raise RuntimeError(result.error_msg)

    if stage in ("transformer", "all"):
        want_codes = goldens.bin("det_speech_codes.bin", np.int64)
        if want_codes is not None:
            want_codes = want_codes.reshape(-1, gl.N_CODEBOOKS)
            n = min(len(want_codes), len(result.codes))
            cb0 = float((result.codes[:n, 0] == want_codes[:n, 0]).mean()) if n else 0.0
            cb_rest = float((result.codes[:n, 1:5] == want_codes[:n, 1:5]).mean()) if n else 0.0
            ok = cb0 >= BARS["cb0_match"] and cb_rest >= BARS["cb1_4_match"]
            report("transformer_codes", ok,
                   f"cb0 match {cb0:.2%}, cb1-4 match {cb_rest:.2%}, frames {n}",
                   cb0_match=cb0, cb1_4_match=cb_rest, frames=n,
                   frames_golden=len(want_codes), frames_run=int(result.n_frames),
                   codes_equal=bool(np.array_equal(result.codes, want_codes)))

    if stage in ("decoder", "all"):
        want_audio = goldens.bin("det_decoded_audio.bin", np.float32)
        if want_audio is not None:
            n = min(len(want_audio), len(result.audio))
            corr = _cosine(result.audio[:n], want_audio[:n])
            rms = float(np.sqrt(np.mean((result.audio[:n] - want_audio[:n]) ** 2)))
            report("decoder_audio", corr > BARS["audio_correlation"] or rms < BARS["audio_rms_err"],
                   f"correlation {corr:.4f}, rms-err {rms:.5f}, samples {n}",
                   correlation=corr, rms_err=rms, samples=n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--goldens", required=True)
    gl.add_model_args(ap)
    ap.add_argument("--stage", default="all", choices=STAGES)
    ap.add_argument("--teacher-forced", action="store_true",
                    help="also print the teacher-forced code agreement and vocoder error")
    args = ap.parse_args(argv)
    goldens = gl.Goldens(args.goldens)
    try:
        tts = gl.load_pipeline(args)
        bars = verify(tts, goldens, args.stage, args.tiny)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for b in bars:
        print(f"[{'PASS' if b['ok'] else 'FAIL'}] {b['stage']}: {b['detail']}")
    if args.teacher_forced:
        print(f"[INFO] route: {json.dumps(gl.route(tts))}")
        print(f"[INFO] teacher_forced: {json.dumps(gl.teacher_forced(tts, goldens))}")
        print(f"[INFO] vocoder_on_golden_codes: {json.dumps(gl.vocode_goldens(tts, goldens))}")
    n_fail = sum(not b["ok"] for b in bars)
    print(f"\n{len(bars) - n_fail} passed, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
