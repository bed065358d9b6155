#!/usr/bin/env python3
"""Dump tensor names, shapes and dtypes of a checkpoint (an HF safetensors
directory or a GGUF file) and audit them against the configured model
shapes (counterpart of ``tools/inspect_checkpoint.py``: the same report).

    python3 qwen3tts_tpu_torch/tools/inspect_checkpoint.py <path> \\
        [--audit tts|tokenizer] [--tiny] [--device cpu]

--audit loads the checkpoint through the port's loaders in float32 (GGUF
through the native reader), prints each stage's parameter count as the
JAX tool does, and holds every loaded leaf's shape against the shape the
config gives (``PipelineConfig()``'s 0.6B widths, or the tiny config with
--tiny). A loader that fails or a leaf of another shape fails the audit:
it is printed, and the tool exits 1. Loads on the card unless --device cpu.
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

from qwen3tts_tpu_torch.config import PipelineConfig, tiny_pipeline_config  # noqa: E402
from qwen3tts_tpu_torch.io import loader as loader_mod  # noqa: E402
from qwen3tts_tpu_torch.io.gguf import GGUFReader  # noqa: E402
from qwen3tts_tpu_torch.io.gguf_checkpoint import GGUFCheckpoint  # noqa: E402
from qwen3tts_tpu_torch.io.safetensors_io import SafetensorsDir  # noqa: E402
from qwen3tts_tpu_torch.models import code_predictor, speaker_encoder, talker, vocoder  # noqa: E402

GGML_TYPE_NAMES = {0: "f32", 1: "f16", 8: "q8_0"}


def iter_tensors(path: str):
    """(name, shape, dtype name) of every tensor, sorted by name; dtypes as
    the JAX tool names them (numpy's names; GGUF f32/f16/q8_0, other GGML
    types by number)."""
    if os.path.isdir(path):
        sub = os.path.join(path, "speech_tokenizer")
        st = SafetensorsDir(sub if os.path.isdir(sub) else path)
        for name in sorted(st.keys()):
            t = st.tensor(name)
            yield name, tuple(t.shape), str(t.dtype).replace("torch.", "")
    elif path.endswith(".gguf"):
        r = GGUFReader(path)
        for name in sorted(r.keys()):
            shape, ttype, _ = r.tensors[name]
            yield name, shape, GGML_TYPE_NAMES.get(ttype, str(ttype))
    else:
        raise ValueError(f"unsupported checkpoint path: {path}")


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    else:
        names = getattr(tree, "_fields", range(len(tree)))
        for name, t in zip(names, tree):
            yield from _leaves(t, f"{prefix}.{name}" if prefix else str(name))


def count_params(tree) -> int:
    """Elements of every tensor leaf of a params tree."""
    return sum(t.numel() for _, t in _leaves(tree))


def shape_errors(stage: str, got, want) -> list:
    """A line for each leaf of the params tree got whose shape is not its
    counterpart's in want (the configured tree)."""
    return [f"{stage}.{name}: {tuple(g.shape)} != configured {tuple(w.shape)}"
            for (name, g), (_, w) in zip(_leaves(got), _leaves(want)) if g.shape != w.shape]


def audit(path: str, kind: str, cfg=None, device="cuda") -> list:
    """Load path's tts (talker, code predictor, speaker encoder) or
    tokenizer (vocoder) stages in float32 and print their parameter counts;
    returns the audit's failures (empty when it passes)."""
    cfg = cfg or PipelineConfig()
    st = (loader_mod.open_checkpoint_dir(path) if os.path.isdir(path)
          else GGUFCheckpoint(path))
    f32 = torch.float32
    if kind == "tts":
        stages = [
            ("talker", "talker params:         ",
             lambda: loader_mod.load_talker(st, cfg.talker, f32, device),
             lambda: talker.init_talker_params(None, cfg.talker, f32, "meta")),
            ("code_predictor", "code-predictor params: ",
             lambda: loader_mod.load_code_predictor(st, cfg.code_predictor, f32, device),
             lambda: code_predictor.init_code_predictor_params(None, cfg.code_predictor,
                                                               f32, "meta")),
            ("speaker_encoder", "speaker-encoder params:",
             lambda: loader_mod.load_speaker_encoder(st, cfg.speaker_encoder, f32, device),
             lambda: speaker_encoder.init_speaker_encoder_params(None, cfg.speaker_encoder,
                                                                 f32, "meta")),
        ]
    else:
        stages = [("vocoder", "vocoder params:        ",
                   lambda: loader_mod.load_vocoder(st, cfg.vocoder, f32, device),
                   lambda: vocoder.init_vocoder_params(None, cfg.vocoder, "meta"))]
    errors = []
    for stage, label, load, configured in stages:
        try:
            with torch.no_grad():
                got = load()
        except (KeyError, RuntimeError, ValueError) as e:
            errors.append(f"{stage}: the loader failed: {e}")
            continue
        print(f"{label} {count_params(got):>12,}")
        errors += shape_errors(stage, got, configured())
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path")
    ap.add_argument("--audit", choices=["tts", "tokenizer"], default=None)
    ap.add_argument("--tiny", action="store_true", help="audit against the tiny config")
    ap.add_argument("--device", default="cuda", help="torch device the audit loads on")
    args = ap.parse_args(argv)

    total = n = 0
    for name, shape, dtype in iter_tensors(args.path):
        print(f"{name:<70} {str(tuple(shape)):<24} {dtype}")
        total += int(np.prod(shape)) if shape else 1
        n += 1
    print(f"\n{n} tensors, {total:,} parameters")
    if not args.audit:
        return 0
    errors = audit(args.path, args.audit, tiny_pipeline_config() if args.tiny else None,
                   args.device)
    for e in errors:
        print(f"audit: {e}")
    print(f"audit {'FAILED' if errors else 'passed'}: {len(errors)} problem(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
