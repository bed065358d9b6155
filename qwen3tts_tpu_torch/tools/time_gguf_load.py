#!/usr/bin/env python3
"""Where a checkpoint load's time goes on an NVIDIA GPU: the int8 tier
loaded from the two Q8_0 GGUF files through the native reader and through
the pure-Python reader, beside the int8 load of the safetensors directory
they were converted from, stage by stage (``load_split``: parse,
tokenizer, read and dequantization on the host, host to device, casts on
the card, int8 quantization), in turns, and Qwen3TTS.load_models of each
directory.

    python3 qwen3tts_tpu_torch/tools/time_gguf_load.py [--runs N] [--dir DIR]

Without --dir it writes tools/hf_fixture.py's checkpoint at
``PipelineConfig()``'s 0.6B widths (seed 0, 2.29 GB) into a temporary
directory and converts it with tools/convert_hf_to_gguf.py to q8_0 (the
file cache is warm: the files were just written). Runs on the card (CUDA
device 0); without one it exits 2. Prints one JSON line: each run's split
per reader, the mean of each stage over the runs, and ``device`` (the
card's name and power limit, as nvidia-smi gives them). ``load_split`` and
``load_readers`` are chip_smoke.py's too (its checkpoint_tools phase).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__" and not __package__:
    sys.path.insert(0, HERE)

import torch  # noqa: E402


def reader_name(ckpt) -> str:
    """The class that reads a GGUFCheckpoint's first file."""
    return type(ckpt._readers[0]).__name__


def load_split(open_ckpts, cfg, device) -> dict:
    """Where a load_models of the int8 tier spends its time, stage by stage
    of the pipeline's _load_tokenizer / _load_talker / _load_vocoder:
    open_ckpts() -> (tts checkpoint, tokenizer checkpoint, tokenizer loader).
    parse_s: opening them (the GGUF tensor tables; the safetensors
    headers); tokenizer_s; read_s: each tensor read to the host (and
    dequantized, for GGUF); h2d_s: its copy to the device, synchronized;
    cast_s: the rest of the loaders (casts, transposes, stacks on the
    device); quant_s: the int8 tier's quantization. The file cache is warm
    (the files were just written)."""
    from qwen3tts_tpu_torch.io import loader
    from qwen3tts_tpu_torch.io.config_io import infer_vocoder_config
    from qwen3tts_tpu_torch.ops.quant import quantize_block_params, quantize_talker_blocks

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    class Timed:
        def __init__(self, st):
            self.st, self.read_s, self.h2d_s = st, 0.0, 0.0

        def __contains__(self, name):
            return name in self.st

        def shape(self, name):
            return self.st.shape(name)

        def tensor(self, name):
            t0 = time.perf_counter()
            t = self.st.tensor(name)
            t1 = time.perf_counter()
            t = t.to(device)
            sync()
            self.read_s += t1 - t0
            self.h2d_s += time.perf_counter() - t1
            return t

    dtype = torch.bfloat16 if cfg.runtime.dtype == "bfloat16" else torch.float32
    t0 = time.perf_counter()
    st_tts, st_tok, tokenizer = open_ckpts()
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokenizer()
    tokenizer_s = time.perf_counter() - t0
    a, b = Timed(st_tts), Timed(st_tok)
    t0 = time.perf_counter()
    with torch.no_grad():
        tp = loader.load_talker(a, cfg.talker, dtype, device)
        cp = loader.load_code_predictor(a, cfg.code_predictor, dtype, device)
        vp = loader.load_vocoder(b, infer_vocoder_config(b, cfg.vocoder), torch.float32, device)
        sync()
        loaders_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        quantize_talker_blocks(tp.blocks, "int8")
        quantize_block_params(cp.blocks)
        sync()
        quant_s = time.perf_counter() - t0
    del tp, cp, vp
    read_s, h2d_s = a.read_s + b.read_s, a.h2d_s + b.h2d_s
    out = dict(parse_s=parse_s, tokenizer_s=tokenizer_s, read_s=read_s, h2d_s=h2d_s,
               cast_s=loaders_s - read_s - h2d_s, quant_s=quant_s)
    out["total_s"] = sum(out.values())
    return out


def load_readers(q8_dir: str, tts_dir: str, tok_dir: str) -> dict:
    """The readers load_split compares, by name: the two Q8_0 files of
    q8_dir through NativeGGUF (the pipeline's) and through the pure-Python
    GGUFReader, and the safetensors directories (the GGUF tokenizer from
    the file's metadata, the other from vocab.json)."""
    from qwen3tts_tpu_torch.io import loader
    from qwen3tts_tpu_torch.io.gguf import GGUFReader
    from qwen3tts_tpu_torch.io.gguf_checkpoint import GGUFCheckpoint
    from qwen3tts_tpu_torch.text.bpe import TextTokenizer

    paths = [os.path.join(q8_dir, "qwen3-tts-0.6b-q8_0.gguf"),
             os.path.join(q8_dir, "qwen3-tts-tokenizer-q8_0.gguf")]
    return {
        "gguf_native": lambda: (GGUFCheckpoint(paths[0]), GGUFCheckpoint(paths[1]),
                                lambda: TextTokenizer.from_gguf(GGUFReader(paths[0]))),
        "gguf_python": lambda: (GGUFCheckpoint(paths[0], reader=GGUFReader),
                                GGUFCheckpoint(paths[1], reader=GGUFReader),
                                lambda: TextTokenizer.from_gguf(GGUFReader(paths[0]))),
        "safetensors": lambda: (loader.open_checkpoint_dir(tts_dir),
                                loader.open_checkpoint_dir(tok_dir),
                                lambda: TextTokenizer.from_hf_dir(tts_dir)),
    }


def prepare(root: str, cfg) -> tuple:
    """(q8_0 directory, tts dir, tokenizer dir) under root: the fixture of
    seed 0 and its q8_0 conversion, each written unless it is there."""
    from qwen3tts_tpu_torch.tools import convert_hf_to_gguf, hf_fixture

    hf_fixture.fixture_for(cfg, root, 0)
    tts_dir, tok_dir = (os.path.join(root, hf_fixture.TTS_DIR),
                        os.path.join(root, hf_fixture.TOKENIZER_DIR))
    q8 = os.path.join(root, "q8_0")
    os.makedirs(q8, exist_ok=True)
    for kind, src, stem in (("tts", tts_dir, "qwen3-tts-0.6b"),
                            ("tokenizer", tok_dir, "qwen3-tts-tokenizer")):
        out = os.path.join(q8, f"{stem}-q8_0.gguf")
        if not os.path.exists(out):
            convert_hf_to_gguf.convert(src, out, "q8_0", kind)
    return q8, tts_dir, tok_dir


def time_loads(root: str, cfg, device, runs: int) -> dict:
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    q8, tts_dir, tok_dir = prepare(root, cfg)
    cfg8 = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, quant="int8"))
    readers = load_readers(q8, tts_dir, tok_dir)
    splits = {name: [] for name in readers}
    load_ms = {"gguf_native": [], "safetensors": []}
    for _ in range(runs):
        for name, open_ckpts in readers.items():
            splits[name].append(load_split(open_ckpts, cfg8, device))
            torch.cuda.empty_cache()
        for name, d in (("gguf_native", q8), ("safetensors", root)):
            tts = Qwen3TTS(cfg8, device)
            if not tts.load_models(d):
                raise RuntimeError(tts.error_msg)
            load_ms[name].append(tts.t_load_ms)
            tts.unload_models()
            torch.cuda.empty_cache()
    mean = {name: {k: sum(s[k] for s in ss) / len(ss) for k in ss[0]}
            for name, ss in splits.items()}
    return dict(runs=runs, splits=splits, mean=mean, load_models_ms=load_ms,
                gguf_bytes=sum(os.path.getsize(os.path.join(q8, f)) for f in os.listdir(q8)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--dir", default=None, help="where the fixture is or goes (default: a "
                                                "new temporary directory)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_gguf_load: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from qwen3tts_tpu_torch.config import PipelineConfig
    from qwen3tts_tpu_torch.tools.benchmark_continuous import card_line

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = time_loads(args.dir or tmp, PipelineConfig(), dev, args.runs)
    print(json.dumps(dict(out, wall_s=time.perf_counter() - t0,
                          device=card_line(dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
