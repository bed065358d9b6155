#!/usr/bin/env python3
"""Convert HF Qwen3-TTS checkpoints to GGUF (f16/f32/q8_0/q4_k/q4_k_mixed)
with the port's GGUF writer (counterpart of ``tools/convert_hf_to_gguf.py``:
the same flags, tensor types, metadata and vocabulary, so the two tools
write the same bytes from the same directory).

    python3 qwen3tts_tpu_torch/tools/convert_hf_to_gguf.py --input <hf_model_dir> \\
        --output model.gguf --type q8_0 [--kind tts|tokenizer]

--kind tts: the main model, with the metadata keys the reference's
parse_config reads (tts_transformer.cpp:212-344) and its BPE vocabulary
when vocab.json is there; --kind tokenizer: the codec tokenizer (from a
speech_tokenizer/ subdirectory when there is one), its codebooks divided
by their usage (the usage is not written). Types: vectors F32; with
q8_0 the quantizable projections (``tensor_names.should_quantize_q8``)
whose rows are whole 32-blocks Q8_0; with q4_k those of whole 256-blocks
Q4_K; with q4_k_mixed the FFN projections Q4_K and the other
quantizables Q8_0 (the storage analog of the runtime q4 tier); the rest
F16 (or every matrix F32 with f32).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from qwen3tts_tpu_torch.io import config_io, tensor_names  # noqa: E402
from qwen3tts_tpu_torch.io.gguf import (  # noqa: E402
    GGML_F16, GGML_F32, GGML_Q4_K, GGML_Q8_0, GGUFWriter, T_ARR, T_F32, T_STR, T_U32,
)
from qwen3tts_tpu_torch.io.safetensors_io import SafetensorsDir  # noqa: E402

TYPES = ("f16", "f32", "q8_0", "q4_k", "q4_k_mixed")
KINDS = ("tts", "tokenizer")


def tensor_type(ggml: str, data: np.ndarray, out_type: str) -> int:
    """The GGML type of one tensor under out_type (the module docstring)."""
    quantizable = tensor_names.should_quantize_q8(ggml)
    if data.ndim <= 1 or out_type == "f32":
        return GGML_F32
    if out_type == "q8_0" and quantizable and data.shape[-1] % 32 == 0:
        return GGML_Q8_0
    if out_type == "q4_k" and quantizable and data.shape[-1] % 256 == 0:
        return GGML_Q4_K
    if out_type == "q4_k_mixed" and quantizable:
        if tensor_names.is_ffn_projection(ggml) and data.shape[-1] % 256 == 0:
            return GGML_Q4_K
        return GGML_Q8_0 if data.shape[-1] % 32 == 0 else GGML_F16
    return GGML_F16


def gguf_tensors(st):
    """(GGML name, float32 array) of every tensor of the safetensors
    directory st that has a GGML name, in HF-name order; each codebook's
    embedding_sum divided by its cluster_usage clamped at 1e-5, in float64
    (the usage is not written)."""
    for name in sorted(st.keys()):
        ggml = tensor_names.hf_to_ggml(name)
        if name.endswith("cluster_usage") or ggml is None:
            continue
        data = st.tensor(name).float().numpy()
        usage = name.replace("embedding_sum", "cluster_usage")
        if usage != name and usage in st:
            u = np.clip(st.tensor(usage).double().numpy(), 1e-5, None)
            data = (data.astype(np.float64) / u[:, None]).astype(np.float32)
        yield ggml, data


def _tts_metadata(w: GGUFWriter, arch: str, input_dir: str) -> None:
    cfg = config_io.config_from_model_dir(os.path.dirname(os.path.abspath(input_dir)))
    t, cpred, spk = cfg.talker, cfg.code_predictor, cfg.speaker_encoder
    cj = os.path.join(input_dir, "config.json")
    if os.path.exists(cj):
        with open(cj) as f:
            data = json.load(f)
        t, cpred = config_io.talker_config_from_json(data)
        spk = config_io.speaker_config_from_json(data)
    u32 = [("block_count", t.n_layers), ("embedding_length", t.hidden_size),
           ("feed_forward_length", t.intermediate_size), ("attention.head_count", t.n_heads),
           ("attention.head_count_kv", t.n_kv_heads), ("attention.key_length", t.head_dim),
           ("attention.value_length", t.head_dim)]
    for key, v in u32:
        w.add_meta(f"{arch}.{key}", T_U32, v)
    w.add_meta(f"{arch}.attention.layer_norm_rms_epsilon", T_F32, t.rms_norm_eps)
    w.add_meta(f"{arch}.rope.freq_base", T_F32, t.rope_theta)
    w.add_meta(f"{arch}.rope.mrope_section", (T_ARR, T_U32), list(t.mrope_section))
    for key, v in [("vocab_size", t.codec_vocab_size), ("text_vocab_size", t.text_vocab_size),
                   ("text_hidden_size", t.text_embd_dim), ("num_code_groups", t.n_codebooks),
                   ("code_predictor.layer_count", cpred.n_layers),
                   ("code_predictor.vocab_size", cpred.vocab_size),
                   ("speaker_encoder.embedding_length", spk.embedding_dim),
                   ("speaker_encoder.sample_rate", spk.sample_rate),
                   ("codec.pad_id", t.codec_pad_id), ("codec.bos_id", t.codec_bos_id),
                   ("codec.eos_id", t.codec_eos_id)]:
        w.add_meta(f"{arch}.{key}", T_U32, v)


def _vocabulary(w: GGUFWriter, input_dir: str) -> None:
    """The BPE tokenizer as GGUF metadata, when vocab.json is there
    (convert_tts_to_gguf.py:475-524)."""
    vocab_path = os.path.join(input_dir, "vocab.json")
    merges_path = os.path.join(input_dir, "merges.txt")
    if not os.path.exists(vocab_path):
        return
    with open(vocab_path, encoding="utf-8") as f:
        vocab = json.load(f)
    w.add_meta("tokenizer.ggml.model", T_STR, "gpt2")
    w.add_meta("tokenizer.ggml.tokens", (T_ARR, T_STR),
               [tok for tok, _ in sorted(vocab.items(), key=lambda kv: kv[1])])
    if os.path.exists(merges_path):
        with open(merges_path, encoding="utf-8") as f:
            merges = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
        w.add_meta("tokenizer.ggml.merges", (T_ARR, T_STR), merges)


def convert(input_dir: str, output: str, out_type: str, kind: str) -> dict:
    """Write the GGUF file; returns the counts of converted and skipped
    tensors and the seconds it took."""
    if out_type not in TYPES or kind not in KINDS:
        raise ValueError(f"type must be one of {TYPES} and kind one of {KINDS}")
    t0 = time.perf_counter()
    sub = os.path.join(input_dir, "speech_tokenizer")
    st = SafetensorsDir(sub if (kind == "tokenizer" and os.path.isdir(sub)) else input_dir)
    arch = "qwen3-tts" if kind == "tts" else "qwen3-tts-tokenizer"
    w = GGUFWriter(arch)
    w.add_meta("general.name", T_STR,
               "Qwen3-TTS-12Hz-0.6B" if kind == "tts" else "Qwen3-TTS-Tokenizer-12Hz")
    if kind == "tts":
        _tts_metadata(w, arch, input_dir)
        _vocabulary(w, input_dir)
    else:
        w.add_meta(f"{arch}.num_codebooks", T_U32, 16)
        w.add_meta(f"{arch}.codebook_size", T_U32, 2048)
        w.add_meta(f"{arch}.sample_rate", T_U32, 24000)

    n_conv = 0
    for ggml, data in gguf_tensors(st):
        w.add_tensor(ggml, data, ttype=tensor_type(ggml, data, out_type))
        n_conv += 1
    w.write(output)
    n_skip = sum(1 for n in st.keys()
                 if not n.endswith("cluster_usage") and tensor_names.hf_to_ggml(n) is None)
    return dict(converted=n_conv, skipped=n_skip, seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", "-i", required=True)
    ap.add_argument("--output", "-o", required=True)
    ap.add_argument("--type", "-t", choices=TYPES, default="f16")
    ap.add_argument("--kind", choices=KINDS, default="tts")
    args = ap.parse_args(argv)
    r = convert(args.input, args.output, args.type, args.kind)
    print(f"wrote {args.output}: {r['converted']} tensors converted, {r['skipped']} skipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
