"""Write a Qwen3-TTS checkpoint directory with seeded random weights, at any
PipelineConfig, for exercising the port's loaders without real model files
(the port's counterpart of ``tests/hf_fixture.py``: the same tensor names
and shapes, under the HF names of Qwen3-TTS-12Hz-0.6B-Base and
Qwen3-TTS-Tokenizer-12Hz).

    python3 -m qwen3tts_tpu_torch.tools.hf_fixture OUT_DIR [--tiny] [--seed N]

writes ``OUT_DIR/Qwen3-TTS-12Hz-0.6B-Base`` (model.safetensors in BF16,
config.json, vocab.json, merges.txt) and ``OUT_DIR/Qwen3-TTS-Tokenizer-12Hz``
(model.safetensors in float32, config.json); ``write_gguf_dir`` writes the
same tensors as the reference's two GGUF files. Matrices are drawn as
N(0, 1/fan_in), so a full-width model keeps its activations in range; norms
are ones, biases N(0, 0.01).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict

import torch

from ..config import PipelineConfig, tiny_pipeline_config
from ..io import gguf
from ..io.safetensors_io import SafetensorsDir, write_safetensors
from ..text.bpe import bytes_to_unicode
from .convert_hf_to_gguf import gguf_tensors, tensor_type

TTS_DIR = "Qwen3-TTS-12Hz-0.6B-Base"
TOKENIZER_DIR = "Qwen3-TTS-Tokenizer-12Hz"
MERGES = [("H", "e"), ("He", "l"), ("Hel", "l"), ("Hell", "o"),
          ("Ġ", "t"), ("Ġt", "h"), ("Ġth", "e")]
SPECIAL_TOKENS = ("<|im_start|>", "<|im_end|>", "<|endoftext|>", "assistant")


class _Draw:
    """Seeded tensors in one dtype: normal matrices scaled by 1/sqrt(fan_in)
    (fan_in: the product of every axis but the first, HF's [out, in, k])."""

    def __init__(self, seed: int, dtype):
        self.gen = torch.Generator()
        self.gen.manual_seed(seed)
        self.dtype = dtype

    def normal(self, shape, scale):
        return torch.randn(shape, generator=self.gen).mul_(scale).to(self.dtype)

    def w(self, *shape):
        return self.normal(shape, 1.0 / math.sqrt(math.prod(shape[1:])))

    def b(self, n, scale=0.01):
        return self.normal((n,), scale)

    def full(self, n, v):
        return torch.full((n,), v, dtype=self.dtype)


def make_tts_checkpoint(cfg: PipelineConfig, seed: int = 0,
                        dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """HF-named tensors of the main model (talker, code predictor, speaker
    encoder), as tests/hf_fixture.make_tts_checkpoint names and shapes them."""
    r = _Draw(seed, dtype)
    t, c, s = cfg.talker, cfg.code_predictor, cfg.speaker_encoder
    H, Et = t.hidden_size, t.text_embd_dim
    out = {
        "talker.model.text_embedding.weight": r.w(t.text_vocab_size, Et),
        "talker.text_projection.linear_fc1.weight": r.w(Et, Et),
        "talker.text_projection.linear_fc1.bias": r.b(Et),
        "talker.text_projection.linear_fc2.weight": r.w(H, Et),
        "talker.text_projection.linear_fc2.bias": r.b(H),
        "talker.model.codec_embedding.weight": r.w(t.codec_vocab_size, H),
        "talker.codec_head.weight": r.w(t.codec_vocab_size, H),
        "talker.model.norm.weight": r.full(H, 1.0),
    }

    def layers(prefix, lc, hidden):
        D, F = lc.head_dim, lc.intermediate_size
        for i in range(lc.n_layers):
            p = f"{prefix}.layers.{i}"
            out[f"{p}.input_layernorm.weight"] = r.full(hidden, 1.0)
            out[f"{p}.self_attn.q_proj.weight"] = r.w(lc.n_heads * D, hidden)
            out[f"{p}.self_attn.k_proj.weight"] = r.w(lc.n_kv_heads * D, hidden)
            out[f"{p}.self_attn.v_proj.weight"] = r.w(lc.n_kv_heads * D, hidden)
            out[f"{p}.self_attn.o_proj.weight"] = r.w(hidden, lc.n_heads * D)
            out[f"{p}.self_attn.q_norm.weight"] = r.full(D, 1.0)
            out[f"{p}.self_attn.k_norm.weight"] = r.full(D, 1.0)
            out[f"{p}.post_attention_layernorm.weight"] = r.full(hidden, 1.0)
            out[f"{p}.mlp.gate_proj.weight"] = r.w(F, hidden)
            out[f"{p}.mlp.up_proj.weight"] = r.w(F, hidden)
            out[f"{p}.mlp.down_proj.weight"] = r.w(hidden, F)

    layers("talker.model", t, H)
    layers("talker.code_predictor.model", c, c.hidden_size)
    out["talker.code_predictor.model.norm.weight"] = r.full(c.hidden_size, 1.0)
    for i in range(c.n_steps):
        out[f"talker.code_predictor.model.codec_embedding.{i}.weight"] = \
            r.w(c.vocab_size, c.hidden_size)
        out[f"talker.code_predictor.lm_head.{i}.weight"] = r.w(c.vocab_size, c.hidden_size)

    C, B, A, M = s.hidden_dim, s.branch_dim, s.attention_dim, s.mfa_dim
    out["speaker_encoder.blocks.0.conv.weight"] = r.w(C, s.n_mels, 5)
    out["speaker_encoder.blocks.0.conv.bias"] = r.b(C)
    for b in range(1, s.n_blocks + 1):
        p = f"speaker_encoder.blocks.{b}"
        out[f"{p}.tdnn1.conv.weight"] = r.w(C, C, 1)
        out[f"{p}.tdnn1.conv.bias"] = r.b(C)
        for i in range(s.res2net_scale - 1):
            out[f"{p}.res2net_block.blocks.{i}.conv.weight"] = r.w(B, B, 3)
            out[f"{p}.res2net_block.blocks.{i}.conv.bias"] = r.b(B)
        out[f"{p}.tdnn2.conv.weight"] = r.w(C, C, 1)
        out[f"{p}.tdnn2.conv.bias"] = r.b(C)
        out[f"{p}.se_block.conv1.weight"] = r.w(s.se_dim, C, 1)
        out[f"{p}.se_block.conv1.bias"] = r.b(s.se_dim)
        out[f"{p}.se_block.conv2.weight"] = r.w(C, s.se_dim, 1)
        out[f"{p}.se_block.conv2.bias"] = r.b(C)
    out["speaker_encoder.mfa.conv.weight"] = r.w(M, M, 1)
    out["speaker_encoder.mfa.conv.bias"] = r.b(M)
    out["speaker_encoder.asp.tdnn.conv.weight"] = r.w(A, 3 * M, 1)
    out["speaker_encoder.asp.tdnn.conv.bias"] = r.b(A)
    out["speaker_encoder.asp.conv.weight"] = r.w(M, A, 1)
    out["speaker_encoder.asp.conv.bias"] = r.b(M)
    out["speaker_encoder.fc.weight"] = r.w(s.embedding_dim, 2 * M, 1)
    out["speaker_encoder.fc.bias"] = r.b(s.embedding_dim)
    return out


def make_tokenizer_checkpoint(cfg: PipelineConfig, seed: int = 1,
                              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """HF-named tensors of the codec tokenizer's decoder (the vocoder), as
    tests/hf_fixture.make_tokenizer_checkpoint names and shapes them."""
    r = _Draw(seed, dtype)
    v = cfg.vocoder
    q = "decoder.quantizer"
    out = {
        f"{q}.rvq_first.input_proj.weight": r.w(v.codebook_dim, v.hidden_dim, 1),
        f"{q}.rvq_first.output_proj.weight": r.w(v.hidden_dim, v.codebook_dim, 1),
        f"{q}.rvq_rest.input_proj.weight": r.w(v.codebook_dim, v.hidden_dim, 1),
        f"{q}.rvq_rest.output_proj.weight": r.w(v.hidden_dim, v.codebook_dim, 1),
    }
    books = [f"{q}.rvq_first.vq.layers.0"] + [
        f"{q}.rvq_rest.vq.layers.{i}" for i in range(v.n_codebooks - 1)]
    for p in books:
        out[f"{p}._codebook.embedding_sum"] = r.w(v.codebook_size, v.codebook_dim)
        out[f"{p}._codebook.cluster_usage"] = r.normal((v.codebook_size,), 0.1).abs_() + 0.5

    out["decoder.pre_conv.conv.weight"] = r.w(v.latent_dim, v.hidden_dim, 3)
    out["decoder.pre_conv.conv.bias"] = r.b(v.latent_dim)
    W, Q, F = v.pre_tfm_width, v.pre_tfm_qkv_dim, v.pre_tfm_ffn_dim
    out["decoder.pre_transformer.input_proj.weight"] = r.w(W, v.latent_dim)
    out["decoder.pre_transformer.input_proj.bias"] = r.b(W)
    for i in range(v.n_pre_tfm_layers):
        p = f"decoder.pre_transformer.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = r.full(W, 1.0)
        out[f"{p}.self_attn.q_proj.weight"] = r.w(Q, W)
        out[f"{p}.self_attn.k_proj.weight"] = r.w(Q, W)
        out[f"{p}.self_attn.v_proj.weight"] = r.w(Q, W)
        out[f"{p}.self_attn.o_proj.weight"] = r.w(W, Q)
        out[f"{p}.self_attn_layer_scale.scale"] = r.full(W, 0.1)
        out[f"{p}.post_attention_layernorm.weight"] = r.full(W, 1.0)
        out[f"{p}.mlp.gate_proj.weight"] = r.w(F, W)
        out[f"{p}.mlp.up_proj.weight"] = r.w(F, W)
        out[f"{p}.mlp.down_proj.weight"] = r.w(W, F)
        out[f"{p}.mlp_layer_scale.scale"] = r.full(W, 0.1)
    out["decoder.pre_transformer.norm.weight"] = r.full(W, 1.0)
    out["decoder.pre_transformer.output_proj.weight"] = r.w(v.latent_dim, W)
    out["decoder.pre_transformer.output_proj.bias"] = r.b(v.latent_dim)

    C = v.latent_dim
    for i in range(v.n_convnext):
        p = f"decoder.upsample.{i}"
        out[f"{p}.0.conv.weight"] = r.w(C, C, 2)
        out[f"{p}.0.conv.bias"] = r.b(C)
        out[f"{p}.1.dwconv.conv.weight"] = r.w(C, 1, 7)
        out[f"{p}.1.dwconv.conv.bias"] = r.b(C)
        out[f"{p}.1.norm.weight"] = r.full(C, 1.0)
        out[f"{p}.1.norm.bias"] = r.full(C, 0.0)
        out[f"{p}.1.pwconv1.weight"] = r.w(v.convnext_mlp_dim, C)
        out[f"{p}.1.pwconv1.bias"] = r.b(v.convnext_mlp_dim)
        out[f"{p}.1.pwconv2.weight"] = r.w(C, v.convnext_mlp_dim)
        out[f"{p}.1.pwconv2.bias"] = r.b(C)
        out[f"{p}.1.gamma"] = r.full(C, 0.5)

    chans = v.decoder_channels
    out["decoder.decoder.0.conv.weight"] = r.w(v.decoder_dim, v.latent_dim, 7)
    out["decoder.decoder.0.conv.bias"] = r.b(v.decoder_dim)
    for bi, rate in enumerate(v.upsample_rates, start=1):
        cin, cout = chans[bi - 1], chans[bi]
        p = f"decoder.decoder.{bi}.block"
        out[f"{p}.0.alpha"] = r.b(cin, 0.05)
        out[f"{p}.0.beta"] = r.b(cin, 0.05)
        out[f"{p}.1.conv.weight"] = r.w(cin, cout, 2 * rate)
        out[f"{p}.1.conv.bias"] = r.b(cout)
        for ri in (2, 3, 4):
            out[f"{p}.{ri}.act1.alpha"] = r.b(cout, 0.05)
            out[f"{p}.{ri}.act1.beta"] = r.b(cout, 0.05)
            out[f"{p}.{ri}.conv1.conv.weight"] = r.w(cout, cout, 7)
            out[f"{p}.{ri}.conv1.conv.bias"] = r.b(cout)
            out[f"{p}.{ri}.act2.alpha"] = r.b(cout, 0.05)
            out[f"{p}.{ri}.act2.beta"] = r.b(cout, 0.05)
            out[f"{p}.{ri}.conv2.conv.weight"] = r.w(cout, cout, 1)
            out[f"{p}.{ri}.conv2.conv.bias"] = r.b(cout)
    out["decoder.decoder.5.alpha"] = r.b(chans[-1], 0.05)
    out["decoder.decoder.5.beta"] = r.b(chans[-1], 0.05)
    out["decoder.decoder.6.conv.weight"] = r.w(1, chans[-1], 7)
    out["decoder.decoder.6.conv.bias"] = r.b(1)
    return out


def tts_config_json(cfg: PipelineConfig) -> dict:
    """config.json of the main model, in the keys io/config_io reads."""
    t, c, s = cfg.talker, cfg.code_predictor, cfg.speaker_encoder
    return {
        "talker_config": {
            "text_vocab_size": t.text_vocab_size, "text_hidden_size": t.text_embd_dim,
            "hidden_size": t.hidden_size, "num_hidden_layers": t.n_layers,
            "num_attention_heads": t.n_heads, "num_key_value_heads": t.n_kv_heads,
            "head_dim": t.head_dim, "intermediate_size": t.intermediate_size,
            "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
            "rope_scaling": {"mrope_section": list(t.mrope_section)},
            "vocab_size": t.codec_vocab_size, "num_code_groups": t.n_codebooks,
            "codec_pad_id": t.codec_pad_id, "codec_bos_id": t.codec_bos_id,
            "codec_eos_token_id": t.codec_eos_id, "codec_think_id": t.codec_think_id,
            "codec_nothink_id": t.codec_nothink_id,
            "codec_think_bos_id": t.codec_think_bos_id,
            "codec_think_eos_id": t.codec_think_eos_id,
            "tts_bos_token_id": t.tts_bos_token_id, "tts_eos_token_id": t.tts_eos_token_id,
            "tts_pad_token_id": t.tts_pad_token_id,
            "code_predictor_config": {
                "hidden_size": c.hidden_size, "num_hidden_layers": c.n_layers,
                "num_attention_heads": c.n_heads, "num_key_value_heads": c.n_kv_heads,
                "head_dim": c.head_dim, "intermediate_size": c.intermediate_size,
                "rms_norm_eps": c.rms_norm_eps, "rope_theta": c.rope_theta,
                "vocab_size": c.vocab_size,
            },
        },
        "speaker_encoder_config": {"sample_rate": s.sample_rate, "enc_dim": s.embedding_dim},
    }


def tokenizer_config_json(cfg: PipelineConfig) -> dict:
    """config.json of the codec tokenizer, in the keys io/config_io reads."""
    v = cfg.vocoder
    return {
        "input_sample_rate": v.sample_rate,
        "decoder_config": {
            "num_quantizers": v.n_codebooks, "codebook_size": v.codebook_size,
            "latent_dim": v.latent_dim, "hidden_size": v.hidden_dim,
            "num_hidden_layers": v.n_pre_tfm_layers, "num_attention_heads": v.n_heads,
            "upsample_rates": list(v.upsample_rates),
        },
    }


def fixture_vocab():
    """(vocab, merges) of a small byte-level BPE: the 256 byte tokens at their
    byte values, the chat-template specials from 256 (<|im_start|> = 256),
    then the merges' results."""
    vocab = {u: b for b, u in bytes_to_unicode().items()}
    for tok in SPECIAL_TOKENS + tuple(a + b for a, b in MERGES):
        vocab[tok] = len(vocab)
    return vocab, MERGES


def _write_json(path, data):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)


def write_checkpoint_dir(root: str, cfg: PipelineConfig, seed: int = 0):
    """Write the main model (BF16) and the codec tokenizer (float32) with
    their config.json files under root, vocab.json and merges.txt beside the
    main model. Returns (tts_dir, tok_dir)."""
    tts_dir, tok_dir = os.path.join(root, TTS_DIR), os.path.join(root, TOKENIZER_DIR)
    os.makedirs(tts_dir, exist_ok=True)
    os.makedirs(tok_dir, exist_ok=True)
    write_safetensors(os.path.join(tts_dir, "model.safetensors"),
                      make_tts_checkpoint(cfg, seed, torch.bfloat16))
    _write_json(os.path.join(tts_dir, "config.json"), tts_config_json(cfg))
    v, merges = fixture_vocab()
    _write_json(os.path.join(tts_dir, "vocab.json"), v)
    with open(os.path.join(tts_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    write_safetensors(os.path.join(tok_dir, "model.safetensors"),
                      make_tokenizer_checkpoint(cfg, seed + 1))
    _write_json(os.path.join(tok_dir, "config.json"), tokenizer_config_json(cfg))
    return tts_dir, tok_dir


def fixture_for(cfg: PipelineConfig, root: str, seed: int) -> str:
    """The checkpoint of `seed` at cfg's widths under root, written unless
    it is there: root itself for seed 0 (where write_checkpoint_dir(root,
    cfg) puts it), else root/seed<seed>. Returns its directory."""
    if seed != 0:
        root = os.path.join(root, f"seed{seed}")
    if not os.path.exists(os.path.join(root, TTS_DIR, "model.safetensors")):
        write_checkpoint_dir(root, cfg, seed)
    return root


def write_gguf_dir(src_root: str, dst: str, *, vocab: bool = True):
    """The checkpoint that write_checkpoint_dir wrote under src_root as the
    reference's two Q8_0 GGUF files under dst (qwen3-tts-0.6b-q8_0.gguf and
    qwen3-tts-tokenizer-q8_0.gguf): the codebooks with their usage folded
    in, the tokenizer vocabulary in the main file's metadata unless vocab
    is False; the tensors and types of convert_hf_to_gguf's q8_0, without
    its model metadata. Returns the two paths."""
    os.makedirs(dst, exist_ok=True)
    paths = []
    for kind, sub in (("tts", TTS_DIR), ("tokenizer", TOKENIZER_DIR)):
        st = SafetensorsDir(os.path.join(src_root, sub))
        arch = "qwen3-tts" if kind == "tts" else "qwen3-tts-tokenizer"
        w = gguf.GGUFWriter(arch)
        w.add_meta("general.name", gguf.T_STR, sub)
        if kind == "tts" and vocab:
            with open(os.path.join(src_root, sub, "vocab.json"), encoding="utf-8") as f:
                v = json.load(f)
            w.add_meta("tokenizer.ggml.model", gguf.T_STR, "gpt2")
            w.add_meta("tokenizer.ggml.tokens", (gguf.T_ARR, gguf.T_STR),
                       [tok for tok, _ in sorted(v.items(), key=lambda kv: kv[1])])
            w.add_meta("tokenizer.ggml.merges", (gguf.T_ARR, gguf.T_STR),
                       [f"{a} {b}" for a, b in MERGES])
        for ggml, data in gguf_tensors(st):
            w.add_tensor(ggml, data, ttype=tensor_type(ggml, data, "q8_0"))
        stem = "qwen3-tts-0.6b" if kind == "tts" else "qwen3-tts-tokenizer"
        path = os.path.join(dst, f"{stem}-q8_0.gguf")
        w.write(path)
        paths.append(path)
    return tuple(paths)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", help="directory to write the two checkpoints under")
    p.add_argument("--tiny", action="store_true", help="the tiny test config")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cfg = tiny_pipeline_config() if args.tiny else PipelineConfig()
    for d in write_checkpoint_dir(args.out, cfg, args.seed):
        print(d)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
