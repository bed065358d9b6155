"""HF checkpoint -> the port's parameter NamedTuples (counterpart of
``qwen3tts_tpu/io/loader.py``; the same names, layouts and casts, so every
leaf equals the JAX loader's bit for bit).

Maps the HuggingFace tensor names of Qwen3-TTS-12Hz-0.6B-Base and
Qwen3-TTS-Tokenizer-12Hz onto the stacked params of ``models/``. The name
contract mirrors the reference's conversion maps
(scripts/convert_tts_to_gguf.py:44-126, scripts/convert_tokenizer_to_gguf.py:
44-166 and docs/tensor_mapping.md). ``st`` is a ``SafetensorsDir`` or a
``GGUFCheckpoint``: ``st.tensor(name)`` gives a CPU tensor in its stored
dtype.

Layout conventions (see models/transformer_core.py):
- linear weights stored [in, out]  (HF [out, in] -> .T)
- conv1d weights stored [K, in, out]  (HF [out, in, K] -> permute(2, 1, 0))
- transposed-conv weights stored pre-flipped [K, in, out] such that
  w[K-1-k, i, o] == HF[i, o, k] (see models/vocoder.py conv_transpose1d)
- VQ codebooks usage-normalized at load, in float64:
  embedding_sum / clamp(usage, 1e-5) (reference
  audio_tokenizer_decoder.cpp:40-73)

Each tensor is copied to `device` as stored and cast, transposed and
stacked there, not on the host (the 0.6B text embedding alone is
[151936, 2048]). Casts to bfloat16 round to nearest even, as
``jnp.asarray(..., bfloat16)`` does; every other cast the loaders make is
exact, or (the codebooks' float64 quotient) correctly rounded on both.
"""

from __future__ import annotations

import os

import torch

from ..models.code_predictor import CodePredictorParams
from ..models.speaker_encoder import SEResBlockParams, SpeakerEncoderParams
from ..models.talker import TalkerParams
from ..models.transformer_core import BlockParams
from ..models.vocoder import (
    ConvNeXtParams,
    DecoderBlockParams,
    PreTfmBlockParams,
    ResBlockParams,
    VocoderParams,
)
from .safetensors_io import SafetensorsDir


def _getter(st, device):
    return lambda name: st.tensor(name).to(device)


def _vec(get, name, dtype):
    return get(name).to(dtype)


def _lin(get, name, dtype):
    return get(name).to(dtype).T.contiguous()


def _conv(get, name, dtype):
    return get(name).to(dtype).permute(2, 1, 0).contiguous()


def _convt(get, name, dtype):
    # [in, out, K] -> [K, in, out], flipped along K
    return get(name).to(dtype).permute(2, 0, 1).flip(0).contiguous()


def _stack_blocks(get, prefix: str, n_layers: int, dtype) -> BlockParams:
    def stack(fmt, f):
        return torch.stack([f(get, fmt.format(prefix=prefix, i=i), dtype)
                            for i in range(n_layers)])

    def fused(fmts):
        return torch.stack([
            torch.cat([_lin(get, f.format(prefix=prefix, i=i), dtype) for f in fmts], dim=1)
            for i in range(n_layers)])

    return BlockParams(
        attn_norm=stack("{prefix}.layers.{i}.input_layernorm.weight", _vec),
        wqkv=fused(["{prefix}.layers.{i}.self_attn.q_proj.weight",
                    "{prefix}.layers.{i}.self_attn.k_proj.weight",
                    "{prefix}.layers.{i}.self_attn.v_proj.weight"]),
        wo=stack("{prefix}.layers.{i}.self_attn.o_proj.weight", _lin),
        q_norm=stack("{prefix}.layers.{i}.self_attn.q_norm.weight", _vec),
        k_norm=stack("{prefix}.layers.{i}.self_attn.k_norm.weight", _vec),
        ffn_norm=stack("{prefix}.layers.{i}.post_attention_layernorm.weight", _vec),
        w_gateup=fused(["{prefix}.layers.{i}.mlp.gate_proj.weight",
                        "{prefix}.layers.{i}.mlp.up_proj.weight"]),
        w_down=stack("{prefix}.layers.{i}.mlp.down_proj.weight", _lin),
    )


def load_talker(st, cfg, dtype=torch.bfloat16, device="cuda") -> TalkerParams:
    g = _getter(st, device)
    return TalkerParams(
        text_embd=_vec(g, "talker.model.text_embedding.weight", dtype),
        text_proj_fc1_w=_lin(g, "talker.text_projection.linear_fc1.weight", dtype),
        text_proj_fc1_b=_vec(g, "talker.text_projection.linear_fc1.bias", dtype),
        text_proj_fc2_w=_lin(g, "talker.text_projection.linear_fc2.weight", dtype),
        text_proj_fc2_b=_vec(g, "talker.text_projection.linear_fc2.bias", dtype),
        codec_embd=_vec(g, "talker.model.codec_embedding.weight", dtype),
        blocks=_stack_blocks(g, "talker.model", cfg.n_layers, dtype),
        output_norm=_vec(g, "talker.model.norm.weight", dtype),
        codec_head=_lin(g, "talker.codec_head.weight", dtype),
    )


def load_code_predictor(st, cfg, dtype=torch.bfloat16, device="cuda") -> CodePredictorParams:
    g = _getter(st, device)
    n = cfg.n_steps
    return CodePredictorParams(
        blocks=_stack_blocks(g, "talker.code_predictor.model", cfg.n_layers, dtype),
        output_norm=_vec(g, "talker.code_predictor.model.norm.weight", dtype),
        embds=torch.stack([
            _vec(g, f"talker.code_predictor.model.codec_embedding.{i}.weight", dtype)
            for i in range(n)]),
        heads=torch.stack([
            _lin(g, f"talker.code_predictor.lm_head.{i}.weight", dtype) for i in range(n)]),
    )


def load_speaker_encoder(st, cfg, dtype=torch.float32, device="cuda") -> SpeakerEncoderParams:
    g = _getter(st, device)
    blocks = []
    for b in range(1, cfg.n_blocks + 1):
        p = f"speaker_encoder.blocks.{b}"
        res = range(cfg.res2net_scale - 1)
        blocks.append(SEResBlockParams(
            tdnn1_w=_conv(g, f"{p}.tdnn1.conv.weight", dtype),
            tdnn1_b=_vec(g, f"{p}.tdnn1.conv.bias", dtype),
            res2net_w=torch.stack([
                _conv(g, f"{p}.res2net_block.blocks.{i}.conv.weight", dtype) for i in res]),
            res2net_b=torch.stack([
                _vec(g, f"{p}.res2net_block.blocks.{i}.conv.bias", dtype) for i in res]),
            tdnn2_w=_conv(g, f"{p}.tdnn2.conv.weight", dtype),
            tdnn2_b=_vec(g, f"{p}.tdnn2.conv.bias", dtype),
            se1_w=_conv(g, f"{p}.se_block.conv1.weight", dtype),
            se1_b=_vec(g, f"{p}.se_block.conv1.bias", dtype),
            se2_w=_conv(g, f"{p}.se_block.conv2.weight", dtype),
            se2_b=_vec(g, f"{p}.se_block.conv2.bias", dtype),
        ))
    return SpeakerEncoderParams(
        conv0_w=_conv(g, "speaker_encoder.blocks.0.conv.weight", dtype),
        conv0_b=_vec(g, "speaker_encoder.blocks.0.conv.bias", dtype),
        blocks=tuple(blocks),
        mfa_w=_conv(g, "speaker_encoder.mfa.conv.weight", dtype),
        mfa_b=_vec(g, "speaker_encoder.mfa.conv.bias", dtype),
        asp_tdnn_w=_conv(g, "speaker_encoder.asp.tdnn.conv.weight", dtype),
        asp_tdnn_b=_vec(g, "speaker_encoder.asp.tdnn.conv.bias", dtype),
        asp_conv_w=_conv(g, "speaker_encoder.asp.conv.weight", dtype),
        asp_conv_b=_vec(g, "speaker_encoder.asp.conv.bias", dtype),
        fc_w=_conv(g, "speaker_encoder.fc.weight", dtype),
        fc_b=_vec(g, "speaker_encoder.fc.bias", dtype),
    )


def _normalized_codebook(get, base: str, dtype):
    emb = get(f"{base}.embedding_sum").to(torch.float64)
    usage = get(f"{base}.cluster_usage").to(torch.float64)
    return (emb / usage.clamp(min=1e-5)[:, None]).to(dtype)


def load_vocoder(st, cfg, dtype=torch.float32, device="cuda") -> VocoderParams:
    g = _getter(st, device)
    L = cfg.n_pre_tfm_layers
    pfx = "decoder.pre_transformer.layers"

    def stack_pt(fmt, f):
        return torch.stack([f(g, fmt.format(i=i), dtype) for i in range(L)])

    pt = PreTfmBlockParams(
        attn_norm=stack_pt(pfx + ".{i}.input_layernorm.weight", _vec),
        wq=stack_pt(pfx + ".{i}.self_attn.q_proj.weight", _lin),
        wk=stack_pt(pfx + ".{i}.self_attn.k_proj.weight", _lin),
        wv=stack_pt(pfx + ".{i}.self_attn.v_proj.weight", _lin),
        wo=stack_pt(pfx + ".{i}.self_attn.o_proj.weight", _lin),
        attn_scale=stack_pt(pfx + ".{i}.self_attn_layer_scale.scale", _vec),
        ffn_norm=stack_pt(pfx + ".{i}.post_attention_layernorm.weight", _vec),
        w_gate=stack_pt(pfx + ".{i}.mlp.gate_proj.weight", _lin),
        w_up=stack_pt(pfx + ".{i}.mlp.up_proj.weight", _lin),
        w_down=stack_pt(pfx + ".{i}.mlp.down_proj.weight", _lin),
        ffn_scale=stack_pt(pfx + ".{i}.mlp_layer_scale.scale", _vec),
    )

    def stack_up(fmt, f):
        return torch.stack([f(g, fmt.format(i=i), dtype) for i in range(cfg.n_convnext)])

    cnx = ConvNeXtParams(
        convt_w=stack_up("decoder.upsample.{i}.0.conv.weight", _convt),
        convt_b=stack_up("decoder.upsample.{i}.0.conv.bias", _vec),
        dw_w=stack_up("decoder.upsample.{i}.1.dwconv.conv.weight", _conv),
        dw_b=stack_up("decoder.upsample.{i}.1.dwconv.conv.bias", _vec),
        ln_w=stack_up("decoder.upsample.{i}.1.norm.weight", _vec),
        ln_b=stack_up("decoder.upsample.{i}.1.norm.bias", _vec),
        pw1_w=stack_up("decoder.upsample.{i}.1.pwconv1.weight", _lin),
        pw1_b=stack_up("decoder.upsample.{i}.1.pwconv1.bias", _vec),
        pw2_w=stack_up("decoder.upsample.{i}.1.pwconv2.weight", _lin),
        pw2_b=stack_up("decoder.upsample.{i}.1.pwconv2.bias", _vec),
        gamma=stack_up("decoder.upsample.{i}.1.gamma", _vec),
    )

    dec_blocks = []
    for bi, _rate in enumerate(cfg.upsample_rates, start=1):
        p = f"decoder.decoder.{bi}.block"

        def res(fmt, f):
            return torch.stack([f(g, fmt.format(p=p, r=r), dtype) for r in (2, 3, 4)])

        dec_blocks.append(DecoderBlockParams(
            snake_alpha=_vec(g, f"{p}.0.alpha", dtype),
            snake_beta=_vec(g, f"{p}.0.beta", dtype),
            convt_w=_convt(g, f"{p}.1.conv.weight", dtype),
            convt_b=_vec(g, f"{p}.1.conv.bias", dtype),
            res=ResBlockParams(
                act1_alpha=res("{p}.{r}.act1.alpha", _vec),
                act1_beta=res("{p}.{r}.act1.beta", _vec),
                conv1_w=res("{p}.{r}.conv1.conv.weight", _conv),
                conv1_b=res("{p}.{r}.conv1.conv.bias", _vec),
                act2_alpha=res("{p}.{r}.act2.alpha", _vec),
                act2_beta=res("{p}.{r}.act2.beta", _vec),
                conv2_w=res("{p}.{r}.conv2.conv.weight", _conv),
                conv2_b=res("{p}.{r}.conv2.conv.bias", _vec),
            ),
        ))

    q = "decoder.quantizer"
    return VocoderParams(
        vq_first_cb=_normalized_codebook(g, f"{q}.rvq_first.vq.layers.0._codebook", dtype),
        vq_rest_cb=torch.stack([
            _normalized_codebook(g, f"{q}.rvq_rest.vq.layers.{i}._codebook", dtype)
            for i in range(cfg.n_codebooks - 1)]),
        vq_first_proj=g(f"{q}.rvq_first.output_proj.weight")[:, :, 0].to(dtype).T.contiguous(),
        vq_rest_proj=g(f"{q}.rvq_rest.output_proj.weight")[:, :, 0].to(dtype).T.contiguous(),
        pre_conv_w=_conv(g, "decoder.pre_conv.conv.weight", dtype),
        pre_conv_b=_vec(g, "decoder.pre_conv.conv.bias", dtype),
        pt_in_w=_lin(g, "decoder.pre_transformer.input_proj.weight", dtype),
        pt_in_b=_vec(g, "decoder.pre_transformer.input_proj.bias", dtype),
        pt_blocks=pt,
        pt_norm=_vec(g, "decoder.pre_transformer.norm.weight", dtype),
        pt_out_w=_lin(g, "decoder.pre_transformer.output_proj.weight", dtype),
        pt_out_b=_vec(g, "decoder.pre_transformer.output_proj.bias", dtype),
        convnext=cnx,
        dec0_w=_conv(g, "decoder.decoder.0.conv.weight", dtype),
        dec0_b=_vec(g, "decoder.decoder.0.conv.bias", dtype),
        dec_blocks=tuple(dec_blocks),
        final_alpha=_vec(g, "decoder.decoder.5.alpha", dtype),
        final_beta=_vec(g, "decoder.decoder.5.beta", dtype),
        out_w=_conv(g, "decoder.decoder.6.conv.weight", dtype),
        out_b=_vec(g, "decoder.decoder.6.conv.bias", dtype),
    )


def open_checkpoint_dir(path: str) -> SafetensorsDir:
    """Open a model directory; tokenizer checkpoints keep their tensors under
    a speech_tokenizer/ subdir (convert_tokenizer_to_gguf.py:252-260)."""
    sub = os.path.join(path, "speech_tokenizer")
    if os.path.isdir(sub) and any(f.endswith(".safetensors") for f in os.listdir(sub)):
        return SafetensorsDir(sub)
    return SafetensorsDir(path)
