"""Build PipelineConfig from checkpoint metadata (counterpart of
``qwen3tts_tpu/io/config_io.py``, field for field).

The reference parses every hyperparameter from GGUF metadata through
multi-key fallback chains with hardcoded defaults (tts_transformer.cpp:
212-344) so models load even with sparse metadata. The HF-side equivalents
are the checkpoints' config.json files (key layout per
scripts/convert_tts_to_gguf.py:153-191 and convert_tokenizer_to_gguf.py:
191-218); every getter falls back to the same defaults. ``infer_*_config``
read tensor shapes only (the readers' ``.shape``), never tensor data.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

from ..config import (
    CodePredictorConfig,
    PipelineConfig,
    RuntimeConfig,
    SpeakerEncoderConfig,
    TalkerConfig,
    VocoderConfig,
)


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def talker_config_from_json(cfg: dict) -> tuple[TalkerConfig, CodePredictorConfig]:
    t = cfg.get("talker_config", cfg)
    cp = t.get("code_predictor_config", {})
    d = TalkerConfig()
    talker = TalkerConfig(
        text_vocab_size=t.get("text_vocab_size", d.text_vocab_size),
        text_embd_dim=t.get("text_hidden_size", d.text_embd_dim),
        hidden_size=t.get("hidden_size", d.hidden_size),
        n_layers=t.get("num_hidden_layers", d.n_layers),
        n_heads=t.get("num_attention_heads", d.n_heads),
        n_kv_heads=t.get("num_key_value_heads", d.n_kv_heads),
        head_dim=t.get("head_dim", d.head_dim),
        intermediate_size=t.get("intermediate_size", d.intermediate_size),
        rms_norm_eps=t.get("rms_norm_eps", d.rms_norm_eps),
        rope_theta=t.get("rope_theta", d.rope_theta),
        mrope_section=tuple(t.get("rope_scaling", {}).get("mrope_section", d.mrope_section)),
        codec_vocab_size=t.get("vocab_size", d.codec_vocab_size),
        n_codebooks=t.get("num_code_groups", d.n_codebooks),
        codec_pad_id=t.get("codec_pad_id", d.codec_pad_id),
        codec_bos_id=t.get("codec_bos_id", d.codec_bos_id),
        codec_eos_id=t.get("codec_eos_token_id", d.codec_eos_id),
        codec_think_id=t.get("codec_think_id", d.codec_think_id),
        codec_nothink_id=t.get("codec_nothink_id", d.codec_nothink_id),
        codec_think_bos_id=t.get("codec_think_bos_id", d.codec_think_bos_id),
        codec_think_eos_id=t.get("codec_think_eos_id", d.codec_think_eos_id),
        tts_bos_token_id=t.get("tts_bos_token_id", d.tts_bos_token_id),
        tts_eos_token_id=t.get("tts_eos_token_id", d.tts_eos_token_id),
        tts_pad_token_id=t.get("tts_pad_token_id", d.tts_pad_token_id),
    )
    dc = CodePredictorConfig()
    code_pred = CodePredictorConfig(
        hidden_size=cp.get("hidden_size", talker.hidden_size),
        n_layers=cp.get("num_hidden_layers", dc.n_layers),
        n_heads=cp.get("num_attention_heads", dc.n_heads),
        n_kv_heads=cp.get("num_key_value_heads", dc.n_kv_heads),
        head_dim=cp.get("head_dim", dc.head_dim),
        intermediate_size=cp.get("intermediate_size", dc.intermediate_size),
        rms_norm_eps=cp.get("rms_norm_eps", dc.rms_norm_eps),
        rope_theta=cp.get("rope_theta", dc.rope_theta),
        vocab_size=cp.get("vocab_size", dc.vocab_size),
        n_codebooks=t.get("num_code_groups", dc.n_codebooks),
    )
    return talker, code_pred


def speaker_config_from_json(cfg: dict) -> SpeakerEncoderConfig:
    s = cfg.get("speaker_encoder_config", {})
    d = SpeakerEncoderConfig()
    return dataclasses.replace(
        d,
        sample_rate=s.get("sample_rate", d.sample_rate),
        embedding_dim=s.get("enc_dim", d.embedding_dim),
    )


def vocoder_config_from_json(cfg: dict) -> VocoderConfig:
    dec = cfg.get("decoder_config", {})
    d = VocoderConfig()
    return dataclasses.replace(
        d,
        sample_rate=cfg.get("input_sample_rate", d.sample_rate),
        n_codebooks=dec.get("num_quantizers", d.n_codebooks),
        codebook_size=dec.get("codebook_size", d.codebook_size),
        latent_dim=dec.get("latent_dim", d.latent_dim),
        hidden_dim=dec.get("hidden_size", d.hidden_dim),
        n_pre_tfm_layers=dec.get("num_hidden_layers", d.n_pre_tfm_layers),
        n_heads=dec.get("num_attention_heads", d.n_heads),
        upsample_rates=tuple(dec.get("upsample_rates", d.upsample_rates)),
    )


def config_from_model_dir(model_dir: Optional[str],
                          runtime: Optional[RuntimeConfig] = None) -> PipelineConfig:
    """PipelineConfig from the config.json files under a model directory
    (hyperparameters default to the 0.6B values when files/keys are absent,
    matching the reference's sparse-metadata tolerance)."""
    base = PipelineConfig(runtime=runtime or RuntimeConfig())
    if not model_dir or not os.path.isdir(model_dir):
        return base
    tts_cfg: dict[str, Any] = {}
    tok_cfg: dict[str, Any] = {}
    for name in sorted(os.listdir(model_dir)):
        sub = os.path.join(model_dir, name)
        cj = os.path.join(sub, "config.json")
        if not os.path.isdir(sub) or not os.path.exists(cj):
            continue
        data = _load_json(cj)
        if "talker_config" in data or "speaker_encoder_config" in data:
            tts_cfg = data
        elif "decoder_config" in data or "encoder_config" in data:
            tok_cfg = data
    direct = os.path.join(model_dir, "config.json")
    if not tts_cfg and os.path.exists(direct):
        data = _load_json(direct)
        if "talker_config" in data:
            tts_cfg = data

    talker, code_pred = talker_config_from_json(tts_cfg) if tts_cfg else (base.talker, base.code_predictor)
    speaker = speaker_config_from_json(tts_cfg) if tts_cfg else base.speaker_encoder
    vocoder = vocoder_config_from_json(tok_cfg) if tok_cfg else base.vocoder
    return PipelineConfig(
        talker=talker,
        code_predictor=code_pred,
        vocoder=vocoder,
        speaker_encoder=speaker,
        runtime=base.runtime,
    )


def infer_vocoder_config(st, base: Optional[VocoderConfig] = None) -> VocoderConfig:
    """Derive vocoder dimensions from checkpoint tensor shapes — the same
    strategy the reference uses for this model (it ggml_dup_tensor's from
    GGUF metadata instead of hand-specifying shapes,
    audio_tokenizer_decoder.cpp:118-316). config.json keys for several of
    these dims are unreliable (e.g. decoder_config.codebook_dim says 512
    while the rvq codebooks are 256-wide)."""
    base = base or VocoderConfig()

    shape = st.shape

    hidden_dim, codebook_dim, _ = shape("decoder.quantizer.rvq_first.output_proj.weight")
    codebook_size = shape("decoder.quantizer.rvq_first.vq.layers.0._codebook.embedding_sum")[0]
    latent_dim = shape("decoder.pre_conv.conv.weight")[0]
    pre_tfm_width = shape("decoder.pre_transformer.input_proj.weight")[0]
    qkv = shape("decoder.pre_transformer.layers.0.self_attn.q_proj.weight")[0]
    ffn = shape("decoder.pre_transformer.layers.0.mlp.gate_proj.weight")[0]
    n_pt = 0
    while f"decoder.pre_transformer.layers.{n_pt}.input_layernorm.weight" in st:
        n_pt += 1
    n_cnx = 0
    while f"decoder.upsample.{n_cnx}.0.conv.weight" in st:
        n_cnx += 1
    mlp = shape("decoder.upsample.0.1.pwconv1.weight")[0]
    decoder_dim = shape("decoder.decoder.0.conv.weight")[0]
    rates = []
    b = 1
    while f"decoder.decoder.{b}.block.1.conv.weight" in st:
        k = shape(f"decoder.decoder.{b}.block.1.conv.weight")[2]
        rates.append(k // 2)  # kernel = 2 * stride in this family
        b += 1
    n_cb = 1
    while f"decoder.quantizer.rvq_rest.vq.layers.{n_cb - 1}._codebook.embedding_sum" in st:
        n_cb += 1
    return dataclasses.replace(
        base,
        n_codebooks=n_cb,
        codebook_size=codebook_size,
        codebook_dim=codebook_dim,
        hidden_dim=hidden_dim,
        latent_dim=latent_dim,
        pre_tfm_width=pre_tfm_width,
        pre_tfm_qkv_dim=qkv,
        pre_tfm_ffn_dim=ffn,
        n_pre_tfm_layers=n_pt,
        n_convnext=n_cnx,
        convnext_mlp_dim=mlp,
        decoder_dim=decoder_dim,
        upsample_rates=tuple(rates),
    )


def infer_speaker_config(st, base: Optional[SpeakerEncoderConfig] = None) -> SpeakerEncoderConfig:
    """Derive ECAPA dimensions from tensor shapes (mel parameters are a fixed
    convention of the model family, audio_tokenizer_encoder.h:16-28)."""
    base = base or SpeakerEncoderConfig()

    shape = st.shape

    hidden, n_mels, _k = shape("speaker_encoder.blocks.0.conv.weight")
    n_blocks = 0
    while f"speaker_encoder.blocks.{n_blocks + 1}.tdnn1.conv.weight" in st:
        n_blocks += 1
    scale = 1
    while f"speaker_encoder.blocks.1.res2net_block.blocks.{scale - 1}.conv.weight" in st:
        scale += 1
    se_dim = shape("speaker_encoder.blocks.1.se_block.conv1.weight")[0]
    attention_dim = shape("speaker_encoder.asp.tdnn.conv.weight")[0]
    mfa_dim = shape("speaker_encoder.mfa.conv.weight")[0]
    embedding_dim = shape("speaker_encoder.fc.weight")[0]
    return dataclasses.replace(
        base,
        n_mels=n_mels,
        hidden_dim=hidden,
        n_blocks=n_blocks,
        res2net_scale=scale,
        se_dim=se_dim,
        attention_dim=attention_dim,
        mfa_dim=mfa_dim,
        embedding_dim=embedding_dim,
    )
