"""HF <-> GGML tensor-name contract for Qwen3-TTS checkpoints: the port's copy
of ``qwen3tts_tpu/io/tensor_names.py`` (same mapping, same policies), so the
port reads the GGUF files the reference's converters and the JAX package's
``tools/convert_hf_to_gguf.py`` write.

The contract is the one documented in the reference's docs/tensor_mapping.md
and implemented by its converters (scripts/convert_tts_to_gguf.py,
scripts/convert_tokenizer_to_gguf.py).
"""

from __future__ import annotations

import re
from typing import Optional

_DIRECT = {
    # talker
    "talker.model.codec_embedding.weight": "talker.codec_embd.weight",
    "talker.model.text_embedding.weight": "talker.text_embd.weight",
    "talker.codec_head.weight": "talker.codec_head.weight",
    "talker.model.norm.weight": "talker.output_norm.weight",
    "talker.text_projection.linear_fc1.weight": "talker.text_proj.fc1.weight",
    "talker.text_projection.linear_fc1.bias": "talker.text_proj.fc1.bias",
    "talker.text_projection.linear_fc2.weight": "talker.text_proj.fc2.weight",
    "talker.text_projection.linear_fc2.bias": "talker.text_proj.fc2.bias",
    "talker.code_predictor.model.norm.weight": "code_pred.output_norm.weight",
    # speaker encoder heads
    "speaker_encoder.blocks.0.conv.weight": "spk_enc.conv0.weight",
    "speaker_encoder.blocks.0.conv.bias": "spk_enc.conv0.bias",
    "speaker_encoder.asp.conv.weight": "spk_enc.asp.conv.weight",
    "speaker_encoder.asp.conv.bias": "spk_enc.asp.conv.bias",
    "speaker_encoder.asp.tdnn.conv.weight": "spk_enc.asp.tdnn.weight",
    "speaker_encoder.asp.tdnn.conv.bias": "spk_enc.asp.tdnn.bias",
    "speaker_encoder.mfa.conv.weight": "spk_enc.mfa.weight",
    "speaker_encoder.mfa.conv.bias": "spk_enc.mfa.bias",
    "speaker_encoder.fc.weight": "spk_enc.fc.weight",
    "speaker_encoder.fc.bias": "spk_enc.fc.bias",
    # vocoder fixed names
    "decoder.pre_conv.conv.bias": "tok_dec.pre_conv.bias",
    "decoder.pre_conv.conv.weight": "tok_dec.pre_conv.weight",
    "decoder.pre_transformer.input_proj.bias": "tok_dec.pre_tfm.input_proj.bias",
    "decoder.pre_transformer.input_proj.weight": "tok_dec.pre_tfm.input_proj.weight",
    "decoder.pre_transformer.output_proj.bias": "tok_dec.pre_tfm.output_proj.bias",
    "decoder.pre_transformer.output_proj.weight": "tok_dec.pre_tfm.output_proj.weight",
    "decoder.pre_transformer.norm.weight": "tok_dec.pre_tfm.norm.weight",
    "decoder.quantizer.rvq_first.input_proj.weight": "tok_dec.vq_first.input_proj.weight",
    "decoder.quantizer.rvq_first.output_proj.weight": "tok_dec.vq_first.output_proj.weight",
    "decoder.quantizer.rvq_rest.input_proj.weight": "tok_dec.vq_rest.input_proj.weight",
    "decoder.quantizer.rvq_rest.output_proj.weight": "tok_dec.vq_rest.output_proj.weight",
    "decoder.decoder.0.conv.weight": "tok_dec.dec.0.conv.weight",
    "decoder.decoder.0.conv.bias": "tok_dec.dec.0.conv.bias",
    "decoder.decoder.5.alpha": "tok_dec.dec.5.snake.alpha",
    "decoder.decoder.5.beta": "tok_dec.dec.5.snake.beta",
    "decoder.decoder.6.conv.weight": "tok_dec.dec.6.conv.weight",
    "decoder.decoder.6.conv.bias": "tok_dec.dec.6.conv.bias",
}

_LAYER_FIELDS = {
    "input_layernorm.weight": "attn_norm.weight",
    "self_attn.q_proj.weight": "attn_q.weight",
    "self_attn.k_proj.weight": "attn_k.weight",
    "self_attn.v_proj.weight": "attn_v.weight",
    "self_attn.o_proj.weight": "attn_output.weight",
    "self_attn.q_norm.weight": "attn_q_norm.weight",
    "self_attn.k_norm.weight": "attn_k_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
    "mlp.gate_proj.weight": "ffn_gate.weight",
    "mlp.up_proj.weight": "ffn_up.weight",
    "mlp.down_proj.weight": "ffn_down.weight",
    # vocoder pre-transformer extras
    "self_attn_layer_scale.scale": "attn_scale",
    "mlp_layer_scale.scale": "ffn_scale",
}

_PATTERNS = [
    (re.compile(r"talker\.model\.layers\.(\d+)\.(.+)"), "talker.blk.{0}.{field}"),
    (re.compile(r"talker\.code_predictor\.model\.layers\.(\d+)\.(.+)"), "code_pred.blk.{0}.{field}"),
    (re.compile(r"decoder\.pre_transformer\.layers\.(\d+)\.(.+)"), "tok_dec.pre_tfm.blk.{0}.{field}"),
]

_MISC = [
    (re.compile(r"talker\.code_predictor\.model\.codec_embedding\.(\d+)\.weight"),
     "code_pred.codec_embd.{0}.weight"),
    (re.compile(r"talker\.code_predictor\.lm_head\.(\d+)\.weight"),
     "code_pred.lm_head.{0}.weight"),
    (re.compile(r"speaker_encoder\.blocks\.(\d+)\.res2net_block\.blocks\.(\d+)\.conv\.(weight|bias)"),
     "spk_enc.blk.{0}.res2net.{1}.{2}"),
    (re.compile(r"speaker_encoder\.blocks\.(\d+)\.se_block\.conv(\d)\.(weight|bias)"),
     "spk_enc.blk.{0}.se.conv{1}.{2}"),
    (re.compile(r"speaker_encoder\.blocks\.(\d+)\.tdnn(\d)\.conv\.(weight|bias)"),
     "spk_enc.blk.{0}.tdnn{1}.{2}"),
    # vocoder decoder blocks
    (re.compile(r"decoder\.decoder\.(\d+)\.block\.0\.(alpha|beta)"),
     "tok_dec.dec.{0}.snake.{1}"),
    (re.compile(r"decoder\.decoder\.(\d+)\.block\.1\.conv\.(weight|bias)"),
     "tok_dec.dec.{0}.conv_t.{1}"),
    (re.compile(r"decoder\.decoder\.(\d+)\.block\.(\d+)\.(act\d)\.(alpha|beta)"),
     "tok_dec.dec.{0}.res.{1}.{2}.{3}"),
    (re.compile(r"decoder\.decoder\.(\d+)\.block\.(\d+)\.(conv\d)\.conv\.(weight|bias)"),
     "tok_dec.dec.{0}.res.{1}.{2}.{3}"),
    # vocoder quantizer codebooks (written pre-normalized as ".codebook")
    (re.compile(r"decoder\.quantizer\.rvq_first\.vq\.layers\.(\d+)\._codebook\.embedding_sum"),
     "tok_dec.vq_first.{0}.codebook"),
    (re.compile(r"decoder\.quantizer\.rvq_rest\.vq\.layers\.(\d+)\._codebook\.embedding_sum"),
     "tok_dec.vq_rest.{0}.codebook"),
    # ConvNeXt upsample
    (re.compile(r"decoder\.upsample\.(\d+)\.0\.conv\.(weight|bias)"),
     "tok_dec.upsample.{0}.conv.{1}"),
    (re.compile(r"decoder\.upsample\.(\d+)\.1\.dwconv\.conv\.(weight|bias)"),
     "tok_dec.upsample.{0}.dwconv.{1}"),
    (re.compile(r"decoder\.upsample\.(\d+)\.1\.gamma"),
     "tok_dec.upsample.{0}.gamma"),
    (re.compile(r"decoder\.upsample\.(\d+)\.1\.norm\.(weight|bias)"),
     "tok_dec.upsample.{0}.norm.{1}"),
    (re.compile(r"decoder\.upsample\.(\d+)\.1\.pwconv(\d)\.(weight|bias)"),
     "tok_dec.upsample.{0}.pwconv{1}.{2}"),
]


def hf_to_ggml(hf_name: str) -> Optional[str]:
    """Map an HF tensor name to its GGML/GGUF name (None = not converted,
    e.g. cluster_usage which the converter folds into the codebook)."""
    if hf_name in _DIRECT:
        return _DIRECT[hf_name]
    for pat, template in _PATTERNS:
        m = pat.match(hf_name)
        if m:
            field = _LAYER_FIELDS.get(m.group(2))
            if field is None:
                return None
            return template.format(m.group(1), field=field)
    for pat, template in _MISC:
        m = pat.match(hf_name)
        if m:
            return template.format(*m.groups())
    return None


def should_quantize_q8(ggml_name: str) -> bool:
    """Selective Q8_0 policy (convert_tts_to_gguf.py:244-270): embeddings,
    codebooks, norms, biases, scales, snake params and heads stay F16."""
    keep_f16 = ("_embd", "codebook", "_norm", "norm.", ".bias", "lm_head",
                "codec_head", "scale", "alpha", "beta", "gamma", "usage")
    return not any(s in ggml_name for s in keep_f16)


def is_ffn_projection(ggml_name: str) -> bool:
    """True for transformer-block FFN projection matrices (ffn_gate/up/down)
    — the 4-bit leg of the MIXED storage policy (attn stays Q8_0). Matches
    the runtime policy in ops/quant.quantize_block_params_mixed."""
    return any(s in ggml_name for s in ("ffn_gate", "ffn_up", "ffn_down"))
