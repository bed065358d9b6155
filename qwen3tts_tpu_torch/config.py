"""Model / pipeline configuration of the PyTorch/CUDA port: a copy of
``qwen3tts_tpu/config.py`` whose dataclasses match it field for field and
default for default (tests/test_torch_package.py holds the two together).

Hyper-parameter values mirror the reference engine's configuration structs so a
user of the reference can switch over without relearning anything:

- talker / code-predictor: reference ``src/tts_transformer.h:58-99`` and the HF
  ``config.json`` defaults in ``scripts/convert_tts_to_gguf.py:153-191``.
- vocoder: reference ``src/audio_tokenizer_decoder.h:15-29``.
- speaker encoder (ECAPA-TDNN + mel front end):
  reference ``src/audio_tokenizer_encoder.h:16-28``.

Everything is a frozen dataclass: configs are static, hashable metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    """The 28-layer autoregressive codec-token transformer ("talker")."""

    # Text-embedding side (prefill conditioning only).
    text_vocab_size: int = 151936
    text_embd_dim: int = 2048

    # Transformer trunk.
    hidden_size: int = 1024
    n_layers: int = 28
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6

    # M-RoPE sections carried by the checkpoint; all positions are scalar in
    # the TTS pipeline so this degenerates to standard 1-D NEOX RoPE
    # (reference tts_transformer.cpp:1181-1187).
    mrope_section: Tuple[int, int, int] = (24, 20, 20)

    # Codec vocabulary.
    codec_vocab_size: int = 3072
    n_codebooks: int = 16

    # Special codec ids (reference tts_transformer.h:84-98).
    codec_pad_id: int = 2148
    codec_bos_id: int = 2149
    codec_eos_id: int = 2150
    codec_think_id: int = 2154
    codec_nothink_id: int = 2155
    codec_think_bos_id: int = 2156
    codec_think_eos_id: int = 2157

    # Special text ids overlaid during prefill.
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673
    tts_pad_token_id: int = 151671

    # Default language id (English). Full map lives in cli.py.
    english_language_id: int = 2050

    @property
    def n_suppressed_tail(self) -> int:
        """The talker suppresses the top 1024 codec ids (except EOS) when
        sampling codebook-0 (reference tts_transformer.cpp:2658,2665-2670)."""
        return 1024


@dataclasses.dataclass(frozen=True)
class CodePredictorConfig:
    """The 5-layer AR "code predictor" emitting codebooks 1..15 per frame."""

    hidden_size: int = 1024
    n_layers: int = 5
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    vocab_size: int = 2048          # per-codebook vocab
    n_codebooks: int = 16           # incl. codebook 0 predicted by the talker

    @property
    def n_steps(self) -> int:
        return self.n_codebooks - 1  # 15 codes per frame

    @property
    def max_ctx(self) -> int:
        return self.n_codebooks      # 2-token prefill + 14 steps = 16


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """WavTokenizer-style neural codec decoder (codes -> 24 kHz waveform).

    Matches reference ``src/audio_tokenizer_decoder.h:15-29`` and the HF shapes
    recorded in ``docs/model_inspection.txt``.
    """

    sample_rate: int = 24000
    n_codebooks: int = 16
    codebook_size: int = 2048
    codebook_dim: int = 256          # VQ embedding dim
    hidden_dim: int = 512            # latent width after VQ output_proj
    latent_dim: int = 1024           # pre-conv output / ConvNeXt width
    pre_tfm_width: int = 512         # pre-transformer residual width
    pre_tfm_qkv_dim: int = 1024      # q/k/v projection dim (16 heads x 64)
    pre_tfm_ffn_dim: int = 1024
    n_pre_tfm_layers: int = 8
    n_heads: int = 16
    decoder_dim: int = 1536
    upsample_rates: Tuple[int, int, int, int] = (8, 5, 4, 3)
    n_convnext: int = 2              # x2 each => 4x before decoder stack
    convnext_mlp_dim: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e4
    res_dilations: Tuple[int, int, int] = (1, 3, 9)

    @property
    def samples_per_frame(self) -> int:
        r = 1
        for u in self.upsample_rates:
            r *= u
        return r * (2 ** self.n_convnext)  # 480 * 4 = 1920

    @property
    def decoder_channels(self) -> Tuple[int, ...]:
        # 1536 -> 768 -> 384 -> 192 -> 96 (halved per upsample block)
        ch = [self.decoder_dim]
        for _ in self.upsample_rates:
            ch.append(ch[-1] // 2)
        return tuple(ch)


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    """ECAPA-TDNN x-vector extractor + log-mel front end.

    Mel parameters must match the reference exactly
    (``src/audio_tokenizer_encoder.h:16-28``).
    """

    sample_rate: int = 24000
    n_mels: int = 128
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    f_min: float = 0.0
    f_max: float = 12000.0

    hidden_dim: int = 512
    n_blocks: int = 3
    res2net_scale: int = 8
    dilations: Tuple[int, int, int] = (2, 3, 4)
    se_dim: int = 128
    attention_dim: int = 128
    mfa_dim: int = 1536              # 3 x hidden_dim
    embedding_dim: int = 1024

    @property
    def branch_dim(self) -> int:
        return self.hidden_dim // self.res2net_scale  # 64


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """CLI-visible decoding knobs (reference src/qwen3_tts.h:16-44).

    ``top_p`` is parsed-but-dead in the reference CLI (README.md:184); here it
    is actually wired into sampling (SURVEY.md build plan step 7).
    """

    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.05
    max_audio_tokens: int = 4096
    language_id: int = 2050
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution policy: dtypes and shape buckets. The port reads dtype,
    quant, the prefill and frame buckets, vocoder_chunk_frames, kv_margin
    and kv_quant; the other fields are kept so the two packages' configs
    stay interchangeable."""

    # Parameter / activation compute dtype ("bfloat16" or "float32").
    dtype: str = "bfloat16"
    # Weight quantization: None | "int8" (Q8_0-parity selective policy) |
    # "q4" (mixed attn-int8/ffn-u4 talker — the 4-bit default, beats the
    # reference's Q4_K storage quality) | "q4pure" (all-u4 talker, smallest).
    # The code predictor is int8 in every quantized tier.
    quant: str | None = None
    # Prefill-length buckets (text prompts are padded up to one of these).
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    # Frame-count buckets for the decode while_loop / KV-cache capacity.
    frame_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048, 4096)
    # Vocoder frame buckets (one compiled graph per bucket).
    vocoder_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048, 4096)
    # Vocoder chunk size in frames (0 = the whole clip in one pass; else
    # longer clips are vocoded in chunks with 16 frames of left context).
    vocoder_chunk_frames: int = 0
    # Samples buckets for the speaker-encoder mel front end (seconds * 24k).
    speaker_buckets: Tuple[int, ...] = tuple(24000 * s for s in (2, 5, 10, 20, 30, 60))
    # Extra KV headroom past prefill+frames (reference uses +8).
    kv_margin: int = 8
    # Single-dispatch synthesis: generation + vocoder in one program (the
    # JAX package's runtime/e2e.py). Saves a device round trip per call but
    # always vocodes the full frame bucket, so it suits tight max-token
    # budgets / serving; the default split path vocodes a bucket sized to
    # the ACTUAL frame count.
    fused_dispatch: bool = False
    # KV-cache storage: "none" (cache at compute dtype) | "int8" (per-row
    # quantized (q, scale) pair on the fused talker step: 0.516 of the bf16
    # cache's bytes, a MEMORY tier) | "auto" (policy in
    # pipeline.resolve_kv_quant: "none"). The JAX package also reads an
    # environment override, which the port does not.
    kv_quant: str = "auto"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    talker: TalkerConfig = TalkerConfig()
    code_predictor: CodePredictorConfig = CodePredictorConfig()
    vocoder: VocoderConfig = VocoderConfig()
    speaker_encoder: SpeakerEncoderConfig = SpeakerEncoderConfig()
    runtime: RuntimeConfig = RuntimeConfig()


def tiny_pipeline_config() -> PipelineConfig:
    """A shrunken config (same topology, tiny dims) for fast CPU tests."""
    return PipelineConfig(
        talker=TalkerConfig(
            text_vocab_size=512,
            text_embd_dim=32,
            hidden_size=32,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            head_dim=8,
            intermediate_size=48,
            codec_vocab_size=3072,
            n_codebooks=16,
            tts_bos_token_id=501,
            tts_eos_token_id=502,
            tts_pad_token_id=500,
        ),
        code_predictor=CodePredictorConfig(
            hidden_size=32,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            head_dim=8,
            intermediate_size=48,
            vocab_size=2048,
            n_codebooks=16,
        ),
        vocoder=VocoderConfig(
            codebook_size=2048,
            codebook_dim=8,
            hidden_dim=16,
            latent_dim=32,
            pre_tfm_width=16,
            pre_tfm_qkv_dim=32,
            pre_tfm_ffn_dim=32,
            n_pre_tfm_layers=2,
            n_heads=4,
            decoder_dim=32,
            convnext_mlp_dim=64,
        ),
        speaker_encoder=SpeakerEncoderConfig(
            n_mels=16,
            n_fft=64,
            hop_length=16,
            win_length=64,
            hidden_dim=16,
            res2net_scale=4,
            se_dim=8,
            attention_dim=8,
            mfa_dim=48,
            embedding_dim=32,
        ),
        runtime=RuntimeConfig(
            dtype="float32",
            prefill_buckets=(16, 32),
            frame_buckets=(8, 16, 32),
            vocoder_buckets=(8, 16, 32),
            speaker_buckets=(512, 1024),
        ),
    )
