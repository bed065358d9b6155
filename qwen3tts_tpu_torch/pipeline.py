"""Qwen3TTS pipeline of the port (counterpart of ``qwen3tts_tpu/pipeline.py``:
the model lifecycle, single-stream synthesis, voice cloning, batched and
continuous serving).

``Qwen3TTS(config, device="cuda")`` holds the weights on one device: bf16
talker and code-predictor weights and KV cache, and a float32 vocoder. The
weight tier is ``RuntimeConfig.quant``, resolved as the JAX package
resolves it (``qwen3tts_tpu/pipeline.py:385-396``):
  - None (the default ``PipelineConfig()``): plain bf16 projection blocks
    in the talker and the code predictor;
  - "int8": int8 ``QuantLinear`` blocks in both;
  - "q4": the talker's attention projections int8 and its FFN affine u4
    (``QuantLinear4``), the code predictor int8;
  - "q4pure": every talker projection u4, the code predictor int8.
The KV cache is stored at the compute dtype, or, with
``RuntimeConfig.kv_quant="int8"`` (the int8-KV tier, a memory tier: 0.516
of the bf16 cache's bytes), as the (q, scale) pair of ``ops/kv_quant.py``
on the fused talker step (K1, K5); ``resolve_kv_quant`` resolves the field
as the JAX package's does, without its environment override ("auto" gives
"none"; above 64 lanes a batch gets "none"); an unknown value is refused.
``RuntimeConfig.vocoder_chunk_frames`` > 0 vocodes clips longer than that
many frames in windows with 16 frames of left context
(``stream_decode_chunks``), as the JAX package's ``decode_codes`` does.
``Qwen3TTS.from_pretrained(model_dir)`` and ``load_models(model_dir)``
load a checkpoint directory (safetensors or the reference's GGUF files;
``io/loader.py``) with the tokenizer it carries, and
``load_models(None, synthetic=True, seed=...)`` draws deterministic
synthetic weights at the configured widths; ``unload_models``,
``is_loaded``, ``set_progress_callback`` and ``low_mem`` (drop the talker
after generation and the vocoder after decode, reloading them from what
load_models read on the next call) are the JAX pipeline's lifecycle, with ``low_mem`` an argument where
the JAX package reads ``QWEN3_TTS_LOW_MEM``. ``synthesize_with_voice``
clones a voice: the reference audio's ECAPA-TDNN embedding
(``models/speaker_encoder.py``, loaded on first use) replaces the default
voice's zero embedding. ``synthesize``
runs host BPE, the prefill, the frame loop and the vocoder (kernel K3);
``synthesize_batch`` runs B requests in lockstep through the batched frame
loop, then vocodes each lane (K3). The prefill's int8 projections run in
the W8A16 kernel (``ops/int8_matmul.py``), its u4 ones in the grouped
product of ``ops/quant.py`` and its bf16 ones in ``torch.matmul``.

``Qwen3TTS(config, device, fused_talker="auto", fused_cp="auto")`` picks
the decode step, for both loops (the JAX package's ``QWEN3TTS_FUSED_TALKER``
and ``QWEN3TTS_FUSED_CP`` gates, as arguments; "auto" is resolved per call
in ``runtime/decode_loop.py``):
  - fused_talker=True (auto: every tier): the talker step is kernel K1
    (single stream) or K5 (batched), in the blocks' weight modes, which
    also samples the next codebook-0 token;
  - fused_talker=False: ``talker.talker_step``, whose projections go
    through ``quant.matmul`` (int8: W8A16 kernel launches) and whose
    attention, at KV capacities of 1024 rows and more, is the
    decode-attention kernel (``ops/decode_attention.py``); cb0 is sampled
    in PyTorch;
  - fused_cp=True (auto: int8 code-predictor blocks, so every quantized
    tier): the code predictor is kernel K2 (single) or K6 (batched); True
    on the bf16 tier's blocks raises ValueError;
  - fused_cp=False (auto in the bf16 tier): ``code_predictor.predict_codes``,
    ``quant.matmul`` projections and PyTorch attention and sampling.
On a CUDA device every kernel launches on the card or raises; there is no
CPU fallback. The CPU runs only when asked for (``device="cpu"``), through
the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Optional, Union

import numpy as np
import torch

from .audio.wav import load_wav, resample_linear, save_wav  # noqa: F401 (re-export)
from .config import PipelineConfig, RuntimeConfig, SamplingConfig
from .io import loader
from .io.config_io import config_from_model_dir, infer_speaker_config, infer_vocoder_config
from .io.gguf import GGUFReader
from .io.gguf_checkpoint import GGUFCheckpoint, find_gguf_models
from .models import code_predictor as cp_model
from .models import speaker_encoder as se_model
from .models import talker as talker_model
from .models import vocoder as vocoder_model
from .models.transformer_core import float32_norms
from .ops.quant import quantize_block_params, quantize_talker_blocks
from .runtime import decode_loop
from .runtime.buckets import pick_bucket
from .runtime.timing import StageTimings, now_ms, rss_bytes
from .text.bpe import TextTokenizer, synthetic_tokenizer

# lanes of one batched frame loop (the batched talker kernel's cap); larger
# batches run in groups of this many, one after another
MAX_BATCH_LANES = 128

# the synthetic speaker encoder's generator seed is this plus load_models'
# seed (the talker, code predictor and vocoder take seed * 3 + 0, 1, 2)
SPEAKER_SEED_OFFSET = 1 << 32

# the weight tiers RuntimeConfig.quant may name (None: plain bf16 blocks)
WEIGHT_TIERS = (None, "int8", "q4", "q4pure")


# the KV-cache tiers RuntimeConfig.kv_quant may name
KV_TIERS = ("auto", "none", "int8")
# lanes above which a batch gets a compute-dtype cache whatever kv_quant says
INT8_KV_MAX_LANES = 64


def resolve_kv_quant(rt, *, batched: bool = False, lanes: int = 0) -> str:
    """RuntimeConfig.kv_quant as the decode loops' kv_quant, as the JAX
    package's ``resolve_kv_quant`` (``pipeline.py:178-217``) resolves it
    without its environment override: "auto" gives "none" (the cache at the
    compute dtype), another value is returned as it is, except that "int8"
    for a batch of more than 64 lanes gives "none", with the JAX package's
    message on stderr. The card needs no such cap (128 lanes at C = 4352
    take 33 GB in int8); it is kept so that both packages give the same
    output for every config."""
    mode = getattr(rt, "kv_quant", "auto")
    if mode == "auto":
        return "none"
    if mode == "int8" and batched and lanes > INT8_KV_MAX_LANES:
        print(f"qwen3tts: int8 KV requested at {lanes} lanes — capped at "
              f"{INT8_KV_MAX_LANES} (as the JAX package caps it); using bf16 KV",
              file=sys.stderr)
        return "none"
    return mode


# Language name/code -> codec language id (reference src/main.cpp:104-113).
LANGUAGE_IDS = {
    "en": 2050, "english": 2050,
    "de": 2053, "german": 2053,
    "es": 2054, "spanish": 2054,
    "zh": 2055, "chinese": 2055,
    "ja": 2058, "japanese": 2058,
    "fr": 2061, "french": 2061,
    "ko": 2064, "korean": 2064,
    "ru": 2069, "russian": 2069,
    "it": 2070, "italian": 2070,
    "pt": 2071, "portuguese": 2071,
}


@dataclasses.dataclass
class TTSResult:
    audio: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.float32))
    sample_rate: int = 24000
    codes: Optional[np.ndarray] = None
    # per-frame output-normed talker hidden states [n_frames, H]
    hidden_states: Optional[np.ndarray] = None
    n_frames: int = 0
    success: bool = False
    error_msg: str = ""
    timings: StageTimings = dataclasses.field(default_factory=StageTimings)

    @property
    def audio_seconds(self) -> float:
        return len(self.audio) / self.sample_rate if self.sample_rate else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Qwen3TTS:
    """End-to-end text -> 24 kHz waveform pipeline on one torch device."""

    def __init__(self, config: Optional[PipelineConfig] = None, device="cuda", *,
                 fused_talker="auto", fused_cp="auto", low_mem: bool = False):
        self.config = config or PipelineConfig()
        self.device = torch.device(device)
        self.fused = dict(fused_talker=fused_talker, fused_cp=fused_cp)
        self.dtype = torch.bfloat16 if self.config.runtime.dtype == "bfloat16" else torch.float32
        self.tokenizer: Optional[TextTokenizer] = None
        self.talker_params = None
        self.cp_params = None
        self.vocoder_params = None
        self.speaker_params = None
        self.low_mem = low_mem
        self.progress_callback: Optional[Callable[[int, int], None]] = None
        self._loaded = False
        self._model_dir: Optional[str] = None
        self._synthetic_seed: Optional[int] = None
        self.t_load_ms = 0.0
        self.error_msg = ""
        # the last synthesize_queue call's lanes, KV capacity and scheduler
        # counts (chunks, refills, compactions, sessions)
        self.last_queue_stats: dict = {}

    @classmethod
    def from_pretrained(cls, model_dir: str, runtime: Optional[RuntimeConfig] = None,
                        device="cuda", **kw) -> "Qwen3TTS":
        """Construct with hyperparameters read from the checkpoint's
        config.json files (defaults fill gaps) and load the weights; raises
        RuntimeError with error_msg when load_models fails. kw: the
        constructor's keyword arguments."""
        tts = cls(config_from_model_dir(model_dir, runtime), device, **kw)
        if not tts.load_models(model_dir):
            raise RuntimeError(tts.error_msg)
        return tts

    # ------------------------------------------------------------------
    # model lifecycle (JAX pipeline.py:288-440)
    # ------------------------------------------------------------------

    def load_models(self, model_dir: Optional[str] = None, *, synthetic: bool = False,
                    seed: int = 0) -> bool:
        """Load weights from a checkpoint directory: safetensors (the
        Qwen3-TTS-12Hz-0.6B-Base and Qwen3-TTS-Tokenizer-12Hz subdirectories,
        or the main model's safetensors directly) or the reference's two GGUF
        files; or, with model_dir None or synthetic=True, deterministic
        synthetic weights drawn from torch Generators on the device, seeded
        by `seed`. The talker and code predictor load in the compute dtype
        and are quantized to the weight tier (module docstring); the
        vocoder (float32) loads now unless low_mem; the speaker encoder on
        the first voice-cloning request. A bad directory or an unknown
        weight or KV tier returns False with error_msg set; an error of the
        device raises."""
        rt = self.config.runtime
        if rt.quant not in WEIGHT_TIERS:
            self.error_msg = (f"Failed to load models: quant tier {rt.quant!r} is not one of "
                              f"{WEIGHT_TIERS}")
            return False
        if rt.kv_quant not in KV_TIERS:
            self.error_msg = (f"Failed to load models: kv_quant {rt.kv_quant!r} is not one "
                              f"of {KV_TIERS}")
            return False
        t0 = now_ms()
        self._model_dir = model_dir
        self._synthetic_seed = seed if (synthetic or model_dir is None) else None
        self.speaker_params = None
        try:
            tokenizer = self._load_tokenizer()
            tp, cp = self._load_talker()
            vp = None if self.low_mem else self._load_vocoder()
        except (OSError, KeyError, ValueError) as e:
            self.error_msg = f"Failed to load models: {e}"
            return False
        self.set_params(tp, cp, vp, tokenizer)
        _sync(self.device)
        self.t_load_ms = now_ms() - t0
        return True

    def set_params(self, talker_params, cp_params, vocoder_params, tokenizer=None) -> None:
        """Install talker/code-predictor params already in their weight tier,
        vocoder params and a text tokenizer: load_models passes the one it
        chose; None (e.g. weights from ``io.from_jax``) installs the
        synthetic tokenizer. The norm weights are kept in float32, as the
        kernels read them, so no frame converts them again."""
        self._set_talker(talker_params, cp_params)
        self.vocoder_params = vocoder_params
        self.tokenizer = (tokenizer if tokenizer is not None
                          else synthetic_tokenizer(self.config.talker.text_vocab_size))
        self._loaded = True

    def _set_talker(self, talker_params, cp_params) -> None:
        self.talker_params = talker_params._replace(
            blocks=float32_norms(talker_params.blocks),
            output_norm=talker_params.output_norm.float())
        self.cp_params = cp_params._replace(
            blocks=float32_norms(cp_params.blocks), output_norm=cp_params.output_norm.float())

    def unload_models(self) -> None:
        self.talker_params = self.cp_params = None
        self.vocoder_params = self.speaker_params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def set_progress_callback(self, cb: Optional[Callable[[int, int], None]]) -> None:
        """cb(frames_so_far, max_audio_tokens), called once per frame of
        ``synthesize`` and ``synthesize_with_voice``."""
        self.progress_callback = cb

    def _paths(self):
        """(main model dir, tokenizer dir) under the model directory, as the
        JAX pipeline's ``_paths`` finds them (``pipeline.py:309-324``)."""
        d = self._model_dir
        tts_dir, tok_dir = None, None
        if d:
            for name in sorted(os.listdir(d)):
                sub = os.path.join(d, name)
                if not os.path.isdir(sub):
                    continue
                low = name.lower()
                if "tokenizer" in low:
                    tok_dir = sub
                elif "tts" in low or "base" in low:
                    tts_dir = sub
            if tts_dir is None and any(f.endswith(".safetensors") for f in os.listdir(d)):
                tts_dir = d
        return tts_dir, tok_dir

    def _gguf_paths(self):
        """The reference's convention: <dir>/qwen3-tts-0.6b-f16.gguf and
        <dir>/qwen3-tts-tokenizer-f16.gguf (qwen3_tts.cpp:118-119)."""
        if not self._model_dir:
            return None, None
        return find_gguf_models(self._model_dir)

    def _open_checkpoint(self, which: int, what: str):
        d = self._paths()[which]
        if d is not None:
            return loader.open_checkpoint_dir(d)
        gguf_path = self._gguf_paths()[which]
        if gguf_path is not None:
            return GGUFCheckpoint(gguf_path)
        raise FileNotFoundError(f"no {what} checkpoint (safetensors or gguf) under "
                                f"{self._model_dir}")

    def _generator(self, k: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self._synthetic_seed * 3 + k)
        return g

    def _load_tokenizer(self) -> TextTokenizer:
        """The tokenizer the JAX pipeline's ``_load_tokenizer`` chooses
        (``pipeline.py:354-372``): the main model directory's vocab, else
        the GGUF file's; the synthetic one for synthetic weights, or, with
        a warning, for a GGUF with no vocabulary."""
        vocab = self.config.talker.text_vocab_size
        if self._synthetic_seed is not None:
            return synthetic_tokenizer(vocab)
        tts_dir, _ = self._paths()
        if tts_dir is not None:
            return TextTokenizer.from_hf_dir(tts_dir)
        tts_gguf, _ = self._gguf_paths()
        if tts_gguf is None:
            return synthetic_tokenizer(vocab)
        try:
            return TextTokenizer.from_gguf(GGUFReader(tts_gguf))
        except ValueError:
            print("warning: GGUF file carries no tokenizer vocab; "
                  "using the embedded synthetic tokenizer", file=sys.stderr)
            return synthetic_tokenizer(vocab)

    def _load_talker(self):
        """(talker, code predictor) params in the compute dtype, quantized to
        the weight tier."""
        cfg, rt = self.config, self.config.runtime
        with torch.no_grad():
            if self._synthetic_seed is not None:
                tp = talker_model.init_talker_params(self._generator(0), cfg.talker, self.dtype,
                                                     self.device)
                cp = cp_model.init_code_predictor_params(
                    self._generator(1), cfg.code_predictor, self.dtype, self.device)
            else:
                st = self._open_checkpoint(0, "TTS")
                tp = loader.load_talker(st, cfg.talker, self.dtype, self.device)
                cp = loader.load_code_predictor(st, cfg.code_predictor, self.dtype, self.device)
            if rt.quant is not None:
                tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, rt.quant))
                cp = cp._replace(blocks=quantize_block_params(cp.blocks))
        return tp, cp

    def _load_vocoder(self):
        """float32 vocoder params; the config's vocoder dimensions are
        replaced by those the checkpoint's shapes give."""
        if self._synthetic_seed is not None:
            return vocoder_model.init_vocoder_params(self._generator(2), self.config.vocoder,
                                                     self.device)
        st = self._open_checkpoint(1, "tokenizer/vocoder")
        vcfg = infer_vocoder_config(st, self.config.vocoder)
        if vcfg != self.config.vocoder:
            self.config = dataclasses.replace(self.config, vocoder=vcfg)
        with torch.no_grad():
            return loader.load_vocoder(st, vcfg, torch.float32, self.device)

    def _load_speaker_encoder(self):
        """float32 speaker-encoder params; the config's encoder dimensions are
        replaced by those the checkpoint's shapes give (and the mel
        filterbank follows them: the JAX pipeline builds it from the config
        before that replacement, ``pipeline.py:412-424``)."""
        if self._synthetic_seed is not None:
            g = torch.Generator(device=self.device)
            g.manual_seed(SPEAKER_SEED_OFFSET + self._synthetic_seed)
            return se_model.init_speaker_encoder_params(g, self.config.speaker_encoder,
                                                        torch.float32, self.device)
        st = self._open_checkpoint(0, "TTS")
        scfg = infer_speaker_config(st, self.config.speaker_encoder)
        if scfg != self.config.speaker_encoder:
            self.config = dataclasses.replace(self.config, speaker_encoder=scfg)
        with torch.no_grad():
            return loader.load_speaker_encoder(st, scfg, torch.float32, self.device)

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------

    def _fit_tokens(self, tokens):
        """Pad token ids into a prefill bucket (truncating, with the template
        suffix kept, past the largest), as the JAX pipeline does."""
        rt = self.config.runtime
        max_b = max(rt.prefill_buckets)
        if len(tokens) > max_b:
            tokens = list(tokens[: max_b - 5]) + list(tokens[-5:])
        Tb = pick_bucket(len(tokens), rt.prefill_buckets)
        padded = np.zeros((Tb,), np.int64)
        padded[: len(tokens)] = tokens
        return padded, len(tokens)

    def _frame_budget(self, params: SamplingConfig):
        """(frames the loop may run, KV capacity): the capacity is sized by
        the frame bucket as the JAX pipeline sizes it; the loop stops at
        max_audio_tokens instead of running the bucket out."""
        rt = self.config.runtime
        bucket = pick_bucket(params.max_audio_tokens, rt.frame_buckets)
        kv_capacity = -(-(10 + bucket + rt.kv_margin) // 256) * 256
        return min(bucket, params.max_audio_tokens), kv_capacity

    def synthesize(self, text: str, params: SamplingConfig = SamplingConfig()) -> TTSResult:
        """Basic synthesis with the default voice (zero speaker embedding)."""
        speaker = np.zeros((self.config.talker.hidden_size,), np.float32)
        return self._synthesize_internal(text, speaker, params, t_encode_ms=0.0)

    def synthesize_with_voice(self, text: str, reference_audio: Union[str, np.ndarray],
                              params: SamplingConfig = SamplingConfig(),
                              reference_sample_rate: Optional[int] = None) -> TTSResult:
        """Voice cloning from a reference waveform: a WAV path, or samples at
        reference_sample_rate (default: the encoder's 24 kHz), resampled to
        24 kHz; its speaker embedding takes the default voice's place in the
        prefill. t_encode_ms times the embedding (the encoder's lazy load on
        the first call included, as in the JAX pipeline)."""
        result = TTSResult()
        if not self._loaded:
            result.error_msg = "Models not loaded"
            return result
        sr_enc = self.config.speaker_encoder.sample_rate
        if isinstance(reference_audio, str):
            samples, sr = load_wav(reference_audio)
        else:
            samples = np.asarray(reference_audio, np.float32)
            sr = reference_sample_rate or sr_enc
        if sr != sr_enc:
            samples = resample_linear(samples, sr, sr_enc)
        t0 = now_ms()
        speaker = self.extract_speaker_embedding(samples)
        return self._synthesize_internal(text, speaker, params, t_encode_ms=now_ms() - t0)

    def extract_speaker_embedding(self, samples: np.ndarray) -> np.ndarray:
        """The ECAPA-TDNN x-vector [embedding_dim] of 24 kHz samples, run on
        exactly the samples given; beyond the largest of
        RuntimeConfig.speaker_buckets they are truncated, with the JAX
        pipeline's warning, so the embedding equals its."""
        if self.speaker_params is None:
            self.speaker_params = self._load_speaker_encoder()
        cfg = self.config.speaker_encoder
        max_n = max(self.config.runtime.speaker_buckets)
        if len(samples) > max_n:
            print(f"warning: reference audio of {len(samples) / cfg.sample_rate:.1f}s "
                  f"exceeds the largest speaker bucket ({max_n / cfg.sample_rate:.0f}s); "
                  "truncating", file=sys.stderr)
            samples = samples[:max_n]
        x = torch.as_tensor(np.asarray(samples, np.float32), device=self.device)
        return se_model.speaker_embedding(self.speaker_params, cfg, x).cpu().numpy()

    def _synthesize_internal(self, text: str, speaker: np.ndarray, params: SamplingConfig,
                             t_encode_ms: float) -> TTSResult:
        result = TTSResult()
        result.timings.t_load_ms = self.t_load_ms
        result.timings.t_encode_ms = t_encode_ms
        result.timings.mem_rss_start = rss_bytes()
        t_total0 = now_ms()
        if not self._loaded:
            result.error_msg = "Models not loaded"
            return result
        rt = self.config.runtime
        tcfg = self.config.talker

        t0 = now_ms()
        tokens = self.tokenizer.encode_for_tts(text)
        result.timings.t_tokenize_ms = now_ms() - t0
        if len(tokens) < 9:
            result.error_msg = "Text produced no tokens"
            return result

        if self.talker_params is None:
            self._set_talker(*self._load_talker())
        t0 = now_ms()
        padded, n_tok = self._fit_tokens(tokens)
        max_frames, kv_capacity = self._frame_budget(params)
        progress_cb = None
        if self.progress_callback is not None:
            user_cb, total = self.progress_callback, params.max_audio_tokens

            def progress_cb(frame):  # noqa: ANN001
                user_cb(frame, total)
        gen = torch.Generator()
        gen.manual_seed(params.seed)
        gen_out = decode_loop.generate_from_tokens(
            self.talker_params, self.cp_params, torch.from_numpy(padded), n_tok,
            torch.as_tensor(speaker, dtype=torch.float32, device=self.device),
            params.language_id, gen, talker_cfg=tcfg, cp_cfg=self.config.code_predictor,
            max_frames=max_frames, kv_capacity=kv_capacity,
            temperature=params.temperature, top_k=params.top_k, top_p=params.top_p,
            repetition_penalty=params.repetition_penalty,
            nothink=params.language_id < 0, kv_quant=resolve_kv_quant(rt),
            progress_cb=progress_cb, **self.fused)
        n_frames = gen_out.n_frames
        result.codes = gen_out.codes.cpu().numpy().astype(np.int32)
        result.hidden_states = gen_out.hidden.float().cpu().numpy()
        result.timings.t_generate_ms = now_ms() - t0
        result.n_frames = n_frames
        if n_frames == 0:
            result.error_msg = "No speech codes generated"
            return result
        if self.low_mem:
            self.talker_params = self.cp_params = None

        t0 = now_ms()
        if self.vocoder_params is None:
            self.vocoder_params = self._load_vocoder()
        result.audio = self.decode_codes(result.codes)
        result.timings.t_decode_ms = now_ms() - t0
        if self.low_mem:
            self.vocoder_params = None
        result.sample_rate = self.config.vocoder.sample_rate
        result.success = True
        result.timings.t_total_ms = now_ms() - t_total0
        result.timings.mem_rss_peak = rss_bytes()
        return result

    def decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """codes [n_frames, 16] -> float32 waveform [n_frames * 1920]: the
        whole clip in one vocoder pass, or, when
        RuntimeConfig.vocoder_chunk_frames is set and the clip is longer,
        in chunks (``stream_decode_chunks``), as the JAX package's
        ``decode_codes`` (``pipeline.py:1062-1076``). The stack is causal,
        so the JAX pipeline's right-padding to a vocoder bucket (a
        compile-cache device) changes no valid sample and is not copied."""
        codes = np.asarray(codes)
        chunk = self.config.runtime.vocoder_chunk_frames
        if chunk and codes.shape[0] > chunk:
            return np.concatenate(list(self.stream_decode_chunks(codes, chunk)))
        return self._vocode(codes)

    def _vocode(self, codes: np.ndarray) -> np.ndarray:
        """One vocoder pass over exactly codes [n, 16]."""
        c = torch.as_tensor(codes, dtype=torch.int64, device=self.device)
        audio = vocoder_model.vocoder_decode(self.vocoder_params, self.config.vocoder, c,
                                             c.shape[0])
        _sync(self.device)
        return audio.cpu().numpy()

    def stream_decode_chunks(self, codes: np.ndarray, chunk: int, history: int = 16):
        """Chunked vocoder decode (counterpart of ``stream_decode_chunks``,
        ``qwen3tts_tpu/pipeline.py:1081-1103``): each chunk of `chunk`
        frames is vocoded with up to `history` frames of left context whose
        samples are dropped; yields each chunk's float32 samples. The
        stack's convolutions are causal, but its pre-transformer's causal
        attention is unbounded, so the audio differs from one pass over the
        whole clip; it equals the JAX package's chunked decode. Each window
        is vocoded at its exact length (the JAX package pads it to a
        bucket, which changes no valid sample)."""
        spf = self.config.vocoder.samples_per_frame
        n = codes.shape[0]
        start = 0
        while start < n:
            lo, hi = max(0, start - history), min(n, start + chunk)
            yield self._vocode(codes[lo:hi])[(start - lo) * spf:(hi - lo) * spf]
            start = hi

    def synthesize_batch(self, texts, params: SamplingConfig = SamplingConfig(),
                         speakers=None):
        """Batched synthesis: the requests run one lockstep frame loop
        (``decode_loop.generate_from_tokens_batched``: kernels K5 and K6, or
        the unfused step with the lanes as the rows of each product), in
        groups of MAX_BATCH_LANES one after another; then each lane is
        vocoded on exactly its frames. Returns a list of TTSResult.

        Timing attribution, as in the JAX pipeline
        (``qwen3tts_tpu/pipeline.py:691-721``): t_generate_ms is the
        generate wall divided by B; t_decode_ms is the vocoder wall divided
        by B, or, when chunked vocoding applies (the longest lane exceeds
        RuntimeConfig.vocoder_chunk_frames), each lane's own decode time;
        t_total_ms is the wall up to the end of the lane's vocoding. A lane
        with no frames gets neither. Lane b of a group samples with
        its own seed drawn from params.seed (decode_loop), so lanes are
        independent and the grouping changes no lane's output. The KV tier
        is resolved once for the whole batch (``resolve_kv_quant`` with
        lanes = B, as the JAX pipeline resolves it)."""
        tcfg = self.config.talker
        B = len(texts)
        results = [TTSResult() for _ in texts]
        if not self._loaded:
            for r in results:
                r.error_msg = "Models not loaded"
            return results
        if speakers is None:
            speakers = np.zeros((B, tcfg.hidden_size), np.float32)
        t_total0 = now_ms()
        token_lists = [self.tokenizer.encode_for_tts(t) for t in texts]
        fitted = [self._fit_tokens(ids) for ids in token_lists]
        Tb = max(p.shape[0] for p, _ in fitted)
        tokens = np.zeros((B, Tb), np.int64)
        for i, (p_i, _) in enumerate(fitted):
            tokens[i, : p_i.shape[0]] = p_i
        n_tok = [n for _, n in fitted]
        max_frames, kv_capacity = self._frame_budget(params)
        kv_quant = resolve_kv_quant(self.config.runtime, batched=True, lanes=B)
        spk = torch.as_tensor(np.asarray(speakers), dtype=torch.float32, device=self.device)

        t0 = now_ms()
        codes, n_frames = [], []
        gen = torch.Generator()
        gen.manual_seed(params.seed)
        for o in range(0, B, MAX_BATCH_LANES):
            out = decode_loop.generate_from_tokens_batched(
                self.talker_params, self.cp_params,
                torch.from_numpy(tokens[o:o + MAX_BATCH_LANES]),
                n_tok[o:o + MAX_BATCH_LANES], spk[o:o + MAX_BATCH_LANES],
                [params.language_id] * len(texts[o:o + MAX_BATCH_LANES]), gen,
                talker_cfg=tcfg, cp_cfg=self.config.code_predictor, max_frames=max_frames,
                kv_capacity=kv_capacity, temperature=params.temperature, top_k=params.top_k,
                top_p=params.top_p, repetition_penalty=params.repetition_penalty,
                nothink=params.language_id < 0, kv_quant=kv_quant, **self.fused)
            codes += list(out.codes.numpy().astype(np.int32))
            n_frames += out.n_frames
        t_gen = now_ms() - t0

        # the JAX pipeline vocodes the batch in one dispatch unless chunked
        # vocoding applies (the longest lane exceeds vocoder_chunk_frames);
        # then it vocodes lane by lane and times each lane on its own
        chunk = self.config.runtime.vocoder_chunk_frames
        per_lane = bool(chunk) and max(n_frames, default=0) > chunk
        t0 = now_ms()
        audio = (None if per_lane else
                 [self.decode_codes(c[:n]) if n else None for c, n in zip(codes, n_frames)])
        t_dec = now_ms() - t0
        for i, (r, c, n) in enumerate(zip(results, codes, n_frames)):
            r.codes = c[:n]
            r.n_frames = n
            r.timings.t_generate_ms = t_gen / max(B, 1)
            if n == 0:
                r.error_msg = "No speech codes generated"
                continue
            if per_lane:
                t0 = now_ms()
                r.audio = self.decode_codes(r.codes)
                r.timings.t_decode_ms = now_ms() - t0
            else:
                r.audio = audio[i]
                r.timings.t_decode_ms = t_dec / max(B, 1)
            r.sample_rate = self.config.vocoder.sample_rate
            r.success = True
            r.timings.t_total_ms = now_ms() - t_total0
        return results

    def synthesize_queue(self, texts, params: SamplingConfig = SamplingConfig(),
                         speakers=None, *, lanes: Optional[int] = None,
                         kv_capacity: Optional[int] = None, chunk_frames: int = 8,
                         refill_slots: int = 8, on_audio=None,
                         max_audio_tokens_per_request=None):
        """Continuous serving of a request queue (counterpart of
        ``synthesize_queue``, ``qwen3tts_tpu/pipeline.py:722-978``): finished
        lanes are refilled mid-flight (``runtime/continuous.py``), so a mix
        of unequal lengths keeps the lanes busy where ``synthesize_batch``
        idles them until its longest request ends. Returns TTSResults in
        submission order, each vocoded (K3) on exactly its frames.

        Defaults as in the JAX package: lanes = min(64, len(texts));
        kv_capacity from P + 2 * frame bucket + chunk_frames + kv_margin,
        rounded up to 256 (about two request generations per session);
        request i samples with seed params.seed + i, so it equals
        ``synthesize`` of its text with that seed on the same path.
        max_audio_tokens_per_request (a list, one int per text) overrides
        params.max_audio_tokens per request. Every weight tier runs: K5 with
        ``start`` (fused_talker) and K6 with per-lane parameters (fused_cp),
        or the unfused step. The cache stays at the compute dtype whatever
        RuntimeConfig.kv_quant says: the JAX package's queue passes no
        kv_quant either (``pipeline.py:788-927``; K5 takes no ``start``
        with the int8 cache). on_audio streaming belongs to the streaming
        path, which is not ported yet: passing it raises
        NotImplementedError."""
        if on_audio is not None:
            raise NotImplementedError(
                "synthesize_queue(on_audio=...): streaming audio is not ported yet "
                "(the streaming path); call without on_audio for whole results")
        from .runtime.continuous import ContinuousScheduler, prefill_window_len

        rt, tcfg = self.config.runtime, self.config.talker
        B = len(texts)
        results = [TTSResult() for _ in texts]
        if not self._loaded:
            for r in results:
                r.error_msg = "Models not loaded"
            return results
        if speakers is None:
            speakers = np.zeros((B, tcfg.hidden_size), np.float32)
        t_total0 = now_ms()
        fitted = [self._fit_tokens(self.tokenizer.encode_for_tts(t)) for t in texts]
        Tb = max(p.shape[0] for p, _ in fitted)
        max_frames = pick_bucket(params.max_audio_tokens, rt.frame_buckets)
        nothink = params.language_id < 0
        if lanes is None:
            lanes = max(1, min(64, B))
        if kv_capacity is None:
            P = prefill_window_len(nothink)
            kv_capacity = -(-(P + 2 * max_frames + chunk_frames + rt.kv_margin) // 256) * 256
        sched = ContinuousScheduler(
            self.talker_params, self.cp_params, tcfg, self.config.code_predictor, lanes=lanes,
            kv_capacity=kv_capacity, text_bucket=Tb, chunk_frames=chunk_frames,
            refill_slots=refill_slots, max_frames=max_frames, temperature=params.temperature,
            top_k=params.top_k, top_p=params.top_p,
            repetition_penalty=params.repetition_penalty, nothink=nothink, **self.fused)
        budgets = [params.max_audio_tokens if max_audio_tokens_per_request is None
                   else int(max_audio_tokens_per_request[i]) for i in range(B)]
        t0 = now_ms()
        rids = [sched.submit(p_i, n_i, np.asarray(speakers[i], np.float32), params.language_id,
                             seed=params.seed + i, max_frames=min(budgets[i], max_frames))
                for i, (p_i, n_i) in enumerate(fitted)]
        out = sched.run()
        _sync(self.device)
        t_gen = now_ms() - t0
        self.last_queue_stats = dict(lanes=lanes, kv_capacity=kv_capacity,
                                     chunks=sched.chunks_run, refills=sched.refills,
                                     compactions=sched.compactions, sessions=sched.sessions)

        t0 = now_ms()
        codes = [out[rid][:budgets[i]].astype(np.int32) for i, rid in enumerate(rids)]
        audio = [self.decode_codes(c) if len(c) else None for c in codes]
        t_dec = now_ms() - t0
        for r, c, a in zip(results, codes, audio):
            r.codes = c
            r.n_frames = len(c)
            r.timings.t_generate_ms = t_gen / max(B, 1)
            r.timings.t_decode_ms = t_dec / max(B, 1)
            r.timings.t_total_ms = now_ms() - t_total0
            if a is None:
                r.error_msg = "No speech codes generated"
                continue
            r.audio = a
            r.sample_rate = self.config.vocoder.sample_rate
            r.success = True
        return results
