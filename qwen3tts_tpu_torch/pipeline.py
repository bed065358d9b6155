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
``synthesize_streaming`` yields the same request's audio in chunks while
its frame loop runs (``decode_loop.generate_init`` / ``generate_chunk``,
``runtime/e2e.start_and_vocode``); ``synthesize_batch`` runs B requests in
lockstep through the batched frame loop, then vocodes the lanes in groups
(``vocode_batched``: K3 over a group's lanes in one launch);
``synthesize_queue`` serves a queue continuously and, with ``on_audio``,
streams each request's audio on the JAX package's cadence. The prefill's
int8 projections run in
the W8A16 kernel (``ops/int8_matmul.py``), its u4 ones in the grouped
product of ``ops/quant.py`` and its bf16 ones in ``torch.matmul``.

``Qwen3TTS(config, device, fused_talker="auto", fused_cp="auto")`` picks
the decode step, for both loops (the JAX package's ``QWEN3TTS_FUSED_TALKER``
and ``QWEN3TTS_FUSED_CP`` gates, as arguments; "auto" is resolved per call
in ``runtime/decode_loop.py``). Every flag serves in every tier and compute
dtype: ``RuntimeConfig(dtype="float32")`` runs K1/K5 in their "f32" mode
over a float32 cache and head (quant=None) or in w8a8 with K2/K6 over
float32 heads and embeddings (quant="int8"), and decode attention over a
float32 cache.
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
``batched_kv_layout`` ("batch", the default, or "lane"; the JAX package's
``QWEN3TTS_BATCHED_KV_LAYOUT``) is the cache layout of ``synthesize_batch``'s
fused loop: "lane" keeps it [L, 2, Hkv, C, B, D] and runs K5 over it, with
cb0 drawn by ``decode_loop.sample_cb0``; the int8 KV cache and the unfused
step keep batch-major (logged once), and ``synthesize_queue`` is always
batch-major (it passes ``start``, which needs it).
On a CUDA device every kernel launches on the card or raises; there is no
CPU fallback. The CPU runs only when asked for (``device="cpu"``), through
the kernels' plain versions.

``SamplingConfig.seed`` means the JAX package's seed: every entry point
draws from the threefry key ``prng_key(seed)`` (``ops/prng.py``) as the
JAX pipeline draws from ``jax.random.PRNGKey(seed)``; ``synthesize_batch``
gives lane b ``split(prng_key(seed), B)[b]`` and ``synthesize_queue``
gives request i ``prng_key(seed + i)``. With the same weights, tokens and
seed, the sampled codes are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
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
from .ops import prng
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


def resolve_kv_quant(rt, *, kv_capacity: int = 0, batched: bool = False,
                     lanes: int = 0) -> str:
    """RuntimeConfig.kv_quant as the decode loops' kv_quant, as the JAX
    package's ``resolve_kv_quant`` (``pipeline.py:178-217``) resolves it
    without its environment override: "auto" gives "none" (the cache at the
    compute dtype), another value is returned as it is, except that "int8"
    for a batch of more than 64 lanes gives "none", with the JAX package's
    message on stderr. The card needs no such cap (128 lanes at C = 4352
    take 33 GB in int8); it is kept so that both packages give the same
    output for every config. kv_capacity is taken and ignored, as the JAX
    package's body ignores it (its streaming path passes it)."""
    mode = getattr(rt, "kv_quant", "auto")
    if mode == "auto":
        return "none"
    if mode == "int8" and batched and lanes > INT8_KV_MAX_LANES:
        print(f"qwen3tts: int8 KV requested at {lanes} lanes — capped at "
              f"{INT8_KV_MAX_LANES} (as the JAX package caps it); using bf16 KV",
              file=sys.stderr)
        return "none"
    return mode


# The batched vocoder's groups (``vocode_groups``). The float32 activations
# of the last decoder block are 1920 rows x 96 channels x 4 B = 737,280 B per
# frame per lane, and a res block or a transposed conv keeps about four
# alive: ~3 MB per frame per lane. A group's lanes x frames (each lane
# padded to the group's longest) stays within VOCODE_MAX_LANE_FRAMES, and a
# group holds at most VOCODE_MAX_LANES lanes; a lane longer than the budget
# is vocoded alone. (The JAX package's 16 lanes, ``_VOCODE_MAX_LANES``, is a
# TPU compile limit.) Both constants were chosen on an H100 by
# tools/time_vocoder_gemm.py --groups (PERF.md §5): on the 64-lane batch,
# 16 lanes a group vocoded as fast as 32 at half the memory (~3.7 MB a
# lane-frame), 8 within 3% of it, one group of 64 slower.
VOCODE_MAX_LANE_FRAMES = 4096
VOCODE_MAX_LANES = 16


def vocode_groups(n_frames):
    """Contiguous lane groups [(g0, g1)] over frame counts n_frames [B]: a
    group grows while it holds at most VOCODE_MAX_LANES lanes and its lane
    count times its longest lane stays within VOCODE_MAX_LANE_FRAMES (both
    read at the call)."""
    groups, g0, longest = [], 0, 0
    for b, n in enumerate(n_frames):
        grown = max(longest, int(n), 1)
        if b > g0 and (b - g0 + 1 > VOCODE_MAX_LANES
                       or (b - g0 + 1) * grown > VOCODE_MAX_LANE_FRAMES):
            groups.append((g0, b))
            g0, grown = b, max(int(n), 1)
        longest = grown
    if len(n_frames):
        groups.append((g0, len(n_frames)))
    return groups


def vocode_batched_groups(vparams, cfg, codes, n_frames):
    """Vocode lanes in groups (``vocode_groups``), yielding (g0, g1,
    host_audio [g1 - g0, F * 1920] float32) per group, F the group's longest
    lane: lane b's waveform is its first n_frames[b] * 1920 samples
    (counterpart of ``vocode_batched_groups``,
    ``qwen3tts_tpu/pipeline.py:144-169``). codes [B, >= max(n_frames), 16]
    (host or device), each lane's first n_frames[b] rows valid; a lane of 0
    frames is vocoded as one padding frame, as the JAX package does.

    Every group is enqueued before the first copy to the host, so group g's
    copy and the consumer's work on it overlap the later groups' compute:
    on the card each group's audio goes to pinned host memory by a
    non-blocking copy with an event of its own, and the generator waits on
    that event alone. The JAX package's tail-group and lane padding
    (compile-cache devices) are not copied: a group holds exactly its lanes,
    each padded to the group's longest only."""
    n = [max(int(k), 1) for k in n_frames]
    dev = vparams.vq_first_cb.device
    # one upload before the first group: a copy from pageable host memory
    # waits for the stream, so one per group would hold each group back
    codes = torch.as_tensor(codes).to(dev)
    pending = []
    for g0, g1 in vocode_groups(n):
        F = max(n[g0:g1])
        audio = vocoder_model.vocoder_decode(vparams, cfg, codes[g0:g1, :F], n[g0:g1])
        if dev.type == "cuda":
            host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
            host.copy_(audio, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        else:
            host, ready = audio, None
        pending.append((g0, g1, host, ready))
    for g0, g1, host, ready in pending:
        if ready is not None:
            ready.synchronize()
        yield g0, g1, host.numpy()


def vocode_batched(vparams, cfg, codes, n_frames) -> np.ndarray:
    """Vocode B lanes in groups: [B, max(n_frames) * 1920] float32 on the
    host, lane b's waveform in its first n_frames[b] * 1920 samples and
    zeros after them (counterpart of ``vocode_batched``,
    ``qwen3tts_tpu/pipeline.py:172-175``)."""
    spf = cfg.samples_per_frame
    n = [int(k) for k in n_frames]
    out = np.zeros((len(n), max(n, default=0) * spf), np.float32)
    for g0, g1, audio in vocode_batched_groups(vparams, cfg, codes, n):
        for b in range(g0, g1):
            out[b, :n[b] * spf] = audio[b - g0, :n[b] * spf]
    return out


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
                 fused_talker="auto", fused_cp="auto", low_mem: bool = False,
                 batched_kv_layout: str = "batch"):
        self.config = config or PipelineConfig()
        self.device = torch.device(device)
        self.fused = dict(fused_talker=fused_talker, fused_cp=fused_cp)
        if batched_kv_layout not in decode_loop.KV_LAYOUTS:
            raise ValueError(f"batched_kv_layout must be one of {decode_loop.KV_LAYOUTS}, "
                             f"got {batched_kv_layout!r}")
        self.batched_kv_layout = batched_kv_layout
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
        # the last synthesize_queue call's lanes, KV capacity, scheduler
        # counts (chunks, refills, compactions, sessions) and the
        # perf_counter second its run() started
        self.last_queue_stats: dict = {}
        # the last synthesize_streaming call's codes (the rows copied to the
        # host), frame count and frames per chunk
        self.last_stream: dict = {}

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
        gen_out = decode_loop.generate_from_tokens(
            self.talker_params, self.cp_params, torch.from_numpy(padded), n_tok,
            torch.as_tensor(speaker, dtype=torch.float32, device=self.device),
            params.language_id, prng.prng_key(params.seed), talker_cfg=tcfg,
            cp_cfg=self.config.code_predictor,
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
        groups of MAX_BATCH_LANES one after another; then the lanes that
        emitted frames are vocoded together (``vocode_batched``: groups of
        lanes, K3 over each group's lanes in one launch), each lane on
        exactly its frames, or, when chunked vocoding applies, lane by lane
        through ``decode_codes``, as the JAX pipeline does
        (``qwen3tts_tpu/pipeline.py:684-700``). Returns a list of
        TTSResult.

        Timing attribution, as in the JAX pipeline
        (``qwen3tts_tpu/pipeline.py:691-721``): t_generate_ms is the
        generate wall divided by B; t_decode_ms is the vocoder wall divided
        by B, or, when chunked vocoding applies (the longest lane exceeds
        RuntimeConfig.vocoder_chunk_frames), each lane's own decode time;
        t_total_ms is the wall up to the end of the lane's vocoding. A lane
        with no frames gets neither. Lane b samples with its own key,
        split(prng_key(params.seed), B)[b], as the JAX pipeline's lanes do
        (``pipeline.py:667``), so lanes are independent and the grouping
        changes no lane's output. The KV tier
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
        keys = prng.split(prng.prng_key(params.seed), B)
        keys = np.asarray(keys, np.uint32).reshape(B, 2)
        for o in range(0, B, MAX_BATCH_LANES):
            out = decode_loop.generate_from_tokens_batched(
                self.talker_params, self.cp_params,
                torch.from_numpy(tokens[o:o + MAX_BATCH_LANES]),
                n_tok[o:o + MAX_BATCH_LANES], spk[o:o + MAX_BATCH_LANES],
                [params.language_id] * len(texts[o:o + MAX_BATCH_LANES]),
                keys[o:o + MAX_BATCH_LANES],
                talker_cfg=tcfg, cp_cfg=self.config.code_predictor, max_frames=max_frames,
                kv_capacity=kv_capacity, temperature=params.temperature, top_k=params.top_k,
                top_p=params.top_p, repetition_penalty=params.repetition_penalty,
                nothink=params.language_id < 0, kv_quant=kv_quant,
                kv_layout=self.batched_kv_layout, **self.fused)
            codes += list(out.codes.numpy().astype(np.int32))
            n_frames += out.n_frames
        t_gen = now_ms() - t0

        # the JAX pipeline vocodes the batch together unless chunked
        # vocoding applies (the longest lane exceeds vocoder_chunk_frames);
        # then it vocodes lane by lane and times each lane on its own
        chunk = self.config.runtime.vocoder_chunk_frames
        per_lane = bool(chunk) and max(n_frames, default=0) > chunk
        t0 = now_ms()
        audio = None if per_lane else self._vocode_lanes(codes, n_frames)
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

    def _vocode_lanes(self, codes, n_frames):
        """Each lane's waveform (None for a lane of no frames) through
        ``vocode_batched`` over the lanes that have frames; codes: one
        [>= n, 16] array per lane."""
        if self.vocoder_params is None:
            self.vocoder_params = self._load_vocoder()
        spf = self.config.vocoder.samples_per_frame
        live = [i for i, n in enumerate(n_frames) if n > 0]
        out = [None] * len(n_frames)
        if not live:
            return out
        nmax = max(n_frames[i] for i in live)
        bufs = np.zeros((len(live), nmax, self.config.vocoder.n_codebooks), np.int64)
        for j, i in enumerate(live):
            bufs[j, :n_frames[i]] = codes[i][:n_frames[i]]
        audio = vocode_batched(self.vocoder_params, self.config.vocoder, bufs,
                               [n_frames[i] for i in live])
        for j, i in enumerate(live):
            out[i] = audio[j, :n_frames[i] * spf]
        return out

    def synthesize_queue(self, texts, params: SamplingConfig = SamplingConfig(),
                         speakers=None, *, lanes: Optional[int] = None,
                         kv_capacity: Optional[int] = None, chunk_frames: int = 8,
                         refill_slots: int = 8, on_audio=None, stream_history: int = 16,
                         stream_cadence: int = 32, max_audio_tokens_per_request=None,
                         admit_per_chunk: Optional[int] = None):
        """Continuous serving of a request queue (counterpart of
        ``synthesize_queue``, ``qwen3tts_tpu/pipeline.py:722-978``): finished
        lanes are refilled mid-flight (``runtime/continuous.py``), so a mix
        of unequal lengths keeps the lanes busy where ``synthesize_batch``
        idles them until its longest request ends. Returns TTSResults in
        submission order.

        Defaults as in the JAX package: lanes = min(64, len(texts));
        kv_capacity from P + 2 * frame bucket + chunk_frames + kv_margin,
        rounded up to 256 (about two request generations per session);
        request i samples with the key prng_key(params.seed + i), as the JAX
        package's request i does, so it equals ``synthesize`` of its text
        with that seed on the same path.
        max_audio_tokens_per_request (a list, one int per text) overrides
        params.max_audio_tokens per request; admit_per_chunk caps the
        admissions per chunk boundary (``admit_per_boundary``). The
        scheduler's loop is overlapped without on_audio and serial with it,
        the JAX package's defaults without its ``QWEN3TTS_OVERLAP_HARVEST``
        override. The loop decides where each later request is spliced
        into the cache: the codes of a request spliced elsewhere are the
        same in exact arithmetic, and on the card they may differ in the
        last bits, which sampling can turn into other codes. Every weight
        tier runs: K5 with ``start`` (fused_talker) and K6 with per-lane
        parameters (fused_cp), or the unfused step. The cache stays at the
        compute dtype whatever RuntimeConfig.kv_quant says: the JAX
        package's queue passes no kv_quant either (``pipeline.py:788-927``;
        K5 takes no ``start`` with the int8 cache).

        Without on_audio the results are vocoded after the run through
        ``vocode_batched`` (lane by lane through ``decode_codes`` when
        chunked vocoding applies), t_decode_ms the vocoder wall / B.
        With on_audio(request_index, audio_chunk, finished), each request's
        audio streams while the queue runs, on the JAX package's staggered
        cadence (``_stream_on_chunk``): a request's first decoded frames
        (at most chunk_frames rounded up to 8) are vocoded at once, with no
        history; then it emits segments of stream_cadence frames, each
        vocoded with stream_history frames of left context whose samples
        are dropped; the rest goes out when it finishes (stream_cadence=0:
        whatever each chunk brought). A request that finishes with no
        frames still gets on_audio(i, empty, True). The windows of a chunk
        boundary are vocoded through ``vocode_batched_groups``, the first
        windows as one set and the steady ones as another, and on_audio
        fires per group as that group's audio reaches the host. The
        harvest is serial while streaming (the JAX package's default
        then: its first windows would otherwise queue behind the next
        chunk). The results carry the streamed audio concatenated and
        t_decode_ms 0 (the vocoder runs inside the generate wall)."""
        from .runtime.continuous import ContinuousScheduler, prefill_window_len

        if on_audio is not None and not callable(on_audio):
            raise TypeError(f"on_audio must be callable, got {type(on_audio).__name__}")
        rt, tcfg = self.config.runtime, self.config.talker
        spf = self.config.vocoder.samples_per_frame
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
        if self.talker_params is None:
            self._set_talker(*self._load_talker())
        if self.vocoder_params is None:
            self.vocoder_params = self._load_vocoder()
        sched = ContinuousScheduler(
            self.talker_params, self.cp_params, tcfg, self.config.code_predictor, lanes=lanes,
            kv_capacity=kv_capacity, text_bucket=Tb, chunk_frames=chunk_frames,
            refill_slots=refill_slots, max_frames=max_frames, temperature=params.temperature,
            top_k=params.top_k, top_p=params.top_p,
            repetition_penalty=params.repetition_penalty, nothink=nothink,
            overlap_harvest=on_audio is None,
            admit_per_boundary=admit_per_chunk,
            **self.fused)
        budgets = [params.max_audio_tokens if max_audio_tokens_per_request is None
                   else int(max_audio_tokens_per_request[i]) for i in range(B)]
        t0 = now_ms()
        rids = [sched.submit(p_i, n_i, np.asarray(speakers[i], np.float32), params.language_id,
                             seed=params.seed + i, max_frames=min(budgets[i], max_frames))
                for i, (p_i, n_i) in enumerate(fitted)]
        streamed: dict = {}
        on_chunk = None
        if on_audio is not None:
            on_chunk = self._stream_on_chunk(
                {rid: i for i, rid in enumerate(rids)}, on_audio, streamed,
                chunk_frames=chunk_frames, history=stream_history, cadence=stream_cadence)
        run_started = time.perf_counter()
        out = sched.run(on_chunk=on_chunk)
        _sync(self.device)
        t_gen = now_ms() - t0
        self.last_queue_stats = dict(lanes=lanes, kv_capacity=kv_capacity,
                                     chunks=sched.chunks_run, refills=sched.refills,
                                     compactions=sched.compactions, sessions=sched.sessions,
                                     run_started=run_started)

        codes = [out[rid][:budgets[i]].astype(np.int32) for i, rid in enumerate(rids)]
        n_frames = [len(c) for c in codes]
        chunk = rt.vocoder_chunk_frames
        per_lane = bool(chunk) and max(n_frames, default=0) > chunk
        t0 = now_ms()
        audio = None if on_audio is not None or per_lane else self._vocode_lanes(codes,
                                                                                n_frames)
        t_dec = now_ms() - t0
        for i, (r, c, n) in enumerate(zip(results, codes, n_frames)):
            r.codes = c
            r.n_frames = n
            r.timings.t_generate_ms = t_gen / max(B, 1)
            if n == 0:
                r.error_msg = "No speech codes generated"
                continue
            if on_audio is not None:
                chunks = streamed.get(rids[i], [])
                r.audio = (np.concatenate(chunks)[: n * spf] if chunks
                           else np.zeros(0, np.float32))
                r.timings.t_decode_ms = 0.0
            elif per_lane:
                t1 = now_ms()
                r.audio = self.decode_codes(c)
                r.timings.t_decode_ms = now_ms() - t1
            else:
                r.audio = audio[i]
                r.timings.t_decode_ms = t_dec / max(B, 1)
            r.sample_rate = self.config.vocoder.sample_rate
            r.success = True
            r.timings.t_total_ms = now_ms() - t_total0
        return results

    def _stream_on_chunk(self, rid_to_idx, on_audio, streamed, *, chunk_frames: int,
                         history: int, cadence: int):
        """The scheduler's on_chunk for synthesize_queue(on_audio=...): the
        JAX package's staggered-cadence emission (``pipeline.py:819-927``),
        call for call. Per request: its first emission takes min(available,
        chunk_frames rounded up to 8) frames with no history; then segments
        of `cadence` frames (0: whatever is available) with up to `history`
        frames of context; on finish, the remainder in segments of at most
        `cadence`. Each emission's window is [history + k, 16] codes; the
        chunk's first windows are vocoded as one group set, then its steady
        windows as another, each window at its exact length (the JAX
        package pads them to two vocoder buckets and its lanes to multiples
        of 16; a lane's valid samples are the same). Appends each
        request's chunks to streamed[rid]."""
        vparams, vcfg = self.vocoder_params, self.config.vocoder
        spf, ncb = vcfg.samples_per_frame, vcfg.n_codebooks
        cadence = cadence if cadence > 0 else 0
        first_k = max(8, -(-chunk_frames // 8) * 8)
        ctx_codes: dict = {}
        pend_codes: dict = {}
        emitted_count: dict = {}

        def vocode_wins(wins):
            nf = [w[1].shape[0] for w in wins]
            bufs = np.zeros((len(wins), max(nf), ncb), np.int64)
            for g, (_, window, *_rest) in enumerate(wins):
                bufs[g, :window.shape[0]] = window
            for g0, g1, audio in vocode_batched_groups(vparams, vcfg, bufs, nf):
                for g in range(g0, g1):
                    rid, window, hist, k, fin = wins[g]
                    chunk_audio = audio[g - g0, hist * spf:(hist + k) * spf]
                    streamed.setdefault(rid, []).append(chunk_audio)
                    on_audio(rid_to_idx[rid], chunk_audio, fin)

        def on_chunk(events):
            first_wins, steady_wins = [], []
            for rid, rows, finished in events:
                pend = pend_codes.get(rid)
                pend = rows if pend is None else np.concatenate([pend, rows], axis=0)
                emits = []   # (k, is_first)
                avail = pend.shape[0]
                if emitted_count.get(rid, 0) == 0 and avail:
                    k = min(avail, first_k)
                    emits.append((k, True))
                    avail -= k
                if cadence:
                    while avail >= cadence:
                        emits.append((cadence, False))
                        avail -= cadence
                    if finished:
                        while avail > 0:
                            k = min(avail, cadence)
                            emits.append((k, False))
                            avail -= k
                elif avail:
                    emits.append((avail, False))
                    avail = 0
                off = 0
                for k, is_first in emits:
                    seg = pend[off:off + k]
                    off += k
                    ctx = ctx_codes.get(rid)
                    hist = 0 if is_first or ctx is None else min(history, ctx.shape[0])
                    window = seg if hist == 0 else np.concatenate([ctx[-hist:], seg], axis=0)
                    fin = finished and off == pend.shape[0]
                    (first_wins if is_first else steady_wins).append(
                        (rid, window, hist, k, fin))
                    grown = seg if ctx is None else np.concatenate([ctx, seg], axis=0)
                    ctx_codes[rid] = grown[-history:] if history > 0 else grown[:0]
                    emitted_count[rid] = emitted_count.get(rid, 0) + k
                pend_codes[rid] = pend[off:]
                if finished:
                    pend_codes.pop(rid, None)
                    ctx_codes.pop(rid, None)
                    if not emits:   # a finish with no frames still signals
                        streamed.setdefault(rid, []).append(np.zeros((0,), np.float32))
                        on_audio(rid_to_idx[rid], np.zeros((0,), np.float32), True)
            if first_wins:
                vocode_wins(first_wins)
            if steady_wins:
                vocode_wins(steady_wins)

        return on_chunk

    def synthesize_streaming(self, text: str, params: SamplingConfig = SamplingConfig(), *,
                             chunk_frames: int = 16, history: int = 32,
                             speaker: Optional[np.ndarray] = None):
        """Streaming synthesis: a generator of float32 audio chunks, yielded
        while generation runs (counterpart of ``synthesize_streaming``,
        ``qwen3tts_tpu/pipeline.py:980-1060``). The first chunk comes from
        ``runtime/e2e.start_and_vocode`` (the prefill, up to chunk_frames
        frames, the vocoder over them); then each ``generate_chunk`` of
        chunk_frames frames is vocoded over the window
        codes[max(0, emitted - history):n] (the codes on the device; the
        window at its exact length) and its new samples are yielded. The
        stream stops at EOS or at min(max_audio_tokens, frame bucket)
        frames; its chunks hold 1920 samples per frame in all. speaker: an
        embedding [H] (the default voice's zeros when None).

        Codes and keys are those of ``synthesize`` (the same loop, cut into
        chunks; the key chain carries across chunks in the LoopState): a
        streamed request's codes equal its. Only the new code
        rows are copied to the host; after the stream, last_stream holds
        them (codes [n, 16] int32), the frame count and each chunk's frames.
        The windows' pre-transformer attention is unbounded, so the chunks
        differ from one pass over the whole clip, as the JAX package's
        do."""
        from .runtime import e2e

        if not self._loaded:
            raise RuntimeError("Models not loaded")
        rt, tcfg = self.config.runtime, self.config.talker
        vcfg = self.config.vocoder
        spf = vcfg.samples_per_frame
        if speaker is None:
            speaker = np.zeros((tcfg.hidden_size,), np.float32)
        padded, n_tok = self._fit_tokens(self.tokenizer.encode_for_tts(text))
        budget, kv_capacity = self._frame_budget(params)
        if self.talker_params is None:
            self._set_talker(*self._load_talker())
        if self.vocoder_params is None:
            self.vocoder_params = self._load_vocoder()
        samp = dict(temperature=params.temperature, top_k=params.top_k, top_p=params.top_p,
                    repetition_penalty=params.repetition_penalty)
        codes, chunks = [], []
        self.last_stream = dict(codes=np.zeros((0, tcfg.n_codebooks), np.int32), n_frames=0,
                                chunk_frames=chunks)

        def take(state, lo, hi):
            """Copy the new code rows [lo, hi) to the host."""
            codes.append(state.codes[lo:hi].cpu().numpy().astype(np.int32))
            chunks.append(hi - lo)
            self.last_stream.update(codes=np.concatenate(codes), n_frames=hi)

        audio0, state, prefill = e2e.start_and_vocode(
            self.talker_params, self.cp_params, self.vocoder_params, torch.from_numpy(padded),
            n_tok, torch.as_tensor(speaker, dtype=torch.float32, device=self.device),
            params.language_id, prng.prng_key(params.seed), talker_cfg=tcfg,
            cp_cfg=self.config.code_predictor, vocoder_cfg=vcfg, chunk_frames=chunk_frames,
            max_frames=budget,
            kv_capacity=kv_capacity, nothink=params.language_id < 0,
            kv_quant=resolve_kv_quant(rt, kv_capacity=kv_capacity), **samp, **self.fused)
        emitted = min(state.frame, budget)
        if emitted > 0:
            take(state, 0, emitted)
            yield audio0[:emitted * spf].cpu().numpy()
        if state.done or emitted >= budget:
            return
        while True:
            decode_loop.generate_chunk(
                self.talker_params, self.cp_params, prefill, state, talker_cfg=tcfg,
                cp_cfg=self.config.code_predictor, chunk_frames=chunk_frames,
                max_frames=budget, **samp, **self.fused)
            n = min(state.frame, budget)
            if n > emitted:
                take(state, emitted, n)
                lo = max(0, emitted - history)
                audio = vocoder_model.vocoder_decode(self.vocoder_params, vcfg,
                                                     state.codes[lo:n], n - lo)
                yield audio[(emitted - lo) * spf:(n - lo) * spf].cpu().numpy()
                emitted = n
            if state.done or n >= budget:
                break
