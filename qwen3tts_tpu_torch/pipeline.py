"""Qwen3TTS pipeline of the port (counterpart of ``qwen3tts_tpu/pipeline.py``:
single-stream synthesis and batched serving).

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
``load_models(None, synthetic=True, seed=...)`` draws deterministic
synthetic weights at the configured widths (no checkpoint ships with the
repository; the checkpoint loaders are not ported yet). ``synthesize``
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
import sys
from typing import Optional

import numpy as np
import torch

from .config import PipelineConfig, SamplingConfig
from .models import code_predictor as cp_model
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
                 fused_talker="auto", fused_cp="auto"):
        self.config = config or PipelineConfig()
        self.device = torch.device(device)
        self.fused = dict(fused_talker=fused_talker, fused_cp=fused_cp)
        self.dtype = torch.bfloat16 if self.config.runtime.dtype == "bfloat16" else torch.float32
        self.tokenizer: Optional[TextTokenizer] = None
        self.talker_params = None
        self.cp_params = None
        self.vocoder_params = None
        self._loaded = False
        self.error_msg = ""
        # the last synthesize_queue call's lanes, KV capacity and scheduler
        # counts (chunks, refills, compactions, sessions)
        self.last_queue_stats: dict = {}

    def load_models(self, model_dir: Optional[str] = None, *, synthetic: bool = False,
                    seed: int = 0) -> bool:
        """Deterministic synthetic weights (model_dir None or synthetic=True)
        drawn from torch Generators on the device, seeded by `seed`, then
        quantized to the weight tier (module docstring). Checkpoint
        directories and unknown weight or KV tiers are not supported:
        returns False with error_msg set."""
        rt = self.config.runtime
        if model_dir is not None and not synthetic:
            self.error_msg = "Failed to load models: checkpoint loading is not ported yet"
            return False
        if rt.quant not in WEIGHT_TIERS:
            self.error_msg = (f"Failed to load models: quant tier {rt.quant!r} is not one of "
                              f"{WEIGHT_TIERS}")
            return False
        if rt.kv_quant not in KV_TIERS:
            self.error_msg = (f"Failed to load models: kv_quant {rt.kv_quant!r} is not one "
                              f"of {KV_TIERS}")
            return False
        cfg = self.config
        gens = []
        for k in range(3):
            g = torch.Generator(device=self.device)
            g.manual_seed(seed * 3 + k)
            gens.append(g)
        with torch.no_grad():
            tp = talker_model.init_talker_params(gens[0], cfg.talker, self.dtype, self.device)
            cp = cp_model.init_code_predictor_params(
                gens[1], cfg.code_predictor, self.dtype, self.device)
            vp = vocoder_model.init_vocoder_params(gens[2], cfg.vocoder, self.device)
            if rt.quant is not None:
                tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, rt.quant))
                cp = cp._replace(blocks=quantize_block_params(cp.blocks))
            self.set_params(tp, cp, vp)
        return True

    def set_params(self, talker_params, cp_params, vocoder_params) -> None:
        """Install talker/code-predictor params already in their weight tier
        and vocoder params (e.g. from ``io.from_jax``) and the synthetic
        tokenizer. The
        norm weights are kept in float32, as the kernels read them, so no
        frame converts them again."""
        self.talker_params = talker_params._replace(
            blocks=float32_norms(talker_params.blocks),
            output_norm=talker_params.output_norm.float())
        self.cp_params = cp_params._replace(
            blocks=float32_norms(cp_params.blocks), output_norm=cp_params.output_norm.float())
        self.vocoder_params = vocoder_params
        self.tokenizer = synthetic_tokenizer(self.config.talker.text_vocab_size)
        self._loaded = True

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
        result = TTSResult()
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

        t0 = now_ms()
        padded, n_tok = self._fit_tokens(tokens)
        max_frames, kv_capacity = self._frame_budget(params)
        gen = torch.Generator()
        gen.manual_seed(params.seed)
        gen_out = decode_loop.generate_from_tokens(
            self.talker_params, self.cp_params, torch.from_numpy(padded), n_tok,
            torch.zeros((tcfg.hidden_size,), dtype=torch.float32, device=self.device),
            params.language_id, gen, talker_cfg=tcfg, cp_cfg=self.config.code_predictor,
            max_frames=max_frames, kv_capacity=kv_capacity,
            temperature=params.temperature, top_k=params.top_k, top_p=params.top_p,
            repetition_penalty=params.repetition_penalty,
            nothink=params.language_id < 0, kv_quant=resolve_kv_quant(rt), **self.fused)
        n_frames = gen_out.n_frames
        result.codes = gen_out.codes.cpu().numpy().astype(np.int32)
        result.hidden_states = gen_out.hidden.float().cpu().numpy()
        result.timings.t_generate_ms = now_ms() - t0
        result.n_frames = n_frames
        if n_frames == 0:
            result.error_msg = "No speech codes generated"
            return result

        t0 = now_ms()
        result.audio = self.decode_codes(result.codes)
        result.timings.t_decode_ms = now_ms() - t0
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
