"""Continuous serving: refill finished lanes mid-flight (counterpart of
``qwen3tts_tpu/runtime/continuous.py``).

The batched loop (``decode_loop.generate_from_tokens_batched``) admits B
requests together and runs until every lane is done, so short requests idle
while the longest drains. Here the step stays lockstep (one weight stream
for all lanes: K5 and K6, or the unfused step with the lanes as rows) but a
lane's occupant changes:

- one global write row ``n_past`` advances every step, shared by the lanes;
- a finished lane takes a new request: its fixed prefill window (10 rows, 9
  nothink) is computed at the absolute positions [n_past - P, n_past)
  (``talker.talker_prefill_window``) and spliced into the lane's cache
  there, over its previous occupant's stale rows;
- each lane carries ``start``, its first valid cache row; attention masks
  the rows below it (K5's ``start`` operand, or the XLA mask of the unfused
  step). RoPE uses absolute positions and rotary attention depends on
  relative ones only, so a spliced request computes what a fresh run at
  [0, P) computes;
- the host drives chunks of K frames (``decode_chunk``) and refills idle
  lanes between chunks (``refill``); one device-to-host copy per chunk.

Capacity: admission needs n_past + max_frames + K <= C. When admission is
blocked with lanes still active, ``compact`` rolls the cache down by the
smallest active start and re-rotates the K rows by -shift; when every lane
is idle the session resets (n_past back to P).

The port's differences, each the counterpart of a JAX mechanism:
- the state is updated in place (JAX donates it and returns a new one);
  ``n_past`` is a host int, the scheduler's own count;
- keys: each request's threefry key is ``prng_key(seed)`` at refill (the
  JAX scheduler's ``_host_prngkey``, :81-90, :723); refill draws frame 0's
  cb0 from a split of it into 3, and every frame of a chunk splits each
  lane's chain key into 3 (JAX's vmapped split, :193, :373), in the order
  ``generate_from_tokens`` splits them, so a request's output equals a
  fresh run of the same path from the same key, and the JAX scheduler's.
  JAX carries the keys on the device; the host carries them here ([B, 2]
  uint32, numpy over the lanes) and builds a chunk's keys in one pass
  before its launch, uploading the kernels' int32 seeds once a chunk;
- the next cb0 is sampled at the end of each frame (K5's epilogue, or
  ``sample_cb0`` on the unfused step's logits) and carried, on both paths
  (JAX carries logits on its unfused path and samples them next frame: the
  same draw with the same seen-set);
- ``refill`` prefills exactly the admitted slots (eager PyTorch has no
  compiled shape to pad to), still as one [R, P, H] prefill;
- EOS and budgets latch on the device within a chunk: ``decode_chunk``
  launches its K frames without reading anything back, as the JAX
  ``fori_loop`` does;
- the overlapped loop copies a chunk's results into pinned host memory
  without blocking, records an event, and harvests chunk N-1 while chunk N
  runs (the ``QWEN3TTS_OVERLAP_HARVEST`` gate is the ``overlap_harvest``
  argument).
The int8-KV tier is not ported here (the queue keeps a bf16 cache, as
the JAX package's does).

On a mesh (``ContinuousScheduler(mesh=...)``, the JAX scheduler's ``mesh``
and ``_shard_state``, :523, :550-574, :671-686), every rank runs this
scheduler with the same queue, one process per rank. The lane state is
split over "dp": dp rank r holds lanes [r B/dp, (r+1) B/dp) on its device
(B a multiple of dp), and the weights may be split over "tp"
(``parallel/shardings.shard_params``; the models sum and gather over "tp").
The host scheduling stays global and identical on every rank: each rank
refills the admitted lanes it holds, advances its lanes' key chains, and
harvests the chunk's packed copy gathered over "dp" (``gather_lanes``), so
refills, compactions and each request's codes are the unsharded
scheduler's. The fused kernels are off under any multi-device mesh, as in
the JAX package (an explicit True raises).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import code_predictor as cp_model
from ..models import talker as talker_model
from ..ops import prng
from ..ops.fused_code_predictor_batched import fused_predict_codes_batched
from ..ops.fused_talker_step import MAX_LANES as TALKER_KERNEL_MAX_LANES
from ..ops.fused_talker_step import fused_talker_step_batched
from ..ops.kernel_prng import sampling_flags
from ..ops.rope import rope_angles
from ..parallel.collectives import gather_lanes, lane_range
from ..parallel.shardings import local_config
from .decode_loop import (CP_KERNEL_MAX_LANES, _rest_embd_sum, resolve_fused_cp,
                          resolve_fused_talker, sample_cb0)


def prefill_window_len(nothink: bool) -> int:
    """build_prefill's fixed window: 3 role rows, 3 (nothink) or 4 codec
    rows, speaker, pad/bos and the first text row."""
    return 9 if nothink else 10


@dataclasses.dataclass
class ContinuousState:
    """The lanes' serving state (JAX ``ContinuousState``), updated in place."""

    n_past: int                 # the global write row (lockstep), a host int
    start: torch.Tensor         # [B] int32: each lane's first valid cache row
    cb0_next: torch.Tensor      # [B] int64: each lane's next codebook-0 token
    last_hidden: torch.Tensor   # [B, H] param dtype
    kv: torch.Tensor            # [B, L, 2, Hkv, C, D] batch-major
    seen: torch.Tensor          # [B, Vc] int8 repetition-penalty set
    frame: torch.Tensor         # [B] int64: frames the occupant emitted
    budget: torch.Tensor        # [B] int64: the occupant's frame budget
    samp: torch.Tensor          # [B, 3] f32: (temperature, top_p, repetition_penalty)
    trailing: torch.Tensor      # [B, Trb, H] the occupant's trailing schedule
    done: torch.Tensor          # [B] bool: lane idle (finished or never filled)


def init_state(talker_params, talker_cfg, *, lanes: int, kv_capacity: int, trailing_len: int,
               nothink: bool = False) -> ContinuousState:
    """Every lane idle; n_past starts at the prefill window's length, so the
    first refill splices at [0, P) like every later one. talker_cfg is the
    params' own (``shardings.local_config`` of a tensor-parallel shard), as
    for refill and decode_chunk."""
    B, tcfg = lanes, talker_cfg
    H, Vc = tcfg.hidden_size, tcfg.codec_vocab_size
    dtype, dev = talker_params.codec_embd.dtype, talker_params.codec_embd.device
    zeros = lambda *s, dt=torch.int64: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    return ContinuousState(
        n_past=prefill_window_len(nothink),
        start=zeros(B, dt=torch.int32),
        cb0_next=zeros(B),
        last_hidden=zeros(B, H, dt=dtype),
        kv=zeros(B, tcfg.n_layers, 2, tcfg.n_kv_heads, kv_capacity, tcfg.head_dim, dt=dtype),
        seen=zeros(B, Vc, dt=torch.int8),
        frame=zeros(B),
        budget=zeros(B),
        samp=torch.ones((B, 3), dtype=torch.float32, device=dev),
        trailing=zeros(B, trailing_len, H, dt=dtype),
        done=torch.ones((B,), dtype=torch.bool, device=dev),
    )


def refill(talker_params, state: ContinuousState, lanes, tokens, n_tokens, speaker_embd,
           language_id, keys, budgets, samp, *, talker_cfg, nothink: bool = False,
           top_k: int = 0, allow_eos: bool = True, greedy: bool = False,
           use_top_p: bool = True) -> None:
    """Splice R new requests into the lanes `lanes` ([R] ints) at the
    current n_past (JAX ``refill``, :145-253): tokens [R, Tb], n_tokens [R],
    speaker_embd [R, H], language_id [R], keys [R, 2] (the key each
    request's frame-0 cb0 draws with: split(prng_key(seed), 3)[1]), budgets
    [R], samp [R, 3] (temperature, top_p, penalty).

    The R windows run as one prefill at positions [n_past - P, n_past)
    (every projection one product of R*P rows); frame 0's cb0 is drawn from
    each window's logits by ``sample_cb0`` with the slot's own temperature
    and top-p (the exact top-k of ``sample_token``); each window's K/V go to
    its lane's rows [n_past - P, n_past), and the lane's start, hidden,
    seen-set, frame, budget, sampling parameters, trailing schedule and done
    flag are reset. greedy, use_top_p and top_k are the server's."""
    tcfg = talker_cfg
    dev = state.kv.device
    dtype = talker_params.codec_embd.dtype
    P = prefill_window_len(nothink)
    pos0 = state.n_past - P
    Vc = tcfg.codec_vocab_size
    idx = torch.as_tensor(lanes, dtype=torch.int64).to(dev)
    samp = torch.as_tensor(samp, dtype=torch.float32).to(dev)
    with torch.no_grad():
        pre = talker_model.build_prefill(
            talker_params, tcfg, torch.as_tensor(tokens), torch.as_tensor(n_tokens),
            torch.as_tensor(speaker_embd).to(dev), torch.as_tensor(language_id), nothink=nothink)
        hidden, logits, kv_win = talker_model.talker_prefill_window(
            talker_params, tcfg, pre.prefill_embd, pos0)
        cb0 = sample_cb0(logits, keys, suppress_start=Vc - tcfg.n_suppressed_tail,
                         eos_id=tcfg.codec_eos_id if allow_eos else -1,
                         temperature=samp[:, 0], top_k=top_k, top_p=samp[:, 1], greedy=greedy,
                         use_top_p=use_top_p)
        state.kv[idx, :, :, :, pos0:state.n_past] = kv_win.to(state.kv.dtype)
        state.start[idx] = pos0
        state.cb0_next[idx] = cb0.to(torch.int64)
        state.last_hidden[idx] = hidden.to(dtype)
        state.seen[idx] = 0
        state.frame[idx] = 0
        state.budget[idx] = torch.as_tensor(budgets, dtype=torch.int64).to(dev)
        state.samp[idx] = samp
        state.trailing[idx] = pre.trailing.to(state.trailing.dtype)
        state.done[idx] = False


def compact(state: ContinuousState, shift: int, *, talker_cfg) -> None:
    """Reclaim the cache rows below every active lane's start (JAX
    ``compact``, :258-301): roll the cache down by `shift` rows, re-rotate
    the K rows by -shift, and rebase n_past and start (idle lanes' stale
    starts clamp at 0).

    Attention depends on relative positions only: a K row stored as
    R(pos) k must read R(pos - shift) k = R(-shift) R(pos) k at its new
    row, and NEOX rotations compose per frequency pair, so one rotation by
    -shift in float32 fixes every K row (V rows carry no position). One
    layer at a time, so the float32 copy is 1/L of the cache (64 lanes at C
    = 1024 hold a 7.5 GB bf16 cache)."""
    kv = state.kv
    L, D = kv.shape[1], kv.shape[5]
    half = D // 2
    cos, sin = rope_angles(-int(shift), D, talker_cfg.rope_theta)
    cos, sin = cos.to(kv.device), sin.to(kv.device)
    with torch.no_grad():
        for l in range(L):
            rolled = torch.roll(kv[:, l], -int(shift), dims=3)       # [B, 2, Hkv, C, D]
            k = rolled[:, 0].float()
            k1, k2 = k[..., :half], k[..., half:]
            rolled[:, 0] = torch.cat([k1 * cos - k2 * sin, k1 * sin + k2 * cos],
                                     dim=-1).to(kv.dtype)
            kv[:, l] = rolled
    state.n_past -= int(shift)
    state.start.sub_(int(shift)).clamp_(min=0)


class ChunkResult(NamedTuple):
    """One chunk's emissions (JAX ``ChunkResult``; the state is updated in
    place): ``host`` packs codes [B, K, 16] | emit [B, K] (row (b, k) is a
    real emission) | eos [B, K] (lane b hit EOS at step k) | done [B] into
    one int32 [B, 16K + 2K + 1] host tensor, the chunk's one device-to-host
    copy, which may still be in flight until ``ready`` (a CUDA event; None
    on the CPU) has passed."""

    host: torch.Tensor
    ready: Optional[object]

    def fetch(self) -> np.ndarray:
        """The packed host copy as numpy, once it has landed."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.host.numpy()


def decode_chunk(talker_params, cp_params, state: ContinuousState, keys, *, talker_cfg,
                 cp_cfg, chunk_frames: int, start_min: int = 0, top_k: int = 0,
                 fused_cp="auto", fused_talker="auto", allow_eos: bool = True,
                 greedy: bool = False, use_top_p: bool = True,
                 non_blocking: bool = False) -> ChunkResult:
    """Advance every lane K = chunk_frames steps (JAX ``decode_chunk``,
    :304-485) with no read back to the host until the chunk's one packed
    copy. keys [B, K, 2, 2] uint32 (numpy): lane b's (code predictor, next
    cb0) keys of frame k; the kernels take their ``seed32`` (one upload a
    chunk), the unfused code predictor and sampler the keys. start_min: a
    host lower bound of every
    lane's effective start (the scheduler's mirror), which lets K5 skip the
    attention chunks below it; 0 is always safe.

    Per frame, as ``generate_from_tokens_batched`` with four differences:
    lane b attends rows [start_eff[b], n_past], start_eff = n_past for a
    done lane (only its own row) and its start otherwise; the trailing row
    comes from the lane's own schedule; each lane samples with its
    occupant's temperature, top-p and penalty; and a lane is also done when
    its occupant reaches its budget. Emissions are masked by done; the
    seen-set grows only for emitting lanes. fused_talker: K5 (in groups of
    128 lanes) with ``start`` and per-lane sampling, which samples the next
    cb0; else ``talker_step`` (XLA attention at every capacity) and
    ``sample_cb0``. fused_cp: K6 (groups of 64) with per-lane temperature
    and top-p; else ``predict_codes``. non_blocking: the packed copy goes to
    pinned memory without waiting (the overlapped loop)."""
    tcfg, ccfg = talker_cfg, cp_cfg
    use_cp = resolve_fused_cp(fused_cp, cp_params)
    use_talker = resolve_fused_talker(fused_talker, talker_params)
    tp = talker_params
    dev = state.kv.device
    B, K = state.kv.shape[0], chunk_frames
    Vc, eos = tcfg.codec_vocab_size, tcfg.codec_eos_id
    suppress_start = Vc - tcfg.n_suppressed_tail
    eos_for_mask = eos if allow_eos else -1
    dtype = tp.codec_embd.dtype
    Trb = state.trailing.shape[1]
    keys = prng.key_array(keys)
    if use_cp or use_talker:
        # [0]: K6's seeds, [1]: K5's, each [K, B]
        seeds = prng.to_device(np.stack([prng.seed32(keys[:, :, 0]).T,
                                         prng.seed32(keys[:, :, 1]).T]), dev)
    lanes = torch.arange(B, device=dev)
    temp, top_p, pen = (state.samp[:, i].contiguous() for i in range(3))
    statics = dict(top_k=top_k, greedy=greedy, use_top_p=use_top_p)
    codes_buf = torch.zeros((B, K, tcfg.n_codebooks), dtype=torch.int64, device=dev)
    emit_buf = torch.zeros((B, K), dtype=torch.bool, device=dev)
    eos_buf = torch.zeros((B, K), dtype=torch.bool, device=dev)
    with torch.no_grad():
        for k in range(K):
            cb0 = state.cb0_next
            is_eos = (cb0 == eos) if allow_eos else torch.zeros_like(state.done)
            done = state.done | is_eos
            emit = ~done
            start_eff = torch.where(done, torch.full_like(state.start, state.n_past),
                                    state.start)
            cb0_embd = tp.codec_embd[cb0]                                    # [B, H]
            if use_cp:
                outs = [fused_predict_codes_batched(
                    cp_params, ccfg, state.last_hidden[o:o + CP_KERNEL_MAX_LANES],
                    cb0_embd[o:o + CP_KERNEL_MAX_LANES],
                    seeds[0, k, o:o + CP_KERNEL_MAX_LANES],
                    temperature=temp[o:o + CP_KERNEL_MAX_LANES],
                    top_p=top_p[o:o + CP_KERNEL_MAX_LANES], **statics)
                    for o in range(0, B, CP_KERNEL_MAX_LANES)]
                rest = torch.cat([r.to(torch.int64) for r, _ in outs])
                rest_sum = torch.cat([rs for _, rs in outs])
            else:
                rest = cp_model.predict_codes(cp_params, ccfg, state.last_hidden, cb0_embd,
                                              keys[:, k, 0], temperature=temp, top_p=top_p,
                                              **statics)
                rest_sum = _rest_embd_sum(cp_params, rest)
            codes_buf[:, k] = torch.cat([cb0[:, None], rest], dim=1)
            emit_buf[:, k] = emit
            eos_buf[:, k] = is_eos & ~state.done
            state.seen[lanes, cb0] |= emit.to(torch.int8)
            trailing_row = state.trailing[lanes, torch.clamp(state.frame, max=Trb - 1)]
            step_embd = (cb0_embd.float() + rest_sum + trailing_row.float()).to(dtype)
            if use_talker:
                G = TALKER_KERNEL_MAX_LANES
                outs = [fused_talker_step_batched(
                    tp.blocks, tcfg, step_embd[o:o + G], state.n_past, state.kv[o:o + G],
                    output_norm=tp.output_norm, codec_head=tp.codec_head,
                    seen=state.seen[o:o + G], seeds=seeds[1, k, o:o + G],
                    start=start_eff[o:o + G], start_min=start_min,
                    temperature=temp[o:o + G], top_p=top_p[o:o + G],
                    repetition_penalty=pen[o:o + G], suppress_start=suppress_start,
                    eos_id=eos_for_mask, **statics) for o in range(0, B, G)]
                state.last_hidden = torch.cat([out.hidden for out in outs]).to(dtype)
                state.cb0_next = torch.cat([out.cb0 for out in outs]).to(torch.int64)
            else:
                hidden, logits = talker_model.talker_step(tp, tcfg, step_embd, state.n_past,
                                                          state.kv, start=start_eff)
                state.last_hidden = hidden.to(dtype)
                state.cb0_next = sample_cb0(
                    logits, keys[:, k, 1], suppress_start=suppress_start,
                    eos_id=eos_for_mask, temperature=temp, top_p=top_p, seen=state.seen,
                    repetition_penalty=pen, **statics)
            state.frame = state.frame + emit.to(torch.int64)
            state.done = done | (state.frame >= state.budget)
            state.n_past += 1
        packed = torch.cat([codes_buf.reshape(B, -1).to(torch.int32), emit_buf.to(torch.int32),
                            eos_buf.to(torch.int32), state.done.to(torch.int32)[:, None]], dim=1)
    ready = None
    if dev.type == "cuda":
        host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(packed, non_blocking=non_blocking)
        ready = torch.cuda.Event()
        ready.record()
    else:
        host = packed
    return ChunkResult(host=host, ready=ready)


class _Lane(NamedTuple):
    rid: int
    codes: list


class _Request(NamedTuple):
    rid: int
    tokens: np.ndarray        # [Tb] padded ids
    n_tokens: int
    speaker: np.ndarray       # [H] float32
    language_id: int
    seed: int
    budget: int
    samp: tuple               # (temperature, top_p, repetition_penalty)


class ContinuousScheduler:
    """Host-side request scheduler over ``refill``, ``decode_chunk`` and
    ``compact`` (JAX ``ContinuousScheduler``, :493-1018).

        sched = ContinuousScheduler(tp, cp, talker_cfg, cp_cfg, lanes=64,
                                    kv_capacity=1024, text_bucket=32,
                                    max_frames=256)
        rid = sched.submit(tokens, n_tokens, speaker_embd, language_id, seed)
        results = sched.run()       # {rid: codes np [n, 16]}

    compact_policy "pressure" (the default) compacts only when admission is
    blocked and the shift unblocks it; "opportunistic" also shifts whenever
    the smallest active start reaches compact_threshold (a correctness
    stressor: a global shift leaves every lane's attended rows as they
    were). overlap_harvest (default True) keeps one chunk in flight and
    harvests the previous one meanwhile; False is the serial loop. timing
    synchronizes the device after each phase and sums its wall into
    ``stats`` (a diagnosis mode, not for headline numbers). mesh: a
    ``parallel.mesh.Mesh`` to split the lanes over (module docstring);
    every rank constructs the scheduler and submits the same requests."""

    def __init__(self, talker_params, cp_params, talker_cfg, cp_cfg, *, lanes: int = 64,
                 kv_capacity: int = 1024, text_bucket: int = 32, chunk_frames: int = 32,
                 refill_slots: int = 8, max_frames: int = 256, temperature: float = 0.9,
                 top_k: int = 50, top_p: float = 1.0, repetition_penalty: float = 1.05,
                 nothink: bool = False, allow_eos: bool = True, fused_cp="auto",
                 fused_talker="auto", mesh=None, compact_threshold: int = 128,
                 compact_policy: str = "pressure", timing: bool = False,
                 overlap_harvest: bool = True, admit_per_boundary: Optional[int] = None):
        P = prefill_window_len(nothink)
        if kv_capacity < P + max_frames + chunk_frames:
            raise ValueError("kv_capacity cannot admit even one request")
        if compact_policy not in ("pressure", "opportunistic"):
            raise ValueError(f"unknown compact_policy {compact_policy!r}")
        self.tp, self.cp = talker_params, cp_params
        # the params' own configs (a tensor-parallel shard's head counts)
        self.tcfg = local_config(talker_cfg, talker_params.blocks)
        self.ccfg = local_config(cp_cfg, cp_params.blocks)
        self.B, self.C = lanes, kv_capacity
        self.Tb, self.K, self.R = text_bucket, chunk_frames, refill_slots
        self.max_frames = max_frames
        self.compact_threshold = int(compact_threshold)
        self.compact_policy = compact_policy
        self.nothink, self.allow_eos = nothink, allow_eos
        self.fused_cp = resolve_fused_cp(fused_cp, cp_params)
        self.fused_talker = resolve_fused_talker(fused_talker, talker_params)
        if mesh is not None and mesh.size > 1 and (self.fused_cp or self.fused_talker):
            if fused_cp is True or fused_talker is True:
                raise ValueError(
                    "fused kernels cannot run under a multi-device mesh in the continuous "
                    "scheduler (its lane state is split over dp in place); pass "
                    "fused_cp/fused_talker='auto' for the unfused path")
            print("qwen3tts: continuous scheduler on a multi-device mesh — fused kernels "
                  "off, unfused decode path (parallel/kernel_safety.py)", file=sys.stderr)
            self.fused_cp = self.fused_talker = False
        self.mesh = mesh
        if mesh is not None and lanes % mesh.dp:
            raise ValueError(f"{lanes} lanes do not split over dp = {mesh.dp}")
        # the lanes [lo, hi) whose state this rank holds
        self.lo, self.hi = (0, lanes) if mesh is None else lane_range(mesh, lanes)
        # greedy, use_top_p and top_k are the server's; temperature, top_p
        # and repetition_penalty are each request's, defaulting to these
        greedy, use_top_p = sampling_flags(temperature, top_p)
        self.defaults = (float(temperature), float(top_p), float(repetition_penalty))
        self.statics = dict(top_k=top_k, greedy=greedy, use_top_p=use_top_p)
        self.device = talker_params.codec_embd.device
        self.state = self._new_state()
        self._queue: list[_Request] = []
        self._next_rid = 0
        self._lane_owner: list[Optional[_Lane]] = [None] * lanes
        # each lane's chain key (two uint32): its occupant's, split per frame
        self._keys = np.zeros((lanes, 2), np.uint32)
        # host mirrors of the device's scheduling state: n_past moves by K
        # per chunk and -shift per compaction, and every start is set by this
        # scheduler's own refills, so nothing is read back to decide
        self._n_past_h = P
        self._start_h = np.zeros((lanes,), np.int64)
        self._done_h = np.ones((lanes,), bool)
        self.results: dict[int, np.ndarray] = {}
        self.chunks_run = 0
        self.sessions = 0
        self.compactions = 0
        self.refills = 0
        self.overlap_harvest = bool(overlap_harvest)
        self.admit_per_boundary = (None if admit_per_boundary is None
                                   else int(admit_per_boundary))
        self.timing = bool(timing)
        self.stats = {k: 0.0 for k in ("refill_s", "decode_s", "compact_s", "harvest_s")}

    def _new_state(self) -> ContinuousState:
        return init_state(self.tp, self.tcfg, lanes=self.hi - self.lo, kv_capacity=self.C,
                          trailing_len=self.Tb - 3, nothink=self.nothink)

    def _tock(self, key: str, t0: float) -> None:
        if self.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats[key] += time.perf_counter() - t0

    def submit(self, tokens, n_tokens: int, speaker_embd, language_id: int, seed: int = 0,
               max_frames: Optional[int] = None, temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None) -> int:
        """Enqueue one request and return its id. max_frames is its frame
        budget (at most the scheduler's); temperature, top_p and
        repetition_penalty override the server's defaults for this request,
        within the server's sampling class: a greedy server (default
        temperature <= 0) takes no sampled request and a sampled one no
        greedy request, and top_p < 1 needs a server whose default top_p
        engaged the top-p stage. Raises ValueError otherwise, and for a
        prompt longer than the text bucket."""
        tokens = np.asarray(tokens, np.int64)
        if tokens.shape[0] > self.Tb:
            raise ValueError(f"prompt ({tokens.shape[0]}) exceeds text bucket {self.Tb}")
        budget = self.max_frames if max_frames is None else int(max_frames)
        if not 0 < budget <= self.max_frames:
            raise ValueError(f"max_frames {budget} outside (0, {self.max_frames}]")
        t0, p0, r0 = self.defaults
        t = t0 if temperature is None else float(temperature)
        p = p0 if top_p is None else float(top_p)
        rp = r0 if repetition_penalty is None else float(repetition_penalty)
        if (t <= 0.0) != self.statics["greedy"]:
            raise ValueError(f"temperature {t} crosses this server's greedy/sampled class")
        if not (p >= 1.0 or self.statics["use_top_p"] or self.statics["greedy"]):
            raise ValueError(f"top_p {p} needs a server compiled with the top-p stage")
        padded = np.zeros((self.Tb,), np.int64)
        padded[:tokens.shape[0]] = tokens
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, padded, int(n_tokens),
                                    np.asarray(speaker_embd, np.float32), int(language_id),
                                    int(seed), budget, (t, p, rp)))
        return rid

    # -- internals ---------------------------------------------------------

    def _can_admit(self) -> bool:
        return self._n_past_h + self.max_frames + self.K <= self.C

    def _do_refill(self, done_np, limit: Optional[int] = None) -> int:
        """Admit queued requests into idle lanes: up to R per call, or every
        idle lane at once when more than R are idle and the queue covers
        them (the bulk refill). Returns the number admitted; `limit` caps it
        (admission pacing)."""
        idle = [b for b in range(self.B) if self._lane_owner[b] is None and bool(done_np[b])]
        n = min(len(idle), len(self._queue))
        if limit is not None:
            n = min(n, limit)
        n = min(n, self.B if n > self.R else self.R)
        if n == 0 or not self._can_admit():
            return 0
        P = prefill_window_len(self.nothink)
        reqs = [self._queue.pop(0) for _ in range(n)]
        lanes = idle[:n]
        keys = prng.key_array([prng.prng_key(r.seed) for r in reqs])
        first = prng.split(keys, 3)        # frame 0's cb0 draws with [:, 1]
        self._keys[lanes] = first[:, 0] if self.fused_talker else keys
        for lane, req in zip(lanes, reqs):
            self._lane_owner[lane] = _Lane(rid=req.rid, codes=[])
            self._start_h[lane] = self._n_past_h - P
            self._done_h[lane] = False
        t0 = time.perf_counter()
        # the admitted lanes this rank holds
        mine = [i for i, lane in enumerate(lanes) if self.lo <= lane < self.hi]
        if mine:
            reqs = [reqs[i] for i in mine]
            refill(self.tp, self.state, [lanes[i] - self.lo for i in mine],
                   np.stack([r.tokens for r in reqs]), [r.n_tokens for r in reqs],
                   np.stack([r.speaker for r in reqs]), [r.language_id for r in reqs],
                   first[mine, 1], [r.budget for r in reqs],
                   np.asarray([r.samp for r in reqs], np.float32), talker_cfg=self.tcfg,
                   nothink=self.nothink, allow_eos=self.allow_eos, **self.statics)
        self.refills += 1
        self._tock("refill_s", t0)
        return n

    def _chunk_keys(self) -> np.ndarray:
        """[B, K, 2, 2] keys of the next chunk (``decode_chunk``), every
        lane's chain advanced K frames at once over the lanes: frame k's
        split (next key, k_cb0, k_cp) gives the code predictor k_cp; the
        next cb0 draws with this split's k_cb0 on the fused talker step
        (K5's epilogue) and with the next frame's unfused (as
        ``generate_chunk``). Idle lanes' chains advance too, unread, as
        JAX's do."""
        keys = np.zeros((self.B, self.K, 2, 2), np.uint32)
        chain = self._keys
        s = prng.split(chain, 3)
        for k in range(self.K):
            chain = s[:, 0]
            keys[:, k, 0] = s[:, 2]
            if self.fused_talker:
                keys[:, k, 1] = s[:, 1]
            s = prng.split(chain, 3)
            if not self.fused_talker:
                keys[:, k, 1] = s[:, 1]
        self._keys = chain
        return keys

    def _decode(self, non_blocking: bool) -> ChunkResult:
        """Launch one chunk (K frames) and advance the host mirror."""
        active = [int(self._start_h[b]) for b in range(self.B)
                  if self._lane_owner[b] is not None]
        t0 = time.perf_counter()
        res = decode_chunk(self.tp, self.cp, self.state, self._chunk_keys()[self.lo:self.hi],
                           talker_cfg=self.tcfg, cp_cfg=self.ccfg, chunk_frames=self.K,
                           start_min=min(active, default=self._n_past_h),
                           fused_cp=self.fused_cp, fused_talker=self.fused_talker,
                           allow_eos=self.allow_eos, non_blocking=non_blocking,
                           **self.statics)
        self._n_past_h += self.K
        self.chunks_run += 1
        self._tock("decode_s", t0)
        return res

    def _harvest(self, res: ChunkResult, on_chunk=None, owners=None):
        """Fold one chunk's emissions into its lanes' request buffers.

        `owners`, if given, is the lane owners as they were when the chunk
        was launched (the overlapped loop refills lanes while a chunk is in
        flight: a stale chunk's done flag must not finalize a lane's new
        occupant). A lane whose snapshot owner is already finalized only
        carries masked emissions and a latched done bit; it is skipped."""
        blob = res.fetch()
        if self.mesh is not None:
            blob = gather_lanes(torch.from_numpy(blob), self.mesh).numpy()
        if owners is None:
            owners = self._lane_owner
        K, nc = self.K, self.tcfg.n_codebooks
        codes = blob[:, :K * nc].reshape(self.B, K, nc)
        emit = blob[:, K * nc:K * nc + K].astype(bool)
        done_np = blob[:, -1].astype(bool)
        self._done_h = done_np
        events = []
        for b in range(self.B):
            owner = owners[b]
            if owner is None or owner.rid in self.results:
                continue
            rows = codes[b][emit[b]]
            if rows.size:
                owner.codes.append(rows)
            finished = bool(done_np[b])
            if rows.size or finished:
                events.append((owner.rid, rows, finished))
            if finished:
                self.results[owner.rid] = (np.concatenate(owner.codes, axis=0) if owner.codes
                                           else np.zeros((0, nc), np.int32))
                if self._lane_owner[b] is owner:
                    self._lane_owner[b] = None
        if on_chunk is not None and events:
            on_chunk(events)
        return done_np

    def _reset_session(self):
        """Capacity reached and every lane idle: rewind the write row."""
        if any(o is not None for o in self._lane_owner):
            raise RuntimeError("a session reset needs every lane idle")
        self.state = None   # free the old cache before allocating the new
        self.state = self._new_state()
        self._n_past_h = prefill_window_len(self.nothink)
        self._start_h[:] = 0
        self._done_h[:] = True
        self.sessions += 1

    def _try_compact(self, opportunistic: bool = False) -> bool:
        """Reclaim the rows below every active lane's start (``compact``).
        The pressure trigger fires only when admission is blocked and the
        shift unblocks it; idle lanes do not constrain the shift (their
        windows are dead, and decode_chunk gives done lanes start_eff =
        n_past)."""
        active_starts = [int(self._start_h[b]) for b in range(self.B)
                         if self._lane_owner[b] is not None]
        if not active_starts:
            return False
        smin = min(active_starts)
        needed = (self.compact_threshold if opportunistic
                  else self._n_past_h + self.max_frames + self.K - self.C)
        if smin <= 0 or smin < needed:
            return False
        t0 = time.perf_counter()
        compact(self.state, smin, talker_cfg=self.tcfg)
        self._n_past_h -= smin
        np.maximum(self._start_h - smin, 0, out=self._start_h)
        self.compactions += 1
        self._tock("compact_s", t0)
        return True

    def check_host_mirrors(self) -> None:
        """Raise AssertionError unless the host mirrors equal the device
        state (a drifted start mirror would compact past a live lane's splice
        and corrupt its history)."""
        assert self._n_past_h == self.state.n_past, (self._n_past_h, self.state.n_past)
        np.testing.assert_array_equal(self._start_h[self.lo:self.hi],
                                      self.state.start.cpu().numpy().astype(np.int64))
        np.testing.assert_array_equal(self._done_h[self.lo:self.hi],
                                      self.state.done.cpu().numpy())

    def _admit(self, done_np) -> None:
        """Refill until lanes are full, the queue drains, capacity blocks or
        admit_per_boundary is reached (one call admits at most R, and a chunk
        can finish far more lanes than R)."""
        cap = self.admit_per_boundary
        admitted = 0
        while cap is None or admitted < cap:
            got = self._do_refill(done_np, None if cap is None else cap - admitted)
            if not got:
                break
            admitted += got

    def _make_room(self, active: bool) -> None:
        """At a boundary with queued work that capacity blocks: reset the
        session when every lane is idle, else compact under pressure (then
        opportunistically, under that policy); without pressure, compact
        opportunistically under that policy."""
        if self._queue and not self._can_admit():
            if not active:
                self._reset_session()
            elif not self._try_compact() and self.compact_policy == "opportunistic":
                self._try_compact(opportunistic=True)
        elif active and self.compact_policy == "opportunistic":
            self._try_compact(opportunistic=True)

    def run(self, max_chunks: Optional[int] = None, on_chunk=None,
            feeder=None) -> dict[int, np.ndarray]:
        """Drive the scheduler until the queue drains and every lane is
        done. Returns {rid: codes [n_frames, 16]} for every completed
        request.

        on_chunk, if given, is called after each chunk's harvest with a list
        of (rid, new_codes [k, 16], finished) events. feeder, if given,
        models online arrivals: called as feeder(idle) at every loop
        boundary, it submits the requests whose time has come and returns
        True while arrivals are pending, which keeps the loop alive on an
        empty queue; idle is True when nothing runs (a real-time feeder
        then blocks until its next arrival).

        With overlap_harvest one chunk stays in flight: the previous chunk's
        copy is harvested while the device runs the next, and refills see
        the done flags one chunk late (per-request outputs unchanged: a
        splice is exact wherever it lands)."""
        if self.overlap_harvest:
            return self._run_overlapped(max_chunks, on_chunk, feeder)
        return self._run_serial(max_chunks, on_chunk, feeder)

    def _run_serial(self, max_chunks, on_chunk, feeder) -> dict[int, np.ndarray]:
        done_np = self._done_h
        while True:
            active = any(o is not None for o in self._lane_owner)
            if feeder is not None:
                pending = feeder(not active and not self._queue)
                if not self._queue and not active:
                    if not pending:
                        break
                    continue
            elif not self._queue and not active:
                break
            sessions = self.sessions
            self._make_room(active)
            if self.sessions != sessions:
                done_np = self._done_h
            self._admit(done_np)
            if not any(o is not None for o in self._lane_owner):
                continue
            res = self._decode(non_blocking=False)
            t0 = time.perf_counter()
            done_np = self._harvest(res, on_chunk)
            self._tock("harvest_s", t0)
            if max_chunks is not None and self.chunks_run >= max_chunks:
                break
        return self.results

    def _run_overlapped(self, max_chunks, on_chunk, feeder) -> dict[int, np.ndarray]:
        """run() with one chunk in flight. Per boundary the device gets
        [refill*, compact?, chunk N], then the host harvests chunk N-1 while
        the device runs N; refills see chunk N-1's done flags."""
        pending = None      # (ChunkResult, owner snapshot) in flight
        done_np = self._done_h

        def drain():
            nonlocal pending, done_np
            done_np = self._harvest(pending[0], on_chunk, pending[1])
            pending = None

        while True:
            active = any(o is not None for o in self._lane_owner)
            idle = not active and not self._queue and pending is None
            if feeder is not None:
                arrivals_pending = feeder(idle)
                if not self._queue and not active:
                    if pending is not None:
                        drain()
                        continue
                    if not arrivals_pending:
                        break
                    continue
            elif not self._queue and not active:
                if pending is not None:
                    drain()
                    continue
                break
            if self._queue and not self._can_admit() and pending is not None:
                # reset and compaction decide on fresh owners and done flags
                drain()
                continue
            sessions = self.sessions
            self._make_room(active)
            if self.sessions != sessions:
                done_np = self._done_h
            self._admit(done_np)
            if not any(o is not None for o in self._lane_owner):
                if pending is not None:
                    drain()
                continue
            res = self._decode(non_blocking=True)
            snapshot = list(self._lane_owner)
            if pending is not None:
                t0 = time.perf_counter()
                drain()
                self._tock("harvest_s", t0)
            pending = (res, snapshot)
            if max_chunks is not None and self.chunks_run >= max_chunks:
                break
        if pending is not None:
            drain()
        return self.results
