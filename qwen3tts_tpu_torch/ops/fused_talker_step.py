"""K1 and K5: one talker frame through all layers, plus the codec head and
the sampling of the next frame's codebook-0 token, for one stream (K1) or
for B lockstep lanes (K5).

Counterpart of ``qwen3tts_tpu/ops/pallas_talker_step.py``. K1 replaces the
Pallas kernels ``fused_talker_step`` (:387) and ``fused_talker_step_hbm``
(:980) in their weight modes. On the TPU the two differ in where the KV
cache lives; on the H100 it always lives in device memory, so one kernel
(``csrc/talker_step.cu``) serves every capacity. K5 replaces
``fused_talker_step_batched`` (:1604) in its batch-major form and, with
``kv_layout="lane"``, in its lane-major one (``_make_kernel_batched_lane``,
:1246; ``csrc/talker_step_batched.cu``). The sources say what bounds them (the
bytes of 28 layers of weights per frame, read once for all lanes in K5) and
what the design does about it; K5's projections run on the tensor cores
(int8 and float64 mma, ``gemm_plan`` mirrors their tile plan), K1's on
GEMVs that keep whole tiles of weights in flight (``gemv_plan`` mirrors
their grid). K5 also takes the two operands only
continuous serving uses (``runtime/continuous.py``): ``start`` [B], each
lane's first valid cache row, and per-lane temperature, top-p and
repetition penalty ([B] each) for its cb0 epilogue. Both take the int8-KV
tier's cache, the (q, scale) pair of ``ops/kv_quant.py`` (the Pallas
kernels' ``kv_int8`` operand, :564, :765, :1402), in every weight mode.

The weight mode is set per projection from the leaf type (``weight_mode``,
the counterpart of ``_weight_mode``, :153): an int8 ``QuantLinear`` runs in
"w8a8", a u4 ``QuantLinear4`` in "w4bf16", a plain ``[L, K, N]`` tensor in
"bf16", or "f32" when it is float32 (the float32 tier, ``RuntimeConfig(
dtype="float32")``: the Pallas "bf16" mode dots ``x.astype(wq.dtype)``,
which is then float32); the q4 tier's blocks give the tuple ("w8a8",
"w8a8", "w4bf16", "w4bf16") in (wqkv, wo, w_gateup, w_down) order. Per
mode (``_make_mm_values``, :71-127):
  - w8a8: the activation is quantized per token (s = max(amax, 1e-8) /
    127, round half to even), the integer dot accumulates in int32 (exact
    and independent of order) and is scaled by act_scale * w_scale;
  - bf16 and f32: the activation is rounded to the weight's dtype (a no-op
    for float32) and dotted with the weights, accumulating in float32;
  - w4bf16: per half of K, the weight is dequantized (q * s - z with its
    group's scale and offset, the product rounded first) and rounded to
    bf16, dotted with the bf16 activation; the two halves' float32 sums
    are added.
The float sums that feed a rounding run in float64 here and in the kernels
(layer.cuh), so both get the same bits; a product of two bf16 values, or
of two float32 values, is exact in float64, so the float64 dot rounded
once to float32 does not depend on the summation order.

The KV cache is bf16 or float32 (the compute dtype), or the int8 pair
below; the codec head is bf16 or float32. K5 takes the cache batch-major
[B, L, 2, Hkv, C, D] (``kv_layout="batch"``) or lane-major [L, 2, Hkv, C,
B, D] (``"lane"``, bf16 or float32, as the Pallas kernel takes it: no int8
pair, no ``start``, no in-kernel sampling); the two run the same
arithmetic, so they agree bit for bit on the same cache contents.

Per layer: RMSNorm -> fused QKV -> q/k RMSNorm -> NEOX RoPE -> K/V row write
at n_past -> GQA attention over [0, n_past] (float32 probabilities; q cast
to the KV dtype, and in K1 the probabilities too) -> o_proj -> RMSNorm ->
SwiGLU -> residual (K5 with ``start``: attention over [start[b], n_past]
for lane b). Then the output RMSNorm, the codec head, and, when
``seen`` is given, the cb0 epilogue: suppress [suppress_start, V) except
eos_id, repetition penalty over ``seen``, and the counter-hash sampler.

The KV cache is updated IN PLACE: the new K/V row is written into ``kv`` at
``n_past`` (JAX aliases the kernel's KV operand to its output instead).

With the int8 (q, scale) cache the attention follows the Pallas kernels'
int8 form, where it differs from the bf16 one in four ways:
  - the current row is never read from the cache: it is attended in bf16,
    unquantized, as one more column (:716-725, :930; batched :1554-1566),
    and only then is its bf16-rounded value quantized (``quantize_kv``)
    into q and scale at n_past (the wrappers' scatter, :1202-1212, :1809);
  - q is rounded to bf16, and a cached row's score is (q . k) * D^-0.5 *
    k_scale, two float32 roundings in that order (:693, :907, :1529-1533);
  - V's scale folds into the probability: e * v_scale, with e = exp(s -
    m) not yet normalized (m the cached rows' maximum), rounded to bf16 in
    K1 (:701-703, :915-917), kept in float32 in K5 (:1541-1543); the
    current row's p is neither scaled nor rounded;
  - the current row folds in after the cached rows and the sum is divided
    out last, as in the Pallas kernels' online softmax (:711-725, the
    flash state of one chunk: ``gqa_attention``). The port's sums stay in
    float64 and its maximum is taken over all cached rows at once, so the
    kernels and the plain versions agree bit for bit, and JAX to float32
    rounding while the cached rows fit one of its chunks (256 rows on a
    TPU).
K5 takes no ``start`` with an int8 cache (the JAX package never combines
them: continuous serving keeps a compute-dtype cache).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import _kernels
from . import library
from .kv_quant import is_quantized_kv, quantize_kv
from .quant import QuantLinear, QuantLinear4, group_rows, unpack4
from .library import as_int
from .rope import rope_angles
from .sampling import sample_rows, sample_rows_plain

MAX_LANES = 128   # lanes of one batched step (the JAX package's decode_loop.py:49)


class StepOut(NamedTuple):
    hidden: torch.Tensor              # [H] ([B, H] batched) f32, output-normed
    logits: torch.Tensor              # [Vc] ([B, Vc]) f32, before suppression/penalty
    cb0: Optional[torch.Tensor]       # [1] ([B]) next frame's cb0 (when sampling)


def _rms(x, w, eps):
    """RMSNorm in float32 with the variance summed in float64 (then rounded
    to float32) and an IEEE reciprocal square root (1 / sqrt): torch.rsqrt
    on CUDA is approximate, and one ulp flips int8 activation roundings that
    then grow through 28 random-weight layers. The kernels (layer.cuh) sum
    in float64 too, so the result does not depend on summation order."""
    xd = x.double()
    var = (torch.sum(xd * xd, dim=-1, keepdim=True) / x.shape[-1]).float()
    return x * (1.0 / torch.sqrt(var + eps)) * w.float()


def mm_w8a8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] f32 @ int8 q [K, N] with scale [1, N]: the activation is
    quantized per row (s = max(amax, 1e-8) * (1/127), round half to even,
    clip to +-127); the integer dot runs in float64, where every partial sum
    of int8 products is exact, so it equals an int32 accumulation."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    s_act = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(x / s_act), -127.0, 127.0)
    acc = torch.matmul(xq.double(), q.double()).float()
    return acc * (s_act * scale.float())


def gqa_attention(q, K, V, p_dtype, valid=None, cur=None):
    """q [..., Hq, D] @ K [..., Hkv, S, D]^T * D^-0.5 -> softmax -> the
    probabilities rounded to float32, then to p_dtype -> @ V [..., Hkv, S,
    D]. Returns [..., Hq*D] float32. The dot products, exp and the softmax
    sum run in float64 and are rounded to float32 once, as in the kernels
    (layer.cuh), so that summation order cannot change a bit. valid [..., S]
    (bool), when given, leaves out the rows it marks False: they set no
    maximum, and their exact zeros add nothing to the float64 sums, so the
    result is that of the valid rows alone, which the kernels read.

    int8 cache (``cur`` given; no ``valid``): K and V are (q, scale) pairs
    ([..., Hkv, S, D] int8 and [..., Hkv, S] float32) and cur = (k, v)
    [..., Hkv, D] is the current row, attended unquantized after the
    cached rows, as the Pallas kernels fold it into their flash state
    (module docstring).
    Cached scores are multiplied by their K scale; e = exp(s - m) over the
    cached rows with m their maximum, e * v_scale rounded to p_dtype and
    dotted with V; then the current row folds in with m' = max(m, s_cur),
    alpha = exp(m - m'), p_cur = exp(s_cur - m'): o = (acc * alpha + p_cur
    * v) / (alpha * sum(e) + p_cur), each float32 operation rounded."""
    if cur is not None:
        (K, ksc), (V, vsc) = K, V
    *lead, Hkv, S, D = K.shape
    qg = q.reshape(*lead, Hkv, -1, D).double()
    s = torch.matmul(qg, K.double().transpose(-1, -2)).float() * D ** -0.5
    if cur is not None:
        s = s * ksc[..., None, :]
        s_cur = torch.matmul(qg, cur[0].double()[..., None]).float() * D ** -0.5
        m = torch.amax(torch.cat([torch.full_like(s_cur, -3.4e38), s], -1), -1, keepdim=True)
        m_fin = torch.maximum(m, s_cur)
        e = torch.exp((s - m).double()).float()
        alpha = torch.exp((m - m_fin).double()).float()
        p_cur = torch.exp((s_cur - m_fin).double()).float()
        total = alpha * torch.sum(e.double(), -1, keepdim=True).float() + p_cur
        pv = (e * vsc[..., None, :]).to(p_dtype)
        acc = torch.matmul(pv.double(), V.double()).float()
        o = (acc * alpha + p_cur * cur[1][..., None, :].float()) / total
        return o.reshape(*lead, -1)
    if valid is not None:
        keep = valid[..., None, None, :]
        s = torch.where(keep, s, torch.full_like(s, float("-inf")))
        V = torch.where(keep.transpose(-1, -2), V, torch.zeros_like(V))
    e = torch.exp((s - torch.amax(s, dim=-1, keepdim=True)).double())
    p = (e / torch.sum(e, dim=-1, keepdim=True)).float().to(p_dtype)
    return torch.matmul(p.double(), V.double()).float().reshape(*lead, -1)


# csrc/layer.cuh's attention grid: ring tiles (rows at most) and stages,
# rows a block takes at least, the largest cluster, the shared memory a
# block may have, the blocks that fill the H100 about twice (kSplitTarget)
ATTN_TILE, ATTN_STAGES, ATTN_MIN_ROWS, ATTN_MAX_CLUSTER = 64, 3, 64, 16
ATTN_MAX_SMEM, ATTN_BLOCK_TARGET = 232448, 264


def attention_clusters(B: int, Hkv: int, G: int, rows: int, kv_int8: bool = False,
                       D: int = 128, kv_f32: bool = False) -> int:
    """The cluster size of K1/K5's attention kernel (attn_clusters in the
    source) for B lanes, Hkv KV heads, G query heads per KV head and at most
    `rows` rows a lane, over a bf16, int8 or float32 (kv_f32) cache: about
    two blocks an SM, each of at least 64 rows, at most 16, more where a
    block's slice of scores would not fit its shared memory (the AttLayout
    bytes; a ring tile is 64 rows, 32 of float32's)."""
    row = D * (1 if kv_int8 else 4 if kv_f32 else 2)
    tile = ATTN_TILE // 2 if row > 2 * D else ATTN_TILE

    def smem(s):
        cap = max(1, -(-rows // s))
        ring = max(ATTN_STAGES * tile * row, 8 * G * D * 8)
        return (ring + 8 * G * D + 16 * G * ATTN_TILE + 16 * G + 256 + 24 * G + 128
                + 8 * ATTN_STAGES + 4 * G * cap)

    s = max(1, min(ATTN_BLOCK_TARGET // (B * Hkv), -(-rows // ATTN_MIN_ROWS), ATTN_MAX_CLUSTER))
    while s < ATTN_MAX_CLUSTER and smem(s) > ATTN_MAX_SMEM:
        s += 1
    return s


def lane_map_shape(L: int, Hkv: int, C: int, B: int, D: int, rows: int, kv_f32: bool = False):
    """The tensor map through which K5's attention reads the lane-major
    cache [L, 2, Hkv, C, B, D] (lane_map_shape in
    csrc/talker_step_batched.cu): (dims, byte strides of dims 1-4, box),
    innermost first. The cache is {D, B, rows, Hkv, 2 L} with rows the
    valid rows (n_past + 1), so that elements past them arrive as zeros and
    are never read; a ring tile is the box {D, 1, tile rows, 1, 1} at
    (0, lane, first row, head, 2 l for K or 2 l + 1 for V): one lane's
    rows, B * D elements apart."""
    row = D * (4 if kv_f32 else 2)
    tile = ATTN_TILE // 2 if row > 2 * D else ATTN_TILE
    return ((D, B, rows, Hkv, 2 * L), (row, B * row, C * B * row, Hkv * C * B * row),
            (D, 1, tile, 1, 1))


def attention_slices(t0: int, n_end: int, clusters: int):
    """The rows [lo, hi) of each block of a cluster, in rank order, over a
    lane's rows [t0, n_end): contiguous slices of ceil((n_end - t0) /
    clusters) rows (the last ones shorter or empty)."""
    per = -(-(n_end - t0) // clusters)
    return [(min(n_end, t0 + r * per), min(n_end, t0 + (r + 1) * per)) for r in range(clusters)]


# csrc/layer.cuh's batched projections (B >= 2, on the tensor cores): a
# block's output columns and weight rows per tile (packed rows for w4bf16)
# by mode, the blocks a GEMM aims at (kI8Blocks, kFBlocks: one or two per
# SM of the H100), and the k depth of one mma (m16n8k32 int8, m16n8k8
# float64)
GEMM_TILES = {"w8a8": (128, 128), "bf16": (64, 32), "w4bf16": (64, 32), "f32": (64, 32)}
GEMM_BLOCKS = {"w8a8": 132, "bf16": 264, "w4bf16": 264, "f32": 264}
GEMM_DEPTH = {"w8a8": 32, "bf16": 8, "w4bf16": 8, "f32": 8}
GEMM_MIN_TILES = 2   # K tiles a block takes at least, where K allows (kGemmMinTiles)


def gemm_plan(mode: str, K: int, N: int):
    """The tile plan of K5's GEMM for x [B, K] @ W [K, N] in `mode`, B >= 2
    (gemm_plan in the source): (column strips, K splits, tiles per split).
    The weight rows (K, or the K/2 packed rows of w4bf16) are cut into tiles
    of GEMM_TILES[mode][1] rows, and each split takes a run of `per`
    consecutive tiles (the last run shorter), so that about
    GEMM_BLOCKS[mode] blocks (strips x splits, x 2 halves for w4bf16), or
    fewer, stream at least GEMM_MIN_TILES tiles each. The same for every
    B."""
    tn, tk = GEMM_TILES[mode]
    rows, halves = (K // 2, 2) if mode == "w4bf16" else (K, 1)
    gx, n_tiles = -(-N // tn), -(-rows // tk)
    max_splits = max(1, min(GEMM_BLOCKS[mode] // (gx * halves), n_tiles // GEMM_MIN_TILES))
    ks = max_splits if max_splits < n_tiles else n_tiles
    per = -(-n_tiles // ks)
    return gx, -(-n_tiles // per), per


def gemm_split_rows(mode: str, K: int, N: int):
    """The weight rows [lo, hi) (packed rows for w4bf16) that each split of
    gemm_plan sums, in split order; a split walks its tiles in order and
    each tile's rows in mma depth chunks of GEMM_DEPTH[mode]."""
    _, ks, per = gemm_plan(mode, K, N)
    tk = GEMM_TILES[mode][1]
    rows = K // 2 if mode == "w4bf16" else K
    return [(min(rows, s * per * tk), min(rows, (s + 1) * per * tk)) for s in range(ks)]


# csrc/layer.cuh's GEMVs (one lane, K1): a block's output columns and weight
# rows (packed rows for w4bf16) by mode, "head" and "head_f32" the codec
# head (bf16 or float32 weights, float32 partials); a block's 256 threads
# are 8 along the row (16 bytes each) by 32 along K, each thread
# GEMV_THREAD_ROWS consecutive rows
GEMV_TILES = {"w8a8": (128, 128), "bf16": (64, 128), "w4bf16": (128, 64), "head": (64, 128),
              "f32": (32, 128), "head_f32": (32, 128)}
GEMV_THREAD_ROWS = {"w8a8": 4, "bf16": 4, "w4bf16": 2, "head": 4, "f32": 4, "head_f32": 4}
GEMV_WARPS, GEMV_WARP_ROWS = 8, 4   # warps of a block; thread rows (of K) in a warp


def gemv_plan(mode: str, K: int, N: int):
    """The grid of K1's GEMV for x [K] @ W [K, N] in `mode` (gemv_plan in
    the source): (column blocks, K splits, weight rows per split). Each
    split is one block over GEMV_TILES[mode][1] consecutive weight rows (the
    K/2 packed rows of w4bf16), the last shorter."""
    tn, tk = GEMV_TILES[mode]
    rows = K // 2 if mode == "w4bf16" else K
    return -(-N // tn), -(-rows // tk), tk


def gemv_split_rows(mode: str, K: int, N: int):
    """The weight rows [lo, hi) (packed rows for w4bf16) that each split of
    gemv_plan sums, in split order."""
    _, ks, tk = gemv_plan(mode, K, N)
    rows = K // 2 if mode == "w4bf16" else K
    return [(s * tk, min(rows, (s + 1) * tk)) for s in range(ks)]


def mm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] f32 rounded to w's dtype @ w [K, N] (the JAX formula
    ``dot(x.astype(wq.dtype), wq, f32)``): the dot in float64, rounded to
    float32 once (a product of two bf16 values is exact). The f32 mode
    takes this same path: x is not rounded, and a product of two float32
    values is exact in float64 too."""
    return torch.matmul(x.to(w.dtype).double(), w.double()).float()


def mm_w4bf16(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              zero: torch.Tensor) -> torch.Tensor:
    """x [..., K] f32 @ a u4 weight (q [K/2, N] split-half nibbles, scale
    and zero [G, N]): per half of K, w = q * s - z in float32 (the product
    rounded first), rounded to bf16, dotted with x rounded to bf16 in
    float64 and rounded to float32; then low half + high half in float32."""
    Kh = q.shape[-2]
    Gh = scale.shape[-2] // 2
    xb = x.to(torch.bfloat16).double()

    def half(xh, qh, sh, zh):
        w = qh.float() * group_rows(sh.float(), Kh) - group_rows(zh.float(), Kh)
        return torch.matmul(xh, w.to(torch.bfloat16).double()).float()

    lo, hi = unpack4(q)
    return (half(xb[..., :Kh], lo, scale[:Gh], zero[:Gh])
            + half(xb[..., Kh:], hi, scale[Gh:], zero[Gh:]))


MODE_CODES = {"w8a8": 0, "bf16": 1, "w4bf16": 2, "f32": 3}   # csrc/layer.cuh WeightMode


def _leaf_mode(w) -> str:
    if isinstance(w, QuantLinear4):
        return "w4bf16"
    if isinstance(w, QuantLinear):
        return "w8a8"
    return "f32" if w.dtype == torch.float32 else "bf16"


def weight_mode(blocks):
    """The kernels' weight mode from the leaf types (``_weight_mode``,
    pallas_talker_step.py:153): one string when the four projections share
    it, else the 4-tuple in (wqkv, wo, w_gateup, w_down) order."""
    ms = tuple(_leaf_mode(w) for w in (blocks.wqkv, blocks.wo, blocks.w_gateup,
                                        blocks.w_down))
    return ms[0] if len(set(ms)) == 1 else ms


def mode_label(mode) -> str:
    """A mode's name in launch counts and reports: the string, or "mixed"
    for a per-projection tuple (the q4 tier)."""
    return mode if isinstance(mode, str) else "mixed"


def project_plain(x: torch.Tensor, w, l: int) -> torch.Tensor:
    """x [M, K] float32 @ layer l of the stacked projection w, in w's mode."""
    if isinstance(w, QuantLinear4):
        return mm_w4bf16(x, w.q[l], w.scale[l], w.zero[l])
    if isinstance(w, QuantLinear):
        return mm_w8a8(x, w.q[l], w.scale[l])
    return mm_bf16(x, w[l])


def layer_plain(blocks, cfg, l, x, cos, sin, attend):
    """One decoder layer of the plain K1/K2/K5/K6 on the tokens x [M, H]
    float32 (one per lane), each projection in its own mode
    (``project_plain``). attend(q [M, Hq, D], k [M, Hkv, D], v [M, Hkv, D])
    stores K/V and returns the attention output [M, Hq*D]."""
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F, eps, half = cfg.intermediate_size, cfg.rms_norm_eps, cfg.head_dim // 2

    def rope(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1)

    h = _rms(x, blocks.attn_norm[l], eps)
    heads = project_plain(h, blocks.wqkv, l).reshape(-1, Hq + 2 * Hkv, D)
    q = rope(_rms(heads[:, :Hq], blocks.q_norm[l], eps))
    k = rope(_rms(heads[:, Hq:Hq + Hkv], blocks.k_norm[l], eps))
    x = x + project_plain(attend(q, k, heads[:, Hq + Hkv:]), blocks.wo, l)
    h = _rms(x, blocks.ffn_norm[l], eps)
    gu = project_plain(h, blocks.w_gateup, l)
    gate = gu[:, :F]
    gate = gate / (1.0 + torch.exp(-gate.double()).float())   # exp rounded once
    return x + project_plain(gate * gu[:, F:], blocks.w_down, l)


def talker_step_plain(blocks, cfg, step_embd, n_past, kv, *, p_dtype, output_norm,
                      codec_head, seen=None, seeds=None, temperature=1.0, top_p=1.0,
                      repetition_penalty=1.0, top_k=0, suppress_start=None, eos_id=-1,
                      greedy=False, use_top_p=True, start=None, start_min=0) -> StepOut:
    """Plain PyTorch version of K1 and K5 for B lanes: step_embd [B, H], kv
    [B, L, 2, Hkv, C, D] (or the int8 pair of [B, L, 2, Hkv, C, D] and [B,
    L, 2, Hkv, C]; or a lane-major cache's permuted view, whose writes land
    in its storage) updated in place at n_past, seen [B, Vc] and seeds [B]
    when cb0 is sampled (temperature, top_p, repetition_penalty scalars or
    [B]). q is rounded to the KV dtype (int8 cache: bf16), the softmax
    probabilities to p_dtype (the KV dtype in K1, bf16 with an int8 cache;
    float32 in K5; int8: see the module docstring). start [B], when given:
    lane b attends rows [start[b], n_past] (start clamped to [0, n_past],
    as the kernel clamps it). start_min is K5's promise that no lane's
    start lies below it (the kernel skips the rows under it, so a lane
    below would read scores it never wrote): raises ValueError where a
    lane's clamped start, or 0 without ``start``, breaks it. codec_head
    None (and output_norm None): the hidden state is the last layer's
    residual x, and there are no logits (the Pallas kernel without its
    head)."""
    n = int(n_past)
    quant = is_quantized_kv(kv)
    cache = kv[0] if quant else kv
    if quant and start is not None:
        raise ValueError("the int8 KV cache takes no per-lane start (continuous serving "
                         "keeps a compute-dtype cache)")
    dev = cache.device
    B = step_embd.shape[0]
    cos, sin = _rope_row(n, cfg, dev, cache.shape[4])
    x = step_embd.float().reshape(B, cfg.hidden_size)
    valid = None
    first = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    if start is not None:
        first = torch.clamp(torch.as_tensor(start, device=dev).reshape(B, 1), 0, n)
        valid = torch.arange(n + 1, device=dev) >= first                # [B, n+1]
    floor = min(max(int(start_min), 0), n)
    if floor and bool((first < floor).any()):
        raise ValueError(f"start_min {int(start_min)} lies above the start of lanes "
                         f"{torch.nonzero(first[:, 0] < floor)[:, 0].tolist()}")
    for l in range(cfg.n_layers):
        def attend(q, k, v, l=l):
            if quant:
                kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
                qc, sc = kv[0][:, l], kv[1][:, l]
                out = gqa_attention(q.to(torch.bfloat16).float(),
                                    (qc[:, 0, :, :n], sc[:, 0, :, :n]),
                                    (qc[:, 1, :, :n], sc[:, 1, :, :n]), p_dtype,
                                    cur=(kb.float(), vb.float()))
                qc[:, :, :, n], sc[:, :, :, n] = quantize_kv(torch.stack([kb, vb], 1))
                return out
            kv[:, l, 0, :, n] = k.to(kv.dtype)
            kv[:, l, 1, :, n] = v.to(kv.dtype)
            return gqa_attention(q.to(kv.dtype).float(), kv[:, l, 0, :, :n + 1].float(),
                                 kv[:, l, 1, :, :n + 1].float(), p_dtype, valid)

        x = layer_plain(blocks, cfg, l, x, cos, sin, attend)
    if codec_head is None:
        return StepOut(x, None, None)
    normed = _rms(x, output_norm, cfg.rms_norm_eps)
    logits = torch.matmul(normed.to(codec_head.dtype).float(), codec_head.float())
    cb0 = None
    if seen is not None:
        cb0 = sample_rows_plain(
            logits, torch.as_tensor(seeds, device=dev), 0,
            temperature=temperature, top_p=top_p, top_k=top_k, greedy=greedy,
            use_top_p=use_top_p,
            suppress_start=logits.shape[-1] if suppress_start is None else suppress_start,
            eos_id=eos_id, seen=seen, repetition_penalty=repetition_penalty)
    return StepOut(normed, logits, cb0)


def fused_talker_step_plain(blocks, cfg, step_embd, n_past, kv, *, seen=None, seed=0,
                            **kw) -> StepOut:
    """Plain PyTorch version of K1 (same semantics; kv updated in place):
    one lane of talker_step_plain, probabilities rounded to the KV dtype
    (bf16 with the int8 pair)."""
    if is_quantized_kv(kv):
        kv, p_dtype = (kv[0][None], kv[1][None]), torch.bfloat16
    else:
        kv, p_dtype = kv[None], kv.dtype
    out = talker_step_plain(blocks, cfg, step_embd[None], n_past, kv, p_dtype=p_dtype,
                            seen=None if seen is None else seen[None], seeds=[int(seed)],
                            **kw)
    return StepOut(out.hidden[0], out.logits[0], out.cb0)


@functools.lru_cache(maxsize=8)
def rope_table(n_pos: int, head_dim: int, theta: float, device):
    """cos/sin [n_pos, head_dim/2] for positions 0..n_pos-1, built once per
    shape and device (a row equals rope_angles of that one position: the
    same elementwise float32 ops)."""
    return rope_angles(torch.arange(n_pos, device=device), head_dim, theta)


def _rope_row(pos: int, cfg, device, capacity: int):
    """cos/sin [head_dim/2] of one position: row views of the cached table."""
    cos, sin = rope_table(capacity, cfg.head_dim, cfg.rope_theta, device)
    return cos[pos], sin[pos]


def check_w8a8_blocks(blocks):
    """The code-predictor kernels (K2, K6) take int8 blocks only, as the
    Pallas code predictor does (it reads ``blocks.wqkv.q``,
    pallas_code_predictor.py:361): other tiers raise, naming the mode."""
    for w in (blocks.wqkv, blocks.wo, blocks.w_gateup, blocks.w_down):
        if not isinstance(w, QuantLinear):
            tier = {"bf16": "bf16 (quant=None)",
                    "f32": "bf16 tier's unquantized (quant=None) in float32"}.get(
                _leaf_mode(w), "u4")
            raise ValueError(f"the fused code predictor takes int8 QuantLinear blocks; "
                             f"these are {tier}: pass fused_cp=False or 'auto'")


def _cache_operands(kv, kv_shape):
    """(cache, row scales or None) of K1's and K5's KV operand, checked: a
    contiguous bf16 or float32 cache of kv_shape, or the int8 pair, a
    contiguous int8 q of kv_shape and float32 scale of kv_shape[:-1]."""
    if is_quantized_kv(kv):
        q, scale = kv
        if (q.dtype != torch.int8 or scale.dtype != torch.float32 or not q.is_contiguous()
                or not scale.is_contiguous() or tuple(q.shape) != tuple(kv_shape)
                or tuple(scale.shape) != tuple(kv_shape[:-1])):
            raise ValueError(f"the int8 KV cache must be a contiguous int8 {tuple(kv_shape)} "
                             f"and float32 {tuple(kv_shape[:-1])} pair, got {q.dtype} "
                             f"{tuple(q.shape)} and {scale.dtype} {tuple(scale.shape)}")
        return q, scale
    if kv.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError("the CUDA talker step takes a bf16 or float32 KV cache, or "
                                  f"the int8 pair; got {kv.dtype}")
    if not kv.is_contiguous() or tuple(kv.shape) != tuple(kv_shape):
        raise ValueError(f"kv must be a contiguous {tuple(kv_shape)} cache, "
                         f"got {tuple(kv.shape)}")
    return kv, None


def _cuda_operands(blocks, output_norm, codec_head):
    """Checks shared by K1 and K5, then (mode code, operands) for their C
    signatures: the packed per-projection mode codes (2 bits each, wqkv
    first) and, between (cos, sin) and the KV cache, the four norms (f32),
    for each projection (weights, scale or None, zero or None, G), the
    output norm (f32) and the codec head (bf16 or float32; both None for
    K5 without its head), contiguous. Plain weights are bf16 ("bf16") or
    float32 ("f32"); another dtype raises NotImplementedError."""
    if codec_head is not None and codec_head.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA talker step takes a bf16 or float32 codec head, "
                                  f"got {codec_head.dtype}")
    f32 = lambda t: t.float().contiguous()   # noqa: E731
    ops = [f32(blocks.attn_norm), f32(blocks.q_norm), f32(blocks.k_norm), f32(blocks.ffn_norm)]
    modes = 0
    for j, w in enumerate((blocks.wqkv, blocks.wo, blocks.w_gateup, blocks.w_down)):
        mode = _leaf_mode(w)
        modes |= MODE_CODES[mode] << (2 * j)
        if mode == "w8a8":
            ops += [w.q.contiguous(), f32(w.scale), None, 0]
        elif mode == "w4bf16":
            G, Kh = w.scale.shape[-2], w.q.shape[-2]
            if G % 2 or Kh % (G // 2):
                raise ValueError(f"u4 weight with {G} groups over {2 * Kh} rows: the groups "
                                 f"must split each half of K evenly")
            ops += [w.q.contiguous(), f32(w.scale), f32(w.zero), G]
        else:
            if w.dtype not in (torch.bfloat16, torch.float32):
                raise NotImplementedError(f"the CUDA talker step takes bf16 or float32 plain "
                                          f"weights, got {w.dtype}")
            ops += [w.contiguous(), None, None, 0]
    ops += [None, None] if codec_head is None else [f32(output_norm), codec_head.contiguous()]
    _kernels.require_cuda(*[o for o in ops if isinstance(o, torch.Tensor)])
    return modes, ops


def _ptrs(ops):
    """C arguments of _cuda_operands' list: tensors as device pointers,
    None as a null pointer, ints as they are."""
    return [o.data_ptr() if isinstance(o, torch.Tensor) else o for o in ops]


def _bump(counts, key):
    counts[key] = counts.get(key, 0) + 1


def _count(fn, blocks, scales, cache=None, lane=False):
    """One launch of fn's kernel: the wrapper's total, and either its count
    over the int8 KV cache (``operand_launches["kv_int8"]``, scales given),
    K5's over a lane-major cache (``operand_launches["lane"]``), or its
    per-mode count over a batch-major compute-dtype cache (``mode_launches``,
    keyed by ``mode_label``), so that a mode's count holds those launches
    only. Launches over a float32 cache also count in
    ``operand_launches["kv_f32"]``."""
    fn.launches += 1
    if scales is not None:
        _bump(fn.operand_launches, "kv_int8")
    elif lane:
        _bump(fn.operand_launches, "lane")
    else:
        _bump(fn.mode_launches, mode_label(weight_mode(blocks)))
    if cache is not None and cache.dtype == torch.float32:
        _bump(fn.operand_launches, "kv_f32")


def _dims(cfg, C, Vc):
    return (cfg.n_layers, cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.intermediate_size, C, Vc, float(cfg.rms_norm_eps))


def block_operands(blocks):
    """The talker op's operands of a stack of blocks: the four norms, then
    (weights, scale or None, zero or None) of each projection in (wqkv, wo,
    w_gateup, w_down) order (a QuantLinear, a QuantLinear4 or a plain
    tensor)."""
    ops = [blocks.attn_norm, blocks.q_norm, blocks.k_norm, blocks.ffn_norm]
    for w in (blocks.wqkv, blocks.wo, blocks.w_gateup, blocks.w_down):
        if isinstance(w, QuantLinear4):
            ops += [w.q, w.scale, w.zero]
        elif isinstance(w, QuantLinear):
            ops += [w.q, w.scale, None]
        else:
            ops += [w, None, None]
    return ops


def blocks_of(operands):
    """The BlockParams of block_operands' list."""
    attn_norm, q_norm, k_norm, ffn_norm = operands[:4]
    proj = []
    for j in range(4):
        w, scale, zero = operands[4 + 3 * j: 7 + 3 * j]
        proj.append(w if scale is None else QuantLinear(w, scale) if zero is None
                    else QuantLinear4(w, scale, zero))
    from ..models.transformer_core import BlockParams   # (models import ops)
    return BlockParams(attn_norm, proj[0], proj[1], q_norm, k_norm, ffn_norm, proj[2], proj[3])


def talker_dims(cfg):
    """The op's dims of a talker config: (n_layers, hidden_size, n_heads,
    n_kv_heads, head_dim, intermediate_size)."""
    return (cfg.n_layers, cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.intermediate_size)


@functools.lru_cache(maxsize=16)
def talker_config(dims, eps, rope_theta):
    """A TalkerConfig of the op's dims (the fields the kernels read)."""
    from ..config import TalkerConfig
    L, H, Hq, Hkv, D, F = dims
    return TalkerConfig(n_layers=L, hidden_size=H, n_heads=Hq, n_kv_heads=Hkv, head_dim=D,
                        intermediate_size=F, rms_norm_eps=eps, rope_theta=rope_theta)


def _step_args(x, n_past, *args):
    """(blocks, cfg, kv, keyword arguments) of the talker op's operands."""
    (output_norm, codec_head, kv, kv_scale, seen, seed, temperature, top_p,
     repetition_penalty, top_k, greedy, use_top_p, suppress_start, eos_id, dims, eps,
     rope_theta) = args[16:]
    kw = dict(output_norm=output_norm, codec_head=codec_head, seen=seen, seed=seed,
              temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty,
              top_k=top_k, greedy=greedy, use_top_p=use_top_p, suppress_start=suppress_start,
              eos_id=eos_id)
    return (blocks_of(args[:16]), talker_config(tuple(dims), eps, rope_theta),
            kv if kv_scale is None else (kv, kv_scale), kw)


def _step_result(out: StepOut, x):
    return (out.hidden, out.logits,
            out.cb0 if out.cb0 is not None else x.new_empty((0,), dtype=torch.int32))


def _talker_step_cpu(x, n_past, *args):
    """The talker op's CPU kernel: the plain version."""
    blocks, cfg, kv, kw = _step_args(x, n_past, *args)
    return _step_result(fused_talker_step_plain(blocks, cfg, x, n_past, kv, **kw), x)


def _talker_step_cuda(x, n_past, *args):
    """The talker op's CUDA kernel: launch K1."""
    blocks, cfg, kv, kw = _step_args(x, n_past, *args)
    return _step_result(launch_talker_step(blocks, cfg, x, n_past, kv, **kw), x)


def launch_talker_step(blocks, cfg, step_embd, n_past, kv, *, output_norm, codec_head, seen,
                       seed, temperature, top_p, repetition_penalty, top_k, suppress_start,
                       eos_id, greedy, use_top_p) -> StepOut:
    """One launch of K1 (the talker op's CUDA kernel), counted on
    ``fused_talker_step``; see that wrapper for the operands."""
    cache = kv[0] if is_quantized_kv(kv) else kv
    lib = _kernels.load_library()
    H, L, Hkv, D = cfg.hidden_size, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    C, Vc = cache.shape[3], codec_head.shape[-1]
    cache, scales = _cache_operands(kv, (L, 2, Hkv, C, D))
    _kernels.require_cuda(*(t for t in (cache, scales) if t is not None), step_embd,
                          codec_head, blocks.attn_norm)
    modes, ops = _cuda_operands(blocks, output_norm, codec_head)
    n = int(n_past)
    if not 0 <= n < C:
        raise ValueError(f"n_past {n} outside the cache capacity {C}")
    dev = cache.device
    cos, sin = _rope_row(n, cfg, dev, C)
    x = step_embd.float().contiguous()
    hidden = torch.empty((H,), dtype=torch.float32, device=dev)
    logits = torch.empty((Vc,), dtype=torch.float32, device=dev)
    tok = torch.empty((1,), dtype=torch.int32, device=dev) if seen is not None else None
    seen8 = seen.to(torch.int8).contiguous() if seen is not None else None
    ws = torch.empty(lib.qtts_talker_ws_bytes(H, cfg.n_heads, Hkv, D, cfg.intermediate_size,
                                              Vc, modes), dtype=torch.uint8, device=dev)
    err = lib.qtts_talker_step(
        x.data_ptr(), n, cos.data_ptr(), sin.data_ptr(), *_ptrs(ops), modes,
        *_ptrs([cache, scales]), int(cache.dtype == torch.float32),
        int(codec_head.dtype == torch.float32), *_dims(cfg, C, Vc),
        None if seen8 is None else seen8.data_ptr(), float(temperature),
        float(top_p), float(repetition_penalty), int(top_k), int(greedy),
        int(use_top_p), int(suppress_start), int(eos_id), int(seed), hidden.data_ptr(),
        logits.data_ptr(), None if tok is None else tok.data_ptr(), ws.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "fused_talker_step")
    _count(fused_talker_step, blocks, scales, cache)
    if tok is not None:
        sample_rows.site_rows["K1"] += 1
    return StepOut(hidden, logits, tok)


def talker_step_operands(blocks, cfg, step_embd, n_past, kv, *, output_norm, codec_head,
                         seen=None, seed=0, temperature=1.0, top_p=1.0,
                         repetition_penalty=1.0, top_k=0, suppress_start=None, eos_id=-1,
                         greedy=False, use_top_p=True):
    """The operands of the op ``qwen3tts::talker_step`` (``ops/library.py``)
    for fused_talker_step's arguments."""
    cache, scale = kv if is_quantized_kv(kv) else (kv, None)
    return (step_embd, as_int(n_past), *block_operands(blocks), output_norm, codec_head, cache,
            scale, seen, as_int(seed), float(temperature), float(top_p),
            float(repetition_penalty), int(top_k), bool(greedy), bool(use_top_p),
            codec_head.shape[-1] if suppress_start is None else int(suppress_start),
            int(eos_id), talker_dims(cfg), float(cfg.rms_norm_eps), float(cfg.rope_theta))


def fused_talker_step(blocks, cfg, step_embd, n_past, kv, **kw) -> StepOut:
    """One talker decode step (see the module docstring), through the op
    ``qwen3tts::talker_step`` (``ops/library.py``).

    blocks: BlockParams whose projections are QuantLinear ([L, K, N] int8,
    scale [L, 1, N]), QuantLinear4 ([L, K/2, N] packed, scale and zero [L,
    G, N]) or plain [L, K, N] tensors, in any mix (``weight_mode``);
    step_embd [H]; n_past: int (a SymInt under torch.export); kv [L, 2, Hkv,
    C, D], or the int8 pair (q [L, 2, Hkv, C, D] int8, scale [L, 2, Hkv, C]
    float32; module docstring), written in place at n_past. Keywords
    (``talker_step_operands``): output_norm, codec_head [H, Vc]; when
    ``seen`` ([Vc] bool or int8) is given, the result's cb0 is next
    frame's codebook-0 token sampled with ``seed`` (an int or a SymInt),
    temperature, top_p, repetition_penalty, top_k, greedy and use_top_p,
    after suppression of [suppress_start, Vc) except eos_id. Norm weights
    and scales already in float32 and ``seen`` in int8 (as the pipeline and
    the decode loop keep them) are passed to the kernel without a copy.

    CPU tensors run the plain version. CUDA tensors launch the kernel (bf16,
    float32 or int8 KV cache, bf16 or float32 codec head and plain weights)
    or raise; there is no fallback.
    """
    hidden, logits, tok = torch.ops.qwen3tts.talker_step.default(
        *talker_step_operands(blocks, cfg, step_embd, n_past, kv, **kw))
    return StepOut(hidden, logits, tok if kw.get("seen") is not None else None)


fused_talker_step.launches = 0
fused_talker_step.mode_launches = {}
# launches over the int8 KV cache ("kv_int8") and over a float32 one ("kv_f32")
fused_talker_step.operand_launches = {}
library.implement("talker_step", cpu=_talker_step_cpu, cuda=_talker_step_cuda)


def lane_major_view(kv: torch.Tensor) -> torch.Tensor:
    """The batch-major view [B, L, 2, Hkv, C, D] of a lane-major cache [L, 2,
    Hkv, C, B, D] (no copy: writes through the view land in its storage)."""
    return kv.permute(4, 0, 1, 2, 3, 5)


def to_lane_major(kv: torch.Tensor) -> torch.Tensor:
    """A batch-major cache [B, L, 2, Hkv, C, D] copied once into the
    lane-major layout [L, 2, Hkv, C, B, D] (the JAX package's
    ``kv.transpose(1, 2, 3, 4, 0, 5)``), contiguous."""
    return kv.permute(1, 2, 3, 4, 0, 5).contiguous()


def fused_talker_step_batched_plain(blocks, cfg, step_embd, n_past, kv, kv_layout="batch",
                                    **kw) -> StepOut:
    """Plain PyTorch version of K5 (same semantics; kv updated in place):
    talker_step_plain with float32 probabilities, on the batch-major view of
    a lane-major cache."""
    if kv_layout == "lane":
        kv = lane_major_view(kv)
    return talker_step_plain(blocks, cfg, step_embd, n_past, kv, p_dtype=torch.float32, **kw)


def _lane_values(v, B, dev):
    """(scalar, pointer) of a sampling parameter: a scalar passes by value
    with a null pointer; per-lane values [B] as a float32 array on the card
    (the scalar slot then unused)."""
    if isinstance(v, torch.Tensor) and v.dim() >= 1:
        t = v.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
        if t.numel() != B:
            raise ValueError(f"a per-lane sampling parameter needs {B} values, got {t.numel()}")
        return 1.0, t
    return float(v), None


KV_LAYOUTS = ("batch", "lane")
# K5's return when the lane-major cache's tensor map cannot be encoded
# (kLaneMapFailed in csrc/talker_step_batched.cu: a cache off 16-byte
# alignment, or a driver without cuTensorMapEncodeTiled)
LANE_MAP_FAILED = -1


def _check_layout(kv, kv_layout, seen, start, codec_head, output_norm):
    """The JAX package's asserts on K5's operands (pallas_talker_step.py:1660,
    :1689, :1704), as ValueError."""
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout!r}")
    if (codec_head is None) != (output_norm is None):
        raise ValueError("codec_head and output_norm come together")
    if seen is not None and codec_head is None:
        raise ValueError("cb0 sampling needs codec_head")
    if kv_layout != "lane":
        return
    if is_quantized_kv(kv):
        raise ValueError("int8 KV requires the batch-major layout (scale-slab DMA alignment)")
    if seen is not None:
        raise ValueError("cb0 sampling needs codec_head and the batch-major layout")
    if start is not None:
        raise ValueError("per-lane start (continuous batching) needs the batch-major layout")


def fused_talker_step_batched(blocks, cfg, step_embd, n_past, kv, *, output_norm,
                              codec_head, seen=None, seeds=None, temperature=1.0,
                              top_p=1.0, repetition_penalty=1.0, top_k=0,
                              suppress_start=None, eos_id=-1, greedy=False,
                              use_top_p=True, start=None, start_min=0,
                              kv_layout="batch") -> StepOut:
    """One talker decode step for B lockstep lanes (kernel K5; counterpart
    of the Pallas ``fused_talker_step_batched``, in the blocks' weight mode
    as in ``fused_talker_step``).

    step_embd [B, H]; n_past: int, shared by the lanes; kv (kv_layout
    "batch") [B, L, 2, Hkv, C, D], or the int8 pair (q [B, L, 2, Hkv, C, D]
    int8, scale [B, L, 2, Hkv, C] float32), or (kv_layout "lane") [L, 2,
    Hkv, C, B, D]; bf16 or float32; each lane's row written in place at
    n_past. Returns StepOut with hidden [B, H] (output-normed, f32), logits
    [B, Vc] f32 and, when ``seen`` ([B, Vc] bool or int8) is given, cb0 [B]:
    each lane's next codebook-0 token sampled with seeds[b] (int32 [B]).
    temperature, top_p and repetition_penalty are scalars or per-lane [B]
    tensors (continuous serving: each request its own). Unlike K1, the
    attention keeps its probabilities in float32, as the batched Pallas
    kernel does. B <= 128. codec_head and output_norm None: hidden is the
    last layer's residual x and logits None (the Pallas kernel without its
    head).

    start ([B] int32 tensor), continuous serving's per-lane first valid
    cache row: lane b attends rows [start[b], n_past] only. start_min, a
    host int at most every lane's start (the scheduler's host mirror: the
    wrapper never reads `start` back), lets the kernel skip the attention
    chunks below it; 0 is always safe. The plain version raises where a
    lane's start lies below start_min. An int8 cache takes no ``start``
    (ValueError), as the JAX package never passes one with it. The lane
    layout takes no int8 pair, no ``seen``/``seeds`` and no ``start``
    (ValueError, the JAX package's asserts).

    CPU tensors run the plain version. CUDA tensors launch the kernel (bf16,
    float32 or int8 KV cache, bf16 or float32 codec head and plain weights)
    or raise; there is no fallback.
    """
    B = step_embd.shape[0]
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"fused_talker_step_batched takes 1..{MAX_LANES} lanes, got {B}")
    if seen is not None and seeds is None:
        raise ValueError("sampling cb0 needs per-lane seeds")
    _check_layout(kv, kv_layout, seen, start, codec_head, output_norm)
    lane = kv_layout == "lane"
    cache = kv[0] if is_quantized_kv(kv) else kv
    if start is not None and cache is not kv:
        raise ValueError("fused_talker_step_batched takes no per-lane start with the int8 KV "
                         "cache: continuous serving keeps a compute-dtype cache, as in the "
                         "JAX package")
    if cache.device.type == "cpu":
        return fused_talker_step_batched_plain(
            blocks, cfg, step_embd, n_past, kv, kv_layout, output_norm=output_norm,
            codec_head=codec_head, seen=seen, seeds=seeds, temperature=temperature,
            top_p=top_p, repetition_penalty=repetition_penalty, top_k=top_k,
            suppress_start=suppress_start, eos_id=eos_id, greedy=greedy,
            use_top_p=use_top_p, start=start, start_min=start_min)
    if start is None and start_min > 0:
        raise ValueError("start_min > 0 needs the per-lane start operand")
    lib = _kernels.load_library()
    H, L, Hkv, D = cfg.hidden_size, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    C = cache.shape[3] if lane else cache.shape[4]
    Vc = cfg.codec_vocab_size if codec_head is None else codec_head.shape[-1]
    cache, scales = _cache_operands(kv, (L, 2, Hkv, C, B, D) if lane else (B, L, 2, Hkv, C, D))
    _kernels.require_cuda(*(t for t in (cache, scales, codec_head) if t is not None),
                          step_embd, blocks.attn_norm)
    modes, ops = _cuda_operands(blocks, output_norm, codec_head)
    n = int(n_past)
    if not 0 <= n < C:
        raise ValueError(f"n_past {n} outside the cache capacity {C}")
    dev = cache.device
    cos, sin = _rope_row(n, cfg, dev, C)
    x = step_embd.float().contiguous()
    hidden = torch.empty((B, H), dtype=torch.float32, device=dev)
    logits = None if codec_head is None else torch.empty((B, Vc), dtype=torch.float32,
                                                         device=dev)
    tok = seen8 = seeds32 = None
    if seen is not None:
        tok = torch.empty((B,), dtype=torch.int32, device=dev)
        seen8 = seen.to(torch.int8).contiguous()
        seeds32 = torch.as_tensor(seeds, dtype=torch.int32, device=dev).contiguous()
        if tuple(seen8.shape) != (B, Vc) or tuple(seeds32.shape) != (B,):
            raise ValueError("seen must be [B, Vc] and seeds [B]")
    temp, temps = _lane_values(temperature, B, dev)
    topp, topps = _lane_values(top_p, B, dev)
    pen, pens = _lane_values(repetition_penalty, B, dev)
    start32 = None
    if start is not None:
        start32 = torch.as_tensor(start, dtype=torch.int32, device=dev).reshape(-1).contiguous()
        if start32.numel() != B:
            raise ValueError(f"start must be [{B}], got {tuple(start32.shape)}")
    ws = torch.empty(lib.qtts_talker_batched_ws_bytes(B, H, cfg.n_heads, Hkv, D,
                                                      cfg.intermediate_size, Vc, modes),
                     dtype=torch.uint8, device=dev)
    err = lib.qtts_talker_step_batched(
        x.data_ptr(), B, n, cos.data_ptr(), sin.data_ptr(), *_ptrs(ops), modes,
        *_ptrs([cache, scales]), int(cache.dtype == torch.float32),
        int(codec_head is not None and codec_head.dtype == torch.float32), int(lane),
        *_dims(cfg, C, Vc), None if seen8 is None else seen8.data_ptr(),
        None if seeds32 is None else seeds32.data_ptr(), temp, topp, pen, int(top_k),
        int(greedy), int(use_top_p), Vc if suppress_start is None else int(suppress_start),
        int(eos_id), _ptrs([start32])[0], int(start_min), *_ptrs([temps, topps, pens]),
        hidden.data_ptr(), _ptrs([logits])[0], None if tok is None else tok.data_ptr(),
        ws.data_ptr(), _kernels.stream_ptr(dev))
    if err == LANE_MAP_FAILED:
        raise RuntimeError("fused_talker_step_batched: the driver refused the lane-major "
                           "cache's tensor map (cuTensorMapEncodeTiled); nothing was launched")
    _kernels.check(err, "fused_talker_step_batched")
    _count(fused_talker_step_batched, blocks, scales, cache, lane)
    if tok is not None:
        sample_rows.site_rows["K5"] += B
    if start32 is not None:
        _bump(fused_talker_step_batched.operand_launches, "start")
    return StepOut(hidden, logits, tok)


fused_talker_step_batched.launches = 0
fused_talker_step_batched.mode_launches = {}
# launches with an operand only continuous serving passes ("start"), over the
# int8 KV cache ("kv_int8"), over a float32 cache ("kv_f32") and over a
# lane-major cache ("lane", which counts in no mode)
fused_talker_step_batched.operand_launches = {}
