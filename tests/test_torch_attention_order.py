"""The attention kernels' split and summation order, rebuilt in PyTorch on
the CPU, against the plain versions the kernels are held to on the card.

K1/K5's attention kernel (csrc/layer.cuh ``attn_layer_kernel``) splits each
(lane, KV head)'s rows into the contiguous slices of a thread block
cluster. Each block computes its slice's float64 scores (rounded to
float32 once), the cluster exchanges the exact maximum and adds the blocks'
float64 sums of exp(s - m) in rank order, and rank 0 adds the blocks'
float64 partial p @ V in rank order and rounds once. Rebuilt here with the
wrappers' mirrors of the split rule (``attention_clusters``,
``attention_slices``), the result must equal ``gqa_attention`` bit for bit
at the talker's widths (Hq = 16, Hkv = 8, D = 128). Decode attention
(csrc/decode_attention.cu) splits [0, n_valid) over a cluster
(``decode_attention_split``), runs a float32 online softmax per warp over
its rows of each 64-row tile and combines the warps', then the splits'
states in order; rebuilt here, it must
lie within one bf16 ulp + 1e-6 of ``decode_attention_kernel_plain``, the
card's gate. The split rules must cover each lane's rows exactly once.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qwen3tts_tpu_torch.ops.decode_attention import (decode_attention_kernel_plain,
                                                      decode_attention_split)
from qwen3tts_tpu_torch.ops.fused_talker_step import (ATTN_TILE, attention_clusters,
                                                      attention_slices, gqa_attention)
from qwen3tts_tpu_torch.ops.kv_quant import quantize_kv

Hq, Hkv, D = 16, 8, 128
G = Hq // Hkv


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
        torch.bfloat16)


def _cluster_attention(q, K, V, p_dtype, t0, n_end, clusters):
    """The kernel's order for one lane: q [Hq, D] float32 (rounded as the
    kernel rounds it), K and V [Hkv, C, D] float32 of bf16 values, rows
    [t0, n_end); returns [Hq * D] float32."""
    out = []
    for h in range(Hkv):
        qg = q[h * G:(h + 1) * G].double()
        slices = [(lo, hi) for lo, hi in attention_slices(t0, n_end, clusters)]
        s = [(qg @ K[h, lo:hi].double().T).float() * D ** -0.5 for lo, hi in slices]
        m = torch.stack([x.amax(-1) if x.shape[-1] else torch.full((G,), -3.4e38)
                         for x in s]).amax(0)[:, None]
        total = torch.zeros((G, 1), dtype=torch.float64)
        for x in s:   # the blocks' sums of e, in rank order
            total = total + torch.exp((x - m).double()).sum(-1, keepdim=True)
        o = torch.zeros((G, D), dtype=torch.float64)
        for x, (lo, hi) in zip(s, slices):   # the blocks' partial o, in rank order
            p = (torch.exp((x - m).double()) / total).float().to(p_dtype)
            o = o + p.double() @ V[h, lo:hi].double()
        out.append(o.float())
    return torch.cat(out, 0).reshape(-1)


@pytest.mark.parametrize("kernel_lanes", [1, 16, 64])
@pytest.mark.parametrize("round_p", [True, False], ids=["round_p", "float_p"])
@pytest.mark.parametrize("with_start", [False, True], ids=["all_rows", "start"])
@pytest.mark.parametrize("n_valid", [1, 63, 64, 65, 300, 4000])
def test_talker_attention_order_is_gqa_attention(n_valid, with_start, round_p, kernel_lanes):
    """Two lanes at the clusters K1 (one lane) or K5 (16, 64 lanes) would
    get, with per-lane starts (the second lane mid-range, start_min the
    first's) or without: the rebuilt order equals gqa_attention bit for bit."""
    rng = np.random.default_rng(n_valid * 7 + 3)
    B, C = 2, n_valid + 5
    K = _bf16(rng, (B, Hkv, C, D), 0.5).float()
    V = _bf16(rng, (B, Hkv, C, D), 0.5).float()
    q = _bf16(rng, (B, Hq, D)).float()
    p_dtype = torch.bfloat16 if round_p else torch.float32
    starts = [n_valid // 5, (2 * n_valid) // 3] if with_start else [0, 0]
    floor = min(starts)
    clusters = attention_clusters(kernel_lanes, Hkv, G, n_valid - floor)
    valid = torch.arange(n_valid)[None] >= torch.tensor(starts)[:, None]
    want = gqa_attention(q, K[:, :, :n_valid], V[:, :, :n_valid], p_dtype,
                         valid if with_start else None)
    for b in range(B):
        got = _cluster_attention(q[b], K[b], V[b], p_dtype, max(starts[b], floor), n_valid,
                                 clusters)
        assert torch.equal(got, want[b]), (b, clusters, float((got - want[b]).abs().max()))


def _cluster_attention_q8(q, Kq, ks, Vq, vs, cur, p_dtype, pos, clusters):
    """The kernel's order for one lane over the int8 cache: the cached rows
    [0, pos) in slices, e = exp(s - m) in float32 summed in float64 per
    block and in rank order, e * v_scale rounded to p_dtype, the partial o
    added in rank order, then the current row cur = (k, v) [Hkv, D] folded
    in."""
    out = []
    for h in range(Hkv):
        qg = q[h * G:(h + 1) * G].double()
        slices = attention_slices(0, pos, clusters)
        s = [(qg @ Kq[h, lo:hi].double().T).float() * D ** -0.5 * ks[h, lo:hi]
             for lo, hi in slices]
        s_cur = (qg @ cur[0][h].double()[:, None]).float() * D ** -0.5
        m = torch.full((G, 1), -3.4e38)
        for x in s:
            if x.shape[-1]:
                m = torch.maximum(m, x.amax(-1, keepdim=True))
        total = torch.zeros((G, 1), dtype=torch.float64)
        o = torch.zeros((G, D), dtype=torch.float64)
        for x, (lo, hi) in zip(s, slices):
            e = torch.exp((x - m).double()).float()
            total = total + e.double().sum(-1, keepdim=True)
            o = o + (e * vs[h, lo:hi]).to(p_dtype).double() @ Vq[h, lo:hi].double()
        m_fin = torch.maximum(m, s_cur)
        alpha = torch.exp((m - m_fin).double()).float()
        p_cur = torch.exp((s_cur - m_fin).double()).float()
        l = alpha * total.float() + p_cur
        out.append((o.float() * alpha + p_cur * cur[1][h][None].float()) / l)
    return torch.cat(out, 0).reshape(-1)


@pytest.mark.parametrize("kernel_lanes", [1, 16])
@pytest.mark.parametrize("round_p", [True, False], ids=["round_p", "float_p"])
@pytest.mark.parametrize("pos", [0, 1, 64, 65, 300, 4000])
def test_talker_attention_order_int8_cache(pos, round_p, kernel_lanes):
    """The int8 (q, scale) cache: the rebuilt order equals gqa_attention's
    int8 form bit for bit (K1 rounds e * v_scale to bf16, K5 keeps it)."""
    rng = np.random.default_rng(pos + 11)
    kv = _bf16(rng, (1, 2, Hkv, pos + 1, D), 0.5)
    qkv, skv = quantize_kv(kv)
    cur = (_bf16(rng, (1, Hkv, D), 0.5).float(), _bf16(rng, (1, Hkv, D), 0.5).float())
    q = _bf16(rng, (1, Hq, D)).float()
    p_dtype = torch.bfloat16 if round_p else torch.float32
    clusters = attention_clusters(kernel_lanes, Hkv, G, pos, kv_int8=True)
    want = gqa_attention(q, (qkv[:, 0, :, :pos], skv[:, 0, :, :pos]),
                         (qkv[:, 1, :, :pos], skv[:, 1, :, :pos]), p_dtype, cur=cur)
    got = _cluster_attention_q8(q[0], qkv[0, 0, :, :pos], skv[0, 0, :, :pos],
                                qkv[0, 1, :, :pos], skv[0, 1, :, :pos],
                                (cur[0][0], cur[1][0]), p_dtype, pos, clusters)
    assert torch.equal(got, want[0]), (clusters, float((got - want[0]).abs().max()))


def _combine(parts):
    """(m, l, acc) states rescaled to their common max and added in order."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L, O = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L, O = L + l * w, O + acc * w
    return M, L, O


def _decode_split_attention(q, kv, n_valid, B_kernel):
    """decode_attn_kernel's order for one lane: q [Hq, D] bf16, kv [2, Hkv,
    C, D] bf16. Per split, warp w's float32 online softmax over its rows 4w..
    4w+3 and 4w+32..4w+35 of each 64-row tile; the warps' states combined in
    warp order, then the splits' in rank order."""
    splits, per = decode_attention_split(B_kernel, Hkv, n_valid)
    out = torch.empty((Hq, D), dtype=torch.bfloat16)
    mine = [[4 * w + r for r in range(4)] + [4 * w + 32 + r for r in range(4)]
            for w in range(8)]
    for h in range(Hkv):
        qg = q[h * G:(h + 1) * G].float()
        parts = []
        for r in range(splits):
            lo, hi = r * per, min(n_valid, (r + 1) * per)
            warps = [(torch.full((G, 1), -1e30), torch.zeros((G, 1)), torch.zeros((G, D)))
                     for _ in range(8)]
            for t in range(lo, hi, ATTN_TILE):
                for w in range(8):
                    rows = [t + i for i in mine[w] if t + i < hi]
                    m, l, acc = warps[w]
                    if not rows:
                        continue
                    k, v = kv[0, h, rows].float(), kv[1, h, rows].float()
                    s = (qg @ k.T) * (1.0 / D ** 0.5)
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    p = torch.exp(s - m_new)
                    alpha = torch.exp(m - m_new)
                    warps[w] = (m_new, alpha * l + p.sum(-1, keepdim=True), acc * alpha + p @ v)
            parts.append(_combine(warps))
        _, L, O = _combine(parts)
        out[h * G:(h + 1) * G] = (O / torch.clamp(L, min=1e-30)).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("kernel_lanes", [1, 16])
@pytest.mark.parametrize("n_valid", [1, 63, 64, 65, 300, 4000])
def test_decode_attention_split_order_within_one_ulp(n_valid, kernel_lanes):
    """The splits of one cluster, each eight per-warp online softmaxes over
    tiles of 64 rows, combined in warp and rank order: within one bf16 ulp +
    1e-6 of the plain version at every element (the card's gate)."""
    rng = np.random.default_rng(n_valid + 29)
    L, C = 2, n_valid + 3
    kv = _bf16(rng, (L, 2, Hkv, C, D))
    q = _bf16(rng, (Hq, D))
    want = decode_attention_kernel_plain(q, kv, 1, n_valid).float()
    got = _decode_split_attention(q, kv[1], n_valid, kernel_lanes).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-38))) - 7)
    assert bool(((got - want).abs() <= ulp + 1e-6).all())


@pytest.mark.parametrize("n_valid", [1, 2, 63, 64, 65, 300, 1000, 4000, 4352])
def test_split_rules_cover_each_row_once(n_valid):
    """For every B from 1 to 128: decode attention's splits cover [0,
    n_valid) once, none empty, at most 16; K1/K5's cluster slices cover
    each lane's rows [max(start, start_min), n_valid) once, none longer than
    the slice capacity the kernel's shared memory is sized for (ceil(rows /
    clusters), rows = n_valid - start_min), for a bf16 and an int8 cache."""
    for B in range(1, 129):
        splits, per = decode_attention_split(B, Hkv, n_valid)
        rows = [t for r in range(splits) for t in range(r * per, min(n_valid, (r + 1) * per))]
        assert rows == list(range(n_valid)) and 1 <= splits <= 16
        assert (splits - 1) * per < n_valid
        for floor, start in ((0, 0), (n_valid // 3, n_valid // 2), (n_valid - 1, n_valid - 1)):
            for q8 in (False, True):
                S = attention_clusters(B, Hkv, G, n_valid - floor, kv_int8=q8)
                cap = max(1, -(-(n_valid - floor) // S))
                sl = attention_slices(max(start, floor), n_valid, S)
                got = [t for lo, hi in sl for t in range(lo, hi)]
                assert got == list(range(max(start, floor), n_valid)), (B, S)
                assert all(hi - lo <= cap for lo, hi in sl) and 1 <= S <= 16
