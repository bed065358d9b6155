"""K5's batched projections on the tensor cores (csrc/layer.cuh
gemm_i8_mma_kernel and gemm_f64_mma_kernel), rebuilt on the CPU: their tile
plan's Python mirror (ops/fused_talker_step.gemm_plan, held to the C plan
by chip_smoke.split_rules on the card) covers each weight row once, and the
summation order it implies gives the plain versions' results bit for bit.

The float modes sum exact bf16 x bf16 products in float64: a split walks
its tiles in order, each tile in mma depth chunks of 8 rows whose inner
order the hardware chooses (shuffled here), and the consumer adds the
splits' float64 partials in split order from zero and rounds once to
float32 per half (w4bf16's halves then added in float32). That must equal
mm_bf16 /
mm_w4bf16, which sum the same products in torch.matmul's order, for the
talker's four projections at 0.6B widths, on seeded bf16 data and on data
whose exponents spread over 2^-30..2^30. The int8 mode's per-split int32
sums must add up to the plain integer dot in any order of the splits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qwen3tts_tpu_torch.config import TalkerConfig
from qwen3tts_tpu_torch.ops.fused_talker_step import (GEMM_DEPTH, GEMM_TILES, gemm_plan,
                                                      gemm_split_rows, mm_bf16, mm_w4bf16)
from qwen3tts_tpu_torch.ops.quant import group_rows

MODES = ("w8a8", "bf16", "w4bf16")


def _shapes():
    t = TalkerConfig()
    H, hd, F = t.hidden_size, t.n_heads * t.head_dim, t.intermediate_size
    qkv = (t.n_heads + 2 * t.n_kv_heads) * t.head_dim
    return {"wqkv": (H, qkv), "wo": (hd, H), "w_gateup": (H, 2 * F), "w_down": (F, H)}


SHAPES = _shapes()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("proj", sorted(SHAPES))
def test_plan_covers_each_row_once(mode, proj):
    """The splits' rows tile [0, rows) in order, none empty, with whole
    tiles but the last; the grid stays about one block per SM, each split
    with several tiles where the rows allow. gemm_plan takes no B: this one
    plan serves every B from 2 to 128 (the lanes ride the mma's N, padded
    to 8, inside each block)."""
    K, N = SHAPES[proj]
    rows = K // 2 if mode == "w4bf16" else K
    tn, tk = GEMM_TILES[mode]
    gx, ks, per = gemm_plan(mode, K, N)
    spans = gemm_split_rows(mode, K, N)
    assert len(spans) == ks and gx == -(-N // tn)
    cover = np.zeros(rows, np.int64)
    for lo, hi in spans:
        assert lo < hi and lo % tk == 0
        cover[lo:hi] += 1
    assert (cover == 1).all(), (mode, proj)
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert gx * ks <= 2 * 132 and per >= 2


def _plan_sum(xd, wd, mode, K, N, rng):
    """sum_k xd[:, k] * wd[k, :] (float64 [B, n]) in K5's order over the
    weight rows of one half (xd, wd already cut to that half): per split
    (from 0.0) its tiles in order, each depth chunk's rows shuffled; then
    the splits added in order from 0.0 and rounded to float32."""
    depth = GEMM_DEPTH[mode]
    total = torch.zeros((xd.shape[0], wd.shape[1]), dtype=torch.float64)
    for lo, hi in gemm_split_rows(mode, K, N):
        acc = torch.zeros_like(total)
        for c0 in range(lo, hi, depth):
            for k in rng.permutation(np.arange(c0, min(hi, c0 + depth))):
                acc += xd[:, k:k + 1] * wd[k:k + 1, :]
        total = total + acc
    return total.float()


def _bf16(rng, shape, spread):
    v = rng.standard_normal(shape)
    if spread:
        v = v * np.exp2(rng.integers(-30, 31, shape))
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


# columns of the products rebuilt in order (the plan depends on N, the
# order inside a column does not)
COLS = 48


@pytest.mark.parametrize("spread", [False, True], ids=["normal", "wide_exponents"])
@pytest.mark.parametrize("proj", sorted(SHAPES))
def test_bf16_plan_order_gives_the_plain_bits(proj, spread):
    K, N = SHAPES[proj]
    rng = np.random.default_rng(11 + 7 * sorted(SHAPES).index(proj) + spread)
    B = 3
    x = _bf16(rng, (B, K), spread).float()
    w = _bf16(rng, (K, COLS), spread)
    want = mm_bf16(x, w)
    got = _plan_sum(x.to(torch.bfloat16).double(), w.double(), "bf16", K, N, rng)
    assert torch.isfinite(want).all()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("spread", [False, True], ids=["normal", "wide_exponents"])
@pytest.mark.parametrize("proj", sorted(SHAPES))
def test_w4bf16_plan_order_gives_the_plain_bits(proj, spread):
    """Both halves of a u4 weight (groups of 32 rows, scales spread over
    2^-30..2^30 in the wide case), each summed in the plan's order over the
    packed rows, rounded per half and added in float32."""
    K, N = SHAPES[proj]
    rng = np.random.default_rng(101 + 7 * sorted(SHAPES).index(proj) + spread)
    B, Kh, G = 3, K // 2, K // 32
    q = torch.from_numpy(rng.integers(0, 256, (Kh, COLS)).astype(np.uint8)).view(torch.int8)
    scale = torch.from_numpy((rng.random((G, COLS)) * 0.05 + 0.001).astype(np.float32))
    if spread:
        scale = scale * torch.from_numpy(np.exp2(rng.integers(-30, 31, (G, 1))).astype(
            np.float32))
    zero = scale * torch.from_numpy(rng.integers(0, 16, (G, COLS)).astype(np.float32))
    x = _bf16(rng, (B, K), spread).float()
    want = mm_w4bf16(x, q, scale, zero)
    b = q.to(torch.int32) & 0xFF
    xd = x.to(torch.bfloat16).double()
    got = None
    for h, nib in enumerate((b & 15, b >> 4)):
        sh, zh = scale[h * G // 2:(h + 1) * G // 2], zero[h * G // 2:(h + 1) * G // 2]
        wh = (nib.float() * group_rows(sh, Kh) - group_rows(zh, Kh)).to(torch.bfloat16)
        part = _plan_sum(xd[:, h * Kh:(h + 1) * Kh], wh.double(), "w4bf16", K, N, rng)
        got = part if got is None else got + part
    assert torch.isfinite(want).all()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("proj", sorted(SHAPES))
def test_int8_splits_add_up_to_the_plain_accumulator(proj):
    """Each split's int32 sum over its rows (what one block adds into the
    accumulator) fits int32, and the splits add up to the plain integer dot
    whichever split lands first."""
    K, N = SHAPES[proj]
    rng = np.random.default_rng(5 + sorted(SHAPES).index(proj))
    B = 4
    x = rng.integers(-127, 128, (B, K)).astype(np.int64)
    w = rng.integers(-127, 128, (K, COLS)).astype(np.int64)
    want = torch.matmul(torch.from_numpy(x).double(), torch.from_numpy(w).double()).to(
        torch.int32).numpy()
    parts = [x[:, lo:hi] @ w[lo:hi] for lo, hi in gemm_split_rows("w8a8", K, N)]
    assert all(np.abs(p).max() < 2 ** 31 for p in parts)
    for order in (range(len(parts)), reversed(range(len(parts))), rng.permutation(len(parts))):
        acc = np.zeros((B, COLS), np.int32)
        for i in order:
            acc = (acc + parts[i].astype(np.int32)).astype(np.int32)
        assert (acc == want).all()


def test_w4_groups_hold_whole_tiles():
    """The u4 tier's talker groups (quant.W4_GROUP rows, each half of K
    divisible by them) are a multiple of the GEMM's packed-row tile, so
    every tile reads one group's scale and offset rows per half."""
    from qwen3tts_tpu_torch.ops.quant import _w4_group_size

    for K, _ in SHAPES.values():
        gs = _w4_group_size(K)
        assert gs % GEMM_TILES["w4bf16"][1] == 0 and (K // 2) % gs == 0
