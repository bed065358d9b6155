"""The tile plans of K3 (csrc/res_block.cu) and the W8A16 GEMM
(csrc/int8_matmul.cu), rebuilt on the CPU from their Python mirrors
(``ops/fused_vocoder.res_block_plan`` and ``ops/int8_matmul.int8_mm_plan``,
held to the C plans by chip_smoke.split_rules on the card).

K3: the row and column tiles cover every output once for ragged T, every
width of the vocoder and each dilation; the rows a window reads from x lie
in [0, T) (the rest of the window is the zero halo); and the computation
done tile by tile as the kernel does it (snake1 applied to the window as it
is staged, rows before 0 zero, the 7 taps as row offsets tap * d into the
one window, bias and snake2 in the epilogue, the 1x1 conv on the tile kept
on chip for the narrow widths, through a scratch for the wide ones) equals
``res_block_plain`` within chip_smoke's tolerance.

The GEMM: every K row lies in exactly one cluster rank, and every output
in one block, for M = 1..256 at the talker's four projection shapes; the
ranks' float32 partials added in rank order, times the scale, lie within
chip_smoke's gate of ``int8_matmul_plain``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qwen3tts_tpu_torch.config import TalkerConfig
from qwen3tts_tpu_torch.ops.fused_vocoder import (RB_FUSED_WIDTHS, res_block_plain,
                                                  res_block_plan, snake)
from qwen3tts_tpu_torch.ops.int8_matmul import (MM_BLOCK_TARGET, MM_MAX_SPLITS, MM_ROWS, MM_TK,
                                                MM_TN, int8_matmul_plain, int8_mm_plan,
                                                int8_mm_split_rows)

WIDTHS = (768, 384, 192, 96)          # the vocoder's decoder blocks
DILATIONS = (1, 3, 9)
RAGGED_T = (1, 37, 128, 129, 300, 64 * 47 + 37)


def _windows(T, C, d):
    """Per row tile of res_block_plan: (t0, lo, hi), the x rows [lo, hi)
    the tile's window reads; its rows [t0 - halo, lo) are the zero halo and
    [hi, t0 + 128) rows past the end (zeros too)."""
    _, tm, _, row_tiles, _, halo = res_block_plan(T, C, d)
    return [(r * tm, max(0, r * tm - halo), min(T, r * tm + tm)) for r in range(row_tiles)]


@pytest.mark.parametrize("C", WIDTHS)
def test_res_block_plan_covers_each_output_once(C):
    for T in RAGGED_T + (2048, 10240, 40960, 122880):
        for d in DILATIONS:
            launches, tm, tn, row_tiles, col_tiles, halo = res_block_plan(T, C, d)
            assert launches == (1 if C in RB_FUSED_WIDTHS else 2)
            assert halo == 6 * d and tm == 128
            cover = np.zeros((T, C), np.int64)
            for r in range(row_tiles):
                for c in range(col_tiles):
                    cover[r * tm:(r + 1) * tm, c * tn:(c + 1) * tn] += 1
            assert (cover == 1).all(), (T, C, d)
            if launches == 1:
                assert tn == C and col_tiles == 1
            else:
                assert tn == 128 and C % tn == 0
            for t0, lo, hi in _windows(T, C, d):
                assert 0 <= lo <= t0 < hi <= T
                assert lo == max(0, t0 - halo)


def _res_block_tiled(x, w1, b1, a1, be1, w2, b2, a2, be2, d):
    """K3 tile by tile as the kernel runs it, in float32."""
    T, C = x.shape
    launches, tm, tn, row_tiles, col_tiles, halo = res_block_plan(T, C, d)
    out = torch.empty_like(x)
    s2 = torch.empty_like(x)
    for r in range(row_tiles):
        t0 = r * tm
        win = torch.zeros((tm + halo, C))
        lo, hi = max(0, t0 - halo), min(T, t0 + tm)
        assert lo >= 0
        win[lo - (t0 - halo):hi - (t0 - halo)] = x[lo:hi]
        win = snake(win, a1, be1)                       # snake1 as it is staged; snake(0) = 0
        rows = slice(t0, min(T, t0 + tm))
        n = rows.stop - rows.start
        for c in range(col_tiles):
            cols = slice(c * tn, min(C, (c + 1) * tn))
            acc = torch.zeros((tm, cols.stop - cols.start))
            for tap in range(7):                        # the taps: row offsets into one window
                acc += win[tap * d:tap * d + tm] @ w1[tap][:, cols]
            y = snake(acc + b1[cols], a2[cols], be2[cols])
            if launches == 1:                           # the 1x1 conv on the tile kept on chip
                out[rows] = x[rows] + (y @ w2[0] + b2)[:n]
            else:
                s2[rows, cols] = y[:n]
    if launches == 2:                                   # the second launch, over the scratch
        for r in range(row_tiles):
            rows = slice(r * tm, min(T, (r + 1) * tm))
            for c in range(col_tiles):
                cols = slice(c * tn, min(C, (c + 1) * tn))
                out[rows, cols] = x[rows, cols] + (s2[rows] @ w2[0][:, cols] + b2[cols])
    return out


@pytest.mark.parametrize("C, T", [(96, 300), (192, 64 * 2 + 37), (384, 300), (768, 129)])
@pytest.mark.parametrize("d", DILATIONS)
def test_res_block_tiles_match_plain(C, T, d):
    rng = np.random.default_rng(C * 10 + d)

    def f(*shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc).astype(np.float32))

    x = f(T, C)
    args = (f(7, C, C, sc=(7 * C) ** -0.5), f(C, sc=0.1), f(C, sc=0.3), f(C, sc=0.3),
            f(1, C, C, sc=C ** -0.5), f(C, sc=0.1), f(C, sc=0.3), f(C, sc=0.3))
    want = res_block_plain(x, *args, dilation=d)
    got = _res_block_tiled(x, *args, d)
    assert float((got - want).abs().max()) <= 1e-4 * (1.0 + float(want.abs().max()))


def _talker_shapes():
    t = TalkerConfig()
    H, hd, F = t.hidden_size, t.n_heads * t.head_dim, t.intermediate_size
    qkv = (t.n_heads + 2 * t.n_kv_heads) * t.head_dim
    return {"wqkv": (H, qkv), "wo": (hd, H), "w_gateup": (H, 2 * F), "w_down": (F, H)}


SHAPES = _talker_shapes()


@pytest.mark.parametrize("x_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("proj", sorted(SHAPES))
def test_int8_mm_plan_covers_each_row_once(proj, x_bf16):
    """Each K row in exactly one cluster rank (whole tiles but the last),
    each output row in one row block, each column in one column tile; a
    cluster of at most 16 ranks; about two blocks per SM or fewer, unless a
    single split already exceeds that."""
    K, N = SHAPES[proj]
    for M in range(1, 257):
        path, splits, per, col_tiles, row_tiles = int8_mm_plan(M, K, N, x_bf16)
        assert path == (1 if x_bf16 and M > 8 else 0)
        assert 1 <= splits <= MM_MAX_SPLITS
        assert col_tiles * MM_TN == N
        assert (row_tiles - 1) * MM_ROWS[path] < M <= row_tiles * MM_ROWS[path]
        spans = int8_mm_split_rows(M, K, N, x_bf16)
        assert len(spans) == splits
        cover = np.zeros(K, np.int64)
        for lo, hi in spans:
            assert lo < hi and lo % MM_TK[path] == 0
            cover[lo:hi] += 1
        assert (cover == 1).all(), (proj, M)
        blocks = splits * col_tiles * row_tiles
        assert blocks <= MM_BLOCK_TARGET + col_tiles * row_tiles or splits == 1


def _gate(a, b, rel):
    """chip_smoke.check_int8_matmul's gate: one bf16 ulp (float32 x: 1e-5
    relative) + 1e-5 * max|plain|."""
    bf = b.float()
    if rel:
        tol = 1e-5 * bf.abs()
    else:
        tol = torch.exp2(torch.floor(torch.log2(bf.abs().clamp(min=1e-38))) - 7)
    tol = tol + 1e-5 * float(bf.abs().max())
    return float(((a.float() - bf).abs() - tol).max()) <= 0


@pytest.mark.parametrize("x_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("proj", sorted(SHAPES))
def test_int8_mm_rank_order_within_gate(proj, x_bf16):
    K, N = SHAPES[proj]
    rng = np.random.default_rng(K + N)
    q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    scale = torch.from_numpy((rng.random((1, N)) * 0.02 + 1e-3).astype(np.float32))
    dt = torch.bfloat16 if x_bf16 else torch.float32
    for M in (1, 8, 9, 128):
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dt)
        total = None
        for lo, hi in int8_mm_split_rows(M, K, N, x_bf16):     # ranks in order
            part = x[:, lo:hi].float() @ q[lo:hi].float()
            total = part if total is None else total + part
        got = (total * scale).to(dt)
        assert _gate(got, int8_matmul_plain(x, q, scale), rel=not x_bf16), (proj, M)
