"""K1's GEMVs (csrc/layer.cuh gemv_i8_kernel, gemv_bf16_kernel,
gemv_w4_kernel: one lane), rebuilt on the CPU: their grid's Python mirror
(ops/fused_talker_step.gemv_plan, held to the C plan by
chip_smoke.split_rules on the card) covers each weight row once, and the
summation order it implies gives the plain versions' results bit for bit.

A float-mode GEMV sums exact bf16 x bf16 products in float64: each split is
one block of 128 weight rows (64 packed rows for w4bf16); each of its 32
thread rows sums its GEMV_THREAD_ROWS consecutive rows (in any order:
shuffled here), a warp adds its four thread rows as ((t0 + t1) + (t2 +
t3)), the block adds its 8 warps in order from zero, and the consumer adds
the splits' partials in order from zero and rounds once to float32 per half
(w4bf16's halves then added in float32). That must equal mm_bf16 /
mm_w4bf16 for the talker's four projections at 0.6B widths, on seeded bf16
data and on data whose exponents spread over 2^-30..2^30. The codec head
sums in float32 in the same tree, within the 1e-3 of chip_smoke's gate."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from qwen3tts_tpu_torch.config import TalkerConfig
from qwen3tts_tpu_torch.ops import w4_gemv_probe as probe
from qwen3tts_tpu_torch.ops.fused_talker_step import (GEMV_THREAD_ROWS, GEMV_TILES, GEMV_WARPS,
                                                      GEMV_WARP_ROWS, gemv_plan, gemv_split_rows,
                                                      mm_bf16, mm_w4bf16)
from qwen3tts_tpu_torch.ops.quant import group_rows

MODES = ("w8a8", "bf16", "w4bf16")
T = TalkerConfig()
SHAPES = {"wqkv": (T.hidden_size, (T.n_heads + 2 * T.n_kv_heads) * T.head_dim),
          "wo": (T.n_heads * T.head_dim, T.hidden_size),
          "w_gateup": (T.hidden_size, 2 * T.intermediate_size),
          "w_down": (T.intermediate_size, T.hidden_size)}
HEAD = (T.hidden_size, T.codec_vocab_size)
CASES = [(m, p) for m in MODES for p in sorted(SHAPES)] + [("head", "codec_head")]


@pytest.mark.parametrize("mode, proj", CASES)
def test_plan_covers_each_row_once(mode, proj):
    """The splits' rows tile [0, rows) in order, each one block of
    GEMV_TILES[mode][1] rows but the last; the column blocks cover N; the
    grid gives the H100's 132 SMs about one block each or more at every
    talker shape, so that every SM streams its share."""
    K, N = HEAD if mode == "head" else SHAPES[proj]
    rows = K // 2 if mode == "w4bf16" else K
    tn, tk = GEMV_TILES[mode]
    gx, ks, per = gemv_plan(mode, K, N)
    spans = gemv_split_rows(mode, K, N)
    assert per == tk and len(spans) == ks and gx * tn >= N > (gx - 1) * tn
    cover = np.zeros(rows, np.int64)
    for lo, hi in spans:
        assert lo < hi <= lo + tk and lo % tk == 0
        cover[lo:hi] += 1
    assert (cover == 1).all(), (mode, proj)
    assert tk == GEMV_WARPS * GEMV_WARP_ROWS * GEMV_THREAD_ROWS[mode]
    assert gx * ks >= 128


def _tree_sum(prod, mode, K, N, rng):
    """sum over rows of prod [rows, n] (float64, exact products) in the
    GEMV's order: per split, each thread row's GEMV_THREAD_ROWS rows in a
    shuffled order from 0.0, each warp ((t0 + t1) + (t2 + t3)), the warps
    in order from 0.0; the splits in order from 0.0."""
    R = GEMV_THREAD_ROWS[mode]
    total = torch.zeros(prod.shape[1], dtype=prod.dtype)
    for lo, hi in gemv_split_rows(mode, K, N):
        threads = []
        for t0 in range(lo, lo + 32 * R, R):
            acc = torch.zeros_like(total)
            for k in rng.permutation(np.arange(t0, t0 + R)):
                if k < hi:
                    acc = acc + prod[k]
            threads.append(acc)
        block = torch.zeros_like(total)
        for w in range(GEMV_WARPS):
            t = threads[GEMV_WARP_ROWS * w:GEMV_WARP_ROWS * (w + 1)]
            block = block + ((t[0] + t[1]) + (t[2] + t[3]))
        total = total + block
    return total


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
def test_bf16_gemv_order_gives_the_plain_bits(proj, spread):
    K, N = SHAPES[proj]
    rng = np.random.default_rng(211 + 7 * sorted(SHAPES).index(proj) + spread)
    x = _bf16(rng, (1, K), spread).float()
    w = _bf16(rng, (K, COLS), spread)
    want = mm_bf16(x, w)[0]
    prod = x[0].to(torch.bfloat16).double()[:, None] * w.double()
    got = _tree_sum(prod, "bf16", K, N, rng).float()
    assert torch.isfinite(want).all()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("spread", [False, True], ids=["normal", "wide_exponents"])
@pytest.mark.parametrize("proj", sorted(SHAPES))
def test_w4bf16_gemv_order_gives_the_plain_bits(proj, spread):
    """Both halves of a u4 weight (groups of 32 rows, scales spread over
    2^-30..2^30 in the wide case), each summed in the GEMV's order over the
    packed rows, rounded per half and added in float32."""
    K, N = SHAPES[proj]
    rng = np.random.default_rng(307 + 7 * sorted(SHAPES).index(proj) + spread)
    Kh, G = K // 2, K // 32
    q = torch.from_numpy(rng.integers(0, 256, (Kh, COLS)).astype(np.uint8)).view(torch.int8)
    scale = torch.from_numpy((rng.random((G, COLS)) * 0.05 + 0.001).astype(np.float32))
    if spread:
        scale = scale * torch.from_numpy(np.exp2(rng.integers(-30, 31, (G, 1))).astype(
            np.float32))
    zero = scale * torch.from_numpy(rng.integers(0, 16, (G, COLS)).astype(np.float32))
    x = _bf16(rng, (1, K), spread).float()
    want = mm_w4bf16(x, q, scale, zero)[0]
    b = q.to(torch.int32) & 0xFF
    xd = x[0].to(torch.bfloat16).double()
    got = None
    for h, nib in enumerate((b & 15, b >> 4)):
        sh, zh = scale[h * G // 2:(h + 1) * G // 2], zero[h * G // 2:(h + 1) * G // 2]
        wh = (nib.float() * group_rows(sh, Kh) - group_rows(zh, Kh)).to(torch.bfloat16)
        prod = xd[h * Kh:(h + 1) * Kh, None] * wh.double()
        part = _tree_sum(prod, "w4bf16", K, N, rng).float()
        got = part if got is None else got + part
    assert torch.isfinite(want).all()
    assert _bits_equal(got, want)


def test_head_gemv_order_within_the_gate():
    """The codec head's float32 sums in the GEMV's tree and split order stay
    within chip_smoke's 1e-3 of the plain float32 product (x rounded to
    bf16 @ W), on hidden-like x and W ~ N(0, 1/K)."""
    K, N = HEAD
    rng = np.random.default_rng(401)
    x = torch.from_numpy(rng.standard_normal((1, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, COLS)) / np.sqrt(K)).astype(
        np.float32)).to(torch.bfloat16)
    want = probe.project_layer_plain(x, w[None], "head", 0)[0]
    prod = x[0].to(torch.bfloat16).float()[:, None] * w.float()   # exact in float32
    got = _tree_sum(prod, "head", K, N, rng)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("mode, proj", [(m, p) for m, p in CASES if m != "w8a8"])
def test_mirror_is_the_plan_split_rules_and_the_harness_read(mode, proj):
    """chip_smoke.split_rules holds the C plan to gemv_plan at every talker
    shape and the head's, and the harness's workspace and its reading at B
    = 1 take gemv_plan's splits: partials [halves, splits, 1, N] (float64;
    the head's float32 [splits, N]), added in split order."""
    K, N = HEAD if mode == "head" else SHAPES[proj]
    assert (K, N) in chip_smoke.GEMV_PLAN_SHAPES
    assert probe.HARNESS_CODES[mode] == ({"head": 3}.get(mode) or probe.MODE_CODES[mode])
    ks = gemv_plan(mode, K, N)[1]
    halves = 2 if mode == "w4bf16" else 1
    size = 4 if mode == "head" else 8
    assert probe.project_ws_bytes(mode, 1, K, N) == size * halves * ks * N
    rng = np.random.default_rng(17)
    part = rng.standard_normal((halves, ks, 1, N))
    ws = torch.from_numpy(part.astype(np.float32 if mode == "head" else np.float64).reshape(
        -1).copy()).view(torch.uint8)
    got = probe.project_result(ws, mode, 1, K, N)
    want = None
    for h in range(halves):
        s = torch.zeros((1, N), dtype=torch.float32 if mode == "head" else torch.float64)
        for sp in range(ks):
            s = s + torch.from_numpy(part[h, sp]).to(s.dtype)
        want = s.float() if want is None else want + s.float()
    assert _bits_equal(got, want)


def test_projection_phase_reports_k1_at_b1(monkeypatch, capsys):
    """check_projections at B = 1 (the card's harness stood in for by one
    that writes the plain layer's result into split 0 of its workspace)
    reports every projection equal under K1's entry of each mode, with a
    bound, weight bytes and the library call (for w8a8, torch._int_mm on
    x padded to the 17 rows it takes); check_head_gemv reports the head
    under K1's w8a8 entry within its tolerance."""

    def stand_in(x, w, mode, ws=None):
        B, K = x.shape
        N = (w if isinstance(w, torch.Tensor) else w.q).shape[-1]
        if ws is None:
            ws = torch.zeros(probe.project_ws_bytes(mode, B, K, N), dtype=torch.uint8)
        y = probe.project_layer_plain(x, w, mode, 0)
        if mode == "w8a8":
            ws[:4 * B * N].view(torch.int32).view(B, N).copy_(y)
        elif mode == "head":
            ws[:4 * N].view(torch.float32).view(1, N).copy_(y)
        else:
            ws[:8 * B * N].view(torch.float64).view(B, N).copy_(y.double())
        return ws

    tcfg = dataclasses.replace(T, hidden_size=64, n_heads=2, n_kv_heads=1, head_dim=32,
                               intermediate_size=96, n_layers=2, codec_vocab_size=48)
    monkeypatch.setattr(probe, "project_layers", stand_in)
    report = {}
    chip_smoke.check_projections(tcfg, report, torch.device("cpu"), iters=1, lanes=(1,),
                                 check_lanes=(1,))
    chip_smoke.check_head_gemv(tcfg, report, torch.device("cpu"), iters=1)
    out = capsys.readouterr().out
    assert out.count("K1 GEMV projection") == 3 * 4 and "DIFFERS" not in out
    for mode, key in chip_smoke.K1_KEYS.items():
        r = report[key]["projections"]
        assert r["checked_lanes"] == [1] and set(r["times"]) == {"B=1"}
        t = r["times"]["B=1"]
        assert t["bound_ms"] > 0 and t["weight_bytes"] > 0 and len(t["shapes"]) == 4
        # w8a8's yardstick, torch._int_mm, takes x padded to 17 rows
        assert t["library_ms"] is not None
    head = report["fused_talker_step"]["codec_head"]
    assert head["max_abs_err"] <= 1e-3 and head["bound_ms"] > 0
    assert not any(k.startswith("fused_talker_step_batched") for k in report)


def test_busy_shares_partition_a_chain_of_overlapping_kernels():
    """Under programmatic dependent launch a kernel's interval starts while
    the one before it runs: each kernel is charged from the latest end
    before it, so the shares partition the union of the intervals (and are
    the durations where nothing overlaps)."""
    ev = [dict(cat="kernel", name="resid_rms_kernel", ts=0, dur=10),
          dict(cat="kernel", name="void gemv_i8_kernel(int)", ts=5, dur=15),
          dict(cat="kernel", name="qkv_post_kernel", ts=12, dur=10),
          dict(cat="kernel", name="attn_layer_kernel<bf16, 2>", ts=21, dur=30),
          dict(cat="kernel", name="gemv_bf16_kernel<float>", ts=60, dur=4)]
    groups = (chip_smoke.ATTENTION_PREFIXES, ("gemv_", "gemm_"))
    attention, gemv = chip_smoke.busy_shares(ev, groups)
    assert attention == pytest.approx(0.029) and gemv == pytest.approx(0.014)
    assert chip_smoke.device_busy_ms(ev) == pytest.approx(0.010 + 0.002 + 0.029 + 0.014)
