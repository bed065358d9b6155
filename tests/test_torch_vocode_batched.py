"""Vocoding lanes together at the tiny configuration: kernel K3's plain
version over a group of lanes against the JAX res-block kernel mapped over
lanes (interpret mode), the lane offsets of K3's tile loads, the batched
vocoder against the JAX package's ``vocode_batched``, and
``synthesize_batch``'s grouped vocoding against each lane's
``decode_codes``."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu import pipeline as jpipeline
from qwen3tts_tpu.config import SamplingConfig, tiny_pipeline_config
from qwen3tts_tpu.models import vocoder as jvoc
from qwen3tts_tpu.ops.pallas_vocoder import fused_res_block as jres
from qwen3tts_tpu_torch import pipeline as ppl
from qwen3tts_tpu_torch.models import vocoder as pvoc
from qwen3tts_tpu_torch.ops.fused_vocoder import (fused_res_block, res_block_plain,
                                                  res_block_plan)

CFG = tiny_pipeline_config()
CFG = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant="int8"))
VCFG = CFG.vocoder
SPF = VCFG.samples_per_frame
# the vocoder's tolerance against JAX (tests/test_torch_vocoder.py): snake
# stages amplify reassociation
RTOL, ATOL = 5e-3, 5e-4
# a lane of a group against the same lane vocoded alone: the
# pre-transformer's masked softmax and value product sum over the group's
# padded length, in another order than the one-lane call, and the snakes
# amplify the last bits (up to 3.4e-4 at these weights on the CPU): the
# cause of the tolerance against JAX, so the same tolerance. A lane that
# read another lane's rows or its own padding would move by O(0.1).
LANE_RTOL, LANE_ATOL = RTOL, ATOL


def _res_inputs(seed, B, T, C):
    rng = np.random.default_rng(seed)
    sc = 1.0 / np.sqrt(7 * C)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    return f(B, T, C), (f(7, C, C) * sc, f(C) * 0.1, f(C) * 0.1, f(C) * 0.1,
                        f(1, C, C) * sc * 2, f(C) * 0.1, f(C) * 0.1, f(C) * 0.1)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_res_block_lanes_match_jax_kernel(dilation):
    """Three lanes of T = 192, C = 16 through K3's plain version against the
    JAX kernel mapped over the lanes (64-row tiles, interpret mode), within
    2e-5 as tests/test_torch_vocoder.py allows; each lane equals the plain
    version on that lane alone."""
    x, ws = _res_inputs(10 + dilation, 3, 192, 16)
    wj = tuple(map(jnp.asarray, ws))
    want = np.stack([np.asarray(jres(jnp.asarray(x[b]), *wj, dilation=dilation, tile=64,
                                     interpret=True)) for b in range(3)])
    wt = tuple(map(torch.from_numpy, ws))
    got = fused_res_block(torch.from_numpy(x), *wt, dilation=dilation)
    assert got.shape == (3, 192, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), res_block_plain(torch.from_numpy(x[b]), *wt,
                                            dilation=dilation).numpy())


def _tile_windows(x, T, C, d, lane):
    """The rows K3's blocks of one lane load, as csrc/res_block.cu addresses
    them: over the group's flat buffer x [B * T * C], block (row tile i, lane)
    reads rows t in [t0 - halo, t0 + 128) at (lane * T + t) * C, and zeros
    where t < 0 or t >= T. Returns each row tile's window [128 + halo, C]."""
    _, tm, _, row_tiles, _, halo = res_block_plan(T, C, d)
    out = []
    for i in range(row_tiles):
        t = np.arange(i * tm - halo, i * tm + tm)
        ok = (t >= 0) & (t < T)
        idx = (lane * T + np.clip(t, 0, T - 1))[:, None] * C + np.arange(C)[None, :]
        out.append(np.where(ok[:, None], x[idx], 0.0))
    return out


@pytest.mark.parametrize("C, T, d", [(16, 200, 9), (96, 130, 3)])
def test_lane_halo_reads_zeros_not_the_previous_lane(C, T, d):
    """A lane whose last rows are large does not leak into the next lane:
    the next lane's first window holds zeros in its 6 d halo rows (its
    causal padding), where rows flattened across lanes would hold the
    previous lane's tail; the windows equal the one-lane call's windows of
    that lane, and the plain version of the group equals each lane's own."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, T, C)).astype(np.float32)
    x[0, -6 * d:] = 100.0
    flat = x.reshape(-1)
    halo = 6 * d
    for lane in range(1, 3):
        wins = _tile_windows(flat, T, C, d, lane)
        assert not wins[0][:halo].any()
        alone = _tile_windows(x[lane].reshape(-1), T, C, d, 0)
        for a, b in zip(wins, alone):
            np.testing.assert_array_equal(a, b)
    # the bug this guards against: a group read as B * T rows, where the
    # window of lane 1's row 0 (row T) holds lane 0's last row
    t0 = (T // 128) * 128
    flattened = _tile_windows(flat, 3 * T, C, d, 0)[T // 128]
    assert (flattened[T - 1 - (t0 - halo)] == 100.0).all()
    _, ws = _res_inputs(5, 1, T, C)
    wt = tuple(map(torch.from_numpy, ws))
    y = res_block_plain(torch.from_numpy(x), *wt, dilation=d)
    y1 = res_block_plain(torch.from_numpy(x[1]), *wt, dilation=d)
    np.testing.assert_array_equal(y[1].numpy(), y1.numpy())


def _jax_tree(tree):
    """The port's vocoder params as the JAX package's NamedTuples (the same
    names and fields), leaf for leaf."""
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        return getattr(jvoc, type(tree).__name__)(*(_jax_tree(getattr(tree, f))
                                                    for f in fields))
    if isinstance(tree, tuple):
        return tuple(_jax_tree(t) for t in tree)
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def voc():
    """Seeded vocoder weights (drawn by the port: drawing them with JAX
    compiles a program per shape) in both packages, and three lanes of
    codes."""
    port = pvoc.init_vocoder_params(torch.Generator().manual_seed(3), VCFG)
    params = _jax_tree(port)
    rng = np.random.default_rng(7)
    n = [7, 11, 4]
    codes = np.zeros((3, 16, 16), np.int32)
    for b, k in enumerate(n):
        codes[b, :k] = rng.integers(0, VCFG.codebook_size, size=(k, 16))
    codes[2, 4:11] = rng.integers(0, VCFG.codebook_size, size=(7, 16))  # padding rows
    return params, port, codes, n


def test_vocode_groups_respect_the_budget(monkeypatch):
    """Contiguous groups cover every lane once; each holds at most
    VOCODE_MAX_LANES lanes and lanes x its longest lane within
    VOCODE_MAX_LANE_FRAMES, except a lane longer than the budget, which is
    vocoded alone."""
    n = [5, 9, 2, 30, 7, 7, 7, 1, 0]
    for max_lanes, budget in ((2, 64), (4, 20), (64, 8192), (1, 1)):
        monkeypatch.setattr(ppl, "VOCODE_MAX_LANES", max_lanes)
        monkeypatch.setattr(ppl, "VOCODE_MAX_LANE_FRAMES", budget)
        groups = ppl.vocode_groups(n)
        assert [b for g0, g1 in groups for b in range(g0, g1)] == list(range(len(n)))
        for g0, g1 in groups:
            longest = max(max(k, 1) for k in n[g0:g1])
            assert g1 - g0 <= max_lanes
            assert (g1 - g0) * longest <= budget or g1 - g0 == 1
        if max_lanes == 64:
            assert groups == [(0, 9)]
    assert ppl.vocode_groups([]) == []


def test_vocode_batched_matches_jax(voc, monkeypatch):
    """Three lanes of 7, 11 and 4 frames, padded rows after each lane's
    frames, with the group size forced to 2 lanes (a group boundary inside
    the batch): each lane's valid samples within the vocoder tolerance of
    the JAX package's vocode_batched; every group yielded once, in order,
    from the host."""
    params, port, codes, n = voc
    want = np.asarray(jpipeline.vocode_batched(params, VCFG, jnp.asarray(codes),
                                               jnp.asarray(n, np.int32)))
    monkeypatch.setattr(ppl, "VOCODE_MAX_LANES", 2)
    groups = list(ppl.vocode_batched_groups(port, VCFG, codes, n))
    assert [(g0, g1) for g0, g1, _ in groups] == [(0, 2), (2, 3)]
    assert all(isinstance(a, np.ndarray) for _, _, a in groups)
    assert groups[0][2].shape == (2, 11 * SPF) and groups[1][2].shape == (1, 4 * SPF)
    got = ppl.vocode_batched(port, VCFG, codes, n)
    assert got.shape == (3, 11 * SPF)
    for b, k in enumerate(n):
        np.testing.assert_allclose(got[b, :k * SPF], want[b, :k * SPF], rtol=RTOL, atol=ATOL,
                                   err_msg=f"lane {b}")
        assert not got[b, k * SPF:].any()


def test_lanes_one_by_one_equal_the_group(voc, monkeypatch):
    """Each lane vocoded alone on exactly its frames equals its valid
    samples in the group within LANE_RTOL/LANE_ATOL, in one group of three
    and in groups of two; the longest lane of a group (no padding) bit for
    bit."""
    _, port, codes, n = voc
    for lanes in (64, 2):
        monkeypatch.setattr(ppl, "VOCODE_MAX_LANES", lanes)
        got = ppl.vocode_batched(port, VCFG, codes, n)
        for b, k in enumerate(n):
            alone = pvoc.vocoder_decode(port, VCFG, torch.from_numpy(codes[b, :k]), k).numpy()
            np.testing.assert_allclose(got[b, :k * SPF], alone, rtol=LANE_RTOL,
                                       atol=LANE_ATOL, err_msg=f"lane {b}, groups of {lanes}")
        np.testing.assert_array_equal(
            got[1, :n[1] * SPF],
            pvoc.vocoder_decode(port, VCFG, torch.from_numpy(codes[1, :n[1]]), n[1]).numpy())


def test_padding_changes_no_valid_sample(voc):
    """The stack is causal: a lane padded with 5 more frames of other codes
    gives the valid samples of the lane on its own frames (its
    pre-transformer keys masked at its frame count) within
    LANE_RTOL/LANE_ATOL, where codes read from the padding would move them
    by O(0.1)."""
    _, port, codes, n = voc
    c = np.concatenate([codes[0, :7], codes[1, :5]])[None]
    padded = pvoc.vocoder_decode(port, VCFG, torch.from_numpy(c), [7]).numpy()[0]
    alone = pvoc.vocoder_decode(port, VCFG, torch.from_numpy(codes[0, :7]), 7).numpy()
    np.testing.assert_allclose(padded[:7 * SPF], alone, rtol=LANE_RTOL, atol=LANE_ATOL)


TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request."]


@pytest.fixture(scope="module")
def tts():
    """The port's int8 pipeline on its own seeded synthetic weights (the
    test holds it against itself)."""
    import chip_smoke

    return chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"), seed=11)


def test_synthesize_batch_audio_equals_each_lanes_decode(tts, monkeypatch):
    """synthesize_batch vocodes its lanes together (here in groups of 2):
    each lane's audio equals decode_codes of its own codes within
    LANE_RTOL/LANE_ATOL, and every lane's t_decode_ms is the vocoder wall
    / B."""
    monkeypatch.setattr(ppl, "VOCODE_MAX_LANES", 2)
    calls = []
    real = ppl.vocode_batched

    def spy(*a):
        calls.append(list(a[3]))
        return real(*a)

    monkeypatch.setattr(ppl, "vocode_batched", spy)
    rs = tts.synthesize_batch(TEXTS, SamplingConfig(max_audio_tokens=6, seed=5))
    live = [r for r in rs if r.n_frames]
    assert len(live) >= 2 and calls == [[r.n_frames for r in live]]
    assert len({r.timings.t_decode_ms for r in live}) == 1
    for i, r in enumerate(rs):
        if not r.n_frames:
            continue
        assert r.success and r.audio.shape == (r.n_frames * SPF,)
        np.testing.assert_allclose(r.audio, tts.decode_codes(r.codes), rtol=LANE_RTOL,
                                   atol=LANE_ATOL, err_msg=f"lane {i}")


def test_chip_smoke_res_block_lanes_at_tiny_config():
    """chip_smoke's K3-over-lanes check at the tiny configuration on the CPU
    (plain versions): every width's group equal to each lane's one-lane call
    (0.0) and to the plain version; launches and device times are the
    card's (None here)."""
    import chip_smoke

    tts = chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"))
    report = {}
    chip_smoke.check_res_block_lanes(tts, report, iters=1, lanes=3, frames=2)
    widths = report["fused_res_block"]["lanes"]
    assert sorted(widths) == sorted({b.convt_w.shape[-1] for b in tts.vocoder_params.dec_blocks})
    for w in widths.values():
        assert w["lanes"] == 3 and w["lane_max_abs_err"] == 0.0
        assert w["launches_per_res_block"] is None and w["device_ms"] is None
