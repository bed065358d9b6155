"""The lane-major batched talker step (K5 over a [L, 2, Hkv, C, B, D] cache,
``fused_talker_step_batched(kv_layout="lane")``) and the batched loop on it
(``generate_from_tokens_batched(kv_layout="lane")``,
``Qwen3TTS(batched_kv_layout="lane")``) at the tiny int8 configuration:
the plain version against the JAX package's lane-major Pallas kernel in
interpret mode and against the port's batch-major step, the loop's codes
against the JAX batched loop under QWEN3TTS_BATCHED_KV_LAYOUT=lane, and the
operands and tiers the layout refuses."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_continuous_common import one_torch_thread  # noqa: F401 - fixture by name

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.models import vocoder as jvoc
from qwen3tts_tpu.ops import pallas_talker_step as jpts
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu_torch.config import SamplingConfig
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops import prng
from qwen3tts_tpu_torch.ops.fused_talker_step import (fused_talker_step_batched,
                                                      lane_major_view, lane_map_shape,
                                                      to_lane_major)
from qwen3tts_tpu_torch.ops.kv_quant import quantize_cache
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

CFG = tiny_pipeline_config()
CFG = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant="int8"))
TCFG, CCFG = CFG.talker, CFG.code_predictor
B, C = 4, 32
# the JAX package's own bars for its lane-major kernel
# (tests/test_fused_talker.py:279-317): hidden and rows 2e-4, logits 2e-3
TOL, TOL_LOGITS = 2e-4, 2e-3
# the texts tests/test_torch_batch_slice.py serves
TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request."]


@pytest.fixture(scope="module")
def step():
    params = jtalker.init_talker_params(jax.random.PRNGKey(5), TCFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    rng = np.random.default_rng(29)
    kv = (rng.normal(size=(B, TCFG.n_layers, 2, TCFG.n_kv_heads, C, TCFG.head_dim)) * 0.5
          ).astype(np.float32)
    x = rng.normal(size=(B, TCFG.hidden_size)).astype(np.float32)
    return qparams, port, kv, x


def _lane(kv):
    """[B, L, 2, Hkv, C, D] -> [L, 2, Hkv, C, B, D] (numpy)."""
    return np.ascontiguousarray(kv.transpose(1, 2, 3, 4, 0, 5))


@pytest.mark.parametrize("head", [True, False], ids=["head", "no_head"])
@pytest.mark.parametrize("n_past", [0, 7, 31])
def test_lane_step_matches_jax(step, n_past, head):
    """Hidden (output-normed with the head, the residual without) and the
    whole lane-major cache within 2e-4, logits within 2e-3 of JAX
    fused_talker_step_batched(kv_layout="lane") in interpret mode."""
    qparams, port, kv, x = step
    kvl = _lane(kv)
    heads_j = dict(output_norm=qparams.output_norm, codec_head=qparams.codec_head) if head \
        else {}
    outs = jpts.fused_talker_step_batched(
        qparams.blocks, TCFG, jnp.asarray(x), jnp.int32(n_past), jnp.asarray(kvl),
        mode="w8a8", chunk=8, kv_layout="lane", interpret=True, **heads_j)
    kv_t = torch.from_numpy(kvl.copy())
    heads_t = (dict(output_norm=port.output_norm, codec_head=port.codec_head) if head
               else dict(output_norm=None, codec_head=None))
    out = fused_talker_step_batched(port.blocks, TCFG, torch.from_numpy(x), n_past, kv_t,
                                    kv_layout="lane", **heads_t)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(outs[0]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(outs[-1]), rtol=TOL, atol=TOL)
    if head:
        np.testing.assert_allclose(out.logits.numpy(), np.asarray(outs[1]), rtol=TOL_LOGITS,
                                   atol=TOL_LOGITS)
    else:
        assert out.logits is None and out.cb0 is None


@pytest.mark.parametrize("n_past", [0, 7, 31])
def test_lane_step_equals_batch_step_bit_for_bit(step, n_past):
    """The lane step over the permuted cache equals the batch-major step
    bit for bit: hidden, logits and the written rows (the lane cache read
    back batch-major equals the batch cache)."""
    _, port, kv, x = step
    heads = dict(output_norm=port.output_norm, codec_head=port.codec_head)
    kvb = torch.from_numpy(kv.copy())
    kvl = to_lane_major(torch.from_numpy(kv.copy()))
    assert tuple(kvl.shape) == (TCFG.n_layers, 2, TCFG.n_kv_heads, C, B, TCFG.head_dim)
    b = fused_talker_step_batched(port.blocks, TCFG, torch.from_numpy(x), n_past, kvb, **heads)
    lane = fused_talker_step_batched(port.blocks, TCFG, torch.from_numpy(x), n_past, kvl,
                                     kv_layout="lane", **heads)
    assert torch.equal(lane.hidden, b.hidden) and torch.equal(lane.logits, b.logits)
    assert torch.equal(lane_major_view(kvl), kvb)


def test_lane_step_refuses_what_jax_asserts(step):
    """The lane layout takes no int8 (q, scale) pair, no seen/seeds (no
    in-kernel cb0) and no start: ValueError with the JAX assert's reason;
    an unknown layout raises too."""
    _, port, kv, x = step
    heads = dict(output_norm=port.output_norm, codec_head=port.codec_head)
    xt = torch.from_numpy(x)
    kvl = to_lane_major(torch.from_numpy(kv.copy()))
    pair = quantize_cache(torch.from_numpy(kv.copy()).to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="int8 KV requires the batch-major layout"):
        fused_talker_step_batched(port.blocks, TCFG, xt, 3, pair, kv_layout="lane", **heads)
    with pytest.raises(ValueError, match="cb0 sampling needs codec_head and the batch-major"):
        fused_talker_step_batched(port.blocks, TCFG, xt, 3, kvl, kv_layout="lane",
                                  seen=torch.zeros((B, TCFG.codec_vocab_size), dtype=torch.int8),
                                  seeds=torch.zeros((B,), dtype=torch.int32), **heads)
    with pytest.raises(ValueError, match="per-lane start .* needs the batch-major layout"):
        fused_talker_step_batched(port.blocks, TCFG, xt, 3, kvl, kv_layout="lane",
                                  start=torch.zeros((B,), dtype=torch.int32), **heads)
    with pytest.raises(ValueError, match="kv_layout must be one of"):
        fused_talker_step_batched(port.blocks, TCFG, xt, 3, kvl, kv_layout="heads", **heads)


def _box(kv, shape, c):
    """What a tensor copy of the map `shape` (lane_map_shape: dims, byte
    strides, box {D, 1, tile, 1, 1}) at coordinates c, innermost first,
    brings from the lane-major cache kv, as the TMA unit reads it: [tile,
    D], rows past the map's dims zeros and never read."""
    (D, _, rows, _, _), strides, (_, _, tile, _, _) = shape
    flat, step = kv.reshape(-1), [s // kv.element_size() for s in strides]
    out = torch.zeros((tile, D), dtype=kv.dtype)
    for r in range(min(tile, rows - c[2])):
        at = c[1] * step[0] + (c[2] + r) * step[1] + c[3] * step[2] + c[4] * step[3]
        out[r] = flat[at:at + D]
    return out


@pytest.mark.parametrize("kv_f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("lanes, rows", [(1, 1), (3, 67), (13, 40)])
def test_lane_map_box_is_a_lanes_rows(lanes, rows, kv_f32):
    """The tensor map through which K5's attention reads the lane-major
    cache (lane_map_shape, the mirror of csrc/talker_step_batched.cu's,
    which chip_smoke's split_rules holds to it on the card): the box at
    (0, b, r0, h, 2 l + kv) is lane b's rows [r0, r0 + tile) of (layer l,
    K or V, head h), the rows of the batch-major view, for every tile of
    every lane, head and plane; rows from n_past + 1 on arrive as zeros
    (the cache holds NaN there, which no box reads)."""
    L, Hkv, C, D = 2, 2, 70, 128
    dtype = torch.float32 if kv_f32 else torch.bfloat16
    g = torch.Generator().manual_seed(3)
    kv = torch.randn((L, 2, Hkv, C, lanes, D), generator=g).to(dtype)
    kv[:, :, :, rows:] = float("nan")
    shape, tile = lane_map_shape(L, Hkv, C, lanes, D, rows, kv_f32), 32 if kv_f32 else 64
    assert shape[0] == (D, lanes, rows, Hkv, 2 * L) and shape[2] == (D, 1, tile, 1, 1)
    view = lane_major_view(kv)
    for l, half, h, b in np.ndindex(L, 2, Hkv, lanes):
        for r0 in range(0, rows, tile):
            box = _box(kv, shape, (0, b, r0, h, 2 * l + half))
            n = min(tile, rows - r0)
            assert torch.equal(box[:n], view[b, l, half, h, r0:r0 + n])
            assert not box[n:].any()


@pytest.fixture(scope="module")
def both():
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    vp = jvoc.init_vocoder_params(jax.random.PRNGKey(13), CFG.vocoder, jnp.float32)
    tp = tp._replace(blocks=quantize_block_params(tp.blocks))
    cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    tts = Qwen3TTS(CFG, device="cpu", batched_kv_layout="lane")
    tts.set_params(params_from_jax(to_np(tp)), params_from_jax(to_np(cp)),
                   params_from_jax(to_np(vp)))
    return (tp, cp), tts


def _tokens(tts, texts):
    fitted = [tts._fit_tokens(tts.tokenizer.encode_for_tts(t)) for t in texts]
    Tb = max(p.shape[0] for p, _ in fitted)
    tokens = np.zeros((len(texts), Tb), np.int64)
    for i, (p, _) in enumerate(fitted):
        tokens[i, : p.shape[0]] = p
    return tokens, [n for _, n in fitted]


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_lane_loop_matches_jax_lane_loop(both, monkeypatch, sampling):
    """synthesize_batch with batched_kv_layout="lane" (greedy; default
    sampling with seed 5): codes EQUAL lane for lane to the JAX batched
    fused loop under QWEN3TTS_BATCHED_KV_LAYOUT=lane (its lane-major kernel
    in interpret mode, cb0 drawn by its XLA sampler from the kernel's
    logits, frame 0 too). JAX reads the variable while it traces, so its
    jit caches are cleared before and after."""
    (tp, cp), tts = both
    tokens, n_tok = _tokens(tts, TEXTS)
    n = len(TEXTS)
    seed, temp = (0, 0.0) if sampling == "greedy" else (5, 0.9)
    params = SamplingConfig(temperature=temp, max_audio_tokens=4, seed=seed)
    max_frames, kv_capacity = tts._frame_budget(params)
    monkeypatch.setenv("QWEN3TTS_BATCHED_KV_LAYOUT", "lane")
    jax.clear_caches()
    try:
        gen = jdl._generate_batched_fused(
            tp, cp, jnp.asarray(tokens, jnp.int32), jnp.asarray(n_tok, jnp.int32),
            jnp.zeros((n, TCFG.hidden_size), jnp.float32),
            jnp.full((n,), TCFG.english_language_id, jnp.int32),
            jax.random.split(jax.random.PRNGKey(seed), n), talker_cfg=TCFG, cp_cfg=CCFG,
            max_frames=max_frames, kv_capacity=kv_capacity, temperature=temp, top_k=50,
            top_p=1.0, repetition_penalty=1.05, nothink=False, fused_talker=True)
        jax.block_until_ready(gen.codes)
    finally:
        jax.clear_caches()
    counts = dict(fused_talker_step_batched.operand_launches)
    rs = tts.synthesize_batch(TEXTS, params)
    assert sum(r.n_frames for r in rs) > 0
    for b, r in enumerate(rs):
        m = min(int(gen.n_frames[b]), params.max_audio_tokens)
        assert r.n_frames == m, f"lane {b}"
        np.testing.assert_array_equal(r.codes, np.asarray(gen.codes[b])[:m],
                                      err_msg=f"lane {b}")
    # on the CPU the plain version runs: no launch is counted
    assert dict(fused_talker_step_batched.operand_launches) == counts


def test_lane_loop_draws_cb0_outside_the_kernel(both, monkeypatch):
    """On the lane path K5 gets no seen-set or seeds (its logits go to
    sample_cb0, whose keys are the lanes' k_cb0 splits, not K5's seed32),
    and every frame's cache is the lane-major one."""
    _, tts = both
    tokens, n_tok = _tokens(tts, TEXTS[:2])
    calls, draws = [], []
    step = pdl.fused_talker_step_batched
    sample = pdl.sample_cb0

    def spy_step(*a, **kw):
        calls.append((kw.get("kv_layout"), kw.get("seen"), tuple(a[4].shape)))
        return step(*a, **kw)

    def spy_sample(logits, keys, **kw):
        draws.append(np.asarray(keys).dtype)
        return sample(logits, keys, **kw)

    monkeypatch.setattr(pdl, "fused_talker_step_batched", spy_step)
    monkeypatch.setattr(pdl, "sample_cb0", spy_sample)
    pdl.generate_from_tokens_batched(
        tts.talker_params, tts.cp_params, torch.from_numpy(tokens), n_tok,
        torch.zeros((2, TCFG.hidden_size)), [TCFG.english_language_id] * 2,
        np.asarray(prng.split(prng.prng_key(3), 2), np.uint32), talker_cfg=TCFG, cp_cfg=CCFG,
        max_frames=3, kv_capacity=32, temperature=0.9, top_k=50, allow_eos=False,
        kv_layout="lane")
    L, Hkv, D = TCFG.n_layers, TCFG.n_kv_heads, TCFG.head_dim
    assert calls and all(c == ("lane", None, (L, 2, Hkv, 32, 2, D)) for c in calls)
    # frame 0 from the prefill logits, then one draw a frame-set, all from keys
    assert len(draws) == len(calls) + 1 and all(dt == np.uint32 for dt in draws)


@pytest.mark.parametrize("why", ["int8_kv", "unfused"])
def test_lane_kept_batch_major_with_a_logged_reason(both, capsys, why):
    """kv_quant="int8", or the unfused step, keeps the batch-major cache (the
    JAX package's lane_kv condition) and says why once on stderr; the codes
    are then the batch-major loop's."""
    _, tts = both
    tokens, n_tok = _tokens(tts, TEXTS[:2])
    pdl._FALLBACK_LOGGED.clear()
    kw = (dict(kv_quant="int8") if why == "int8_kv"
          else dict(fused_talker=False, fused_cp=False))
    run = lambda layout: pdl.generate_from_tokens_batched(  # noqa: E731
        tts.talker_params, tts.cp_params, torch.from_numpy(tokens), n_tok,
        torch.zeros((2, TCFG.hidden_size)), [TCFG.english_language_id] * 2,
        np.asarray(prng.split(prng.prng_key(0), 2), np.uint32), talker_cfg=TCFG,
        cp_cfg=CCFG, max_frames=3, kv_capacity=32, temperature=0.0, top_k=50,
        kv_layout=layout, **kw)
    lane, again = run("lane"), run("lane")
    err = capsys.readouterr().err
    reason = "int8 KV cache" if why == "int8_kv" else "unfused talker step"
    assert err.count("batched_kv_layout='lane' kept batch-major") == 1 and reason in err
    batch = run("batch")
    assert lane.n_frames == again.n_frames == batch.n_frames
    assert torch.equal(lane.codes, batch.codes)


def test_pipeline_takes_the_layout_and_refuses_others():
    """Qwen3TTS(batched_kv_layout=...) holds the layout beside the fused
    flags (which stay the JAX package's two gates); another value raises."""
    tts = Qwen3TTS(CFG, device="cpu", batched_kv_layout="lane")
    assert tts.batched_kv_layout == "lane"
    assert tts.fused == dict(fused_talker="auto", fused_cp="auto")
    assert Qwen3TTS(CFG, device="cpu").batched_kv_layout == "batch"
    with pytest.raises(ValueError, match="batched_kv_layout"):
        Qwen3TTS(CFG, device="cpu", batched_kv_layout="heads")


def test_chip_smoke_lane_phases_at_tiny_config(capsys):
    """chip_smoke's check_talker_step_lane (2 layers against the plain
    version, all layers against the batch-major step bit for bit) and its
    serve_lane lines at the tiny configuration on the CPU: every gate holds,
    greedy lanes equal batch-major's, and the counts stay 0 (plain
    versions; the launch gates, which need the card, are stood in for)."""
    import chip_smoke

    tts = chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"))
    report = {}
    chip_smoke.check_talker_step_lane({"int8": tts}, report, iters=1,
                                      shapes=((3, 32, 5), (2, 64, 40)))
    r = report[chip_smoke.LANE_ENTRY]
    assert r["max_abs_err"] <= 1e-3 and r["bound_ms"] > 0 and len(r["times"]) == 2
    check = chip_smoke.check_launches
    chip_smoke.check_launches = lambda *a, **k: None
    try:
        runs = chip_smoke.serve_lane({"int8": tts}, "cpu",
                                     batches=((3, dict(temperature=0.0, seed=1)),
                                              (2, dict(seed=3))), frames={"int8": 3})
    finally:
        chip_smoke.check_launches = check
    assert len(runs) == 2 and all(set(r.values()) == {0} for r in runs)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("serve_lane ")]
    assert len(lines) == 2 and '"lanes_equal": 3' in lines[0] and '"gated": true' in lines[0]
