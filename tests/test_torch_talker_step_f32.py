"""The float32 tier (RuntimeConfig(dtype="float32")) on the port's default
route at the tiny configuration: kernels K1 and K5 in their "f32" weight
mode (float32 blocks, a float32 cache and a float32 codec head) and K2 and
K6 with float32 heads and embeddings, their plain versions against the JAX
package's Pallas kernels in interpret mode; then Qwen3TTS with the default
flags, which must take the talker kernel in "f32" and give the JAX fused
float32 loop's greedy codes. The same numpy inputs; weights cross over
through io/from_jax.py."""

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
from qwen3tts_tpu.ops.pallas_code_predictor import fused_predict_codes as jfused
from qwen3tts_tpu.ops.pallas_code_predictor_batched import (
    fused_predict_codes_batched as jfused_batched)
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu.text.bpe import synthetic_tokenizer
from qwen3tts_tpu_torch.config import SamplingConfig
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops.fused_code_predictor import fused_predict_codes
from qwen3tts_tpu_torch.ops.fused_code_predictor_batched import fused_predict_codes_batched
from qwen3tts_tpu_torch.ops.fused_talker_step import (fused_talker_step,
                                                      fused_talker_step_batched, weight_mode)
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.runtime import decode_loop as pdl
from qwen3tts_tpu_torch.tools import goldens

CFG = tiny_pipeline_config()
# the tiny config computes in float32; quant=None keeps its blocks plain
CFG = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant=None))
TCFG, CCFG = CFG.talker, CFG.code_predictor
assert CFG.runtime.dtype == "float32"
C, B = 32, 3
# Float32 throughout: the versions differ only in the order and precision
# of their sums (the port sums in float64 and rounds once); the hidden
# state and the cache rows agree within 1e-5, the logits (a float32 dot of
# H = 64 terms on each side) within 1e-4.
TOL_HIDDEN, TOL_LOGITS = 1e-5, 1e-4
TEXT = "Hello there, port."


@pytest.fixture(scope="module")
def talker():
    params = jtalker.init_talker_params(jax.random.PRNGKey(5), TCFG, jnp.float32)
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(21)
    kv = (rng.normal(size=(B, TCFG.n_layers, 2, TCFG.n_kv_heads, C, TCFG.head_dim)) * 0.5
          ).astype(np.float32)
    x = rng.normal(size=(B, TCFG.hidden_size)).astype(np.float32)
    return params, port, kv, x


def test_float32_blocks_take_the_f32_mode(talker):
    """Plain float32 projections are the kernels' "f32" mode (the JAX
    package's "bf16" mode dots at the weights' dtype), with a float32 cache
    and head."""
    params, port, *_ = talker
    assert weight_mode(port.blocks) == "f32"
    assert jpts._weight_mode(params.blocks, "w8a8") == "bf16"
    assert port.codec_head.dtype == torch.float32 and port.blocks.wqkv.dtype == torch.float32


@pytest.mark.parametrize("n_past", [0, 19])
def test_k1_f32_matches_jax(talker, n_past):
    """K1's plain version in "f32" (float32 blocks, cache, head): hidden and
    the whole cache within 1e-5, logits within 1e-4 of JAX
    fused_talker_step in interpret mode."""
    params, port, kv, x = talker
    hid_j, logits_j, kv_j = jpts.fused_talker_step(
        params.blocks, TCFG, jnp.asarray(x[0]), jnp.int32(n_past), jnp.asarray(kv[0]),
        output_norm=params.output_norm, codec_head=params.codec_head, interpret=True)
    kv_t = torch.from_numpy(kv[0].copy())
    out = fused_talker_step(port.blocks, TCFG, torch.from_numpy(x[0]), n_past, kv_t,
                            output_norm=port.output_norm, codec_head=port.codec_head)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid_j), rtol=TOL_HIDDEN,
                               atol=TOL_HIDDEN)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(logits_j), rtol=TOL_LOGITS,
                               atol=TOL_LOGITS)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL_HIDDEN,
                               atol=TOL_HIDDEN)


@pytest.mark.parametrize("n_past", [0, 19])
def test_k5_f32_matches_jax(talker, n_past):
    """K5's plain version in "f32" for 3 lanes: hidden and the whole cache
    within 1e-5, logits within 1e-4 of JAX fused_talker_step_batched in
    interpret mode (batch-major)."""
    params, port, kv, x = talker
    hid_j, logits_j, kv_j = jpts.fused_talker_step_batched(
        params.blocks, TCFG, jnp.asarray(x), jnp.int32(n_past), jnp.asarray(kv),
        output_norm=params.output_norm, codec_head=params.codec_head, chunk=8,
        interpret=True)
    kv_t = torch.from_numpy(kv.copy())
    out = fused_talker_step_batched(port.blocks, TCFG, torch.from_numpy(x), n_past, kv_t,
                                    output_norm=port.output_norm, codec_head=port.codec_head)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid_j), rtol=TOL_HIDDEN,
                               atol=TOL_HIDDEN)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(logits_j), rtol=TOL_LOGITS,
                               atol=TOL_LOGITS)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL_HIDDEN,
                               atol=TOL_HIDDEN)


@pytest.fixture(scope="module")
def predictor():
    """The float32 tier's int8 code predictor: int8 blocks, float32 heads
    and embedding tables (the Pallas kernels' operands)."""
    params = jcp.init_code_predictor_params(jax.random.PRNGKey(9), CCFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    rng = np.random.default_rng(33)
    th = rng.normal(size=(2, CCFG.hidden_size)).astype(np.float32)
    cb0 = rng.normal(size=(2, CCFG.hidden_size)).astype(np.float32)
    return qparams, port, th, cb0


SAMPLED = dict(greedy=False, use_top_p=False, temperature=0.9, top_p=1.0, top_k=50)


def test_k2_float32_embeddings_match_jax(predictor):
    """K2's plain version with float32 heads and embeddings: codes equal to
    JAX fused_predict_codes (interpret) with the same seed."""
    qparams, port, th, cb0 = predictor
    assert port.embds.dtype == torch.float32 and port.heads.dtype == torch.float32
    codes_j, _ = jfused(qparams, CCFG, jnp.asarray(th[0]), jnp.asarray(cb0[0]),
                        jnp.int32(4242), mode="w8a8", interpret=True, **SAMPLED)
    codes_t, _ = fused_predict_codes(port, CCFG, torch.from_numpy(th[0]),
                                     torch.from_numpy(cb0[0]), 4242, **SAMPLED)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))


def test_k6_float32_embeddings_match_jax(predictor):
    """K6's plain version with float32 heads, embeddings and K/V scratch:
    codes equal lane for lane to JAX fused_predict_codes_batched
    (interpret) with the same per-lane seeds."""
    qparams, port, th, cb0 = predictor
    seeds = [31, -900001]
    codes_j, _ = jfused_batched(qparams, CCFG, jnp.asarray(th), jnp.asarray(cb0),
                                jnp.asarray(seeds, jnp.int32), mode="w8a8", interpret=True,
                                **SAMPLED)
    codes_t, _ = fused_predict_codes_batched(port, CCFG, torch.from_numpy(th),
                                             torch.from_numpy(cb0), seeds, **SAMPLED)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))


@pytest.fixture(scope="module")
def float32_tier():
    """The float32 tier (quant=None) on the same JAX weights in both
    packages, the port with the default flags."""
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    vp = jvoc.init_vocoder_params(jax.random.PRNGKey(13), CFG.vocoder, jnp.float32)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    tts = Qwen3TTS(CFG, device="cpu")
    tts.set_params(params_from_jax(to_np(tp)), params_from_jax(to_np(cp)),
                   params_from_jax(to_np(vp)))
    return (tp, cp), tts


def test_default_flags_take_the_f32_talker_kernel(float32_tier):
    """"auto" resolves to the talker kernel on float32 blocks (the JAX
    package's _resolve_fused_talker) and to predict_codes for the code
    predictor (its blocks are not int8); the parity tools' route reports
    the "f32" mode."""
    _, tts = float32_tier
    assert tts.fused == dict(fused_talker="auto", fused_cp="auto")
    assert pdl.resolve_fused_talker("auto", tts.talker_params) is True
    assert pdl.resolve_fused_cp("auto", tts.cp_params) is False
    route = goldens.route(tts)
    assert route["dtype"] == "float32" and route["fused_talker"] is True
    assert route["kernel_weight_mode"] == "f32" and route["fused_cp"] is False


def test_default_route_greedy_codes_match_jax_fused_float32_loop(float32_tier):
    """Greedy synthesize codes EQUAL to the JAX loop with the fused talker
    kernel over float32 weights (interpret mode) and the XLA code
    predictor, the same text and key as tests/test_torch_slice.py; the
    per-frame hidden states within 1e-4."""
    (tp, cp), tts = float32_tier
    tokens = synthetic_tokenizer(TCFG.text_vocab_size).encode_for_tts(TEXT)
    padded = np.zeros((32,), np.int32)
    padded[:len(tokens)] = tokens
    gen = jdl.generate_from_tokens(
        tp, cp, jnp.asarray(padded), jnp.int32(len(tokens)),
        jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(TCFG.english_language_id),
        jax.random.PRNGKey(0), talker_cfg=TCFG, cp_cfg=CCFG, max_frames=6, kv_capacity=32,
        temperature=0.0, top_k=50, repetition_penalty=1.05, fused_cp=False,
        fused_talker=True)
    n = int(gen.n_frames)
    r = tts.synthesize(TEXT, SamplingConfig(temperature=0.0, max_audio_tokens=6))
    assert r.success, r.error_msg
    assert r.n_frames == n > 0
    np.testing.assert_array_equal(r.codes, np.asarray(gen.codes)[:n])
    np.testing.assert_allclose(r.hidden_states, np.asarray(gen.hidden)[:n], rtol=1e-4,
                               atol=1e-4)


def test_chip_smoke_float32_phases_at_tiny_config(capsys):
    """chip_smoke's float32 kernel checks (check_float32_tier: K1/K5 in
    "f32" and in w8a8 over a float32 cache, K2/K6 and decode attention over
    float32 operands) and its serve_f32 lines at the tiny configuration on
    the CPU, where the plain versions run: every gate holds, each kernel's
    float32 figures land in its entry, and the counts stay 0."""
    import chip_smoke

    pipes = chip_smoke.float32_pipelines(tiny_pipeline_config(), torch.device("cpu"))
    assert {p.dtype for p in pipes.values()} == {torch.float32}
    report = {}
    chip_smoke.check_float32_tier(pipes, report, iters=1,
                                  positions=((32, (3, 20)), (4352, (300, 4000))),
                                  shapes=((2, 32, (3,)), (3, 32, (5, 20))),
                                  attention=(2, 1280, 1000))
    assert {"fused_talker_step[f32]", "fused_talker_step_batched[f32]",
            "fused_talker_step[kv_f32]", "fused_talker_step_batched[kv_f32]"} <= set(report)
    for name in ("fused_predict_codes", "fused_predict_codes_batched", "decode_attention"):
        assert report[name]["f32"]["bound_ms"] > 0
    small = {q: dict(spec, request=(spec["request"][0], dict(spec["request"][1],
                                                              max_audio_tokens=3)),
                     batch=(3, dict(spec["batch"][1], max_audio_tokens=3)),
                     unfused=(spec["unfused"][0], dict(spec["unfused"][1], max_audio_tokens=3)))
             for q, spec in chip_smoke.F32_SERVE.items()}
    check = chip_smoke.check_launches
    chip_smoke.check_launches = lambda *a, **k: None     # no launch is counted on the CPU
    try:
        runs = chip_smoke.serve_f32(pipes, "cpu", specs=small, min_frames_per_lane=1)
    finally:
        chip_smoke.check_launches = check
    assert len(runs) == 6 and all(set(r.values()) == {0} for r in runs)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("serve_f32 ")]
    assert len(lines) == 6 and all('"kv_capacity": 1280' in l for l in lines[2::3])


def test_chip_smoke_parity_default_at_tiny_config(tmp_path, capsys):
    """chip_smoke.parity_default at the tiny config on the CPU: the default
    flags' route (the talker kernel's "f32" mode, predict_codes) meets every
    verify_stage bar and compare_e2e gate against the JAX package's goldens
    of the tiny fixture (the JAX make_goldens tool, as
    tests/test_torch_goldens.py runs it); plain versions, so the counts
    stay 0."""
    import json

    import chip_smoke
    from qwen3tts_tpu_torch.tools import hf_fixture
    from test_torch_goldens import FRAMES, run_jax_tool

    fx, jg = str(tmp_path / "fixture"), str(tmp_path / "jax")
    hf_fixture.write_checkpoint_dir(fx, tiny_pipeline_config(), 0)
    rc, _ = run_jax_tool("make_goldens", ["--tiny", "--model", fx, "--max-frames", str(FRAMES),
                                          "--out", jg])
    assert rc == 0
    with open(f"{jg}/PROVENANCE.json", "w") as f:
        json.dump({"fixture": {"seed": 0}}, f)
    runs = chip_smoke.parity_default(tiny_pipeline_config(), torch.device("cpu"), "cpu", fx,
                                     goldens_dir=jg)
    assert len(runs) == 2 and all(set(r.values()) == {0} for r in runs)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("parity_fullsize {")]
    assert all(l["route_name"] == "default" for l in lines)
    route = next(l for l in lines if l["what"] == "route")["route"]
    assert route["fused_talker"] is True and route["kernel_weight_mode"] == "f32"
    assert all(l["ok"] for l in lines if l["what"] == "verify_stage")
    assert next(l for l in lines if l["what"] == "compare_e2e")["pass"]
