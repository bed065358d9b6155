"""The port's quality tools (``qwen3tts_tpu_torch/tools/check_quant_cosine.py``,
``ab_kv_int8.py``) against the JAX package at the tiny configuration, on
weights carried over by ``io/from_jax.py``:
- the three prefill-logits cosines (int8, q4, q4pure against bf16) equal
  those of the JAX tool's body (``tools/check_quant_cosine.py:47-78``) run
  at the tiny configuration on the same weights, within 1e-4;
- each cache's codes equal JAX ``generate_from_tokens(kv_quant=...)`` /
  ``generate_from_tokens_batched`` with the fused kernels (the Pallas
  kernels in interpret mode), single stream and batched, with the same
  prompt and keys, so the match rates are JAX's;
- a batch the pipeline gives the bf16 cache is refused.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.tools import ab_kv_int8 as ab_tool
from qwen3tts_tpu_torch.tools import check_quant_cosine as cos_tool
from test_torch_serving_tools import import_jax_tools
from torch_continuous_common import one_torch_thread  # noqa: F401 - fixture by name

CFG = tiny_pipeline_config()
TCFG, CCFG = CFG.talker, CFG.code_predictor
# cosines of float64 logits from float32 prefills in two packages
COS_TOL = 1e-4
# the tiny config's text ids end at 500 (its special ids)
TOKEN_HIGH = 500
FUSED = dict(fused_talker=True, fused_cp=True)


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _jax_cosines(jtool, params, tokens, n_tokens):
    """The JAX tool's body (check_quant_cosine.py:47-78) with cfg the tiny
    talker's, the prompt given and the speaker row and KV cache in the
    weights' float32 (XLA on the CPU runs no bf16 x bf16 = f32 product, so
    the tool's bf16 cannot run here)."""
    cfg = TCFG
    args = (jnp.asarray(tokens.astype(np.int32)), jnp.int32(n_tokens),
            jnp.zeros((cfg.hidden_size,), jnp.float32), jnp.int32(2050))

    @jax.jit
    def prefill_logits(p, tokens, n, spk, lang):
        pf = jtalker.build_prefill(p, cfg, tokens, n, spk, lang)
        kv = jtalker.make_kv_cache(cfg, 64, jnp.float32)
        _, logits, _ = jtalker.talker_prefill(p, cfg, pf.prefill_embd, kv)
        return logits

    base = np.asarray(prefill_logits(params, *args), np.float64)
    out = {}
    for name, qfn in (("int8", jtool.quantize_block_params),
                      ("q4", jtool.quantize_block_params_mixed),
                      ("q4pure", jtool.quantize_block_params_w4)):
        got = np.asarray(prefill_logits(params._replace(blocks=qfn(params.blocks)), *args),
                         np.float64)
        out[name] = (float(base @ got / (np.linalg.norm(base) * np.linalg.norm(got) + 1e-12)),
                     bool(base.argmax() == got.argmax()))
    return out


def test_quant_cosines_equal_the_jax_tools():
    """quant_cosines on the JAX tool's weights (PRNGKey(0), in float32)
    carried into the port: each tier's cosine within COS_TOL of the JAX
    tool's body's, the argmax match the same, and the bars read as the JAX
    tool reads them."""
    (jtool,) = import_jax_tools("check_quant_cosine")
    jp = jtalker.init_talker_params(jax.random.PRNGKey(0), TCFG, jnp.float32)
    tokens, n = cos_tool.prompt(range(10, 160, 10))
    want = _jax_cosines(jtool, jp, tokens, n)
    got = cos_tool.quant_cosines(params_from_jax(_to_np(jp)), TCFG, tokens, n)
    assert got.keys() == want.keys() == cos_tool.BARS.keys()
    for tier, (cos, argmax) in want.items():
        assert abs(got[tier]["cosine"] - cos) <= COS_TOL, (tier, got[tier], cos)
        assert got[tier]["argmax_match"] == argmax, tier
    assert cos_tool.failed_bars(got) == [t for t, (c, _) in want.items()
                                         if not c > cos_tool.BARS[t]]


def test_default_prompt_is_the_jax_tools():
    tokens, n = cos_tool.prompt()
    want = np.zeros((32,), np.int32)
    want[:15] = np.arange(100, 1600, 100)
    np.testing.assert_array_equal(tokens, want)
    assert n == 15


@pytest.fixture(scope="module")
def int8_weights():
    """int8 blocks over float32 weights, in both packages."""
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    tp = tp._replace(blocks=quantize_block_params(tp.blocks))
    cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    return (tp, cp), (params_from_jax(_to_np(tp)), params_from_jax(_to_np(cp)))


def _jax_codes(jp, tokens, kv_quant, frames, batch):
    tp, cp = jp
    kw = dict(talker_cfg=TCFG, cp_cfg=CCFG, max_frames=frames,
              kv_capacity=ab_tool.kv_capacity(frames), allow_eos=False, kv_quant=kv_quant,
              **ab_tool.sampling(False), **FUSED)
    if batch:
        g = jdl.generate_from_tokens_batched(
            tp, cp, jnp.asarray(tokens.astype(np.int32)), jnp.full((batch,), 32, jnp.int32),
            jnp.zeros((batch, TCFG.hidden_size), jnp.float32), jnp.full((batch,), 2050, jnp.int32),
            jax.random.split(jax.random.PRNGKey(1), batch), **kw)
    else:
        g = jdl.generate_from_tokens(
            tp, cp, jnp.asarray(tokens.astype(np.int32)), jnp.int32(32),
            jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(2050),
            jax.random.PRNGKey(1), **kw)
    return np.asarray(g.codes)


@pytest.mark.parametrize("batch", [0, 2])
def test_ab_codes_equal_jax_per_cache(int8_weights, batch):
    """ab_kv_int8's codes for the bf16 and the int8 cache each equal JAX's
    fused loop with that kv_quant on the same prompt and keys (prng_key(1),
    or split(prng_key(1), B)); its match rate and frame-exact share are
    then the ones JAX's codes give."""
    jp, (tp, cp) = int8_weights
    frames = 4
    stats, codes = ab_tool.ab_kv_int8(tp, cp, TCFG, CCFG, frames=frames, batch=batch, runs=1,
                                      token_high=TOKEN_HIGH)
    tokens = ab_tool.make_tokens(np.random.default_rng(0), batch, TOKEN_HIGH)
    want = {kvq: _jax_codes(jp, tokens, kvq, frames, batch) for kvq in ab_tool.CACHES}
    for kvq in ab_tool.CACHES:
        np.testing.assert_array_equal(codes[kvq], want[kvq].reshape(codes[kvq].shape),
                                      err_msg=kvq)
        assert stats[kvq]["frames"] == frames * max(batch, 1)
    a, b = want["none"], want["int8"]
    assert stats["code_match_rate"] == float((a == b).mean())
    fa, fb = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    assert stats["frame_exact_share"] == float((fa == fb).all(axis=1).mean())


def test_ab_refuses_a_batch_without_the_int8_cache(int8_weights, capsys):
    """Above INT8_KV_MAX_LANES lanes the pipeline gives the bf16 cache
    (with its message): the A/B raises before running anything rather than
    compare the bf16 cache with itself."""
    _, (tp, cp) = int8_weights
    with pytest.raises(ValueError, match="bf16 cache with itself"):
        ab_tool.ab_kv_int8(tp, cp, TCFG, CCFG, frames=2, batch=65)
    assert "capped at 64" in capsys.readouterr().err


def test_chip_smoke_quality_phase_at_tiny_config(capsys, monkeypatch):
    """chip_smoke's quality phase at the tiny configuration on the CPU (the
    plain versions, so every launch count stays 0 and only the launch
    checks are left out): the cosines beat the bars, both caches emit every
    frame, and one quality line a part."""
    import json

    import torch

    import chip_smoke
    from qwen3tts_tpu_torch import tiny_pipeline_config

    monkeypatch.setattr(chip_smoke, "check_launches", lambda *a, **k: None)
    cfg = tiny_pipeline_config()
    tts = chip_smoke.make_pipeline(cfg, torch.device("cpu"))
    bf16 = chip_smoke.make_pipeline(cfg, torch.device("cpu"), quant=None)
    runs = chip_smoke.quality(tts, bf16, "cpu", dict(prompt=range(10, 160, 10),
                                                     ab=((4, 0), (4, 2))))
    assert len(runs) == 2 and all(set(r.values()) == {0} for r in runs)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("quality {")]
    assert [l["what"] for l in lines] == ["check_quant_cosine", "ab_kv_int8 single stream",
                                          "ab_kv_int8 2 lanes"]
    assert lines[0]["failed"] == [] and lines[0]["int8"]["cosine"] > 0.99
    assert lines[1]["int8"]["frames"] == 4 and lines[2]["none"]["frames"] == 8
