"""The port's random streams (qwen3tts_tpu_torch/ops/prng.py) against
jax.random on the CPU: the threefry2x32 hash in its three forms, keys,
split, bits and the kernels' int32 seeds exactly; the uniform bit patterns
exactly; the Gumbel field within 2 ulp of each float32 log; categorical
equal to jax.random.categorical; chip_smoke's goldens equal to JAX's, and
its prng and sampled-serve phases at the tiny configuration."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

import chip_smoke
from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.ops import sampling as jsampling
from qwen3tts_tpu_torch.ops import prng, sampling

SEEDS = [0, 3, -5, 2 ** 31 - 1, 2 ** 32 + 7]
TINY = np.finfo(np.float32).tiny


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def test_partitionable_threefry_is_pinned():
    """The port hashes the counters (0, i) of split and bits, which is JAX's
    scheme only with jax_threefry_partitionable on (JAX 0.5 onwards): a JAX
    that turns it off must fail here, not draw other codes in silence."""
    assert jax.config.jax_threefry_partitionable is True


def test_threefry2x32_equals_jax_in_every_form():
    """The hash of 64 counter pairs under 8 keys: Python ints, numpy uint32
    and torch int64 equal jax.extend.random.threefry_2x32 word for word."""
    rng = np.random.default_rng(0)
    for _ in range(8):
        k = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)
        x = rng.integers(0, 2 ** 32, size=128, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
        x0, x1 = x[:64], x[64:]
        got_np = np.concatenate(prng.threefry2x32(k[0], k[1], x0, x1))
        tk = torch.from_numpy(k.astype(np.int64))
        got_t = torch.cat(prng.threefry2x32(tk[0], tk[1], torch.from_numpy(x0.astype(np.int64)),
                                            torch.from_numpy(x1.astype(np.int64)))).numpy()
        got_py = [prng.threefry2x32(int(k[0]), int(k[1]), int(a), int(b))
                  for a, b in zip(x0, x1)]
        got_py = np.asarray([w for w, _ in got_py] + [w for _, w in got_py], np.uint32)
        for got in (got_np, got_t, got_py):
            np.testing.assert_array_equal(np.asarray(got, np.uint64), want.astype(np.uint64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_bits_and_seeds_equal_jax(seed):
    """prng_key(seed) == PRNGKey(seed) (x64 off: negative seeds wrap, 2**32 +
    7 keeps its low word); split(key, n) for n = 2, 3, 16, 64, 128 in the
    pair and the lane forms; bits32 and seed32 of every split key."""
    jk = _jkey(seed)
    key = prng.prng_key(seed)
    assert key == tuple(int(v) for v in np.asarray(jk))
    assert prng.key_pair(np.asarray(jk)) == key
    for n in (2, 3, 16, 64, 128):
        want = np.asarray(jax.random.split(jk, n))
        np.testing.assert_array_equal(np.asarray(prng.split(key, n), np.uint32), want)
        np.testing.assert_array_equal(prng.split(np.asarray(jk), n), want)
        bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (), "uint32"))(want))
        seeds = np.asarray(jax.vmap(lambda k: jax.lax.bitcast_convert_type(
            jax.random.bits(k, (), "uint32"), jnp.int32))(want))
        np.testing.assert_array_equal(prng.bits32(want), bits)
        np.testing.assert_array_equal(prng.seed32(want), seeds)
        assert [prng.seed32(prng.key_pair(k)) for k in want[:4]] == seeds[:4].tolist()
    lanes = np.asarray(jax.random.split(jk, 5))
    np.testing.assert_array_equal(prng.split(lanes, 3), np.asarray(
        jax.vmap(lambda k: jax.random.split(k, 3))(jnp.asarray(lanes))))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_exact_and_gumbel_within_two_ulps(seed):
    """Four keys split from the seed's, a [3072] field each: the uniform bit
    patterns equal jax.random.bits', the uniforms equal jax.random.uniform
    on [tiny, 1) exactly, and the Gumbel field within 2 ulp of each float32
    log of jax.random.gumbel (chip_smoke.gumbel_ulps' unit: near 0 the outer
    log cancels, so the output's own ulp is no measure)."""
    keys = np.asarray(jax.random.split(_jkey(seed), 4))
    V = 3072
    bits = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (V,), "uint32")) for k in keys])
    got = prng.uniform_bits(keys, V).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, (bits >> 9) | np.uint32(0x3F800000))
    u = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (V,), jnp.float32,
                                                minval=TINY, maxval=1.0)) for k in keys])
    mine = np.maximum(got.view(np.float32) - np.float32(1.0), np.float32(TINY))
    np.testing.assert_array_equal(mine, u)
    want = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (V,), jnp.float32))
                     for k in keys])
    g = prng.gumbel(keys, V).numpy()
    w = -np.log(u.astype(np.float64))
    unit = (np.spacing(np.abs(want)).astype(np.float64)
            + np.spacing(w.astype(np.float32)).astype(np.float64) / w)
    assert (np.abs(g.astype(np.float64) - want) / unit).max() <= 2.0
    assert chip_smoke.gumbel_ulps(g, u).max() <= chip_smoke.GUMBEL_ULPS


def _masked_rows(seed, n=6, V=3072):
    """n rows of seeded logits on a 0.25 grid (ties), scaled by 1/0.9, with
    top-k 50 and, in every other row, top-p 0.9 masks of the JAX sampler."""
    rng = np.random.default_rng(seed & 0xFFFF)
    l = jnp.asarray((np.round(rng.normal(size=(n, V)) * 10) / 4).astype(np.float32) / 0.9)
    l = jsampling.apply_top_k(l, 50)
    l = jnp.where(jnp.arange(n)[:, None] % 2 == 0, jsampling.apply_top_p(l, 0.9), l)
    return np.array(l)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_and_sample_token_equal_jax(seed):
    """Each row with its own key (split of the seed's): prng.categorical ==
    the vmapped jax.random.categorical on masked rows, and the port's
    sample_token with the keys' Gumbel fields == JAX's sample_token with
    the keys (temperature 0.9, top-k 50, top-p 0.9)."""
    rows = _masked_rows(seed)
    keys = np.asarray(jax.random.split(_jkey(seed), rows.shape[0]))
    want = np.asarray(jax.vmap(jax.random.categorical)(jnp.asarray(keys), jnp.asarray(rows)))
    np.testing.assert_array_equal(prng.categorical(keys, torch.from_numpy(rows)).numpy(), want)
    raw = np.random.default_rng(seed & 0xFFFF).normal(size=rows.shape).astype(np.float32) * 3
    kw = dict(temperature=0.9, top_k=50, top_p=0.9)
    want = np.asarray(jax.vmap(lambda k, r: jsampling.sample_token(k, r, **kw))(
        jnp.asarray(keys), jnp.asarray(raw)))
    got = sampling.sample_token(torch.from_numpy(raw), prng.gumbel(keys, raw.shape[-1]), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chip_smoke_goldens_equal_jax():
    """chip_smoke.PRNG_GOLDENS, which the card's phase holds its bits to,
    equal JAX's: keys, bits32, the split chain of 8 frames with the bits of
    k_cb0 and k_cp, and the first 16 uniform bit patterns of a [3072]
    field."""
    assert sorted(chip_smoke.PRNG_GOLDENS) == sorted(SEEDS)
    for seed, g in chip_smoke.PRNG_GOLDENS.items():
        jk = _jkey(seed)
        assert g["key"] == tuple(int(v) for v in np.asarray(jk))
        assert g["bits32"] == int(jax.random.bits(jk, (), "uint32"))
        k = jk
        for f, row in enumerate(g["frames"]):
            nxt, k_cb0, k_cp = jax.random.split(k, 3)
            want = (*np.asarray(nxt).tolist(), *np.asarray(k_cb0).tolist(),
                    *np.asarray(k_cp).tolist(), int(jax.random.bits(k_cb0, (), "uint32")),
                    int(jax.random.bits(k_cp, (), "uint32")))
            assert tuple(row) == want, f"seed {seed} frame {f}"
            k = nxt
        bits = np.asarray(jax.random.bits(jk, (3072,), "uint32"))[:16]
        assert g["uniform_bits"] == tuple(int(b) for b in (bits >> 9) | np.uint32(0x3F800000))


def test_chip_smoke_prng_phase_on_the_cpu():
    """chip_smoke.check_prng with the CPU as its device: goldens, the torch
    form against the numpy form, the Gumbel field within its tolerance."""
    out = chip_smoke.check_prng(torch.device("cpu"), iters=1)
    assert out["goldens"] == "equal" and out["gumbel_max_ulps"] <= chip_smoke.GUMBEL_ULPS
    assert out["frame_keys_us"] > 0 and out["field"] == [16, 3072]


def test_chip_smoke_sampled_serves_at_tiny_config(capsys):
    """chip_smoke.check_sampled_serves at the tiny configuration on the CPU
    (plain versions): the same seed twice gives the same codes, the draws
    the loop hands K2 / predict_codes and K1 (K6 / K5 per lane) equal the
    host chain, and here, where the plain versions sum alike at any row
    count, every lane's codes equal the single stream's with its key,
    sampled and greedy."""
    cfg = tiny_pipeline_config()
    tts = chip_smoke.make_pipeline(cfg, torch.device("cpu"))
    bf16 = chip_smoke.make_pipeline(cfg, torch.device("cpu"), quant=None)
    spec = dict(int8=("The quick brown fox.", dict(max_audio_tokens=3, seed=3), 2),
                bf16=("The quick brown fox.", dict(max_audio_tokens=2, seed=3), 2))
    chip_smoke.check_sampled_serves(tts, bf16, "cpu", spec)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("sampled_serve ")]
    assert [l["what"] for l in lines] == ["int8", "bf16"]
    for l, lanes in zip(lines, (2, 2)):
        assert l["lane_draws_equal_host_chain"] == l["lanes_codes_equal_single_stream"] == lanes
        assert l["greedy_lanes_first_differing_frame"] == [None] * 4
