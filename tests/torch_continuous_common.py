"""Fixtures and helpers shared by the continuous-serving test files
(tests/test_torch_continuous.py, test_torch_continuous_sampling.py,
test_torch_continuous_jax.py): the JAX tests' float32 and int8 weights in
both packages, the request queues, the port's fresh single-stream runs and
schedulers, and the JAX package's scheduler on the same queue.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu import pipeline as jpipeline
from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import continuous as jcont
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops import prng
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.runtime import continuous as cont
from qwen3tts_tpu_torch.runtime import decode_loop as pdl


CFG = tiny_pipeline_config()
TCFG, CCFG = CFG.talker, CFG.code_predictor


H = TCFG.hidden_size


UNFUSED = dict(fused_talker=False, fused_cp=False)


FUSED = dict(fused_talker=True, fused_cp=True)


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def jparams():
    tp = jtalker.init_talker_params(jax.random.PRNGKey(21), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(22), CCFG, jnp.float32)
    return tp, cp


@pytest.fixture(scope="module")
def params(jparams):
    """The JAX tests' float32 weights in the port."""
    tp, cp = jparams
    return params_from_jax(_to_np(tp)), params_from_jax(_to_np(cp))


@pytest.fixture(scope="module")
def qparams(jparams):
    """The same weights with int8 blocks, in both packages."""
    tp, cp = jparams
    tpq = tp._replace(blocks=quantize_block_params(tp.blocks))
    cpq = cp._replace(blocks=quantize_block_params(cp.blocks))
    return (tpq, cpq), (params_from_jax(_to_np(tpq)), params_from_jax(_to_np(cpq)))


def _requests():
    """Unequal prompts and frame budgets: staggered finishes force
    mid-session refills at several splice points."""
    reqs = []
    for i, (ntok, budget) in enumerate([(11, 4), (12, 6), (10, 3), (13, 5), (11, 2), (12, 4)]):
        tokens = (np.arange(ntok, dtype=np.int64) * (i + 3)) % 50 + 2
        reqs.append(dict(tokens=tokens, n_tokens=ntok, budget=budget, seed=100 + i))
    return reqs


def _fresh(p, req, *, temperature, top_k, top_p=1.0, repetition_penalty=1.05, flags=UNFUSED,
           Tb=16):
    """The port's single-stream loop on one request, from the key
    prng_key(seed) of the request's seed."""
    tp, cp = p
    padded = np.zeros((Tb,), np.int64)
    padded[:req["n_tokens"]] = req["tokens"]
    res = pdl.generate_from_tokens(
        tp, cp, torch.from_numpy(padded), req["n_tokens"], torch.zeros((H,)),
        TCFG.english_language_id, prng.prng_key(req["seed"]),
        talker_cfg=TCFG, cp_cfg=CCFG, max_frames=req["budget"],
        kv_capacity=10 + req["budget"] + 8, temperature=temperature, top_k=top_k,
        top_p=top_p, repetition_penalty=repetition_penalty, allow_eos=False, **flags)
    return res.codes.numpy()


def _scheduler(p, *, temperature, top_k, lanes=2, kv_capacity=28, chunk_frames=2,
               refill_slots=2, flags=UNFUSED, **kw):
    tp, cp = p
    return cont.ContinuousScheduler(
        tp, cp, TCFG, CCFG, lanes=lanes, kv_capacity=kv_capacity, text_bucket=16,
        chunk_frames=chunk_frames, refill_slots=refill_slots, max_frames=8,
        temperature=temperature, top_k=top_k, repetition_penalty=1.05, allow_eos=False,
        **flags, **kw)


def _run_continuous(p, reqs, **kw):
    sched = _scheduler(p, **kw)
    rids = [sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)), TCFG.english_language_id,
                         seed=r["seed"], max_frames=r["budget"]) for r in reqs]
    results = sched.run()
    sched.check_host_mirrors()   # host n_past/start/done == the state
    return sched, [results[rid] for rid in rids]


def _assert_fresh(p, reqs, got, **kw):
    for r, codes in zip(reqs, got):
        want = _fresh(p, r, **kw)
        assert codes.shape == want.shape == (r["budget"], TCFG.n_codebooks)
        np.testing.assert_array_equal(codes, want, err_msg=f"seed {r['seed']}")


# int8 requests whose greedy codes meet no near-tie between the two
# packages' float sums (the JAX test's queue)
FUSED_REQS = [dict(tokens=np.arange(11) + 2, n_tokens=11, budget=2, seed=7),
              dict(tokens=(np.arange(12) * 5) % 40 + 2, n_tokens=12, budget=3, seed=8),
              dict(tokens=np.arange(10) + 4, n_tokens=10, budget=2, seed=9),
              dict(tokens=(np.arange(13) * 3) % 30 + 2, n_tokens=13, budget=4, seed=10),
              dict(tokens=np.arange(12) + 6, n_tokens=12, budget=2, seed=11),
              dict(tokens=np.arange(11) + 8, n_tokens=11, budget=3, seed=12),
              dict(tokens=(np.arange(10) * 7) % 25 + 2, n_tokens=10, budget=4, seed=13),
              dict(tokens=np.arange(12) + 3, n_tokens=12, budget=2, seed=14)]


def _fused_scheduler(p):
    tp, cp = p
    return cont.ContinuousScheduler(
        tp, cp, TCFG, CCFG, lanes=2, kv_capacity=20, text_bucket=16, chunk_frames=2,
        refill_slots=2, max_frames=4, temperature=0.0, top_k=0, repetition_penalty=1.05,
        allow_eos=False, **FUSED)


def _jax_scheduler_codes(jp, reqs, **kw):
    tp, cp = jp
    sched = jcont.ContinuousScheduler(
        tp, cp, TCFG, CCFG, text_bucket=16, temperature=0.0, top_k=0,
        repetition_penalty=1.05, allow_eos=False, **kw)
    rids = [sched.submit(np.asarray(r["tokens"], np.int32), r["n_tokens"], np.zeros((H,)),
                         TCFG.english_language_id, seed=r["seed"], max_frames=r["budget"])
            for r in reqs]
    results = sched.run()
    return [np.asarray(results[rid]) for rid in rids]


# synthesize_queue against the JAX package's on the same weights
QUEUE_TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request.",
               "Four.", "And a fifth one."]


@pytest.fixture(scope="module")
def pipelines():
    cfg = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant=None))
    jt = jpipeline.Qwen3TTS(cfg)
    assert jt.load_models(None, synthetic=True)
    pt = Qwen3TTS(cfg, device="cpu", **UNFUSED)
    pt.set_params(params_from_jax(_to_np(jt.talker_params)),
                  params_from_jax(_to_np(jt.cp_params)),
                  params_from_jax(_to_np(jt.vocoder_params)))
    return jt, pt


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tiny products: several test
    workers share the machine's cores, and a thread pool's barriers then
    wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
