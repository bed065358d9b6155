"""Multi-device serving in the port (``qwen3tts_tpu_torch/parallel``, the
batched loop's dp lanes, the continuous scheduler on a mesh): the
counterparts of tests/test_parallel.py and tests/test_kernel_safety.py.

One world of 4 ranks (gloo on the CPU, tests/torch_parallel_world.py) is
spawned for the whole file; each rank runs every case with the same global
inputs and saves what it returned. Meanwhile this process runs the JAX
package's sharded runs of the same inputs on the 8-device CPU mesh that
conftest.py sets (with the flags JAX resolves there: its fused kernels are
off on a CPU, so the port runs unfused too). The gates: every rank returns
the same global result, and its greedy codes and frame counts equal the
JAX package's sharded run exactly, and the port's unsharded run. The
inputs are test_parallel.py's and test_kernel_safety.py's own seeds and
sizes.
"""

from __future__ import annotations

import socket
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_world as W
from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops.quant import quantize_block_params, quantize_block_params_w4
from qwen3tts_tpu.parallel import mesh as jmesh
from qwen3tts_tpu.parallel import shardings as jshard
from qwen3tts_tpu.runtime import continuous as jcont
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu_torch import tiny_pipeline_config as port_tiny_config
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.parallel import kernel_safety as KS
from qwen3tts_tpu_torch.parallel import mesh as pmesh
from qwen3tts_tpu_torch.runtime import continuous as cont
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

CFG = tiny_pipeline_config()
TCFG, CCFG = CFG.talker, CFG.code_predictor
PCFG = port_tiny_config()
PT, PC = PCFG.talker, PCFG.code_predictor
# test_parallel.py's KW, and test_kernel_safety.py's shard_map case
KW = dict(max_frames=4, kv_capacity=22, temperature=0.0, top_k=0, repetition_penalty=1.05)
KW8 = dict(max_frames=3, kv_capacity=32)
QUEUE_KW = dict(lanes=2, kv_capacity=30, text_bucket=16, chunk_frames=2, refill_slots=2,
                max_frames=6, temperature=0.0, top_k=0, repetition_penalty=1.05,
                allow_eos=False)
UNFUSED = dict(fused_talker=False, fused_cp=False)
WORLD_SECONDS = 600


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch_inputs(B, seed, key, zero_speaker, Tb=16):
    """test_parallel.py's (seed 0, key 0, random speakers) and
    test_kernel_safety.py's (seed 7, key 3, zero speakers) batches."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, Tb), np.int32)
    for b in range(B):
        tokens[b, :11] = rng.integers(2, 100, size=11)
    n_tok = np.full((B,), 11, np.int32)
    speaker = (np.zeros((B, TCFG.hidden_size), np.float32) if zero_speaker else
               rng.normal(size=(B, TCFG.hidden_size)).astype(np.float32) * 0.1)
    lang = np.full((B,), 2050, np.int32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(key), B))
    return tokens, n_tok, speaker, lang, keys


def _queue():
    rng = np.random.default_rng(4)
    reqs = []
    for budget in [3, 5, 2, 4, 3, 2]:
        nt = int(rng.integers(10, 15))
        reqs.append((rng.integers(2, 90, nt).astype(np.int32), nt, budget))
    return reqs


def _jax_params():
    """test_parallel.py's (keys 11, 12) and test_kernel_safety.py's (keys 21,
    22) params, each init and quantization under jit (one compile each
    instead of one per eager op; both sides of every comparison take these
    same arrays)."""
    init_t = jax.jit(jtalker.init_talker_params, static_argnums=(1, 2))
    init_c = jax.jit(jcp.init_code_predictor_params, static_argnums=(1, 2))
    q8, q4 = jax.jit(quantize_block_params), jax.jit(quantize_block_params_w4)
    tp = init_t(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = init_c(jax.random.PRNGKey(12), CCFG, jnp.float32)
    out = {"f32": (tp, cp)}
    for name, q in (("int8", q8), ("w4", q4)):
        out[name] = (tp._replace(blocks=q(tp.blocks)), cp._replace(blocks=q(cp.blocks)))
    tk = init_t(jax.random.PRNGKey(21), TCFG, jnp.float32)
    ck = init_c(jax.random.PRNGKey(22), CCFG, jnp.float32)
    out["ks"] = (tk._replace(blocks=q8(tk.blocks)), ck._replace(blocks=q8(ck.blocks)))
    return out


def _jax_sharded(jp, inputs, mesh):
    tps = jshard.shard_params(jp[0], jshard.talker_specs(), mesh)
    cps = jshard.shard_params(jp[1], jshard.code_predictor_specs(), mesh)
    dsh = NamedSharding(mesh, P("dp"))
    res = jdl.generate_from_tokens_batched(
        tps, cps, *[jax.device_put(jnp.asarray(a), dsh) for a in inputs],
        talker_cfg=TCFG, cp_cfg=CCFG, **KW)
    return dict(codes=np.asarray(res.codes), n_frames=np.asarray(res.n_frames))


def _jax_queue(jp, mesh):
    tps = jshard.shard_params(jp[0], jshard.talker_specs(), mesh)
    cps = jshard.shard_params(jp[1], jshard.code_predictor_specs(), mesh)
    sched = jcont.ContinuousScheduler(tps, cps, TCFG, CCFG, mesh=mesh, **QUEUE_KW)
    rids = [sched.submit(t, n, np.zeros((TCFG.hidden_size,)), 2050, seed=100 + i,
                         max_frames=b) for i, (t, n, b) in enumerate(_queue())]
    out = sched.run()
    return [np.asarray(out[r]) for r in rids]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world, compute the JAX package's sharded runs while it
    runs, and return both."""
    d = tmp_path_factory.mktemp("world")
    jp = _jax_params()
    params = {k: (params_from_jax(_np(t)), params_from_jax(_np(c))) for k, (t, c) in jp.items()}
    batch = _batch_inputs(2, 0, 0, zero_speaker=False)
    batch8 = _batch_inputs(8, 7, 3, zero_speaker=True)
    job = dict(cfg=(PT, PC), params=params, batch=batch, batch8=batch8, kw=KW, kw8=KW8,
               queue=_queue(), queue_kw=QUEUE_KW)
    job_path = str(d / "job.pt")
    torch.save(job, job_path)
    ctx = tmp.start_processes(W.run_rank, args=(_free_port(), job_path, str(d)),
                              nprocs=W.WORLD, join=False, start_method="spawn")
    try:
        mesh = jmesh.make_mesh(2, 2)
        # four programs, compiled side by side (XLA's compiler leaves the GIL)
        with ThreadPoolExecutor(4) as pool:
            jobs = {tier: pool.submit(_jax_sharded, jp[tier], batch, mesh)
                    for tier in ("f32", "int8", "w4")}
            jobs["continuous"] = pool.submit(_jax_queue, jp["f32"], mesh)
            refs = {k: f.result() for k, f in jobs.items()}
        deadline = time.monotonic() + WORLD_SECONDS
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the world did not finish in {WORLD_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(W.WORLD)]
    return dict(ranks=ranks, jax=refs, params=params, batch=batch, batch8=batch8)


def _case(world, name):
    """Every rank's result of a case; a rank's traceback fails the test."""
    out = [r[name] for r in world["ranks"]]
    for rank, r in enumerate(out):
        if isinstance(r, dict) and "error" in r:
            pytest.fail(f"rank {rank}, case {name}:\n{r['error']}")
    return out


def _port_batched(p, inputs, **kw):
    tokens, n_tok, speaker, lang, keys = inputs
    res = pdl.generate_from_tokens_batched(
        p[0], p[1], torch.from_numpy(tokens), torch.from_numpy(n_tok),
        torch.from_numpy(speaker), torch.from_numpy(lang), keys, talker_cfg=PT, cp_cfg=PC,
        **kw)
    return dict(codes=res.codes.numpy(), n_frames=np.asarray(res.n_frames))


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got["n_frames"], want["n_frames"], err_msg=what)
    np.testing.assert_array_equal(got["codes"], want["codes"], err_msg=what)


def test_batched_matches_single(world):
    """Counterpart of test_parallel.py's: each lane of the port's batched
    loop equals its single-stream run (f32, unfused, as JAX resolves)."""
    tp, cp = world["params"]["f32"]
    tokens, n_tok, speaker, lang, keys = _batch_inputs(3, 0, 0, zero_speaker=False)
    batched = _port_batched((tp, cp), (tokens, n_tok, speaker, lang, keys), **KW, **UNFUSED)
    for b in range(3):
        single = pdl.generate_from_tokens(
            tp, cp, torch.from_numpy(tokens[b]), int(n_tok[b]), torch.from_numpy(speaker[b]),
            int(lang[b]), keys[b], talker_cfg=PT, cp_cfg=PC, **KW, **UNFUSED)
        assert batched["n_frames"][b] == single.n_frames
        np.testing.assert_array_equal(batched["codes"][b, :single.n_frames],
                                      single.codes.numpy())


@pytest.mark.parametrize("tier", ["f32", "int8", "w4"])
def test_sharded_generation_matches_jax_and_unsharded(world, tier):
    """(dp, tp) = (2, 2): every rank's gathered codes and frame counts equal
    the JAX package's sharded run and the port's unsharded run, in float32,
    int8 and u4 (test_parallel.py's f32 and quantized cases)."""
    base = _port_batched(world["params"][tier], world["batch"], **KW, **UNFUSED)
    _assert_same(base, world["jax"][tier], f"{tier}: port unsharded vs JAX sharded")
    for rank, got in enumerate(_case(world, f"sharded_{tier}")):
        _assert_same(got, world["jax"][tier], f"{tier}: rank {rank} vs JAX sharded")


def test_sharded_generation_where_tp_does_not_fit_the_heads(world):
    """(1, 4): 4 does not divide the 2 KV heads, so the attention pair stays
    replicated while the FFN, the text projection and the heads split; the
    codes still equal the unsharded run's."""
    base = _port_batched(world["params"]["f32"], world["batch"], **KW, **UNFUSED)
    for rank, got in enumerate(_case(world, "sharded_f32_1x4")):
        _assert_same(got, base, f"rank {rank}")


def test_sharded_continuous_serving_matches_jax_and_unsharded(world):
    """The scheduler on (2, 2): lane state split over dp (one lane a rank),
    weights over tp; every request's codes equal the JAX package's sharded
    scheduler's and the port's unsharded scheduler's."""
    tp, cp = world["params"]["f32"]
    sched = cont.ContinuousScheduler(tp, cp, PT, PC, **QUEUE_KW)
    rids = [sched.submit(t, n, np.zeros((PT.hidden_size,)), 2050, seed=100 + i, max_frames=b)
            for i, (t, n, b) in enumerate(_queue())]
    out = sched.run()
    base = [out[r] for r in rids]
    for want, b, (_, _, budget) in zip(world["jax"]["continuous"], base, _queue()):
        assert b.shape == (budget, PT.n_codebooks)
        np.testing.assert_array_equal(b, want)
    for rank, got in enumerate(_case(world, "continuous")):
        assert got["fused"] == (False, False)
        assert got["lanes"] == (rank // 2, rank // 2 + 1)
        assert (got["refills"], got["compactions"], got["sessions"]) == (
            sched.refills, sched.compactions, sched.sessions)
        for g, want in zip(got["codes"], world["jax"]["continuous"]):
            np.testing.assert_array_equal(g, want, err_msg=f"rank {rank}")


def test_tp_sharding_actually_distributes(world):
    """Each rank's wqkv holds O/tp columns (its heads), wo Hq*D/tp rows,
    the FFN, text projection and vocab heads their tp-th; at tp = 4 the
    attention pair stays whole (2 KV heads)."""
    L, H, D, F = PT.n_layers, PT.hidden_size, PT.head_dim, PT.intermediate_size
    O = (PT.n_heads + 2 * PT.n_kv_heads) * D
    Et, Vc, V = PT.text_embd_dim, PT.codec_vocab_size, PC.vocab_size
    for got in _case(world, "shard_shapes"):
        s = got["2x2"]
        assert s["wqkv"] == (L, H, O // 2) and s["wo"] == (L, PT.n_heads * D // 2, H)
        assert s["w_gateup"] == (L, H, F) and s["w_down"] == (L, F // 2, H)
        assert s["codec_head"] == (H, Vc // 2) and s["cp_heads"] == (PC.n_steps, H, V // 2)
        assert s["fc1"] == (Et, Et // 2) and s["fc2"] == (Et // 2, H)
        assert s["n_heads"] == PT.n_heads // 2
        s = got["1x4"]
        assert s["wqkv"] == (L, H, O) and s["wo"] == (L, PT.n_heads * D, H)
        assert s["w_gateup"] == (L, H, 2 * F // 4) and s["w_down"] == (L, F // 4, H)
        assert s["n_heads"] == PT.n_heads
        # u4 rows repacked on the rank's rows; int8 columns with their scales,
        # int8 rows with replicated scales
        assert got["w4_w_down"][0] == (L, F // 4, H)
        assert got["int8_wqkv_q"] == (L, H, O // 2)
        assert got["int8_wo_scale"] == (L, 1, H)


def test_partitioned_axes_local_params_empty(world):
    tpq, cpq = world["params"]["ks"]
    assert KS.partitioned_axes(tpq) == frozenset()
    assert KS.partitioned_axes(cpq) == frozenset()
    assert KS.params_mesh(tpq) is None
    for got in _case(world, "kernel_safety"):
        assert got["local"] == (frozenset(), frozenset(), None)


def test_partitioned_axes_sees_tp_sharding(world):
    for got in _case(world, "kernel_safety"):
        assert got["tp_axes"] == (frozenset({"tp"}), frozenset({"tp"}))
        assert got["tp_mesh_is_mesh"]


def test_replicated_on_mesh_is_not_partitioned(world):
    for got in _case(world, "kernel_safety"):
        assert got["rep_axes"] == frozenset()
        assert got["rep_mesh_is_mesh"]


def test_auto_gate_falls_back_on_partitioned_params(world):
    """"auto" keeps K1/K5 and K2/K6 on local int8 params and turns both off
    on tp-split ones."""
    for got in _case(world, "kernel_safety"):
        assert got["auto"] == (True, True, False, False)


def test_explicit_true_on_partitioned_params_raises(world):
    for got in _case(world, "kernel_safety"):
        assert got["explicit"] == (True, True)


def test_dp_kernel_mesh_conditions(world):
    """Replicated on dp = 4: 16 lanes split, 6 do not; local or tp-split
    params never."""
    for got in _case(world, "kernel_safety"):
        assert got["dp_mesh"] == (True, True, True, True)


def test_dp_lanes_keep_the_kernels_on_every_rank(world):
    """Counterpart of test_shard_map_kernel_path_lowers, run to the end:
    replicated int8 weights on dp = 4, 8 lanes, the kernels forced on: each
    rank calls K5 and K6 on its 2 lanes only, and the gathered codes equal
    the unsharded fused run's exactly."""
    base = _port_batched(world["params"]["ks"], world["batch8"], **dict(KW, **KW8),
                         fused_talker=True, fused_cp=True)
    for rank, got in enumerate(_case(world, "dp_fused")):
        assert got["calls"] == [("K5", 2), ("K6", 2)], f"rank {rank}"
        _assert_same(got, base, f"rank {rank}")


def test_unfused_dp_lanes_match_unsharded(world):
    base = _port_batched(world["params"]["ks"], world["batch8"], **dict(KW, **KW8), **UNFUSED)
    for rank, got in enumerate(_case(world, "unfused_dp")):
        _assert_same(got, base, f"rank {rank}")


def test_continuous_scheduler_multi_device_mesh(world):
    """Explicit kernels on a multi-device mesh raise; "auto" runs unfused,
    each rank holding its 2 of the 8 lanes."""
    for rank, got in enumerate(_case(world, "queue_gate")):
        assert got["raised"]
        assert got["fused"] == (False, False)
        assert got["lanes"] == (2 * rank, 2 * rank + 2)


def test_make_mesh_needs_the_devices():
    """As JAX's make_mesh: a mesh larger than the world raises (this
    process is a world of one); a 1x1 mesh holds no group."""
    with pytest.raises(ValueError, match="needs 2 devices"):
        pmesh.make_mesh(2, 1, ["cpu"])
    m = pmesh.single_device_mesh(["cpu"])
    assert (m.dp, m.tp, m.size, m.groups) == (1, 1, 1, {"dp": None, "tp": None})


@pytest.mark.parametrize("lost", ["wqkv", "wo", "w_gateup", "w_down"])
def test_local_config_refuses_a_pair_that_lost_its_placement(lost):
    """A tp shard whose leaf lost its Placement (a new tensor object made
    from it) would skip its pair's sum and compute partial products:
    local_config, which every entry point calls, raises instead. The whole
    shard gives the local head counts."""
    from qwen3tts_tpu_torch.models.talker import init_talker_params
    from qwen3tts_tpu_torch.parallel import shardings

    mesh = pmesh.Mesh(dp=1, tp=2, dp_rank=0, tp_rank=0, device=torch.device("cpu"),
                      groups={"dp": None, "tp": None}, cpu_groups={"dp": None, "tp": None})
    tp = init_talker_params(torch.Generator().manual_seed(0), PT, torch.float32)
    blocks = shardings.shard_params(tp, shardings.talker_specs(), mesh).blocks
    assert shardings.local_config(PT, blocks).n_heads == PT.n_heads // 2
    broken = blocks._replace(**{lost: getattr(blocks, lost).clone()})
    with pytest.raises(ValueError, match="lost its Placement"):
        shardings.local_config(PT, broken)
