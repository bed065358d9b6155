"""One spawned world of ranks for tests/test_torch_parallel.py.

Each rank (a process, gloo on the CPU) loads the job the test wrote
(port params from the JAX package's seeds, inputs, queues), builds the
meshes, runs every case through the port's entry points with the same
global inputs, and saves {case: result} to rank<r>.pt. A case that raises
saves its traceback instead, so one failure fails its own test only. This
module imports torch and the port, never jax: the test compares.
"""

from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from qwen3tts_tpu_torch.parallel import kernel_safety as KS
from qwen3tts_tpu_torch.parallel import mesh as mesh_mod
from qwen3tts_tpu_torch.parallel import shardings
from qwen3tts_tpu_torch.runtime import continuous as cont
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

WORLD = 4


def _shard(p, mesh):
    tp, cp = p
    return (shardings.shard_params(tp, shardings.talker_specs(), mesh),
            shardings.shard_params(cp, shardings.code_predictor_specs(), mesh))


def _batched(p, inputs, kw, **flags):
    tokens, n_tok, speaker, lang, keys = inputs
    res = pdl.generate_from_tokens_batched(
        p[0], p[1], torch.from_numpy(tokens), torch.from_numpy(n_tok),
        torch.from_numpy(speaker), torch.from_numpy(lang), keys, **kw, **flags)
    return dict(codes=res.codes.numpy(), n_frames=np.asarray(res.n_frames))


def _queue(p, job, mesh):
    tcfg, ccfg = job["cfg"]
    sched = cont.ContinuousScheduler(p[0], p[1], tcfg, ccfg, mesh=mesh, **job["queue_kw"])
    rids = [sched.submit(t, n, np.zeros((tcfg.hidden_size,)), 2050, seed=100 + i,
                         max_frames=b) for i, (t, n, b) in enumerate(job["queue"])]
    out = sched.run()
    sched.check_host_mirrors()
    return dict(codes=[out[r] for r in rids], fused=(sched.fused_cp, sched.fused_talker),
                lanes=(sched.lo, sched.hi), refills=sched.refills,
                compactions=sched.compactions, sessions=sched.sessions)


def _raises(fn, match):
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False


def _cases(job, meshes):
    tcfg, ccfg = job["cfg"]
    kw = dict(job["kw"], talker_cfg=tcfg, cp_cfg=ccfg)
    m22, m14, m41 = meshes
    P = job["params"]
    unfused = dict(fused_talker=False, fused_cp=False)

    def sharded(tier, mesh):
        return lambda: _batched(_shard(P[tier], mesh), job["batch"], kw)

    def shapes():
        out = {}
        for name, mesh in (("2x2", m22), ("1x4", m14)):
            tp, cp = _shard(P["f32"], mesh)
            out[name] = dict(
                wqkv=tuple(tp.blocks.wqkv.shape), wo=tuple(tp.blocks.wo.shape),
                w_gateup=tuple(tp.blocks.w_gateup.shape),
                w_down=tuple(tp.blocks.w_down.shape), codec_head=tuple(tp.codec_head.shape),
                fc1=tuple(tp.text_proj_fc1_w.shape), fc2=tuple(tp.text_proj_fc2_w.shape),
                cp_heads=tuple(cp.heads.shape), cp_wqkv=tuple(cp.blocks.wqkv.shape),
                n_heads=shardings.local_config(tcfg, tp.blocks).n_heads)
        q4 = _shard(P["w4"], m22)[0].blocks.w_down
        out["w4_w_down"] = (tuple(q4.q.shape), tuple(q4.scale.shape))
        i8 = _shard(P["int8"], m22)[0].blocks
        out["int8_wqkv_q"] = tuple(i8.wqkv.q.shape)
        out["int8_wo_scale"] = tuple(i8.wo.scale.shape)
        return out

    def safety():
        tpq, cpq = P["ks"]
        tps, cps = _shard(P["ks"], m22)
        rep_t, rep_c = _shard(P["ks"], m41)
        return dict(
            local=(KS.partitioned_axes(tpq), KS.partitioned_axes(cpq), KS.params_mesh(tpq)),
            tp_axes=(KS.partitioned_axes(tps), KS.partitioned_axes(cps)),
            tp_mesh_is_mesh=KS.params_mesh(tps) is m22,
            rep_axes=KS.partitioned_axes(rep_t),
            rep_mesh_is_mesh=KS.params_mesh(rep_t) is m41,
            auto=(pdl.resolve_fused_talker("auto", tpq), pdl.resolve_fused_cp("auto", cpq),
                  pdl.resolve_fused_talker("auto", tps), pdl.resolve_fused_cp("auto", cps)),
            explicit=(_raises(lambda: pdl.resolve_fused_talker(True, tps),
                              "partitioned over mesh axes"),
                      _raises(lambda: pdl.resolve_fused_cp(True, cps),
                              "partitioned over mesh axes")),
            dp_mesh=(KS.dp_kernel_mesh(rep_t, rep_c, 16) is m41,
                     KS.dp_kernel_mesh(rep_t, rep_c, 6) is None,
                     KS.dp_kernel_mesh(tpq, cpq, 16) is None,
                     KS.dp_kernel_mesh(tps, rep_c, 16) is None))

    def dp_fused():
        """Replicated int8 weights on dp = 4 with the kernels forced on: each
        rank's loop calls K5 and K6 (plain versions here) on its 2 lanes."""
        calls = []
        real_t, real_c = pdl.fused_talker_step_batched, pdl.fused_predict_codes_batched

        def spy(name, real):
            def run(*a, **k):
                calls.append((name, int(a[2].shape[0])))
                return real(*a, **k)
            return run

        pdl.fused_talker_step_batched = spy("K5", real_t)
        pdl.fused_predict_codes_batched = spy("K6", real_c)
        try:
            out = _batched(_shard(P["ks"], m41), job["batch8"], dict(kw, **job["kw8"]),
                           fused_talker=True, fused_cp=True)
        finally:
            pdl.fused_talker_step_batched, pdl.fused_predict_codes_batched = real_t, real_c
        out["calls"] = sorted(set(calls))
        return out

    def queue_gate():
        tpq, cpq = _shard(P["ks"], m41)
        qkw = dict(lanes=8, kv_capacity=64, text_bucket=16, chunk_frames=4,
                   refill_slots=2, max_frames=8, temperature=0.0, top_k=0)
        raised = _raises(lambda: cont.ContinuousScheduler(
            tpq, cpq, tcfg, ccfg, mesh=m41, fused_cp=True, fused_talker=True, **qkw),
            "multi-device mesh")
        sched = cont.ContinuousScheduler(tpq, cpq, tcfg, ccfg, mesh=m41, **qkw)
        return dict(raised=raised, fused=(sched.fused_cp, sched.fused_talker),
                    lanes=(sched.lo, sched.hi))

    return {
        "sharded_f32": sharded("f32", m22),
        "sharded_f32_1x4": sharded("f32", m14),
        "sharded_int8": sharded("int8", m22),
        "sharded_w4": sharded("w4", m22),
        "continuous": lambda: _queue(_shard(P["f32"], m22), job, m22),
        "unfused_dp": lambda: _batched(_shard(P["ks"], m41), job["batch8"],
                                       dict(kw, **job["kw8"]), **unfused),
        "shard_shapes": shapes,
        "kernel_safety": safety,
        "dp_fused": dp_fused,
        "queue_gate": queue_gate,
    }


def run_rank(rank: int, port: int, job_path: str, out_dir: str) -> None:
    """The body of rank `rank` of the world (torch.multiprocessing.spawn's
    target)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        job = torch.load(job_path, weights_only=False)
        devices = ["cpu"] * WORLD
        meshes = (mesh_mod.make_mesh(2, 2, devices), mesh_mod.make_mesh(1, 4, devices),
                  mesh_mod.make_mesh(4, 1, devices))
        results = {}
        with torch.no_grad():
            for name, case in _cases(job, meshes).items():
                try:
                    results[name] = case()
                except Exception:  # noqa: BLE001 - recorded for the case's own test
                    results[name] = {"error": traceback.format_exc()}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
