"""The qwen3tts ops (ops/library.py) and the AOT export of the fused int8
route (qwen3tts_tpu_torch/tools/export_aot.py) on the CPU at the tiny
config, where every op runs its kernel's plain version: opcheck of the
five ops, the reloaded prefill / frame / vocoder programs against the
eager loop bit for bit, files without weights, programs that run with the
model functions patched to raise, and chip_smoke's export phase. The
float32 route and the JAX package's exported programs are in
tests/test_torch_export_jax.py."""

from __future__ import annotations

import json
import os
import zipfile

import pytest
import torch

import chip_smoke
from qwen3tts_tpu_torch.config import tiny_pipeline_config
from qwen3tts_tpu_torch.ops import library
from qwen3tts_tpu_torch.ops.fused_code_predictor import predict_codes_operands
from qwen3tts_tpu_torch.ops.fused_talker_step import talker_step_operands
from qwen3tts_tpu_torch.ops.kv_quant import quantize_cache
from qwen3tts_tpu_torch.ops.prng import prng_key
from qwen3tts_tpu_torch.runtime import decode_loop
from qwen3tts_tpu_torch.tools import export_aot
from torch_export_common import (BUCKET, FRAMES, eager, one_torch_thread, pipeline,  # noqa: F401
                                 retrace_check, text)

SAMPLING = dict(temperature=0.9, top_k=50, top_p=1.0, repetition_penalty=1.05)


@pytest.fixture(scope="module")
def int8(tmp_path_factory):
    """(programs, pipeline, directory) of the tiny int8 tier's fused route
    (K1 w8a8, K2, K3 and the W8A16 GEMM, plain on the CPU), exported with
    the JAX tool's sampling and reloaded."""
    out = str(tmp_path_factory.mktemp("int8"))
    tts = pipeline("int8")
    export_aot.save_programs(out, *export_aot.build_programs(FRAMES, BUCKET, True, tts=tts))
    return export_aot.load_programs(out), tts, out


# ---------------------------------------------------------------- the ops

def _talker_case(mode):
    tts = pipeline({"w8a8": "int8", "bf16": None, "mixed": "q4", "w4bf16": "q4pure",
                     "kv_int8": "int8", "no_seen": "int8"}[mode])
    tp, tcfg = tts.talker_params, tts.config.talker
    gen = torch.Generator().manual_seed(5)
    kv = torch.randn((tcfg.n_layers, 2, tcfg.n_kv_heads, 32, tcfg.head_dim), generator=gen)
    kv = kv.to(tp.codec_embd.dtype)
    if mode == "kv_int8":
        kv = quantize_cache(kv.to(torch.bfloat16), 32)
    seen = torch.zeros((tcfg.codec_vocab_size,), dtype=torch.int8)
    seen[[3, 70]] = 1
    kw = {} if mode == "no_seen" else dict(seen=seen, seed=-123456, **SAMPLING)
    return talker_step_operands(
        tp.blocks, tcfg, torch.randn((tcfg.hidden_size,), generator=gen), 9, kv,
        output_norm=tp.output_norm, codec_head=tp.codec_head,
        suppress_start=tcfg.codec_vocab_size - tcfg.n_suppressed_tail,
        eos_id=tcfg.codec_eos_id, **kw)


def _op_case(case):
    """(op name, operands) of one opcheck case at the tiny widths."""
    gen = torch.Generator().manual_seed(7)
    if case.startswith("talker_step"):
        return "talker_step", _talker_case(case.partition("-")[2])
    if case == "predict_codes":
        tts = pipeline("int8")
        H = tts.config.code_predictor.hidden_size
        return "predict_codes", predict_codes_operands(
            tts.cp_params, tts.config.code_predictor, torch.randn((H,), generator=gen),
            torch.randn((H,), generator=gen), 991, temperature=0.9, top_k=50, use_top_p=False)
    if case.startswith("res_block"):
        lead = (3,) if case.endswith("lanes") else ()
        C = 16
        w = lambda *s: torch.randn(s, generator=gen) * 0.1   # noqa: E731
        return "res_block", (w(*lead, 20, C), w(7, C, C), w(C), w(C), w(C), w(1, C, C), w(C),
                             w(C), w(C), 3)
    if case == "int8_matmul":
        q = torch.randint(-127, 128, (128, 64), generator=gen, dtype=torch.int8)
        return "int8_matmul", (torch.randn((5, 128), generator=gen).to(torch.bfloat16), q,
                               torch.rand((1, 64), generator=gen))
    lead = (2,) if case.endswith("lanes") else ()
    kv = torch.randn((*lead, 2, 2, 2, 64, 16), generator=gen).to(torch.bfloat16)
    return "decode_attention", (torch.randn((*lead, 4, 16), generator=gen).to(torch.bfloat16),
                                kv, 1, 40)


OP_CASES = ["talker_step-w8a8", "talker_step-bf16", "talker_step-mixed", "talker_step-w4bf16",
            "talker_step-kv_int8", "talker_step-no_seen", "predict_codes", "res_block",
            "res_block-lanes", "int8_matmul", "decode_attention", "decode_attention-lanes"]


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck(case):
    """torch.library.opcheck of each op: the schema and its declared
    mutation (K1's cache operands) against the CPU kernel, the fake
    implementation's shapes and dtypes, and the op under AOT dispatch."""
    name, args = _op_case(case)
    result = torch.library.opcheck(library.op(name), args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_every_op_has_cpu_cuda_and_meta_kernels():
    """Every op has its plain version for CPU tensors, its launcher for CUDA
    tensors (ops/library.implement) and its fake implementation for meta
    tensors."""
    for name in library.SCHEMAS:
        qual = f"{library.NAMESPACE}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), (qual, key)


# ------------------------------------------------------------ the programs

def test_round_trip_two_texts_one_prefill(int8):
    """Two texts of different n_tokens in one text bucket through the one
    exported prefill: run_generate's codes, frame counts and hidden rows
    equal eager generate_from_tokens' bit for bit."""
    programs, tts, _ = int8
    spec, tcfg = programs.spec, tts.config.talker
    assert (spec.fused_talker, spec.fused_cp) == (True, True)
    for n, seed in ((11, 1), (14, 2)):
        tokens = text(n, seed)
        got = export_aot.run_generate(programs, tts.talker_params, tts.cp_params, tokens, n,
                                      torch.zeros((tcfg.hidden_size,)),
                                      tcfg.english_language_id, prng_key(seed),
                                      talker_cfg=tcfg)
        want = eager(tts, spec, tokens, n, prng_key(seed))
        assert got.n_frames == want.n_frames > 0
        assert torch.equal(got.codes, want.codes)
        assert torch.equal(got.hidden, want.hidden)


def test_frame_program_at_two_positions_and_keys(int8):
    """One frame program at two n_past values with two pairs of K1/K2
    seeds: its codes, hidden, next cb0, cache and seen-set equal
    decode_loop.frame_step's on the same state."""
    programs, tts, _ = int8
    tp, cp, tcfg = tts.talker_params, tts.cp_params, tts.config.talker
    spec = programs.spec
    i64 = dict(dtype=torch.int64)
    kv, hidden, cb0, trailing = programs.prefill(
        tp, torch.from_numpy(text(12, 3)), torch.tensor(12, **i64), torch.zeros(tcfg.hidden_size),
        torch.tensor(tcfg.english_language_id, **i64), torch.tensor([[0, 5]], **i64))
    samp, cb0_kw = export_aot._sampling(spec, tcfg)
    outs = set()
    for n_past, seeds in ((10, (-77, 4242)), (15, (123456789, -5))):
        seen = torch.zeros((tcfg.codec_vocab_size,), dtype=torch.int8)
        kv_x, kv_e, seen_x, seen_e = kv.clone(), kv.clone(), seen.clone(), seen.clone()
        keys = torch.zeros((cp.heads.shape[0] + 1, 2), **i64)
        got = programs.frame(tp, cp, kv_x, seen_x, hidden, cb0, trailing[1], n_past, *seeds,
                             keys)
        want = decode_loop.frame_step(
            tp, cp, tcfg, tts.config.code_predictor, hidden, cb0, kv_e, seen_e, trailing[1],
            n_past, *seeds, fused_talker=True, fused_cp=True, samp=samp, cb0_kw=cb0_kw,
            repetition_penalty=spec.repetition_penalty)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(kv_x, kv_e) and torch.equal(seen_x, seen_e)
        assert not torch.equal(kv_x, kv)   # the row at n_past was written
        outs.add(tuple(got[0].tolist()))
    assert len(outs) == 2


def test_saved_files_hold_no_weights(int8, monkeypatch, caplog):
    """Each .pt2 file is smaller than the parameters its program takes, its
    tensor entries (constants, example inputs) hold a few bytes, and
    torch.export.load never falls back to unpickling with
    weights_only=False."""
    programs, tts, out = int8
    nbytes = lambda tree: sum(t.numel() * t.element_size()   # noqa: E731
                              for t in torch.utils._pytree.tree_leaves(tree)
                              if isinstance(t, torch.Tensor))
    takes = {"prefill": nbytes(tts.talker_params),
             "frame": nbytes(tts.talker_params) + nbytes(tts.cp_params),
             "vocoder": nbytes(tts.vocoder_params)}
    for name in export_aot.PROGRAMS:
        path = os.path.join(out, f"{name}.pt2")
        assert os.path.getsize(path) < takes[name], name
        with zipfile.ZipFile(path) as z:
            data = sum(i.file_size for i in z.infolist() if "/data/" in i.filename)
        assert data < 4096, (name, data)
    calls = []
    load = torch.load

    def recording_load(*args, **kw):
        calls.append(kw.get("weights_only"))
        return load(*args, **kw)

    monkeypatch.setattr(torch, "load", recording_load)
    with caplog.at_level("WARNING"):
        export_aot.load_programs(out)
    assert all(w is True for w in calls), calls
    assert "weights_only=False" not in caplog.text


def test_reloaded_programs_do_not_retrace(int8, tmp_path):
    """The reloaded int8 programs run in a fresh process in which
    build_prefill, talker_prefill, talker_step, predict_codes and
    vocoder_forward raise, and give the eager codes and audio."""
    retrace_check([(int8[2], "int8")], str(tmp_path))


# ---------------------------------------------------------------- the smoke

def test_chip_smoke_export_phase_at_tiny_config(tmp_path, capsys):
    """chip_smoke's export phase at the tiny config on the CPU: the export
    workers (started first, as the smoke starts them before its build)
    write both tiers' programs, a fresh process reloads them, and each
    request equals eager bit for bit, the audio 0.0 from vocoder_decode;
    off the card no launch is counted and no device op is traced."""
    spec = dict(chip_smoke.EXPORT, tiers={
        "int8": dict(chip_smoke.EXPORT["tiers"]["int8"], frames=6),
        "bf16": dict(chip_smoke.EXPORT["tiers"]["bf16"], frames=4)})
    root = str(tmp_path)
    workers = chip_smoke.start_exports(root, torch.device("cpu"), tiny=True, spec=spec)
    try:
        pipes = {tier: chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"),
                                                quant=ts["quant"])
                 for tier, ts in spec["tiers"].items()}
        counts = chip_smoke.export_phase(pipes, "stub card", root, workers, spec=spec)
    finally:
        chip_smoke.stop_processes(workers)
    assert counts == [{name: 0 for name in chip_smoke.KERNELS}]
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("export ")]
    rec = json.loads(line[-1][len("export "):])
    int8, bf16 = rec["tiers"]["int8"], rec["tiers"]["bf16"]
    assert (int8["n_frames"], bf16["n_frames"]) == (6, 4)
    assert int8["codes_equal"] and bf16["codes_equal"] and int8["audio_max_abs"] == 0.0
    assert int8["route"] == dict(fused_talker=True, fused_cp=True)
    assert bf16["route"] == dict(fused_talker=True, fused_cp=False)
    assert set(int8["bytes"]) == set(export_aot.PROGRAMS) and set(bf16["bytes"]) == {
        "prefill", "frame"}
    for r in (int8, bf16):
        assert r["reload_s"] > 0 and all(r["bytes"].values()) and all(r["export_s"].values())
        assert len(r["frame_ms"]["exported"]) == len(r["frame_ms"]["eager"]) == 3
        assert r["frame_device_ops"] == {"exported": None, "eager": None}


def test_chip_smoke_export_phase_fails_on_a_failed_worker(tmp_path):
    """A worker that fails fails the phase (every gate is fatal)."""
    spec = dict(chip_smoke.EXPORT, tiers={"int8": dict(chip_smoke.EXPORT["tiers"]["int8"],
                                                       quant="no such tier")})
    workers = chip_smoke.start_exports(str(tmp_path), torch.device("cpu"), tiny=True, spec=spec)
    with pytest.raises(chip_smoke.SmokeFailure, match="export worker"):
        chip_smoke.export_phase({}, "stub card", str(tmp_path), workers, spec=spec)
    assert all(w.poll() is not None for w in workers)
