"""Package hygiene of the port: no import of jax or of the JAX package, its
own config copy in step with the JAX package's, no fallback from a CUDA
request to a plain version, and chip_smoke.py's phases at the tiny
configuration."""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke
import qwen3tts_tpu.config as jconfig
import qwen3tts_tpu_torch.config as pconfig
from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu_torch import _kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "qwen3tts_tpu_torch", "qwen3tts_tpu_torch.pipeline", "qwen3tts_tpu_torch._kernels",
    "qwen3tts_tpu_torch.io.from_jax", "qwen3tts_tpu_torch.runtime.decode_loop",
    "qwen3tts_tpu_torch.runtime.timing", "qwen3tts_tpu_torch.models.vocoder",
    "qwen3tts_tpu_torch.ops.fused_talker_step", "qwen3tts_tpu_torch.ops.fused_code_predictor",
    "qwen3tts_tpu_torch.ops.fused_vocoder", "qwen3tts_tpu_torch.ops.sampling",
    "qwen3tts_tpu_torch.ops.fused_code_predictor_batched", "qwen3tts_tpu_torch.config",
    "qwen3tts_tpu_torch.text.bpe", "qwen3tts_tpu_torch.ops.int8_matmul",
    "qwen3tts_tpu_torch.ops.decode_attention", "qwen3tts_tpu_torch.ops.attention",
    "qwen3tts_tpu_torch.models.code_predictor", "qwen3tts_tpu_torch.ops.quant",
    "qwen3tts_tpu_torch.ops.w4_gemv_probe", "qwen3tts_tpu_torch.runtime.continuous",
    "qwen3tts_tpu_torch.runtime.e2e", "qwen3tts_tpu_torch.ops.prng",
    "qwen3tts_tpu_torch.ops.kv_quant", "qwen3tts_tpu_torch.cli",
    "qwen3tts_tpu_torch.audio.mel", "qwen3tts_tpu_torch.audio.wav",
    "qwen3tts_tpu_torch.io.safetensors_io", "qwen3tts_tpu_torch.io.tensor_names",
    "qwen3tts_tpu_torch.io.gguf", "qwen3tts_tpu_torch.io.gguf_checkpoint",
    "qwen3tts_tpu_torch.io.config_io", "qwen3tts_tpu_torch.io.loader",
    "qwen3tts_tpu_torch.models.speaker_encoder", "qwen3tts_tpu_torch.ops.precision",
    "qwen3tts_tpu_torch.tools.hf_fixture", "qwen3tts_tpu_torch.parallel",
    "qwen3tts_tpu_torch.parallel.mesh", "qwen3tts_tpu_torch.parallel.shardings",
    "qwen3tts_tpu_torch.parallel.collectives", "qwen3tts_tpu_torch.parallel.kernel_safety",
    "qwen3tts_tpu_torch.utils.profiling", "qwen3tts_tpu_torch.tools.benchmark_continuous",
    "qwen3tts_tpu_torch.tools.benchmark_arrivals",
    "qwen3tts_tpu_torch.tools.benchmark_streaming_load",
    "qwen3tts_tpu_torch.tools.check_quant_cosine", "qwen3tts_tpu_torch.tools.ab_kv_int8",
    "qwen3tts_tpu_torch.io.native", "qwen3tts_tpu_torch.tools.goldens",
    "qwen3tts_tpu_torch.tools.make_goldens", "qwen3tts_tpu_torch.tools.verify_stage",
    "qwen3tts_tpu_torch.tools.compare_e2e", "qwen3tts_tpu_torch.tools.debug_dump",
    "qwen3tts_tpu_torch.tools.selfcheck_fullsize",
    "qwen3tts_tpu_torch.tools.convert_hf_to_gguf",
    "qwen3tts_tpu_torch.tools.inspect_checkpoint",
    "qwen3tts_tpu_torch.tools.time_gguf_load", "qwen3tts_tpu_torch.ops.library",
    "qwen3tts_tpu_torch.tools.export_aot",
]
# packages the port never imports: the JAX package and JAX, and ml_dtypes
# and safetensors, which the machine with the card lacks
BANNED = ("jax", "jaxlib", "qwen3tts_tpu", "ml_dtypes", "safetensors")


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "import qwen3tts_tpu_torch as q; q.Qwen3TTS\n"
            f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {BANNED!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _port_imports():
    """(path, module) of every absolute import in every .py file of the
    port, by an AST walk (relative imports stay inside the port)."""
    root = os.path.join(REPO, "qwen3tts_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                     for a in n.names]
            names += [n.module for n in ast.walk(tree)
                      if isinstance(n, ast.ImportFrom) and n.level == 0]
            yield from ((os.path.relpath(path, REPO), m) for m in names)


def test_no_port_module_imports_jax_or_the_jax_package():
    """No import of the port names jax, a module of qwen3tts_tpu, ml_dtypes
    or safetensors."""
    bad = [(path, m) for path, m in _port_imports() if m.split(".")[0] in BANNED]
    assert not bad, bad


def test_no_port_module_imports_chip_smoke():
    """The package stands below the smoke: no module of the port imports
    chip_smoke.py (the smoke imports the port's helpers, not the other way
    round)."""
    bad = [path for path, m in _port_imports() if m.split(".")[0] == "chip_smoke"]
    assert not bad, bad


@pytest.mark.parametrize("which", ["defaults", "tiny"])
def test_config_copy_matches_the_jax_package(which):
    """The port's config dataclasses equal the JAX package's field for
    field, for the defaults and for tiny_pipeline_config()."""
    def get(mod):
        return mod.PipelineConfig() if which == "defaults" else mod.tiny_pipeline_config()

    j, p = get(jconfig), get(pconfig)
    for name in ("talker", "code_predictor", "vocoder", "speaker_encoder", "runtime"):
        jf = [f.name for f in dataclasses.fields(getattr(j, name))]
        pf = [f.name for f in dataclasses.fields(getattr(p, name))]
        assert jf == pf, name
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert dataclasses.asdict(jconfig.SamplingConfig()) == dataclasses.asdict(
        pconfig.SamplingConfig())
    assert j.talker.n_suppressed_tail == p.talker.n_suppressed_tail
    assert (j.code_predictor.n_steps, j.code_predictor.max_ctx) == (
        p.code_predictor.n_steps, p.code_predictor.max_ctx)
    assert j.vocoder.samples_per_frame == p.vocoder.samples_per_frame


def test_pipeline_defaults_to_the_card():
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    assert Qwen3TTS(pconfig.tiny_pipeline_config()).device.type == "cuda"


@pytest.mark.parametrize("kv_quant", ["int8", "none", "auto"])
def test_kv_quant_is_read_and_the_int8_tier_refused(kv_quant):
    """RuntimeConfig.kv_quant is read, never ignored: the int8-KV tier
    ("int8", refused until it was ported) loads and resolves to "int8";
    "auto" and "none" load and resolve to "none"; an unknown tier is
    refused with a message."""
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS, resolve_kv_quant

    cfg = tiny_pipeline_config()
    rt = dataclasses.replace(cfg.runtime, quant="int8", kv_quant=kv_quant)
    tts = Qwen3TTS(dataclasses.replace(cfg, runtime=rt), device="cpu")
    assert tts.load_models(None, synthetic=True), tts.error_msg
    assert resolve_kv_quant(rt) == ("int8" if kv_quant == "int8" else "none")
    bad = Qwen3TTS(dataclasses.replace(cfg, runtime=dataclasses.replace(rt, kv_quant="fp8")),
                   device="cpu")
    assert not bad.load_models(None, synthetic=True) and "fp8" in bad.error_msg


def test_unknown_weight_tier_is_refused():
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    cfg = tiny_pipeline_config()
    tts = Qwen3TTS(dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                                         quant="fp8")),
                   device="cpu")
    assert not tts.load_models(None, synthetic=True)
    assert "fp8" in tts.error_msg


def test_default_tier_loads_and_serves_on_the_cpu():
    """The default PipelineConfig()'s runtime (quant=None, the bf16 tier;
    kv_quant="auto") at the tiny widths: Qwen3TTS loads synthetic weights
    with plain projection blocks and serves one request and a batch. (The
    full widths run on the card: chip_smoke.default_pipeline.)"""
    from qwen3tts_tpu_torch import SamplingConfig
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    default = pconfig.PipelineConfig().runtime
    assert (default.quant, default.kv_quant) == (None, "auto")
    cfg = tiny_pipeline_config()
    rt = dataclasses.replace(cfg.runtime, quant=default.quant, kv_quant=default.kv_quant)
    tts = Qwen3TTS(dataclasses.replace(cfg, runtime=rt), device="cpu")
    assert tts.load_models(None, synthetic=True), tts.error_msg
    assert all(isinstance(w, torch.Tensor) for w in (
        tts.talker_params.blocks.wqkv, tts.cp_params.blocks.w_down))
    r = tts.synthesize("Hello.", SamplingConfig(max_audio_tokens=4, seed=2))
    assert r.success and len(r.audio) == r.n_frames * 1920
    rs = tts.synthesize_batch(["Hello.", "Two."], SamplingConfig(max_audio_tokens=3))
    assert all(x.success for x in rs)


def test_tier_paths_forbid_every_other_talker_mode():
    """Each tier's serve path demands its own K1/K5 mode and forbids the
    others' (w8a8 included), so no tier runs on another's kernel mode."""
    for q, spec in chip_smoke.TIER_SERVE.items():
        forbidden = chip_smoke.tier_forbidden(spec)
        assert f"fused_talker_step[{spec['mode']}]" in spec["single"]
        assert "fused_talker_step" in forbidden and not set(spec["single"]) & set(forbidden)
        assert chip_smoke.MODE_TIERS[spec["mode"]] == q
    launches = {name: 0 for name in chip_smoke.KERNELS}
    launches.update({"fused_talker_step[bf16]": 2, "fused_res_block": 1})
    spec = chip_smoke.TIER_SERVE[None]
    chip_smoke.check_launches("x", launches, spec["single"], chip_smoke.tier_forbidden(spec))
    launches["fused_talker_step"] = 1
    with pytest.raises(chip_smoke.SmokeFailure, match="fused_talker_step"):
        chip_smoke.check_launches("x", launches, spec["single"], chip_smoke.tier_forbidden(spec))


def test_chip_smoke_names_no_jax_package_module():
    """chip_smoke.py imports the port only: no import statement and no
    module string it loads names jax, a module of qwen3tts_tpu, ml_dtypes
    or safetensors."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    names += [mod for mod, _, _, _ in chip_smoke.KERNELS.values()]
    assert "qwen3tts_tpu_torch.ops.w4_gemv_probe" in names
    assert names and all(m.split(".")[0] not in BANNED for m in names), names


@pytest.fixture
def no_library(monkeypatch):
    def absent():
        raise RuntimeError("kernel library absent")

    monkeypatch.setattr(_kernels, "load_library", absent)


def _tiny_pipeline(quant="int8"):
    return chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"), quant=quant)


def _meta(tree):
    if isinstance(tree, torch.Tensor):
        return tree.to("meta")
    if hasattr(tree, "_fields"):
        return type(tree)(*(_meta(t) for t in tree))
    return tree


def _op_path(base, wrapper):
    """The wrapper of a kernel with a qwen3tts op (ops/library.py), as the
    op's CUDA kernel: the op's operands of the wrapper's arguments, run
    with the dispatcher's CUDA key (a meta tensor itself takes the op's
    fake implementation, shape inference). Other wrappers as they are."""
    from qwen3tts_tpu_torch.ops import library
    from qwen3tts_tpu_torch.ops.fused_code_predictor import predict_codes_operands
    from qwen3tts_tpu_torch.ops.fused_talker_step import talker_step_operands

    ops = {"fused_talker_step": ("talker_step", talker_step_operands),
           "fused_predict_codes": ("predict_codes", predict_codes_operands),
           "int8_matmul": ("int8_matmul", lambda *a: a),
           "decode_attention": ("decode_attention", lambda *a: a),
           "fused_res_block": ("res_block", lambda *a, dilation: (*a, dilation))}
    if base not in ops:
        return wrapper
    name, operands = ops[base]
    cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    return lambda *a, **kw: library.op(name).redispatch(cuda, *operands(*a, **kw))


@pytest.mark.parametrize("kernel", sorted(chip_smoke.KERNELS))
def test_device_request_raises_without_the_library(no_library, kernel):
    """A tensor that is not on the CPU goes to the kernel: with the library
    absent the wrapper raises instead of running its plain version (meta
    tensors stand in for CUDA ones on a machine without a card; the five
    kernels behind a qwen3tts op are reached through the op's CUDA kernel,
    ``_op_path``)."""
    mode = chip_smoke.kernel_mode(kernel)
    tts = _tiny_pipeline(chip_smoke.MODE_TIERS.get(mode, "int8"))
    tcfg, ccfg = tts.config.talker, tts.config.code_predictor
    tp, cp = _meta(tts.talker_params), _meta(tts.cp_params)
    base = kernel.partition("[")[0]
    wrapper = chip_smoke.wrapper(kernel)
    fn = _op_path(base, wrapper)
    meta = torch.device("meta")
    def cache(*lead):
        shape = (*lead, tcfg.n_layers, 2, tcfg.n_kv_heads, 32, tcfg.head_dim)
        if kernel not in chip_smoke.KV_INT8_ENTRIES:
            return torch.zeros(shape, device=meta)
        return (torch.zeros(shape, dtype=torch.int8, device=meta),
                torch.zeros(shape[:-1], device=meta))

    with pytest.raises(RuntimeError, match="absent"):
        if base == "fused_talker_step":
            fn(tp.blocks, tcfg, torch.zeros(tcfg.hidden_size, device=meta), 3, cache(),
               output_norm=tp.output_norm, codec_head=tp.codec_head)
        elif kernel == "fused_predict_codes":
            h = torch.zeros(ccfg.hidden_size, device=meta)
            fn(cp, ccfg, h, h, 0, temperature=0.0, top_k=50, greedy=True)
        elif base == "fused_talker_step_batched":
            start = (dict(start=torch.zeros(2, dtype=torch.int32, device=meta))
                     if kernel == "fused_talker_step_batched[start]" else {})
            fn(tp.blocks, tcfg, torch.zeros((2, tcfg.hidden_size), device=meta), 3, cache(2),
               output_norm=tp.output_norm, codec_head=tp.codec_head, **start)
        elif base == "fused_predict_codes_batched":
            h = torch.zeros((2, ccfg.hidden_size), device=meta)
            temp = (torch.ones(2, device=meta) if kernel in chip_smoke.OPERAND_ENTRIES
                    else 0.0)
            fn(cp, ccfg, h, h, [0, 1], temperature=temp, top_k=50, greedy=True)
        elif kernel == "int8_matmul":
            fn(torch.zeros((2, 128), device=meta), torch.zeros((128, 64), dtype=torch.int8,
                                                             device=meta),
               torch.zeros((1, 64), device=meta))
        elif kernel == "decode_attention":
            kv = torch.zeros((tcfg.n_layers, 2, tcfg.n_kv_heads, 1024, 128), device=meta)
            fn(torch.zeros((tcfg.n_heads, 128), device=meta), kv, 0, 5)
        elif kernel == "w4_gemv_probe":
            fn(torch.zeros((1, 16), dtype=torch.int8, device=meta),
               torch.zeros((2, 8, 4), dtype=torch.int8, device=meta), True)
        elif kernel == "fused_res_block":
            C = 8
            w1, w2, v = (torch.zeros((7, C, C), device=meta),
                         torch.zeros((1, C, C), device=meta), torch.zeros(C, device=meta))
            fn(torch.zeros((64, C), device=meta), w1, v, v, v, w2, v, v, v, dilation=3)
        else:
            fn(torch.zeros((1, 3072), device=meta), torch.zeros(1, dtype=torch.int32,
                                                                device=meta), 0,
               temperature=0.9, top_p=1.0, top_k=50, greedy=False, use_top_p=False)
    assert wrapper.launches == 0 and chip_smoke.read_counts()[kernel] == 0


@pytest.mark.parametrize("lanes", [None, 1, 64], ids=["K2", "K6_B1", "K6_B64"])
def test_code_predictor_grid_needs_the_library(no_library, lanes):
    """The persistent code predictor's grid query (the grid chip_smoke.py
    reports) goes to the library like a launch: without it, it raises; off
    the card chip_smoke reports no grid."""
    from qwen3tts_tpu_torch.config import CodePredictorConfig
    from qwen3tts_tpu_torch.ops.fused_code_predictor import kernel_grid

    with pytest.raises(RuntimeError, match="absent"):
        kernel_grid(CodePredictorConfig(), lanes)
    assert chip_smoke.cp_grid(CodePredictorConfig(), lanes, torch.device("cpu")) is None


def test_cuda_pipeline_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the path without one")
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    cfg = tiny_pipeline_config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, quant="int8"))
    with pytest.raises(RuntimeError):
        Qwen3TTS(cfg, device="cuda").load_models(None, synthetic=True)


def test_chip_smoke_phases_at_tiny_config():
    """Every phase of chip_smoke.py at the tiny configuration on the CPU,
    where each wrapper runs its plain version (so launch counts stay 0)."""
    tts = _tiny_pipeline()
    report = {}
    chip_smoke.check_sampler(tts, report, iters=1)
    chip_smoke.check_talker_step(tts, report, iters=1)
    chip_smoke.check_code_predictor(tts, report, iters=1)
    chip_smoke.check_talker_step_batched(
        tts, report, iters=1, shapes=((2, 32, (3,)), (3, 32, (5, 20)), (2, 64, (40,))))
    chip_smoke.check_code_predictor_batched(tts, report, iters=1, B=6)
    chip_smoke.check_talker_step_start(tts, report, iters=1, B=5, C=64, n_past=40, lows=(0, 24))
    assert {"ms_start_min_24", "bound_ms_start_min_24"} <= set(
        report["fused_talker_step_batched[start]"])
    chip_smoke.check_talker_step_kv_int8(tts, report, iters=1,
                                         single=((32, (0, 20)), (4352, (4000,))),
                                         batched=((3, 32, (0, 5)), (64, 512, (300,))))
    assert {"ms_n_past_4000", "bf16_kv_ms", "bound_ms_n_past_4000"} <= set(
        report["fused_talker_step[kv_int8]"])
    chip_smoke.check_code_predictor_per_lane(tts, report, iters=1, B=6)
    chip_smoke.check_res_block(tts, report, iters=1)
    chip_smoke.check_int8_matmul(tts, report, iters=1, rows=(1, 3))
    chip_smoke.check_decode_attention(tts, report, iters=1, L=2,
                                      shapes=((1, 32, (1, 20)), (2, 64, (40,))))
    tiers = {q: _tiny_pipeline(q) for q in chip_smoke.TIER_SERVE}
    for q, spec in chip_smoke.TIER_SERVE.items():
        chip_smoke.check_talker_step(tiers[q], report, iters=1,
                                     key=f"fused_talker_step[{spec['mode']}]",
                                     positions=((32, (3, 20)), (4352, (300, 4000))), exact=True)
        chip_smoke.check_talker_step_batched(
            tiers[q], report, iters=1, shapes=((2, 32, (3,)), (3, 32, (5, 20))),
            key=f"fused_talker_step_batched[{spec['mode']}]", exact=True)
    chip_smoke.check_w4_gemv_probe(report, torch.device("cpu"), iters=1, shape=(2, 16, 8))
    chip_smoke.check_float32_tier(
        chip_smoke.float32_pipelines(tiny_pipeline_config(), torch.device("cpu")), report,
        iters=1, positions=((32, (3, 20)), (4352, (300,))), shapes=((2, 32, (3,)), (3, 32, (5,))),
        attention=(2, 1280, 40))
    chip_smoke.check_talker_step_lane({"int8": tts}, report, iters=1, shapes=((3, 32, 5),))
    assert set(report) == set(chip_smoke.KERNELS)
    keys = {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err"}
    assert all(keys <= set(r) and r["bound_ms"] > 0 for r in report.values())
    stats, counts = chip_smoke.serve(
        tts, [("Hello.", dict(max_audio_tokens=4, temperature=0.0, seed=1)),
              ("Hi there.", dict(max_audio_tokens=4, seed=3))])
    assert all(s["ok"] for s in stats)
    assert counts == {name: 0 for name in chip_smoke.KERNELS}
    bstats, counts = chip_smoke.serve_batches(
        tts, [(3, dict(max_audio_tokens=4, temperature=0.0, seed=1)),
              (2, dict(max_audio_tokens=4, seed=3))], min_frames_per_lane=1)
    assert [s["lanes"] for s in bstats] == [3, 2] and all(s["frames"] > 0 for s in bstats)
    assert counts == {name: 0 for name in chip_smoke.KERNELS}
    unfused = chip_smoke.unfused_pipeline(tts)
    assert unfused.fused == dict(fused_talker=False, fused_cp=False)
    stats, counts = chip_smoke.serve(
        unfused, [("Hello.", dict(max_audio_tokens=4, temperature=0.0, seed=1))])
    assert all(s["ok"] for s in stats)
    assert counts == {name: 0 for name in chip_smoke.KERNELS}
    for q, spec in chip_smoke.TIER_SERVE.items():
        small = dict(max_audio_tokens=4)
        stats, counts = chip_smoke.serve(tiers[q], [(t, dict(kw, **small))
                                                    for t, kw in spec["requests"]])
        assert all(s["ok"] for s in stats)
        bstats, _ = chip_smoke.serve_batches(
            tiers[q], [(3, dict(kw, **small)) for _, kw in spec["batches"]],
            min_frames_per_lane=1)
        assert len(bstats) == len(spec["batches"])
        assert counts == {name: 0 for name in chip_smoke.KERNELS}
    stats, _ = chip_smoke.serve(chip_smoke.unfused_pipeline(tiers["q4"]),
                                [(t, dict(kw, max_audio_tokens=4))
                                 for t, kw in chip_smoke.UNFUSED_Q4_REQUESTS])
    assert all(s["ok"] for s in stats)


def test_chip_smoke_projection_phase_at_tiny_config(capsys, monkeypatch):
    """K5's projection phase at the tiny configuration on the CPU, with the
    card's harness (project_layers) stood in for by one that writes the
    plain layer's result into its workspace as project_result reads it:
    every projection in every mode reported equal, each timed pass in its
    mode's K5 entry with a bound, the float modes' float64 floor above it,
    and the library call's time; a harness whose result is off by one in
    one element fails the phase."""
    from qwen3tts_tpu_torch.ops import w4_gemv_probe as probe

    def stand_in(x, w, mode, ws=None, off=0):
        B, K = x.shape
        N = (w if isinstance(w, torch.Tensor) else w.q).shape[-1]
        if ws is None:
            ws = torch.zeros(probe.project_ws_bytes(mode, B, K, N), dtype=torch.uint8)
        y = probe.project_layer_plain(x, w, mode, 0)
        y[0, 0] += off
        if mode == "w8a8":
            ws[:4 * B * N].view(torch.int32).view(B, N).copy_(y)
        else:   # split 0 of the first half; the others stay 0
            ws[:8 * B * N].view(torch.float64).view(B, N).copy_(y.double())
        return ws

    tts = _tiny_pipeline()
    monkeypatch.setattr(probe, "project_layers", stand_in)
    report = {}
    chip_smoke.check_projections(tts.config.talker, report, torch.device("cpu"), iters=1,
                                 lanes=(2, 3), check_lanes=(2, 5))
    out = capsys.readouterr().out
    assert out.count(" equal (max abs err") == 3 * 4 * 2 and "DIFFERS" not in out
    for mode, key in chip_smoke.K5_KEYS.items():
        r = report[key]["projections"]
        assert set(r["times"]) == {"B=2", "B=3"}
        for t in r["times"].values():
            assert t["bound_ms"] > 0 and t["device_ms"] is None
            assert t["library_device_ms"] is None and len(t["shapes"]) == 4
            if mode == "w8a8":
                assert t["f64_floor_ms"] is None
            else:
                assert t["library_ms"] is not None and t["f64_floor_ms"] >= t["bound_ms"]
    monkeypatch.setattr(probe, "project_layers", lambda *a: stand_in(*a, off=1))
    for mode in chip_smoke.K5_KEYS:
        with pytest.raises(chip_smoke.SmokeFailure, match="differs"):
            chip_smoke.check_projections(tts.config.talker, {}, torch.device("cpu"), iters=1,
                                         modes=(mode,), lanes=(), check_lanes=(2,))


def test_chip_smoke_queues_at_tiny_config(capsys):
    """The serve phase's continuous queues at the tiny configuration on the
    CPU (plain versions, so every launch count stays 0 and only the
    launch checks are left out): the bench mix emits every budget, the
    tight queue compacts and resets and its first fill equals
    synthesize_batch, the sampled queue stands beside synthesize_batch."""
    tts = _tiny_pipeline()
    bf16 = _tiny_pipeline(None)
    specs = dict(
        bench=dict(n=6, lanes=2, kv_capacity=64, chunk_frames=4, max_frames=8),
        sampled=dict(texts=5, lanes=2, group=3, kw=dict(max_audio_tokens=4, seed=3)),
        # a small tight queue whose budgets still force a compaction and a
        # session reset
        tight=dict(lanes=2, kv_capacity=56, chunk_frames=2, refill_slots=1, max_frames=16),
        bf16=dict(texts=3, lanes=2, kw=dict(max_audio_tokens=4, temperature=0.0, seed=1),
                  budgets=[2, 4, 3]),
        unfused=dict(texts=3, lanes=2, kw=dict(max_audio_tokens=4, temperature=0.0, seed=1),
                     budgets=[3, 2, 4]))
    check = chip_smoke.check_launches
    chip_smoke.check_launches = lambda *a, **k: None
    try:
        runs = chip_smoke.serve_queues(tts, chip_smoke.unfused_pipeline(tts), bf16, "cpu",
                                       specs)
    finally:
        chip_smoke.check_launches = check
    assert len(runs) == 6 and all(set(r.values()) == {0} for r in runs)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("serve_queue ")]
    assert [l["queue"] for l in lines] == ["bench mix", "sampled", "tight greedy", "bf16",
                                           "unfused"]
    assert lines[2]["compactions"] >= 1 and lines[2]["sessions"] >= 1
    assert lines[2]["first_fill_frames_compared"] > 0
    assert lines[1]["static_frames"] > 0 and lines[1]["continuous_over_static"] > 0


def test_chip_smoke_multi_gpu_phase_at_tiny_config(capsys):
    """The multi_gpu phase at the tiny configuration: two gloo ranks on the
    CPU run its three checks (dp lanes of the fused loop against a
    single-process batch of the same lanes, tp = 2 teacher-forced against
    the unsharded run, a queue on dp = 2) through the plain versions, so
    every launch count stays 0 and only the launch gate is left out. On the
    CPU the queue's frames equal the unsharded scheduler's."""
    from qwen3tts_tpu_torch import tiny_pipeline_config as port_tiny_config

    spec = dict(dp=dict(lanes=4, kw=dict(max_audio_tokens=4, seed=5)),
                tp=dict(text="Hello from the port.", capacity=1280, frames=3),
                queue=dict(lanes=2, kv_capacity=64, chunk_frames=2, refill_slots=1,
                           max_frames=6, budgets=(3, 4, 2, 5), seed=40))
    check = chip_smoke.check_launches
    chip_smoke.check_launches = lambda *a, **k: None
    try:
        counts = chip_smoke.serve_multi_gpu(port_tiny_config(), "cpu", spec=spec,
                                            devices=["cpu", "cpu"], backend="gloo")
    finally:
        chip_smoke.check_launches = check
    assert len(counts) == 2 and all(set(c.values()) == {0} for c in counts)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("multi_gpu {")]
    assert [(l["rank"], l["backend"], l["device"]) for l in lines] == [
        (0, "gloo", "cpu"), (1, "gloo", "cpu")]
    assert [l["dp"]["lanes"] for l in lines] == [[0, 2], [2, 4]]
    assert [l["queue"]["lanes"] for l in lines] == [[0, 1], [1, 2]]
    assert lines[0]["queue"]["unsharded_frames_equal_share"] == 1.0
    assert lines[0]["tp"]["local_heads"] == port_tiny_config().talker.n_heads // 2
    # every rank held the GEMM at the shapes its paths gave it (a tp shard's
    # float32 rows among them) against the plain version
    for l in lines:
        assert l["shapes_checked"]["int8_matmul"]["shapes"] > 0
    assert set(chip_smoke.MULTI_GPU_PATH) <= set(chip_smoke.KERNELS)


def test_chip_smoke_kv_int8_serve_at_tiny_config(capsys):
    """The serve phase of the int8-KV tier at the tiny configuration on the
    CPU (plain versions: every count stays 0, so only the launch checks are
    left out): a request and a batch on RuntimeConfig.kv_quant="int8", and
    the paths it demands and forbids (its [kv_int8] entry; no K1/K5 over a
    bf16 cache; the full-width request runs at C = 2304)."""
    from qwen3tts_tpu_torch.config import PipelineConfig, SamplingConfig
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    tts = _tiny_pipeline()
    check = chip_smoke.check_launches
    chip_smoke.check_launches = lambda *a, **k: None
    try:
        runs = chip_smoke.serve_kv_int8(
            tts, "cpu", requests=[("Hello.", dict(max_audio_tokens=4, seed=4))],
            batches=[(3, dict(max_audio_tokens=4, seed=3))], min_frames_per_lane=1)
    finally:
        chip_smoke.check_launches = check
    assert len(runs) == 2 and all(set(r.values()) == {0} for r in runs)
    assert chip_smoke.kv_int8_pipeline(tts).config.runtime.kv_quant == "int8"
    out = capsys.readouterr().out
    assert "serve_kv_int8 " in out and "serve_kv_int8_batch " in out
    for path, own in ((chip_smoke.KV_INT8_SINGLE, "fused_talker_step[kv_int8]"),
                      (chip_smoke.KV_INT8_BATCH, "fused_talker_step_batched[kv_int8]")):
        assert own in path and not set(path) & set(chip_smoke.BF16_KV_TALKER)
    assert {"fused_talker_step", "fused_talker_step_batched",
            "fused_talker_step_batched[start]"} <= set(chip_smoke.BF16_KV_TALKER)
    full = Qwen3TTS(PipelineConfig(), device="cpu")    # no weights needed
    for _, kw in chip_smoke.KV_INT8_REQUESTS:
        assert full._frame_budget(SamplingConfig(**kw))[1] == 2304


def test_unfused_path_needs_decode_attention_from_1024_rows():
    """The kernels the smoke demands of an unfused request: the GEMM and K3,
    and decode attention where the request's KV capacity takes the kernel
    (at the full widths: 600 tokens give C = 1280, 64 give C = 256; the
    smoke's long request and its batch both run at C = 1280)."""
    from qwen3tts_tpu_torch.config import PipelineConfig, SamplingConfig
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    tts = Qwen3TTS(PipelineConfig(), device="cpu")    # no weights needed
    assert chip_smoke.unfused_path(tts, dict(max_audio_tokens=64)) == chip_smoke.UNFUSED_PATH
    assert chip_smoke.unfused_path(tts, dict(max_audio_tokens=600)) == (
        chip_smoke.UNFUSED_PATH + ("decode_attention",))
    for kw in ([kw for _, kw in chip_smoke.UNFUSED_REQUESTS[1:]]
               + [kw for _, kw in chip_smoke.UNFUSED_BATCHES]):
        assert tts._frame_budget(SamplingConfig(**kw))[1] == 1280
        assert "decode_attention" in chip_smoke.unfused_path(tts, kw)


def test_check_launches_demands_the_path_and_forbids_the_rest():
    launches = {name: 0 for name in chip_smoke.KERNELS}
    launches.update(int8_matmul=3, fused_res_block=1)
    chip_smoke.check_launches("x", launches, chip_smoke.UNFUSED_PATH, chip_smoke.FUSED_ONLY)
    with pytest.raises(chip_smoke.SmokeFailure, match="decode_attention"):
        chip_smoke.check_launches("x", launches, ("decode_attention",))
    launches["fused_talker_step"] = 1
    with pytest.raises(chip_smoke.SmokeFailure, match="fused_talker_step"):
        chip_smoke.check_launches("x", launches, chip_smoke.UNFUSED_PATH, chip_smoke.FUSED_ONLY)


def test_chip_smoke_main_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_device_busy_is_the_union_of_device_intervals():
    """Overlapping and nested device intervals count once; host events and
    events without a duration do not count."""
    ev = [dict(cat="kernel", ts=0, dur=1000), dict(cat="kernel", ts=500, dur=1000),
          dict(cat="gpu_memcpy", ts=600, dur=100), dict(cat="gpu_memset", ts=3000, dur=500),
          dict(cat="cpu_op", ts=1500, dur=1000), dict(cat="kernel", ts=4000)]
    assert chip_smoke.device_busy_ms(ev) == pytest.approx(2.0)


def test_device_events_of_a_host_only_profile_are_empty():
    """device_events reads the profiler's event list and keeps only events
    on a CUDA device; a profile of CPU work alone has none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    assert chip_smoke.device_events(prof) == []
    assert chip_smoke.device_ms_per_call(lambda: None, 1, ("x",), torch.device("cpu")) is None


def test_device_top_sums_time_per_kernel_name():
    """Device time and launches summed per kernel (its bare function name),
    largest first; host events do not count."""
    ev = [dict(cat="kernel", name="void (anonymous namespace)::gemm_w8a8_kernel<8>(int)",
               ts=0, dur=3000),
          dict(cat="kernel", name="void (anonymous namespace)::gemm_w8a8_kernel<16>(int)",
               ts=5000, dur=1000),
          dict(cat="gpu_memcpy", name="Memcpy DtoD (Device -> Device)", ts=7000, dur=500),
          dict(cat="cpu_op", name="aten::mm", ts=0, dur=9000),
          dict(cat="kernel", name="void at::native::add<float>(float)", ts=8000, dur=2000)]
    assert chip_smoke.device_top(ev) == [["gemm_w8a8_kernel", 4.0, 2], ["add", 2.0, 1],
                                         ["Memcpy DtoD (Device -> Device)", 0.5, 1]]
    assert len(chip_smoke.device_top(ev, n=1)) == 1


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if any(a.endswith("bad.cu") for a in args):
    sys.exit("bad.cu: error")
with open(out, "w") as f:
    f.write(" ".join(args))
"""


@pytest.mark.parametrize("sources", [("a.cu", "b.cu"), ("a.cu", "bad.cu")])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, sources):
    """One compile per source (-c into its own object), then one link of
    all objects into the library; a failing source raises with its name and
    leaves no library and no objects behind."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    csrc, build_dir = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    for s in sources + ("common.cuh",):
        (csrc / s).write_text(f"// {s}\n")
    monkeypatch.setattr(_kernels, "CSRC", str(csrc))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    if "bad.cu" in sources:
        with pytest.raises(RuntimeError, match="bad.cu"):
            _kernels.build()
        assert os.listdir(build_dir) == []
        return
    lib = _kernels.build()
    assert os.listdir(build_dir) == [os.path.basename(lib)]
    link = open(lib).read().split()
    assert "-shared" in link and [os.path.basename(a) for a in link if a.endswith(".o")] == [
        "a.cu.o", "b.cu.o"]
    assert _kernels.build() == lib   # unchanged sources: built once


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
