"""The port's checkpoint tools against the JAX package's, at the tiny config
on the CPU: ``tools/convert_hf_to_gguf.py`` (every --type, both --kinds:
the file equal byte for byte to the JAX tool's), ``tools/inspect_checkpoint.py``
(the report equal to the JAX tool's; the audit's verdict equal on a sound
checkpoint and on one with a mangled shape), ``tools/selfcheck_fullsize.py``
at the tiny config, the vocoder's ``trim="symmetric"`` against JAX's, and
chip_smoke's ``checkpoint_tools`` phase."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import qwen3tts_tpu.config as jconfig
from qwen3tts_tpu.models import vocoder as jvoc
from qwen3tts_tpu_torch.config import tiny_pipeline_config
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.io.safetensors_io import SafetensorsDir, write_safetensors
from qwen3tts_tpu_torch.models import vocoder as pvoc
from qwen3tts_tpu_torch.tools import convert_hf_to_gguf, hf_fixture, inspect_checkpoint
from qwen3tts_tpu_torch.tools import selfcheck_fullsize
from torch_continuous_common import one_torch_thread  # noqa: F401 - fixture by name

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
CFG = tiny_pipeline_config()
VCFG = CFG.vocoder
# the vocoder's tolerance against JAX (tests/test_torch_vocoder.py)
RTOL, ATOL = 5e-3, 5e-4
KIND_DIRS = {"tts": hf_fixture.TTS_DIR, "tokenizer": hf_fixture.TOKENIZER_DIR}
# a shape the audit must refuse, per kind: a layer's projection inside a
# stacked leaf
MANGLED = {"tts": "talker.model.layers.1.self_attn.q_proj.weight",
           "tokenizer": "decoder.decoder.1.block.3.conv1.conv.weight"}


def jax_tool(name):
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return __import__(name)


def _stdout(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*a, **kw)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    hf_fixture.write_checkpoint_dir(d, CFG)
    return d


@pytest.fixture(scope="module")
def mangled(tmp_path_factory):
    """The fixture with MANGLED[kind]'s last axis one longer, per kind."""
    d = str(tmp_path_factory.mktemp("mangled"))
    hf_fixture.write_checkpoint_dir(d, CFG)
    for kind, name in MANGLED.items():
        path = os.path.join(d, KIND_DIRS[kind])
        tensors = dict(SafetensorsDir(path).items())
        t = tensors[name]
        tensors[name] = torch.cat([t, t[..., :1]], dim=-1)
        write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    return d


@pytest.mark.parametrize("kind", list(KIND_DIRS))
@pytest.mark.parametrize("out_type", convert_hf_to_gguf.TYPES)
def test_converter_writes_the_jax_tools_bytes(root, tmp_path, out_type, kind):
    src = os.path.join(root, KIND_DIRS[kind])
    mine, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    r = convert_hf_to_gguf.convert(src, mine, out_type, kind)
    jax_tool("convert_hf_to_gguf").convert(src, theirs, out_type, kind)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert r["converted"] > 0 and r["skipped"] == 0


def test_converter_cli(root, tmp_path, capsys):
    out = str(tmp_path / "m.gguf")
    assert convert_hf_to_gguf.main(["-i", os.path.join(root, hf_fixture.TTS_DIR), "-o", out,
                                    "-t", "q8_0"]) == 0
    assert "tensors converted, 0 skipped" in capsys.readouterr().out
    with pytest.raises(ValueError):
        convert_hf_to_gguf.convert(root, out, "q3", "tts")


def _jax_inspect(argv):
    mod, old = jax_tool("inspect_checkpoint"), sys.argv
    sys.argv = ["inspect_checkpoint"] + argv
    try:
        return _stdout(mod.main)
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def gguf_files(root, tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf")
    out = {}
    for t in ("q8_0", "q4_k_mixed"):
        for kind, sub in KIND_DIRS.items():
            out[(t, kind)] = str(d / f"{kind}-{t}.gguf")
            convert_hf_to_gguf.convert(os.path.join(root, sub), out[(t, kind)], t, kind)
    return out


@pytest.mark.parametrize("what", ["tts dir", "tokenizer dir", "q8_0 tts", "q8_0 tokenizer",
                                  "q4_k_mixed tts"])
def test_inspector_report_equals_the_jax_tools(root, gguf_files, what):
    a, b = what.split()
    path = (os.path.join(root, KIND_DIRS[a]) if b == "dir" else gguf_files[(a, b)])
    want = _jax_inspect([path])
    got = _stdout(inspect_checkpoint.main, [path])
    assert got == want and want[0] == 0


@pytest.mark.parametrize("kind", list(KIND_DIRS))
@pytest.mark.parametrize("sound", [True, False])
def test_audit_verdict_equals_the_jax_tools(root, mangled, monkeypatch, kind, sound):
    """The JAX audit (against the tiny config in place of PipelineConfig())
    passes a sound checkpoint and prints the same parameter counts as the
    port's; on a mangled shape its loader raises, and the port's audit
    fails (exit 1) naming the loader."""
    path = os.path.join(root if sound else mangled, KIND_DIRS[kind])
    tiny = jconfig.tiny_pipeline_config()
    monkeypatch.setattr(jconfig, "PipelineConfig", lambda: tiny)
    jax_audit = jax_tool("inspect_checkpoint").audit
    rc, out = _stdout(inspect_checkpoint.main, [path, "--audit", kind, "--tiny",
                                                "--device", "cpu"])
    counts = [l for l in out.splitlines() if " params:" in l]
    if sound:
        jrc, jout = _stdout(jax_audit, path, kind)
        assert jrc == 0 and rc == 0
        assert counts == [l for l in jout.splitlines() if " params:" in l]
        assert "audit passed: 0 problem(s)" in out
    else:
        with pytest.raises(Exception):
            _stdout(jax_audit, path, kind)
        assert rc == 1 and "audit FAILED" in out and "the loader failed" in out


def test_audit_holds_a_gguf_file_against_the_config(gguf_files, capsys):
    errors = inspect_checkpoint.audit(gguf_files[("q8_0", "tts")], "tts", CFG, "cpu")
    assert errors == []
    errors = inspect_checkpoint.audit(gguf_files[("q8_0", "tts")], "tts",
                                      chip_smoke.dataclasses.replace(
                                          CFG, talker=chip_smoke.dataclasses.replace(
                                              CFG.talker, intermediate_size=64)), "cpu")
    assert errors and all("configured" in e or "loader" in e for e in errors)


def test_selfcheck_at_tiny_config(tmp_path):
    out = selfcheck_fullsize.selfcheck(str(tmp_path / "fx"), CFG, device="cpu",
                                       runtime=CFG.runtime, log=lambda *_: None)
    assert out["frames"] == 2 and out["samples"] == 2 * 1920 and out["parameters"] > 0


@pytest.fixture(scope="module")
def voc():
    params = jvoc.init_vocoder_params(jax.random.PRNGKey(5), VCFG, jnp.float32)
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    codes = np.random.default_rng(6).integers(0, VCFG.codebook_size, size=(6, 16)).astype(
        np.int32)
    return params, port, codes


@pytest.mark.parametrize("trim", ["causal", "symmetric"])
def test_vocoder_trim_matches_jax(voc, trim):
    """vocoder_forward(trim=...) against JAX's: the symmetric trim drops
    K - stride rows at the left of every transposed conv, so the clip is
    shorter than frames * 1920 (by the same count as JAX's)."""
    params, port, codes = voc
    want = np.asarray(jvoc.vocoder_forward(params, VCFG, jnp.asarray(codes), trim=trim))
    got = pvoc.vocoder_decode(port, VCFG, torch.from_numpy(codes), trim=trim).numpy()
    assert got.shape == want.shape
    assert (got.shape[0] == 6 * VCFG.samples_per_frame) == (trim == "causal")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride", [2, 3, 5])
@pytest.mark.parametrize("trim", ["causal", "symmetric"])
def test_conv_transpose_trim_matches_jax(stride, trim):
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(7, 6)).astype(np.float32)
    w = rng.normal(size=(2 * stride, 6, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = np.asarray(jvoc.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                            stride=stride, trim=trim))
    got = pvoc.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), stride=stride, trim=trim).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_default_trim_is_causal_and_others_raise(voc):
    _, port, codes = voc
    c = torch.from_numpy(codes)
    torch.testing.assert_close(pvoc.vocoder_decode(port, VCFG, c),
                               pvoc.vocoder_decode(port, VCFG, c, trim="causal"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="trim"):
        pvoc.vocoder_decode(port, VCFG, c, trim="left")


def test_chip_smoke_checkpoint_tools_phase_at_tiny_config(tmp_path, capsys, monkeypatch):
    """chip_smoke.checkpoint_tools at the tiny config on the CPU (plain
    versions: the counts stay 0, so the launch checks are left out): both
    conversions, both audits pass, the load split of three readers, and
    the int8 request served from the q8_0 files through NativeGGUF."""
    monkeypatch.setattr(chip_smoke, "check_launches", lambda *a, **k: None)
    root = str(tmp_path)
    hf_fixture.write_checkpoint_dir(root, CFG)
    runs = chip_smoke.checkpoint_tools(
        CFG, torch.device("cpu"), "cpu", root,
        request=("Hello there.", dict(max_audio_tokens=4, seed=3)))
    assert len(runs) == 1 and set(runs[0].values()) == {0}
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("checkpoint_tools {")]
    whats = [l["what"] for l in lines]
    assert whats.count("convert") == 4 and whats.count("audit") == 4
    assert all(l["passed"] for l in lines if l["what"] == "audit")
    split = {l["reader"]: l for l in lines if l["what"] == "load_split"}
    assert set(split) == {"gguf_native", "gguf_python", "safetensors"}
    assert all(s["total_s"] > 0 and s["read_s"] > 0 for s in split.values())
    req = lines[-1]
    assert req["what"] == "int8 GGUF request" and req["reader"] == "NativeGGUF"
    assert req["n_frames"] > 0


def test_time_gguf_load_at_tiny_config(tmp_path):
    """tools/time_gguf_load.py's runs at the tiny config on the CPU: the
    fixture converted to q8_0, each reader's split in every run, and
    load_models of both directories."""
    from qwen3tts_tpu_torch.tools import time_gguf_load

    out = time_gguf_load.time_loads(str(tmp_path), CFG, torch.device("cpu"), runs=2)
    assert set(out["splits"]) == {"gguf_native", "gguf_python", "safetensors"}
    assert all(len(v) == 2 for v in out["splits"].values())
    assert out["mean"]["gguf_native"]["total_s"] > 0 and out["gguf_bytes"] > 0
    assert all(len(v) == 2 and min(v) > 0 for v in out["load_models_ms"].values())
