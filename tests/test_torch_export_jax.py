"""The AOT export's float32 route (qwen3tts_tpu_torch/tools/export_aot.py
at ``--tiny``, the unfused talker step and code predictor, the route the
JAX package's tool exports on the CPU) against the JAX package's own
exported and deserialized programs (tools/export_aot.py, run as
tests/test_export.py runs it), against the port's eager loop, and the
tool itself (do_export, then do_check)."""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax import export as jax_export

from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.tools import export_aot
from torch_export_common import (BUCKET, FRAMES, REPO, eager, one_torch_thread,  # noqa: F401
                                 pipeline, retrace_check)

TOOLS = os.path.join(REPO, "tools")
# tests/test_torch_vocoder.py's tolerance against the JAX vocoder
RTOL, ATOL = 5e-3, 5e-4
# the route of the JAX tool's tiny programs on the CPU (its XLA step)
UNFUSED = dict(fused_talker=False, fused_cp=False)


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """The tool's float32 tiny programs on the unfused route, exported by
    do_export into a directory."""
    out = str(tmp_path_factory.mktemp("f32"))
    sizes = export_aot.do_export(out, FRAMES, BUCKET, True, device="cpu", **UNFUSED)
    assert set(sizes) == set(export_aot.PROGRAMS)
    return out


def import_jax_tool():
    """The JAX package's tools/export_aot.py, imported as
    tests/test_export.py imports it (tools/ on sys.path for the import
    only)."""
    sys.path.insert(0, TOOLS)
    try:
        import export_aot as jtool
    finally:
        sys.path.remove(TOOLS)
    return jtool


def test_export_tool_then_check(f32):
    """do_export wrote the three programs and export.json; do_check reloads
    them and runs one request and its vocoder on freshly built seeded
    parameters."""
    for name in export_aot.PROGRAMS:
        assert os.path.getsize(os.path.join(f32, f"{name}.pt2")) > 0
    shapes = export_aot.do_check(f32, FRAMES, BUCKET, True, device="cpu")
    n = shapes["prefill+frame"][0]
    assert 0 < n <= FRAMES and shapes["prefill+frame"][1] == 16
    assert shapes["vocoder"] == (FRAMES * pipeline(None).config.vocoder.samples_per_frame,)
    with pytest.raises(ValueError, match="frames"):
        export_aot.do_check(f32, FRAMES + 1, BUCKET, True, device="cpu")


def test_matches_the_jax_package_exported_programs(f32):
    """The JAX tool's build_programs(frames=8, text_bucket=16, tiny=True):
    its generate and vocoder exported, serialized, deserialized and run on
    its PRNGKey(0) parameters and arguments. The same parameters carried
    over (io/from_jax.params_from_jax) through the port's reloaded
    programs: the sampled codes equal JAX's, and equal the port's eager
    loop's; the audio of JAX's codes within the vocoder's tolerance."""
    jtool = import_jax_tool()
    jtool._register_param_types()
    programs_j = jtool.build_programs(FRAMES, BUCKET, True)
    exported = {name: jax_export.deserialize(jax_export.export(fn)(*args).serialize())
                for name, (fn, args) in programs_j.items()}
    gen_args = programs_j["generate"][1]
    res_j = exported["generate"].call(*gen_args)
    tp_j, cp_j, tokens, n_tokens, speaker, lang, key = gen_args
    vp_j = programs_j["vocoder"][1][0]
    codes_j = np.asarray(res_j.codes)[:int(res_j.n_frames)]

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)   # noqa: E731
    tp, cp, vp = (params_from_jax(to_np(p)) for p in (tp_j, cp_j, vp_j))
    programs = export_aot.load_programs(f32)
    assert (programs.spec.fused_talker, programs.spec.fused_cp) == (False, False)
    tts = pipeline(None)
    tts.set_params(tp, cp, vp)
    tcfg = tts.config.talker
    got = export_aot.run_generate(programs, tts.talker_params, tts.cp_params,
                                  torch.from_numpy(np.array(tokens)), int(n_tokens),
                                  torch.from_numpy(np.array(speaker)), int(lang),
                                  np.asarray(key), talker_cfg=tcfg)
    assert got.n_frames == len(codes_j) > 0
    np.testing.assert_array_equal(got.codes.numpy(), codes_j)
    want = eager(tts, programs.spec, np.asarray(tokens), int(n_tokens), np.asarray(key))
    assert torch.equal(got.codes, want.codes) and torch.equal(got.hidden, want.hidden)

    padded = np.zeros((FRAMES, 16), np.int32)
    padded[:len(codes_j)] = codes_j
    n = np.int32(len(codes_j))
    audio = export_aot.run_vocoder(programs, vp, torch.from_numpy(padded).long(), int(n))
    np.testing.assert_allclose(audio.numpy(), np.asarray(exported["vocoder"].call(
        vp_j, padded, n)), rtol=RTOL, atol=ATOL)


def test_float32_programs_do_not_retrace(f32, tmp_path):
    """The reloaded float32 programs (the unfused talker step and code
    predictor) run in a fresh process in which build_prefill,
    talker_prefill, talker_step, predict_codes and vocoder_forward raise,
    and give the eager loop's codes and audio bit for bit."""
    retrace_check([(f32, None)], str(tmp_path))
