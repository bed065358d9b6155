"""The port's golden tools (``qwen3tts_tpu_torch/tools``: make_goldens,
verify_stage, compare_e2e, debug_dump) against the JAX package's
(``tools/``), both directions, at the tiny config on the CPU, over one
checkpoint directory written by the port's ``tools/hf_fixture.py`` (whose
leaves both loaders read bit for bit): the JAX goldens pass the port's
bars with the codes equal exactly, the port's goldens pass the JAX bars,
both dumps carry the same file names, the teacher-forced checks and
chip_smoke's ``parity_fullsize`` phase on the JAX goldens.

``test_fullsize_parity`` (marked slow: a 2.29 GB checkpoint and a float32
0.6B model on the CPU, minutes) holds the port at ``PipelineConfig()``'s
widths against the JAX package's committed goldens
(``tests/torch_goldens/fullsize``, PROVENANCE.json) with the same bars and
teacher-forced checks as the smoke's phase."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from qwen3tts_tpu_torch.config import tiny_pipeline_config
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.tools import compare_e2e, debug_dump, goldens, hf_fixture
from qwen3tts_tpu_torch.tools import make_goldens, verify_stage
from torch_continuous_common import one_torch_thread  # noqa: F401 - fixture by name

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
FULLSIZE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_goldens", "fullsize")
FRAMES = 8
DET_FILES = ("det_speaker_embedding.bin", "det_text_tokens.bin", "det_prefill_embedding.bin",
             "det_trailing_text.bin", "det_tts_pad_embed.bin", "det_speech_codes.bin",
             "det_hidden_states.bin", "det_decoded_audio.bin")
# float32 both sides, summation order only; the integer files are equal.
# The audio within the vocoder's tolerance against JAX
# (tests/test_torch_vocoder.py's RTOL, ATOL: the snakes amplify the order)
FLOAT_TOL = dict(rtol=1e-4, atol=1e-4)
AUDIO_TOL = dict(rtol=5e-3, atol=5e-4)


def _tol(name):
    return AUDIO_TOL if "audio" in name else FLOAT_TOL


def jax_tool(name):
    """A module of the JAX package's tools/ (they read sys.argv)."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return __import__(name)


def run_jax_tool(name, argv):
    """(rc, stdout) of the JAX tool's main() with argv."""
    mod, old, out = jax_tool(name), sys.argv, io.StringIO()
    sys.argv = [name] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main()
    finally:
        sys.argv = old
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The tiny checkpoint (seed 0), the JAX goldens of it (with a
    PROVENANCE.json naming the seed, as the committed goldens carry) and
    the port's."""
    root = tmp_path_factory.mktemp("goldens")
    fx = str(root / "fixture")
    hf_fixture.write_checkpoint_dir(fx, tiny_pipeline_config(), 0)
    jg, pg = str(root / "jax"), str(root / "port")
    rc, _ = run_jax_tool("make_goldens", ["--tiny", "--model", fx, "--max-frames", str(FRAMES),
                                          "--out", jg])
    assert rc == 0
    with open(os.path.join(jg, "PROVENANCE.json"), "w") as f:
        json.dump({"fixture": {"seed": 0}}, f)
    assert make_goldens.main(["--tiny", "--model", fx, "--max-frames", str(FRAMES), "--out", pg,
                              "--device", "cpu"]) == 0
    return dict(fixture=fx, jax=jg, port=pg, root=str(root))


@pytest.fixture(scope="module")
def port_tts(dirs):
    tts = Qwen3TTS(goldens.pipeline_config(True), "cpu", **goldens.TOOL_FLAGS)
    assert tts.load_models(dirs["fixture"]), tts.error_msg
    return tts


def _model_args(dirs):
    return ["--tiny", "--model", dirs["fixture"]]


def test_jax_goldens_pass_the_port_verify_stage(dirs, capsys):
    assert verify_stage.main(["--goldens", dirs["jax"], *_model_args(dirs), "--device", "cpu",
                              "--teacher-forced"]) == 0
    out = capsys.readouterr().out
    assert "4 passed, 0 failed" in out and "[INFO] teacher_forced" in out


def test_jax_goldens_codes_equal_the_port_codes_exactly(dirs, port_tts):
    """Every bar passes and the port's greedy codes equal det_speech_codes.bin
    (the port's tiny greedy codes equal JAX's)."""
    bars = verify_stage.verify(port_tts, goldens.Goldens(dirs["jax"]), tiny=True)
    assert [b["stage"] for b in bars] == ["tokenizer", "prefill_embedding",
                                          "transformer_codes", "decoder_audio"]
    assert all(b["ok"] for b in bars)
    codes = bars[2]
    assert codes["codes_equal"] and codes["frames_run"] == codes["frames_golden"] == FRAMES
    assert codes["cb0_match"] == codes["cb1_4_match"] == 1.0


def test_jax_goldens_pass_the_port_compare_e2e(dirs, capsys):
    assert compare_e2e.main(["--goldens", dirs["jax"], *_model_args(dirs),
                             "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["pass"] and report["frame_exact_match"] == 1.0
    assert report["duration_ratio"] == 1.0 and report["correlation"] > 0.9999


@pytest.mark.parametrize("tool", ["verify_stage", "compare_e2e"])
def test_port_goldens_pass_the_jax_tool(dirs, tool):
    rc, out = run_jax_tool(tool, ["--goldens", dirs["port"], *_model_args(dirs)])
    assert rc == 0, out


def test_port_goldens_metadata_equals_the_jax_tools(dirs):
    """det_metadata.json: the same keys and values, the same outputs with
    the same shapes, dtypes and byte counts (the sha256 of the integer
    files too)."""
    j, p = goldens.Goldens(dirs["jax"]).meta, goldens.Goldens(dirs["port"]).meta
    assert {k: v for k, v in j.items() if k != "outputs"} == \
        {k: v for k, v in p.items() if k != "outputs"}
    assert list(j["outputs"]) == list(p["outputs"]) == list(DET_FILES)
    for name, want in j["outputs"].items():
        got = p["outputs"][name]
        for key in ("path", "shape", "dtype", "size_bytes"):
            assert got[key] == want[key], (name, key)
        if want["dtype"] == "int64" or name == "det_speaker_embedding.bin":
            assert got["sha256"] == want["sha256"], name


@pytest.mark.parametrize("name", [n for n in DET_FILES if n not in (
    "det_speaker_embedding.bin", "det_text_tokens.bin", "det_speech_codes.bin")])
def test_port_golden_float_files_match_the_jax_tools(dirs, name):
    j = goldens.Goldens(dirs["jax"]).bin(name, np.float32)
    p = goldens.Goldens(dirs["port"]).bin(name, np.float32)
    np.testing.assert_allclose(p, j, **_tol(name))


def test_teacher_forced_on_the_jax_goldens(dirs, port_tts):
    """The golden codes fed back: every codebook's greedy prediction equals
    the golden code in every frame (the port's free run equals them)."""
    tf = goldens.teacher_forced(port_tts, goldens.Goldens(dirs["jax"]))
    assert tf["frames"] == FRAMES and tf["per_codebook"] == [1.0] * 16
    assert tf["frame_exact"] == 1.0


def test_vocoder_on_the_jax_golden_codes(dirs, port_tts):
    """The golden codes vocoded against det_decoded_audio.bin, within the
    vocoder's tolerance against JAX (tests/test_torch_vocoder.py's ATOL)."""
    v = goldens.vocode_goldens(port_tts, goldens.Goldens(dirs["jax"]))
    assert v["lengths_equal"] and v["samples"] == FRAMES * 1920
    assert v["max_abs_err"] <= 5e-4 and v["rms_err"] <= 5e-5


@pytest.mark.parametrize("voice", [False, True])
def test_debug_dump_names_and_values_match_the_jax_tool(dirs, tmp_path, voice):
    """The same .npy file names, shapes and dtypes as the JAX tool's, the
    values within FLOAT_TOL or AUDIO_TOL (integers equal), with and without a reference
    voice."""
    argv = ["--tiny", "--model", dirs["fixture"], "--max-frames", "4"]
    if voice:
        ref = str(tmp_path / "ref.wav")
        from qwen3tts_tpu_torch.audio.wav import save_wav
        save_wav(ref, (0.3 * np.sin(np.arange(800) * 0.07)).astype(np.float32), 24000)
        argv += ["--reference-audio", ref]
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    rc, _ = run_jax_tool("debug_dump", argv + ["--out", jd])
    assert rc == 0
    tts = Qwen3TTS(goldens.pipeline_config(True), "cpu", **goldens.TOOL_FLAGS)
    assert tts.load_models(dirs["fixture"])
    names = debug_dump.debug_dump(tts, pd, tiny=True, max_frames=4, verbose=False,
                                  reference_audio=argv[-1] if voice else None)
    stems = lambda d: sorted(f[:-4] for f in os.listdir(d))   # noqa: E731
    assert stems(jd) == sorted(names) == stems(pd)
    assert ("mel" in names) == voice
    for name in names:
        j, p = np.load(os.path.join(jd, name + ".npy")), np.load(os.path.join(pd, name + ".npy"))
        assert j.shape == p.shape, name
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(p, j, err_msg=name)
        else:
            np.testing.assert_allclose(p, j, err_msg=name, **_tol(name))


def test_debug_dump_cli_writes_every_file(dirs, tmp_path):
    out = str(tmp_path / "dump")
    assert debug_dump.main(["--tiny", "--model", dirs["fixture"], "--max-frames", "2", "--out",
                            out, "--device", "cpu"]) == 0
    assert len(os.listdir(out)) == 10


def test_verify_stage_fails_loudly_on_other_goldens(dirs, tmp_path, capsys):
    """Goldens of other codes fail the transformer bar, rc 1, with the
    stage named."""
    bad = str(tmp_path / "bad")
    shutil.copytree(dirs["jax"], bad)
    codes = goldens.Goldens(bad).codes()
    ((codes + 7) % 2048).astype(np.int64).tofile(os.path.join(bad, "det_speech_codes.bin"))
    assert verify_stage.main(["--goldens", bad, *_model_args(dirs), "--device", "cpu",
                              "--stage", "transformer"]) == 1
    assert "[FAIL] transformer_codes" in capsys.readouterr().out


def test_chip_smoke_parity_phase_at_tiny_config(dirs, capsys):
    """chip_smoke.parity_fullsize at the tiny config on the CPU over the
    JAX goldens and the fixture of their PROVENANCE seed: every bar and
    gate passes, the teacher-forced shares are 1.0, the vocoder gate holds
    (plain versions: the counts stay 0)."""
    runs = chip_smoke.parity_fullsize(tiny_pipeline_config(), torch.device("cpu"), "cpu",
                                      dirs["fixture"], goldens_dir=dirs["jax"])
    assert len(runs) == 3 and all(set(r.values()) == {0} for r in runs)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("parity_fullsize {")]
    whats = [l["what"] for l in lines]
    assert whats == ["verify_stage"] * 4 + ["route", "compare_e2e", "teacher_forced",
                                            "vocoder_on_golden_codes"]
    assert all(l["ok"] for l in lines[:4]) and lines[5]["pass"]
    assert lines[4]["route"]["dtype"] == "float32" and lines[6]["cb0"] == 1.0
    assert lines[4]["route"]["fused_talker"] is False
    assert lines[7]["ok"]


def test_chip_smoke_parity_phase_fails_on_a_failing_bar(dirs, tmp_path, capsys):
    """Goldens of other codes: parity_fullsize prints every bar, the
    transformer bar and the teacher-forced shares as failing, then raises
    SmokeFailure naming them."""
    bad = str(tmp_path / "bad")
    shutil.copytree(dirs["jax"], bad)
    codes = goldens.Goldens(bad).codes()
    ((codes + 7) % 2048).astype(np.int64).tofile(os.path.join(bad, "det_speech_codes.bin"))
    with pytest.raises(chip_smoke.SmokeFailure, match="transformer_codes") as e:
        chip_smoke.parity_fullsize(tiny_pipeline_config(), torch.device("cpu"), "cpu",
                                   dirs["fixture"], goldens_dir=bad)
    assert "teacher_forced cb0" in str(e.value) and "teacher_forced cb1_15" in str(e.value)
    out = capsys.readouterr().out
    assert "vocoder_on_golden_codes" in out and "FAILED: ['transformer_codes'" in out


@pytest.mark.slow
def test_fullsize_parity(tmp_path):
    """The port at PipelineConfig()'s widths in float32 on the CPU against
    the JAX package's committed goldens, over the fixture of their
    PROVENANCE seed: every verify_stage bar and the compare_e2e gates
    pass, the teacher-forced codes agree in every codebook, and the
    golden codes vocoded lie within chip_smoke's vocoder tolerances."""
    with open(os.path.join(FULLSIZE, "PROVENANCE.json")) as f:
        prov = json.load(f)
    from qwen3tts_tpu_torch.config import PipelineConfig

    root = hf_fixture.fixture_for(PipelineConfig(), str(tmp_path), prov["fixture"]["seed"])
    torch.set_num_threads(os.cpu_count() or 1)   # the module's fixture restores it
    tts = Qwen3TTS(goldens.pipeline_config(False), "cpu", **goldens.TOOL_FLAGS)
    assert tts.load_models(root), tts.error_msg
    g = goldens.Goldens(FULLSIZE)
    v = goldens.vocode_goldens(tts, g)
    assert v["lengths_equal"] and v["max_abs_err"] <= chip_smoke.VOCODER_GOLDEN_MAX_ABS
    assert v["rms_err"] <= chip_smoke.VOCODER_GOLDEN_RMS
    tf = goldens.teacher_forced(tts, g)
    assert tf["frames"] == prov["frames"] and tf["frame_exact"] == 1.0, tf
    assert all(tf[k] >= floor for k, floor in chip_smoke.TEACHER_FORCED_FLOORS.items()), tf
    bars = verify_stage.verify(tts, g)
    assert all(b["ok"] for b in bars), bars
    assert compare_e2e.compare(tts, g)["pass"]
