"""The port's CLI against the JAX package's (the same 17 flags and
defaults, plus --device), run end to end on the CPU against a checkpoint
directory written by the port's tools/hf_fixture.py, and chip_smoke.py's
checkpoint phase at the tiny configuration."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from qwen3tts_tpu import cli as jcli
from qwen3tts_tpu_torch import cli
from qwen3tts_tpu_torch.audio.wav import load_wav, save_wav
from qwen3tts_tpu_torch.config import RuntimeConfig, SamplingConfig, tiny_pipeline_config
from qwen3tts_tpu_torch.io.config_io import config_from_model_dir
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.tools import hf_fixture

TEXT = "Hello there, port."


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


JAX_FLAGS = sorted(_actions(jcli.build_parser()))


def test_the_jax_cli_has_17_flags():
    assert len(JAX_FLAGS) == 17


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_flag_matches_jax(dest):
    """Each of the JAX CLI's flags: the same option strings, default, type,
    choices, required and action."""
    want, got = _actions(jcli.build_parser())[dest], _actions(cli.build_parser()).get(dest)
    assert got is not None
    for attr in ("option_strings", "default", "type", "choices", "required", "nargs", "const"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert type(got) is type(want)


def test_device_flag_defaults_to_the_card():
    extra = set(_actions(cli.build_parser())) - set(JAX_FLAGS)
    assert extra == {"device"}
    assert cli.build_parser().parse_args(["-t", "x"]).device == "cuda"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("model"))
    hf_fixture.write_checkpoint_dir(root, tiny_pipeline_config())
    x = np.sin(np.arange(4800) * 0.05).astype(np.float32) * 0.3
    save_wav(os.path.join(root, "ref.wav"), x, 24000)
    return root


def test_cli_clones_a_voice_and_writes_a_24khz_wav(model_dir, tmp_path):
    """main(...) with -r on the CPU returns 0 and writes a 24 kHz WAV of
    n_frames * 1920 samples, n_frames as the library gives for the same
    flags."""
    out = str(tmp_path / "out.wav")
    ref = os.path.join(model_dir, "ref.wav")
    rc = cli.main(["-m", model_dir, "-t", TEXT, "-r", ref, "-o", out, "--temperature", "0",
                   "--max-tokens", "4", "--device", "cpu"])
    assert rc == 0
    audio, sr = load_wav(out)
    tts = Qwen3TTS(config_from_model_dir(model_dir, RuntimeConfig()), device="cpu")
    assert tts.load_models(model_dir)
    r = tts.synthesize_with_voice(TEXT, ref, SamplingConfig(temperature=0.0, max_audio_tokens=4))
    assert sr == 24000 and r.n_frames > 0 and len(audio) == r.n_frames * 1920


@pytest.mark.parametrize("argv,message", [
    (["-l", "xx"], "unknown language"),
    (["-m", "/nonexistent/model/dir"], "Failed to load models"),
])
def test_cli_fails_with_a_message(capsys, tmp_path, argv, message):
    rc = cli.main(argv + ["-t", TEXT, "-o", str(tmp_path / "o.wav"), "--device", "cpu"])
    assert rc == 1 and message in capsys.readouterr().err


def test_cli_has_no_cpu_fallback(model_dir, tmp_path):
    """Without --device the CLI asks for the card; with none, it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the path without one")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["-m", model_dir, "-t", TEXT, "-o", str(tmp_path / "o.wav")])


def test_chip_smoke_checkpoint_phase_at_tiny_config(tmp_path, capsys, monkeypatch):
    """chip_smoke.serve_checkpoint at the tiny configuration on the CPU
    (plain versions: every count stays 0, so only the launch checks are
    left out): the written checkpoint's int8 and bf16 tiers, the voice
    request with the CPU embedding beside it, the Q8_0 GGUF directory, the
    CLI and unload_models."""
    monkeypatch.setattr(chip_smoke, "check_launches", lambda *a, **k: None)
    cfg = tiny_pipeline_config()
    runs = chip_smoke.serve_checkpoint(
        cfg, torch.device("cpu"), "cpu", str(tmp_path),
        request=("Hello there.", dict(max_audio_tokens=4, seed=3)),
        bf16_request=("Hello.", dict(max_audio_tokens=4, temperature=0.0, seed=1)),
        voice_seconds=0.2, cli_tokens=4)
    assert len(runs) == 5 and all(set(r.values()) == {0} for r in runs)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("serve_checkpoint {")]
    assert [l["what"] for l in lines] == ["int8 request", "int8 voice request", "bf16 request",
                                         "int8 GGUF request", "cli"]
    assert lines[0]["checkpoint_bytes"] > 0 and lines[0]["t_load_ms"] > 0
    assert lines[1]["embedding_rel_err"] == 0.0 and lines[1]["t_encode_ms"] > 0
    assert lines[3]["gguf_bytes"] > 0 and lines[4]["n_frames"] > 0
