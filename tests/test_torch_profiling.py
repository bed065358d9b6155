"""``qwen3tts_tpu_torch/utils/profiling.py``: ``trace`` writes a trace of the
enclosed block into its directory, with the ``annotate`` regions named in
it, at every host tracer level that records the host; level 0 (device
only) is refused where there is no device to record."""

from __future__ import annotations

import glob
import json
import os

import pytest
import torch

from qwen3tts_tpu_torch.utils.profiling import annotate, trace


def _events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("level", [1, 2, 3])
def test_trace_names_the_annotated_region(tmp_path, level):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir, host_tracer_level=level):
        with annotate("request"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    events = _events(log_dir)
    regions = [e for e in events if e.get("name") == "request"]
    assert len(regions) == 1 and regions[0]["cat"] == "user_annotation"
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(("Input Dims" in e.get("args", {})) == (level >= 2) for e in mm)


def test_trace_is_written_when_the_block_raises(tmp_path):
    log_dir = str(tmp_path / "trace")
    with pytest.raises(RuntimeError, match="inside"):
        with trace(log_dir):
            with annotate("failing"):
                raise RuntimeError("inside")
    assert any(e.get("name") == "failing" for e in _events(log_dir))


def test_device_only_level_needs_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: level 0 records it")
    with pytest.raises(ValueError, match="no CUDA device"):
        with trace(str(tmp_path), host_tracer_level=0):
            pass


def test_chip_smoke_trace_phase_at_tiny_config(capsys, monkeypatch):
    """chip_smoke's trace phase at the tiny configuration on the CPU: the
    request succeeds and its one trace file names the annotate region (no
    kernels on the CPU, where the plain versions run and the counts stay
    0; on the card the phase also needs K1's and K2's kernels in it)."""
    import chip_smoke
    from qwen3tts_tpu_torch import tiny_pipeline_config

    tts = chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "check_launches", lambda *a, **k: None)
    counts = chip_smoke.trace_request(tts, "cpu", ("Hello from the port.", dict(
        max_audio_tokens=4, temperature=0.0, seed=1)))
    assert set(counts.values()) == {0}
    (line,) = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
               if l.startswith("trace {")]
    assert line["regions"] == 1 and line["kernels"] == 0 and line["trace_bytes"] > 0
