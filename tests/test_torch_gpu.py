"""The port's CUDA kernels against their plain versions on the card, at the
main path's full widths (the same checks as chip_smoke.py's kernel phase).

Marked ``gpu``; on a machine without a CUDA device every test skips. On the
card: ``python -m pytest -m gpu tests/test_torch_gpu.py -q``; the code
predictor's alone (K2, K6, K6 per lane: codes equal to the plain version,
one persistent launch per call): ``-k code_predictor``.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from qwen3tts_tpu_torch.config import PipelineConfig

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def tts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return chip_smoke.make_pipeline(PipelineConfig(), torch.device("cuda", 0))


@pytest.mark.parametrize("check", ["check_sampler", "check_talker_step",
                                   "check_code_predictor", "check_talker_step_batched",
                                   "check_code_predictor_batched", "check_res_block",
                                   "check_int8_matmul", "check_decode_attention",
                                   "check_talker_step_start", "check_talker_step_kv_int8",
                                   "check_code_predictor_per_lane"])
def test_kernel_matches_plain_on_card(tts, check):
    report = {}
    getattr(chip_smoke, check)(tts, report, iters=1)
    torch.cuda.synchronize()
    assert report


@pytest.mark.parametrize("check, key", [
    ("check_code_predictor", "fused_predict_codes"),
    ("check_code_predictor_batched", "fused_predict_codes_batched"),
    ("check_code_predictor_per_lane", "fused_predict_codes_batched[per_lane]")])
def test_code_predictor_is_one_persistent_launch(tts, check, key):
    """K2 (one lane) and K6 (B = 64, 20 and 5; per-lane sampling): codes
    equal to the plain version (the check's gate), one kernel of the port's
    library per call under the profiler, the phase plan's barriers."""
    report = {}
    getattr(chip_smoke, check)(tts, report, iters=1)
    r, ccfg = report[key], tts.config.code_predictor
    L, S = ccfg.n_layers, ccfg.n_steps
    assert r["kernels_per_call"]["library"] == 1
    # 8 per layer and pass, 2 more per pass that samples
    assert r["grid"]["barriers"] == (S + 1) * L * 8 + 2 * S
    assert r["grid"]["blocks"] >= r["grid"]["sms"]
    assert r["device_ms"] is not None and r["device_ms"] > 0


@pytest.mark.parametrize("quant", [None, "q4", "q4pure"], ids=["bf16", "q4", "q4pure"])
def test_talker_modes_match_plain_on_card(quant):
    """K1 and K5 in the tier's weight mode against their plain versions (the
    exact 2-layer gates of chip_smoke.py), on the tier's synthetic weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    tier = chip_smoke.make_pipeline(PipelineConfig(), torch.device("cuda", 0), quant=quant)
    mode, report = chip_smoke.TIER_SERVE[quant]["mode"], {}
    chip_smoke.check_talker_step(tier, report, iters=1, key=f"fused_talker_step[{mode}]",
                                 positions=((512, (10, 300)),), exact=True)
    chip_smoke.check_talker_step_batched(tier, report, iters=1,
                                         shapes=((5, 512, (10,)), (16, 512, (300,))),
                                         key=f"fused_talker_step_batched[{mode}]", exact=True)
    torch.cuda.synchronize()
    assert len(report) == 2


def test_w4_gemv_probe_exact_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    report = {}
    chip_smoke.check_w4_gemv_probe(report, torch.device("cuda", 0), iters=1)
    assert report["w4_gemv_probe"]["max_abs_err"] == 0.0
