"""The port's CUDA kernels against their plain versions on the card, at the
main path's full widths (the same checks as chip_smoke.py's kernel phase).

Marked ``gpu``; on a machine without a CUDA device every test skips. On the
card: ``python -m pytest -m gpu tests/test_torch_gpu.py -q``.
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
                                   "check_int8_matmul", "check_decode_attention"])
def test_kernel_matches_plain_on_card(tts, check):
    report = {}
    getattr(chip_smoke, check)(tts, report, iters=1)
    torch.cuda.synchronize()
    assert report
