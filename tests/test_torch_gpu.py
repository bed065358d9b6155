"""The port's CUDA kernels against their plain versions on the card, at the
main path's full widths (the same checks as chip_smoke.py's kernel phase).

Marked ``gpu``; on a machine without a CUDA device every test skips. On the
card: ``python -m pytest -m gpu tests/test_torch_gpu.py -q``; the code
predictor's alone (K2, K6, K6 per lane: codes equal to the plain version,
one persistent launch per call): ``-k code_predictor``; the attention kernels
alone (decode attention in one launch per call, K1/K5's attention stage in
one launch per layer, K5's over the lane-major cache, the split rules):
``-k attention``; K1's GEMVs and
K5's projection GEMMs alone (each mode against its plain version): ``-k
"projections or head_gemv"``; K3
alone (every width, each dilation, a ragged T, launches per res block;
over a group of 16 lanes, each lane bit for bit the one-lane call):
``-k res_block``; the W8A16 GEMM alone (bf16 and float32 x, one launch per
call): ``-k int8_matmul``; the sampler alone (the adversarial rows at both
widths, on each site's block): ``-k sampler``.
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


def test_sampler_rows_match_plain_on_card(tts):
    """K4 on the adversarial rows of chip_smoke.sampler_rows at both widths,
    each on its site's block (the codec head's and the code predictor's),
    greedy, top-k and top-k + top-p with per-row parameters: 0 tokens
    differ from the plain version. A default-sampled row takes at most 10
    block-wide exchanges, and each block holds its row."""
    from qwen3tts_tpu_torch.ops.sampling import sample_shape

    worst, draws = chip_smoke.sampler_gate(tts)
    assert draws > 0 and worst == 0, f"{worst} of {draws} tokens differ"
    for V in (tts.config.talker.codec_vocab_size, tts.config.code_predictor.vocab_size):
        threads, per_thread, exchanges = sample_shape(V, greedy=False, top_k=50,
                                                      use_top_p=False)
        assert threads * per_thread >= V and exchanges <= 10


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


@pytest.mark.parametrize("mode", ["w8a8", "bf16", "w4bf16"])
def test_projections_match_plain_on_card(mode):
    """The projection kernels alone (project_layers, one layer on a zeroed
    workspace) against project_layer_plain for the talker's four
    projections: int32 accumulators equal (w8a8), float32 bits equal (the
    float modes). B = 1 runs K1's GEMV; B = 2, 5, 24, 64 and 128 K5's
    tensor-core GEMMs and reach every lane-tile instantiation of both
    (int8: 1, 2, 4, 8 lane tiles a warp; float64: 1, 2, 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    report = {}
    chip_smoke.check_projections(PipelineConfig().talker, report, torch.device("cuda", 0),
                                 iters=1, modes=(mode,), lanes=(),
                                 check_lanes=(1, 2, 5, 24, 64, 128), L=2)
    torch.cuda.synchronize()
    assert report[chip_smoke.K5_KEYS[mode]]["projections"]["checked_lanes"] == [2, 5, 24, 64,
                                                                                  128]
    assert report[chip_smoke.K1_KEYS[mode]]["projections"]["checked_lanes"] == [1]


def test_head_gemv_matches_plain_on_card():
    """K1's codec-head GEMV alone against its plain version within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    report = {}
    chip_smoke.check_head_gemv(PipelineConfig().talker, report, torch.device("cuda", 0),
                               iters=1, L=2)
    assert report["fused_talker_step"]["codec_head"]["max_abs_err"] <= 1e-3


def test_w4_gemv_probe_exact_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    report = {}
    chip_smoke.check_w4_gemv_probe(report, torch.device("cuda", 0), iters=1)
    assert report["w4_gemv_probe"]["max_abs_err"] == 0.0


def test_decode_attention_is_one_launch_on_card(tts):
    """Decode attention within one bf16 ulp + 1e-6 of its plain version (the
    check's gate) at B = 1 and 16 up to n_valid = 4000, one kernel per call
    under the profiler, and its split rule equal to the wrapper module's
    mirror for every B from 1 to 128."""
    report = {}
    chip_smoke.check_decode_attention(tts, report, iters=1, L=4,
                                      shapes=((1, 1280, (1, 63, 65, 300)),
                                              (16, 4352, (1000, 4000))))
    r = report["decode_attention"]
    assert r["launches_per_call"] == 1
    assert all(t["launches_per_call"] == 1 for t in r["times"].values())
    assert r["splits"] > 0


@pytest.mark.parametrize("check, key", [
    ("check_talker_step", "fused_talker_step"),
    ("check_talker_step_batched", "fused_talker_step_batched"),
    ("check_talker_step_start", "fused_talker_step_batched[start]"),
    ("check_talker_step_kv_int8", "fused_talker_step_batched[kv_int8]")])
def test_talker_attention_on_card(tts, check, key):
    """K1 and K5 (with start, and over the int8 cache) against their plain
    versions (the checks' gates) with the attention stage in one launch per
    layer: ten of the port's kernels per layer over a bf16 cache (eleven
    with the int8 cache's row quantization), three after the last, and the
    attention stage's device time measured."""
    report = {}
    getattr(chip_smoke, check)(tts, report, iters=1)
    r, L = report[key], tts.config.talker.n_layers
    per_layer = 11 if "kv_int8" in key else 10
    stats = r if "launches_per_call" in r else next(iter(r["times"].values()))
    assert stats["launches_per_call"] == per_layer * L + 3
    assert stats["attention_device_ms"] is not None and stats["attention_device_ms"] > 0


@pytest.mark.parametrize("shape", [(2, 4352, 4000), (1, 512, 0), (5, 512, 62)],
                         ids=["16_block_clusters", "one_lane_one_row", "rows_below_a_tile"])
def test_lane_major_attention_on_card(tts, shape):
    """K5 over the lane-major cache beyond the smoke's shapes: clusters of
    16 blocks (2 lanes at 4001 rows), one lane (its chain under programmatic
    dependent launch) with one row, and 63 rows (one tile whose last row
    lies past n_past and arrives as zeros): chip_smoke's lane gates (2 layers
    0.0 against the plain version, all layers bit for bit batch-major K5),
    ten kernels a layer, and a cache off 16-byte alignment raises before
    any launch."""
    report = {}
    chip_smoke.check_talker_step_lane({"int8": tts}, report, iters=1, shapes=(shape,))
    torch.cuda.synchronize()
    r = report[chip_smoke.LANE_ENTRY]
    assert r["launches_per_call"] == 10 * tts.config.talker.n_layers + 3
    assert "tensor map" in r["map_refused"]


def test_res_block_launches_on_card(tts):
    """K3 against its plain version (the check's gate) at every width of the
    vocoder (C = 768, 384, 192, 96 at a 64-frame clip's T), d = 1, 3 and 9,
    and a ragged T at C = 96 and 384; one launch per res block at C = 96 and
    192, two at 384 and 768 (the profiler's count); its device time
    measured."""
    report = {}
    chip_smoke.check_res_block(tts, report, iters=1)
    r = report["fused_res_block"]
    assert sorted(r["widths"]) == [96, 192, 384, 768]
    for C, w in r["widths"].items():
        assert w["launches_per_res_block"] == [1 if C in (96, 192) else 2] * 3
        assert w["device_ms"] is not None and w["device_ms"] > 0
    assert r["device_ms"] is not None


def test_res_block_lanes_on_card(tts):
    """K3 over a group of 16 lanes of 64 frames at every width, d = 9: each
    lane equal to the one-lane call bit for bit (the check's 0.0 gate: no
    lane reads another's rows), the group within K3's tolerance of the
    plain version, and the plan's launches per res block for the whole
    group (one at C = 96 and 192, two at 384 and 768)."""
    report = {}
    chip_smoke.check_res_block_lanes(tts, report, iters=1)
    lanes = report["fused_res_block"]["lanes"]
    assert sorted(lanes) == [96, 192, 384, 768]
    for C, w in lanes.items():
        assert w["lanes"] == 16 and w["lane_max_abs_err"] == 0.0
        assert w["launches_per_res_block"] == (1 if C in (96, 192) else 2)
        assert w["device_ms"] is not None and w["device_ms"] > 0


def test_int8_matmul_one_launch_on_card(tts):
    """The W8A16 GEMM against its plain version (the check's gate) at the
    talker's four shapes for M = 1, 8, 9, 16, 128 (bf16 x; 256 at w_down)
    and for M = 1, 8, 9, 16, 128, 256 with float32 x: one kernel per call
    in every case (the check fails otherwise), both paths reached."""
    report = {}
    chip_smoke.check_int8_matmul(tts, report, iters=1, rows=(1, 8, 9, 16, 128))
    per_call = report["int8_matmul"]["launches_per_call"]
    assert len(per_call) == 4 * 5 + 6 + 1 and set(per_call.values()) == {1}
