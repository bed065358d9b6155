"""Shared by tests/test_torch_export.py and tests/test_torch_export_jax.py:
the tiny pipelines, the eager loop an exported request is held to, and
the fresh process that runs reloaded programs with the model functions
patched to raise."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qwen3tts_tpu_torch.models.vocoder import vocoder_decode
from qwen3tts_tpu_torch.ops.prng import prng_key
from qwen3tts_tpu_torch.runtime import decode_loop
from qwen3tts_tpu_torch.tools import export_aot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, BUCKET = 8, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny products share the machine's cores
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pipeline(quant):
    """The tiny config's Qwen3TTS in weight tier `quant` on the seed-0
    weights, as the export tool builds it."""
    return export_aot.build_pipeline(True, "cpu", quant)


def eager(tts, spec, tokens, n_tokens, key):
    """generate_from_tokens on tts's weights with an ExportSpec's route,
    sampling, frames and cache."""
    tcfg = tts.config.talker
    return decode_loop.generate_from_tokens(
        tts.talker_params, tts.cp_params, torch.as_tensor(tokens), n_tokens,
        torch.zeros((tcfg.hidden_size,)), tcfg.english_language_id, key, talker_cfg=tcfg,
        cp_cfg=tts.config.code_predictor, max_frames=spec.frames,
        kv_capacity=spec.kv_capacity, allow_eos=spec.allow_eos, temperature=spec.temperature,
        top_k=spec.top_k, top_p=spec.top_p, repetition_penalty=spec.repetition_penalty,
        fused_talker=spec.fused_talker, fused_cp=spec.fused_cp)


def text(n, seed):
    """n seeded token ids padded to the bucket."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((BUCKET,), np.int64)
    tokens[:n] = rng.integers(1, 500, size=n)
    return tokens


RETRACE_CHILD = r"""
import json, sys
import torch
from qwen3tts_tpu_torch.models import code_predictor, talker, vocoder


def boom(*args, **kw):
    raise RuntimeError("a reloaded program called back into the model code")


talker.build_prefill = talker.talker_prefill = talker.talker_step = boom
code_predictor.predict_codes = vocoder.vocoder_forward = boom

from qwen3tts_tpu_torch.ops.prng import prng_key
from qwen3tts_tpu_torch.tools import export_aot

torch.set_num_threads(1)
out = {}
for d, quant in json.loads(sys.argv[1]):
    programs = export_aot.load_programs(d)
    tts = export_aot.build_pipeline(True, "cpu", quant)
    tcfg = tts.config.talker
    tokens = torch.tensor(json.loads(sys.argv[2]))
    res = export_aot.run_generate(programs, tts.talker_params, tts.cp_params, tokens, 13,
                                  torch.zeros(tcfg.hidden_size), tcfg.english_language_id,
                                  prng_key(9), talker_cfg=tcfg)
    audio = export_aot.run_vocoder(programs, tts.vocoder_params, res.codes, res.n_frames)
    out[d] = dict(codes=res.codes, audio=audio)
torch.save(out, sys.argv[3])
"""


def retrace_check(dirs, tmp):
    """Run dirs' programs ([(directory, weight tier)]) in a fresh process
    whose model functions raise when called; assert each request's codes
    and audio equal the eager loop's in this process bit for bit."""
    tokens, path = text(13, 4), os.path.join(tmp, "retrace.pt")
    proc = subprocess.run([sys.executable, "-c", RETRACE_CHILD, json.dumps(dirs),
                           json.dumps(tokens.tolist()), path], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(path)
    for d, quant in dirs:
        tts = pipeline(quant)
        want = eager(tts, export_aot.load_spec(d), tokens, 13, prng_key(9))
        assert torch.equal(got[d]["codes"], want.codes)
        audio = vocoder_decode(tts.vocoder_params, tts.config.vocoder, want.codes, want.n_frames)
        assert torch.equal(got[d]["audio"], audio)
