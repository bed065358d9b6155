#!/usr/bin/env python3
"""Quantization quality of the port's weight tiers (counterpart of
``tools/check_quant_cosine.py``): the prefill logits' cosine of each
quantized talker (int8 w8a16; q4 = attention int8, FFN group-affine u4;
q4pure = every projection group-affine u4) against the bf16 talker, on
seeded synthetic weights at ``PipelineConfig()``'s 0.6B widths, with
whether the argmax agrees.

The bars are the JAX tool's (``check_quant_cosine.py:80-86``): int8 > 0.99
(near-lossless); q4 > 0.97; q4pure > 0.90. On iid Gaussian synthetic
weights no pure 4-bit scheme reaches 0.99: the bound is the format class,
not the kernels. The synthetic draws are at the JAX package's scales
(normal / sqrt(fan_in), ``models/talker.init_talker_params``), from a
torch.Generator, so the cosines are of other weights than the JAX tool's.

On the card the int8 tier's prefill projections run the W8A16 GEMM kernel
(``ops/int8_matmul.py``), the q4 tier's attention projections too; the u4
ones run the grouped product of ``ops/quant.py``.

    python3 qwen3tts_tpu_torch/tools/check_quant_cosine.py

Runs on the card (CUDA device 0); without a card it exits 2. Prints one
JSON line (each tier's cosine and argmax match, the bars, ``ok``, and
``device``: the card's name and power limit, as nvidia-smi gives them) and
exits 1 when a bar fails. ``quant_cosines`` does the work; the CPU tests
call it at the tiny configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qwen3tts_tpu_torch.config import PipelineConfig  # noqa: E402
from qwen3tts_tpu_torch.models import talker as talker_model  # noqa: E402
from qwen3tts_tpu_torch.ops.quant import quantize_talker_blocks  # noqa: E402
from qwen3tts_tpu_torch.tools.benchmark_continuous import card_line  # noqa: E402

BARS = {"int8": 0.99, "q4": 0.97, "q4pure": 0.90}


def prompt(token_ids=range(100, 1600, 100), bucket=32):
    """(tokens [bucket], n_tokens): the JAX tool's prompt by default, the
    15 ids 100, 200, ..., 1500 padded to 32."""
    ids = list(token_ids)
    tokens = np.zeros((bucket,), np.int64)
    tokens[:len(ids)] = ids
    return tokens, len(ids)


def prefill_logits(tp, tcfg, tokens, n_tokens, language_id=2050) -> np.ndarray:
    """The talker's prefill logits (the last row's) as float64 on the host:
    the default voice, a KV cache of 64 rows in the weights' dtype."""
    dev = tp.codec_embd.device
    with torch.no_grad():
        pf = talker_model.build_prefill(
            tp, tcfg, torch.as_tensor(tokens, device=dev), n_tokens,
            torch.zeros((tcfg.hidden_size,), dtype=tp.codec_embd.dtype, device=dev),
            language_id)
        kv = talker_model.make_kv_cache(tcfg, 64, tp.codec_embd.dtype, dev)
        _, logits = talker_model.talker_prefill(tp, tcfg, pf.prefill_embd, kv)
    return logits.double().cpu().numpy()


def cosine(a, b) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def quant_cosines(tp, tcfg, tokens=None, n_tokens=None, tiers=tuple(BARS)) -> dict:
    """{tier: {"cosine", "argmax_match"}} of the prefill logits of tp's
    blocks quantized to each tier against tp's own (bf16) logits, on the
    prompt (default: ``prompt()``)."""
    if tokens is None:
        tokens, n_tokens = prompt()
    base = prefill_logits(tp, tcfg, tokens, n_tokens)
    out = {}
    for tier in tiers:
        with torch.no_grad():
            qp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, tier))
        got = prefill_logits(qp, tcfg, tokens, n_tokens)
        del qp
        out[tier] = {"cosine": cosine(base, got),
                     "argmax_match": bool(base.argmax() == got.argmax())}
    return out


def failed_bars(results) -> list:
    """The tiers whose cosine is not above its bar."""
    return [t for t, r in results.items() if not r["cosine"] > BARS[t]]


def main() -> int:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
    if not torch.cuda.is_available():
        print("check_quant_cosine: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    tcfg = PipelineConfig().talker
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)      # the talker's generator of load_models(None, synthetic=True)
    with torch.no_grad():
        tp = talker_model.init_talker_params(gen, tcfg, torch.bfloat16, dev)
    res = quant_cosines(tp, tcfg)
    bad = failed_bars(res)
    print(json.dumps(dict(metric="prefill_logits_cosine_vs_bf16", **res, bars=BARS,
                          ok=not bad, device=card_line(dev))))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
