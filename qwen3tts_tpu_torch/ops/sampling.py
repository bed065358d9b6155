"""Token sampling: suppression, repetition penalty, and kernel K4.

Counterpart of ``qwen3tts_tpu/ops/sampling.py`` (``apply_suppression``,
``apply_repetition_penalty``) plus ``sample_rows``, the standalone entry of
the CUDA sampler (``csrc/sampler.cu``). The fused talker and code-predictor
kernels call the same ``__device__`` sampler in their epilogues; the decode
loop calls ``sample_rows`` once per request, for frame 0's codebook-0 token
from the prefill logits.

Kernel K4 replaces the counter-hash sampler that the Pallas kernels run in
their bodies (``qwen3tts_tpu/ops/kernel_prng.py:78 gumbel_noise`` and
``:91 make_sampler``). On the H100 it is bound by latency, not bytes: a row
of 3072 logits is 12 KB, and the top-k and top-p bisections are 50 chains of
block-wide reductions. The design keeps the row in shared memory for the
whole chain, one thread block per row, so no reduction touches device memory.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .kernel_prng import NEG_INF, make_sampler


def apply_suppression(logits: torch.Tensor, suppress_start: int,
                      eos_id: int) -> torch.Tensor:
    """Mask ids in [suppress_start, vocab) except eos_id."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    mask = (ids >= suppress_start) & (ids != eos_id)
    return torch.where(mask, torch.full_like(logits, NEG_INF), logits)


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF-style penalty on previously seen ids (seen: bool [vocab]):
    positive logits divided, negative multiplied."""
    pen = torch.tensor(penalty, dtype=torch.float32, device=logits.device)
    penalized = torch.where(logits > 0.0, logits / pen, logits * pen)
    return torch.where(seen, penalized, logits)


def sample_rows_plain(logits, seeds, step, *, temperature, top_p, top_k,
                      greedy, use_top_p, suppress_start=None, eos_id=-1,
                      seen=None, repetition_penalty=1.0):
    """Plain version of K4: rows [R, V] f32, seeds int [R] -> int32 [R]."""
    R, V = logits.shape
    l = logits.float()
    if suppress_start is not None:
        l = apply_suppression(l, suppress_start, eos_id)
    if seen is not None:
        l = apply_repetition_penalty(l, seen.bool(), repetition_penalty)
    sample = make_sampler(top_k, V, greedy=greedy, use_top_p=use_top_p)
    return sample(l, temperature, top_p, seeds.reshape(R, 1).to(torch.int64),
                  step).to(torch.int32)


def sample_rows(logits, seeds, step, *, temperature, top_p, top_k, greedy,
                use_top_p, suppress_start=None, eos_id=-1, seen=None,
                repetition_penalty=1.0):
    """Sample one token per row of logits [R, V] (float32): optional
    suppression of [suppress_start, V) except eos_id, optional repetition
    penalty over seen [V] (bool), then the counter-hash sampler with seed
    seeds[r] (int32 [R]) at `step`. Returns int32 [R]."""
    if logits.device.type == "cpu":
        return sample_rows_plain(
            logits, seeds, step, temperature=temperature, top_p=top_p,
            top_k=top_k, greedy=greedy, use_top_p=use_top_p,
            suppress_start=suppress_start, eos_id=eos_id, seen=seen,
            repetition_penalty=repetition_penalty)
    lib = _kernels.load_library()
    _kernels.require_cuda(logits, seeds)
    R, V = logits.shape
    if logits.dtype != torch.float32 or seeds.dtype != torch.int32:
        raise ValueError("sample_rows takes float32 logits and int32 seeds")
    logits = logits.contiguous()
    seen8 = None if seen is None else seen.to(torch.int8).contiguous()
    out = torch.empty((R,), dtype=torch.int32, device=logits.device)
    err = lib.qtts_sample_rows(
        logits.data_ptr(), R, V, seeds.contiguous().data_ptr(), int(step),
        float(temperature), float(top_p), int(top_k), int(greedy),
        int(use_top_p), V if suppress_start is None else int(suppress_start),
        int(eos_id), None if seen8 is None else seen8.data_ptr(),
        float(repetition_penalty), out.data_ptr(),
        _kernels.stream_ptr(logits.device))
    _kernels.check(err, "sample_rows")
    sample_rows.launches += 1
    return out


sample_rows.launches = 0
