"""Token sampling: suppression, repetition penalty, the XLA sampler
``sample_token``, and kernel K4.

Counterpart of ``qwen3tts_tpu/ops/sampling.py`` (``apply_suppression``,
``apply_repetition_penalty``, ``apply_top_k``, ``apply_top_p``,
``sample_token``) plus ``sample_rows``, the standalone entry of the CUDA
sampler (``csrc/sampler.cu``). ``sample_token`` is plain PyTorch, as the
JAX package's is plain XLA: the decode loops sample frame 0's codebook-0
token with it (as ``_init_cb0`` does in the JAX package), and the unfused
path every codebook-0 token and every code of the code predictor. Its top-k
is exact (the k-th largest value, ties kept); its noise is the Gumbel field
of the row's threefry key (``ops/prng.gumbel``), so it draws what
``jax.random.categorical`` draws with that key. The fused talker and
code-predictor kernels call the ``__device__`` sampler of K4 in their
epilogues, whose top-k is a 30-step bisection as in the JAX kernels;
``sample_rows`` is that sampler's standalone entry, which no serve path
calls.

Kernel K4 replaces the counter-hash sampler that the Pallas kernels run in
their bodies (``qwen3tts_tpu/ops/kernel_prng.py:78 gumbel_noise`` and
``:91 make_sampler``). On the H100 it is bound by latency, not bytes: a row
of 3072 logits is 12 KB, and the top-k and top-p bisections are chains of
decisions. The design (``csrc/sampler.cuh``) holds the row in registers,
one thread block per row, and decides the bisections' steps in rounds of
five, one block-wide exchange a round: a default-sampled row takes at
most 8 exchanges where step-by-step reductions took 33 (``sample_shape``).
The noise is drawn only for the ids the filters kept.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .kernel_prng import NEG_INF, make_sampler, per_row, sampling_flags


def apply_suppression(logits: torch.Tensor, suppress_start: int,
                      eos_id: int) -> torch.Tensor:
    """Mask ids in [suppress_start, vocab) except eos_id."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    mask = (ids >= suppress_start) & (ids != eos_id)
    return torch.where(mask, torch.full_like(logits, NEG_INF), logits)


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF-style penalty on previously seen ids (seen: bool [vocab], or
    [R, vocab] for rows): positive logits divided, negative multiplied.
    penalty is a scalar or one value per row ([R])."""
    pen = per_row(penalty, logits.device)
    penalized = torch.where(logits > 0.0, logits / pen, logits * pen)
    return torch.where(seen, penalized, logits)


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the logits at or above the k-th largest of their row (ties kept);
    mask the rest. top_k <= 0 or >= vocab keeps everything."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


_TOPP_BSEARCH_ITERS = 30


def apply_top_p(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering: keep the ids whose probability is at least tau, the
    largest threshold whose kept mass reaches top_p (found by a 30-step
    bisection; the crossing token and its ties are kept). top_p >= 1 keeps
    everything. top_p is a scalar or one value per row ([R]), as the JAX
    package's traced top_p."""
    if isinstance(top_p, (int, float)) and top_p >= 1.0:
        return logits
    p = per_row(top_p, logits.device)
    probs = torch.softmax(logits.float(), dim=-1)
    lo = torch.zeros_like(probs[..., :1])
    hi = torch.amax(probs, dim=-1, keepdim=True)
    for _ in range(_TOPP_BSEARCH_ITERS):
        mid = 0.5 * (lo + hi)
        mass = torch.sum(torch.where(probs >= mid, probs, torch.zeros_like(probs)), dim=-1,
                         keepdim=True)
        take = mass >= p
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    masked = torch.where(probs >= lo, logits, torch.full_like(logits, NEG_INF))
    return torch.where(p >= 1.0, logits, masked)


def sample_token(logits: torch.Tensor, noise, *, temperature, top_k: int,
                 top_p=1.0, greedy=None, use_top_p=None) -> torch.Tensor:
    """One token id per row of logits [..., V]: the first-max argmax when
    greedy; else logits / max(temperature, 1e-6), the exact top-k, top-p
    when use_top_p, then argmax(logits + noise). With the Gumbel field of
    each row's key as noise (``prng.gumbel``), that last step is
    ``jax.random.categorical``; the noise comes from the caller (None when
    greedy). temperature and top_p
    are scalars or one value per row of [R, V] logits (continuous serving:
    each request its own); greedy and use_top_p, derived from scalars when
    not given, must then be given. Greedy is one flag for all rows: the
    continuous scheduler refuses a request outside its server's greedy or
    sampled class, so a sampled call never holds a row at temperature <= 0.
    Returns int64 [...]."""
    if greedy is None or use_top_p is None:
        greedy, use_top_p = sampling_flags(temperature, top_p)
    if greedy:
        return torch.argmax(logits, dim=-1)
    # a true division by a tensor on the logits' device (torch turns a
    # division by a host scalar into a product with its reciprocal on CUDA)
    t = per_row(temperature, logits.device)
    scaled = apply_top_k(logits.float() / torch.clamp(t, min=1e-6), top_k)
    if use_top_p:
        scaled = apply_top_p(scaled, top_p)
    return torch.argmax(scaled + noise, dim=-1)


def sample_rows_plain(logits, seeds, step, *, temperature, top_p, top_k,
                      greedy, use_top_p, suppress_start=None, eos_id=-1,
                      seen=None, repetition_penalty=1.0):
    """Plain version of K4: rows [R, V] f32, seeds int [R] -> int32 [R].
    temperature, top_p and repetition_penalty are scalars or per-row [R]."""
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
# rows K4's device code sampled inside the fused kernels, by site: K1 and K5
# one row a lane a call (cb0), K2 and K6 the 15 of a lane's frame one after
# another; the fused wrappers add their rows where they launch
sample_rows.site_rows = {"K1": 0, "K5": 0, "K2": 0, "K6": 0}


def sample_shape(V, *, greedy, top_k, use_top_p, top_p=1.0):
    """How K4 samples a row of width V on the card: (threads of its block,
    elements a thread holds, block-wide exchanges of a row with these
    parameters). Builds the kernels; raises for a row wider than the
    sampler takes."""
    import ctypes

    out = (ctypes.c_int * 3)()
    err = _kernels.load_library().qtts_sample_shape(
        int(V), int(greedy), int(top_k), int(use_top_p), float(top_p), ctypes.addressof(out))
    _kernels.check(err, "sample_shape")
    return tuple(out)
