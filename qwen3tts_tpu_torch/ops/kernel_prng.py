"""Counter-hash Gumbel noise and the shared sampler, plain PyTorch versions.

Counterpart of ``qwen3tts_tpu/ops/kernel_prng.py`` with the same names and
semantics. The noise for a (seed, step, vocab slot) triple is a pure integer
hash (two murmur3-finalizer rounds), so the CUDA sampler in
``csrc/sampler.cuh`` and this version draw the same 24-bit uniforms bit for
bit. The hash needs uint32 wraparound and logical shifts; torch has no
uint32 arithmetic, so it runs in int64 masked to 32 bits, with each multiply
split in 16-bit halves so no product leaves int64's range.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_BSEARCH_ITERS = 30
_TOPP_ITERS = 20

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def sampling_flags(temperature: float, top_p: float):
    """Sampler-stage gates from the sampling params: greedy when
    temperature <= 0, the top-p stage only when top_p < 1."""
    return float(temperature) <= 0.0, float(top_p) < 1.0


def per_row(value, device) -> torch.Tensor:
    """A sampling parameter as float32: a scalar stays 0-d, per-row values
    [R] become a column [R, 1] that broadcasts over the vocabulary, as the
    JAX package's per-lane [R, 1] operands do."""
    t = torch.as_tensor(value, dtype=torch.float32, device=device)
    return t.reshape(-1, 1) if t.dim() >= 1 else t


def _mulmod(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mulmod(x, _M1)
    x = x ^ (x >> 13)
    x = _mulmod(x, _M2)
    return x ^ (x >> 16)


def uniform24(seed, step: int, shape, device=None) -> torch.Tensor:
    """The hash's 24-bit integer uniforms (int64) of `shape`; last dim =
    vocab slots. seed: int, or an int tensor broadcastable over rows."""
    v = torch.arange(shape[-1], dtype=torch.int64, device=device)
    v = v.expand(shape)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    base = (seed + _mulmod(torch.as_tensor(step & _MASK, dtype=torch.int64,
                                           device=device), _GOLDEN)) & _MASK
    x = _mix(_mix((v + _mulmod(base, _M1)) & _MASK) ^ base)
    return x >> 8


def gumbel_noise(seed, step: int, shape, device=None) -> torch.Tensor:
    """Gumbel(0, 1) float32 noise of `shape`. Row r depends only on
    (seed_r, step, column)."""
    u = uniform24(seed, step, shape, device).float() * (1.0 / (1 << 24)) + 1e-12
    return -torch.log(-torch.log(u))


def topk_threshold(l: torch.Tensor, top_k: int) -> torch.Tensor:
    """The top-k stage's threshold of rows l [R, V]: a 30-step bisection on
    the float32 value range from lo = min - 1, hi = max, taking mid = 0.5 *
    (lo + hi) while at least top_k values are >= mid. Returns lo [R, 1]."""
    lo = torch.amin(l, dim=-1, keepdim=True) - 1.0
    hi = torch.amax(l, dim=-1, keepdim=True)
    for _ in range(_BSEARCH_ITERS):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum((l >= mid).to(torch.int32), dim=-1, keepdim=True)
        take = cnt >= top_k
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return lo


def topp_threshold(probs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The top-p stage's threshold of probability rows [R, V]: a 20-step
    bisection from 0 to the largest probability, taking mid while the mass
    of the probabilities >= mid reaches p (a scalar or [R, 1]). Returns
    plo [R, 1]."""
    plo = torch.zeros_like(probs[..., :1])
    phi = torch.amax(probs, dim=-1, keepdim=True)
    for _ in range(_TOPP_ITERS):
        mid = 0.5 * (plo + phi)
        mass = torch.sum(torch.where(probs >= mid, probs, torch.zeros_like(probs)),
                         dim=-1, keepdim=True)
        take = mass >= p
        plo, phi = torch.where(take, mid, plo), torch.where(take, phi, mid)
    return plo


def make_sampler(top_k: int, vocab: int, *, greedy: bool = False,
                 use_top_p: bool = True):
    """sample(logits_f32 [R, V], temp, top_p, seed, step) -> int64 [R].

    Greedy (first-max argmax) when `greedy`; else temperature scale -> top-k
    threshold by a 30-step bisection on the value range (ties kept,
    ``topk_threshold``) -> nucleus top-p by a 20-step bisection on the
    probability threshold (only when `use_top_p`; the crossing token and its
    ties kept, ``topp_threshold``) -> argmax of logits plus Gumbel noise.
    seed is an int or an [R, 1] tensor; temp and top_p are scalars or
    per-row [R] values (``per_row``)."""

    def sample(logits, temp, top_p, seed, step):
        if greedy:
            return torch.argmax(logits, dim=-1)
        dev = logits.device
        t = per_row(temp, dev)
        l = logits * (1.0 / torch.clamp(t, min=1e-6))
        if 0 < top_k < vocab:
            lo = topk_threshold(l, top_k)
            l = torch.where(l >= lo, l, torch.full_like(l, NEG_INF))
        if use_top_p:
            p = per_row(top_p, dev)
            m = torch.amax(l, dim=-1, keepdim=True)
            e = torch.exp(l - m)
            probs = e / torch.sum(e, dim=-1, keepdim=True)
            plo = topp_threshold(probs, p)
            keep = torch.logical_or(p >= 1.0, probs >= plo)
            l = torch.where(keep, l, torch.full_like(l, NEG_INF))
        g = gumbel_noise(seed, step, tuple(l.shape), dev)
        return torch.argmax(l + g, dim=-1)

    return sample
