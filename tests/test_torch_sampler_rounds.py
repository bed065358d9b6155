"""K4's bisections in multi-way rounds (``csrc/sampler.cuh``), mirrored in
PyTorch and held bit for bit against the sequential bisections of the
port's ``make_sampler`` (``kernel_prng.topk_threshold`` /
``topp_threshold``: the top-k ``lo`` and the top-p ``plo``) and, through
the tokens, against the JAX package's ``make_sampler`` (interpret mode).

The mirror does what the kernel does, in the kernel's float32 operations:
each round builds the in-order tree of the midpoints its steps could take
from (lo, hi), finds the bin among them of every element between the first
and the last midpoint by the kernel's M-step search, counts for each
midpoint the binned elements at or above it plus those at or above the
last midpoint (integers), and takes as many midpoints as reach top_k
(after a round, a row whose start interval decides the steps left ends
there, and its lo must be the one the rounds reach); top-p takes as many candidates as carry the mass, summed per candidate as
the sequential step sums it. Its largest probability is 1 / sum and its
top-p maximum the prologue's, as in the kernel; its noise is drawn only
for the ids above -1e30. The kernel runs rounds of 5 steps
(``kSampleLevels``); the mirror also holds rounds of 6. Rows: the
adversarial kinds of ``chip_smoke.sampler_rows`` (ties at the 50th value,
flat rows, few levels, a spike, a narrow range, a -1e30 block), at the two
widths the sites sample (3072 with the cb0 suppression and a repetition
penalty, 2048), rounds of 5 and 6 steps, top-k 1, 50, V - 1 and V,
per-row temperatures 0.05, 0.9 and 1.5 and top-p 0.9 and 1.0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from qwen3tts_tpu.ops import kernel_prng as jprng
from qwen3tts_tpu_torch.ops import kernel_prng, sampling

torch.set_num_threads(1)

NEG_INF = kernel_prng.NEG_INF
LEVELS = (5, 6)
TEMPS = (0.05, 0.9, 1.5)
TOP_PS = (0.9, 1.0)
R = 14           # two rows of each of chip_smoke.SAMPLER_KINDS


def _bits(t):
    return t.contiguous().view(torch.int32)


def _tree(lo, hi, levels):
    """[R, 2^levels + 1]: lo, the in-order midpoints, hi (sampler.cuh's
    tree_nodes: node j at depth d the midpoint of its in-order neighbours
    at distance 2^(levels - 1 - d))."""
    n = 1 << levels
    t = [None] * (n + 1)
    t[0], t[n] = lo, hi
    for d in range(levels):
        half = n >> (d + 1)
        for j in range(half, n, 2 * half):
            t[j] = 0.5 * (t[j - half] + t[j + half])
    return torch.cat(t, dim=-1)


def _bins(x, t, levels):
    """Each element's number of midpoints at or below it, by the kernel's
    search: levels probes of the sorted midpoints."""
    b = torch.zeros(x.shape, dtype=torch.int64)
    for d in range(levels):
        probe = b + ((1 << levels) >> (d + 1))
        b = torch.where(x >= torch.gather(t, -1, probe), probe, b)
    return b


def _rounds(lo, hi, steps, m, values, target, finish=None):
    """A bisection of `steps` steps in rounds of m: values(t, lv) gives each
    candidate's count or mass [R, 2^lv - 1]; a round takes the candidates
    whose value reaches target (they lead the in-order: the values do not
    grow along it) and its new (lo, hi) are t[taken], t[taken + 1]. With
    `finish`, after each round finish(lo, hi of its start, lo, hi after it,
    steps left) -> (ok [R, 1], lo) ends the rows it decides (the kernel's
    topk_finish); their lo must be the one the rounds reach."""
    done = torch.zeros_like(lo, dtype=torch.bool)
    early = torch.zeros_like(lo)
    while steps:
        lv = min(m, steps)
        t = _tree(lo, hi, lv)
        assert bool((t[:, 1:] >= t[:, :-1]).all()), "midpoints out of order"
        v = values(t, lv)
        assert bool((v[:, 1:] <= v[:, :-1]).all()), "a count grew along the in-order"
        taken = (v >= target).sum(-1, keepdim=True)
        start = (lo, hi)
        lo, hi = torch.gather(t, -1, taken), torch.gather(t, -1, taken + 1)
        steps -= lv
        if finish is not None:
            ok, fin = finish(*start, lo, hi, steps)
            early = torch.where(ok & ~done, fin, early)
            done |= ok
    assert torch.equal(_bits(torch.where(done, early, lo)), _bits(lo)), "a finish differs"
    return torch.where(done, early, lo)


def topk_finish(l, top_k):
    """sampler.cuh's topk_finish: from (lo, hi) after a round, the steps left
    decided by the least and largest element of the round's start interval
    and the elements at or above its hi, or not finished (ok False)."""

    def finish(lo0, hi0, lo, hi, steps):
        inside = (l >= lo0) & (l < hi0)
        smin = torch.amin(torch.where(inside, l, torch.full_like(l, float("inf"))), -1, True)
        smax = torch.amax(torch.where(inside, l, torch.full_like(l, float("-inf"))), -1, True)
        take_above = torch.sum(l >= hi0, -1, keepdim=True) >= top_k
        ok = torch.ones_like(lo, dtype=torch.bool)
        a, c = lo, hi
        for _ in range(steps):
            mid = 0.5 * (a + c)
            low, high = mid <= smin, mid > smax
            ok &= low | high
            take = low | take_above
            a, c = torch.where(take, mid, a), torch.where(take, c, mid)
        return ok, a

    return finish


def topk_rounds(l, top_k, m):
    """The top-k stage's lo by rounds of m steps (the kernel's topk_round)."""
    n_rows = l.shape[0]

    def counts(t, lv):
        # the kernel's split: the elements between the first and the last
        # midpoint are searched and binned; those at or above the last count
        # for every midpoint; those below the first for none
        n = 1 << lv
        middle = (l >= t[:, 1:2]) & (l < t[:, n - 1:n])
        up = torch.sum(l >= t[:, n - 1:n], dim=-1, keepdim=True)
        b = _bins(l, t, lv)
        hist = torch.zeros((n_rows, n), dtype=torch.int64).scatter_add_(
            1, b, middle.to(torch.int64))
        above = torch.flip(torch.cumsum(torch.flip(hist, (1,)), 1), (1,))
        return above[:, 1:] + up

    lo = torch.amin(l, dim=-1, keepdim=True) - 1.0
    hi = torch.amax(l, dim=-1, keepdim=True)
    return _rounds(lo, hi, kernel_prng._BSEARCH_ITERS, m, counts, top_k,
                   finish=topk_finish(l, top_k))


def topp_rounds(probs, p, pmax, m):
    """The top-p stage's plo by rounds of m steps (the kernel's topp_round),
    each candidate's mass summed as the sequential step sums it."""
    zero = torch.zeros_like(probs)

    def masses(t, lv):
        return torch.cat([torch.sum(torch.where(probs >= t[:, j:j + 1], probs, zero), -1,
                                    keepdim=True) for j in range(1, 1 << lv)], dim=-1)

    return _rounds(torch.zeros_like(pmax), pmax, kernel_prng._TOPP_ITERS, m, masses, p)


def mirror_sample(logits, temp, top_p, seeds, step, *, top_k, use_top_p, m, stages=None):
    """The kernel's sampler in PyTorch (sampled rows): the prologue's max,
    the rounds, the largest probability 1 / sum, the noise only above
    -1e30. stages, when given, receives the thresholds and the scores."""
    V = logits.shape[-1]
    t = kernel_prng.per_row(temp, logits.device)
    l = logits * (1.0 / torch.clamp(t, min=1e-6))
    lmax = torch.amax(l, dim=-1, keepdim=True)
    if 0 < top_k < V:
        lo = topk_rounds(l, top_k, m)
        l = torch.where(l >= lo, l, torch.full_like(l, NEG_INF))
        if stages is not None:
            stages["lo"] = lo
    if use_top_p:
        p = kernel_prng.per_row(top_p, logits.device)
        e = torch.exp(l - lmax)
        s = torch.sum(e, dim=-1, keepdim=True)
        probs = e / s
        plo = topp_rounds(probs, p, 1.0 / s, m)
        l = torch.where(torch.logical_or(p >= 1.0, probs >= plo), l, torch.full_like(l, NEG_INF))
        if stages is not None:
            stages.update(plo=plo, probs=probs, pmax=1.0 / s)
    g = kernel_prng.gumbel_noise(seeds, step, tuple(l.shape))
    score = torch.where(l > NEG_INF, l + g, l)
    if stages is not None:
        stages.update(l=l, g=g, score=score)
    return torch.argmax(score, dim=-1)


def _rows(V, top_k, seed):
    """The adversarial rows at width V (suppressed and penalized at 3072, as
    the cb0 epilogue does), per-row temperatures and top-p, seeds."""
    logits = torch.from_numpy(chip_smoke.sampler_rows(R, V, seed=seed))
    if V == 3072:
        g = torch.Generator().manual_seed(seed)
        logits = sampling.apply_repetition_penalty(
            sampling.apply_suppression(logits, V - 1024, 2150),
            torch.rand((V,), generator=g) < 0.05, 1.05)
    temps = torch.tensor([TEMPS[r % 3] for r in range(R)], dtype=torch.float32)
    top_ps = torch.tensor([TOP_PS[r % 2] for r in range(R)], dtype=torch.float32)
    seeds = torch.arange(R, dtype=torch.int64).reshape(R, 1) * 7919 - 11 + top_k
    return logits, temps, top_ps, seeds


def _jax_tokens(logits, temps, top_ps, seeds, step, *, top_k, use_top_p):
    """The JAX package's make_sampler in an interpret-mode pallas_call, with
    per-row [R, 1] temperature and top-p operands."""
    n, V = logits.shape
    sample = jprng.make_sampler(top_k, V, greedy=False, use_top_p=use_top_p)

    def kern(l_ref, t_ref, p_ref, s_ref, o_ref):
        o_ref[...] = sample(l_ref[...], t_ref[...], p_ref[...], s_ref[...], jnp.int32(step))

    out = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, 1), jnp.int32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(logits.numpy()), jnp.asarray(temps.numpy().reshape(n, 1)),
      jnp.asarray(top_ps.numpy().reshape(n, 1)),
      jnp.asarray(seeds.numpy().reshape(n, 1).astype(np.int32)))
    return np.asarray(out)[:, 0]


def test_tree_holds_the_sequential_midpoints():
    """Every midpoint a sequence of bisection steps visits from (lo, hi) is
    the tree's node on that path, bit for bit, in rounds of 5 and 6."""
    g = torch.Generator().manual_seed(1)
    lo = torch.randn((64, 1), generator=g) * 1e3 - torch.rand((64, 1), generator=g) * 1e30
    hi = torch.randn((64, 1), generator=g) * 10
    for m in LEVELS:
        t = _tree(lo, hi, m)
        n, b = 1 << m, torch.zeros((64, 1), dtype=torch.int64)
        a, c = lo.clone(), hi.clone()
        for d in range(m):
            probe = b + (n >> (d + 1))
            mid = 0.5 * (a + c)
            assert torch.equal(_bits(mid), _bits(torch.gather(t, -1, probe)))
            take = torch.rand((64, 1), generator=g) < 0.5
            a, c = torch.where(take, mid, a), torch.where(take, c, mid)
            b = torch.where(take, probe, b)
        # after the round: (lo, hi) = (t[b], t[b + 1])
        assert torch.equal(_bits(a), _bits(torch.gather(t, -1, b)))
        assert torch.equal(_bits(c), _bits(torch.gather(t, -1, b + 1)))


@pytest.mark.parametrize("V", [3072, 2048])
@pytest.mark.parametrize("top_k", [1, 50, -1], ids=["k1", "k50", "kV-1"])
def test_topk_rounds_equal_the_sequential_bisection(V, top_k):
    """The top-k lo of rounds of 5 and 6 steps equals topk_threshold's bit
    for bit at every temperature, on every row kind."""
    k = V - 1 if top_k == -1 else top_k
    logits, _, _, _ = _rows(V, k, seed=V + k)
    for temp in TEMPS:
        l = logits * (1.0 / torch.clamp(torch.tensor(temp), min=1e-6))
        want = kernel_prng.topk_threshold(l, k)
        for m in LEVELS:
            assert torch.equal(_bits(topk_rounds(l, k, m)), _bits(want)), (temp, m)


@pytest.mark.parametrize("V", [3072, 2048])
@pytest.mark.parametrize("top_k", [50, 0], ids=["k50", "k_off"])
def test_topp_rounds_equal_the_sequential_bisection(V, top_k):
    """After the top-k stage (or none), the top-p plo of rounds of 5 and 6
    steps equals topp_threshold's bit for bit, and the largest probability
    1 / sum equals amax(probs)."""
    logits, temps, _, _ = _rows(V, top_k, seed=V + 7)
    l = logits * (1.0 / torch.clamp(temps.reshape(-1, 1), min=1e-6))
    if top_k:
        l = torch.where(l >= kernel_prng.topk_threshold(l, top_k), l,
                        torch.full_like(l, NEG_INF))
    e = torch.exp(l - torch.amax(l, dim=-1, keepdim=True))
    s = torch.sum(e, dim=-1, keepdim=True)
    probs = e / s
    assert torch.equal(_bits(1.0 / s), _bits(torch.amax(probs, dim=-1, keepdim=True)))
    for p in (0.9, 0.5, 0.99):
        want = kernel_prng.topp_threshold(probs, torch.tensor(p))
        for m in LEVELS:
            got = topp_rounds(probs, torch.tensor(p), 1.0 / s, m)
            assert torch.equal(_bits(got), _bits(want)), (p, m)


@pytest.mark.parametrize("V", [3072, 2048])
@pytest.mark.parametrize("top_k", [1, 50, -1, 0], ids=["k1", "k50", "kV-1", "kV"])
@pytest.mark.parametrize("use_top_p", [False, True], ids=["topk", "topk_topp"])
def test_rounds_sample_what_make_sampler_and_jax_sample(V, top_k, use_top_p):
    """Tokens of the mirror (rounds of 5 and 6) equal the port's
    make_sampler's and the JAX package's make_sampler's on the same rows,
    with per-row temperatures (0.05, 0.9, 1.5) and top-p (0.9, 1.0); the
    thresholds equal make_sampler's stages bit for bit."""
    k = V - 1 if top_k == -1 else (V if top_k == 0 else top_k)
    logits, temps, top_ps, seeds = _rows(V, k, seed=3 * V + k)
    step = 5
    want = kernel_prng.make_sampler(k, V, greedy=False, use_top_p=use_top_p)(
        logits, temps, top_ps, seeds, step)
    jax_tok = _jax_tokens(logits, temps, top_ps, seeds, step, top_k=k, use_top_p=use_top_p)
    np.testing.assert_array_equal(want.numpy(), jax_tok)
    for m in LEVELS:
        got = mirror_sample(logits, temps, top_ps, seeds, step, top_k=k, use_top_p=use_top_p,
                            m=m)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_noise_skip_leaves_scores_and_tokens():
    """Skipping the noise for the ids at or below -1e30 (filtered,
    suppressed, their values scaled by 1 / temperature) gives every score
    bit for bit and so the same token: |g| < 17 is below half an ulp of
    1e30."""
    for V, top_k in ((3072, 50), (3072, 0), (2048, 50)):
        logits, temps, top_ps, seeds = _rows(V, top_k, seed=V + 11)
        stages = {}
        tok = mirror_sample(logits, temps, top_ps, seeds, 2, top_k=top_k, use_top_p=True, m=5,
                            stages=stages)
        l, g, score = stages["l"], stages["g"], stages["score"]
        assert float(g.abs().max()) < 17.0
        skipped = l <= NEG_INF
        assert int(skipped.sum()) > 0
        assert torch.equal(_bits(score), _bits(l + g))
        np.testing.assert_array_equal(tok.numpy(), torch.argmax(l + g, dim=-1).numpy())
