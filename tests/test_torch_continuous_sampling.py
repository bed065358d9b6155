"""Continuous serving in the port, sampled (tests/test_torch_continuous.py
holds the scheduler's greedy cases): each request's key chain, per-request
sampling parameters, and the overlapped harvest against the serial loop,
with fresh single-stream runs of the port as the reference.
"""

from __future__ import annotations

import numpy as np
import pytest
from torch_continuous_common import (  # noqa: F401 - fixtures by name
    TCFG,
    H,
    jparams,
    params,
    _requests,
    _fresh,
    _scheduler,
    _run_continuous,
    _assert_fresh,
    one_torch_thread)


def test_continuous_sampled_matches_fresh_runs(params):
    """Sampled: each request's key chain (split at refill, then per frame)
    reproduces the single-stream sampled output."""
    reqs = _requests()[:4]
    _, got = _run_continuous(params, reqs, temperature=0.9, top_k=50)
    _assert_fresh(params, reqs, got, temperature=0.9, top_k=50)


def test_per_request_sampling_params(params):
    """Each request carries its own temperature, top-p and penalty: results
    equal fresh runs with those values, in one scheduler; a request outside
    the server's sampling class is refused."""
    overrides = [dict(temperature=0.7, repetition_penalty=1.0),
                 dict(temperature=1.3, repetition_penalty=1.3),
                 dict(temperature=0.9, top_p=0.8), dict()]
    reqs = _requests()[:4]
    sched = _scheduler(params, temperature=0.9, top_k=50, top_p=0.95)
    rids = [sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)), TCFG.english_language_id,
                         seed=r["seed"], max_frames=r["budget"], **ov)
            for r, ov in zip(reqs, overrides)]
    results = sched.run()
    for r, ov, rid in zip(reqs, overrides, rids):
        want = _fresh(params, r, temperature=ov.get("temperature", 0.9), top_k=50,
                      top_p=ov.get("top_p", 0.95),
                      repetition_penalty=ov.get("repetition_penalty", 1.05))
        np.testing.assert_array_equal(results[rid], want)
    with pytest.raises(ValueError, match="greedy"):
        sched.submit(reqs[0]["tokens"], reqs[0]["n_tokens"], np.zeros((H,)),
                     TCFG.english_language_id, temperature=0.0)
    greedy = _scheduler(params, temperature=0.0, top_k=0)
    with pytest.raises(ValueError, match="top-p"):
        _scheduler(params, temperature=0.9, top_k=0).submit(
            reqs[0]["tokens"], reqs[0]["n_tokens"], np.zeros((H,)), 0, top_p=0.5)
    with pytest.raises(ValueError, match="text bucket"):
        greedy.submit(np.arange(17), 17, np.zeros((H,)), 0)


@pytest.mark.parametrize("temperature, top_k", [(0.0, 0), (0.9, 5)])
def test_overlap_harvest_matches_serial(params, temperature, top_k):
    """The overlapped loop (one chunk in flight, refills one chunk late)
    gives the serial loop's per-request codes, and host mirrors equal the
    state after the drain."""
    reqs = _requests()
    outs = {}
    for overlap in (False, True):
        sched, got = _run_continuous(params, reqs, temperature=temperature, top_k=top_k,
                                     overlap_harvest=overlap)
        assert sched.overlap_harvest is overlap
        outs[overlap] = got
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
