"""Continuous serving in the port (runtime/continuous.py): the counterparts
of tests/test_continuous.py, with fresh runs of the port's own loops as the
reference, and the port's scheduler and synthesize_queue against the JAX
package's on the same queue.

The invariant: a request spliced into a lane mid-session at cache rows
[p - P, p) generates exactly what a fresh single-stream run at [0, P)
generates (RoPE is relative, the start mask hides the previous occupant).
Greedy codes are the gate; sampled runs match too, because each request
draws from its own threefry key chain (prng_key(seed)) in the
single-stream loop's order, as the JAX scheduler's requests do.
The float32 queues run the unfused path, as the JAX package's scheduler
does on a CPU; the int8 queue runs K5 and K6 (plain versions here, the
Pallas kernels in interpret mode in JAX).

The cases sit in three files of about equal test time, with their
fixtures and helpers in torch_continuous_common.py: this one (the
scheduler's greedy cases against fresh runs), test_torch_continuous_sampling.py
(sampled cases and the overlapped harvest) and test_torch_continuous_jax.py
(the port against the JAX package's scheduler and synthesize_queue, and
the fused K5/K6 queue).
"""

from __future__ import annotations

import numpy as np

from qwen3tts_tpu_torch.runtime import continuous as cont
from torch_continuous_common import (  # noqa: F401 - fixtures by name
    TCFG,
    CCFG,
    H,
    jparams,
    params,
    _requests,
    _fresh,
    _scheduler,
    _run_continuous,
    _assert_fresh,
    one_torch_thread)


def test_continuous_greedy_matches_fresh_runs(params):
    """Every request through the 2-lane scheduler (staggered refills, a
    capacity tight enough for a session reset or a compaction) emits exactly
    the codes of a fresh single-stream greedy run."""
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0)
    assert sched.sessions + sched.compactions >= 1
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_compaction_is_exact(params):
    """Rolling compaction (roll and K re-rotation by -shift) mid-request
    changes no request's codes."""
    reqs = _requests() + [dict(r, seed=r["seed"] + 50) for r in _requests()]
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, kv_capacity=32)
    assert sched.compactions >= 1
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_pressure_policy_never_compacts_when_roomy(params):
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, kv_capacity=64,
                                 compact_threshold=4)
    assert sched.compactions == 0 and sched.sessions == 0
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_bulk_refill_is_exact(params):
    """4 idle lanes, 6 queued, R = 1: the first boundary fills every lane in
    one refill (one prefill of 4 windows); every request still matches."""
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, lanes=4,
                                 refill_slots=1, kv_capacity=48)
    assert sched.refills < len(reqs)
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_admission_pacing_and_timing_change_no_codes(params):
    """admit_per_boundary=1 admits one request per chunk boundary (more
    refills than the unpaced run); timing=True sums each phase's wall into
    stats. Neither changes a request's codes."""
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, lanes=4,
                                 kv_capacity=48, admit_per_boundary=1, timing=True)
    assert sched.refills == len(reqs)
    assert sched.stats["decode_s"] > 0 and sched.stats["refill_s"] > 0
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_refill_masks_previous_occupant(params):
    """One lane, the same request twice: the second occupant, spliced at
    p > 10, must not see the first one's cache."""
    req = _requests()[0]
    _, got = _run_continuous(params, [req, dict(req)], temperature=0.0, top_k=0, lanes=1,
                             refill_slots=1)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], _fresh(params, req, temperature=0.0, top_k=0))


def test_budget_and_emit_accounting(params):
    """Emissions per request == its budget (allow_eos=False), codes in range;
    every chunk advances n_past by chunk_frames."""
    reqs = _requests()[:3]
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, kv_capacity=64)
    for r, codes in zip(reqs, got):
        assert codes.shape[0] == r["budget"]
        assert (codes >= 0).all() and (codes[:, 0] < TCFG.codec_vocab_size).all()
        assert (codes[:, 1:] < CCFG.vocab_size).all()
    assert sched.state.n_past == cont.prefill_window_len(False) + 2 * sched.chunks_run


def test_state_shapes_and_reset(params):
    st = cont.init_state(params[0], TCFG, lanes=4, kv_capacity=32, trailing_len=13)
    assert st.kv.shape == (4, TCFG.n_layers, 2, TCFG.n_kv_heads, 32, TCFG.head_dim)
    assert bool(st.done.all())
    assert st.n_past == cont.prefill_window_len(False) == 10
    assert cont.prefill_window_len(True) == 9


def test_opportunistic_compaction_is_exact(params):
    """compact_policy="opportunistic" with a threshold far below a roomy
    capacity: compactions fire in the normal refill loop (never a reset),
    and every request still matches its fresh run."""
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, kv_capacity=64,
                                 compact_threshold=4, compact_policy="opportunistic")
    assert sched.compactions >= 1 and sched.sessions == 0
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_feeder_online_arrivals_match_fresh_runs(params):
    """run(feeder=...) submits requests mid-run (keyed to chunks_run, so the
    test is deterministic); the loop idles on an empty queue while arrivals
    are pending, and every request emits its fresh-run codes."""
    reqs = _requests()
    sched = _scheduler(params, temperature=0.0, top_k=0)
    rids = {}
    release_at = [0, 0, 1, 3, 6, 9]
    state = {"next": 0}

    def feeder(idle):
        if idle and state["next"] < len(reqs):
            release_at[state["next"]] = sched.chunks_run   # jump the clock
        while state["next"] < len(reqs) and release_at[state["next"]] <= sched.chunks_run:
            r = reqs[state["next"]]
            rids[state["next"]] = sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)),
                                               TCFG.english_language_id, seed=r["seed"],
                                               max_frames=r["budget"])
            state["next"] += 1
        return state["next"] < len(reqs)

    results = sched.run(feeder=feeder)
    sched.check_host_mirrors()
    assert state["next"] == len(reqs)
    _assert_fresh(params, reqs, [results[rids[i]] for i in range(len(reqs))],
                  temperature=0.0, top_k=0)
