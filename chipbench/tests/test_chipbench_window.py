"""Window arithmetic: tails over every gap, a stall's effect, TTFT from
submission, and the work a window processed."""
import types

import numpy as np
import pytest

from harness import window


def rec(t_submit, times, prompt_len=10):
    req = types.SimpleNamespace(t_submit=t_submit)
    return types.SimpleNamespace(times=list(times), req=req, prompt=np.zeros(prompt_len))


def steady(n_req=4, step=0.1, n_steps=100):
    return [rec(0.0, [0.05 + step * k for k in range(n_steps)]) for _ in range(n_req)]


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys(q):
    v = np.random.default_rng(q).exponential(size=37)
    assert window.percentile(v, q) == pytest.approx(np.percentile(v, q))
    assert window.percentile([], q) is None


def test_tail_over_all_gaps():
    recs = steady()
    e = window.end_to_end(recs, 1.0, 6.0)
    assert e["tokens_per_s"] == pytest.approx(4 * 50 / 5.0)
    assert e["itl_p95_ms"] == pytest.approx(100.0)
    assert e["n_gaps"] == 4 * 50


def test_a_stall_moves_the_tail_and_the_rate():
    base = window.end_to_end(steady(), 1.0, 6.0)
    stalled = steady()
    for r in stalled:                  # every token after 3.0 s comes 0.8 s later
        r.times = [t + 0.8 if t > 3.0 else t for t in r.times]
    e = window.end_to_end(stalled, 1.0, 6.0)
    assert e["tokens_per_s"] < base["tokens_per_s"]
    assert e["itl_p95_ms"] == pytest.approx(base["itl_p95_ms"])   # one gap in 50 a request
    many = steady()
    for r in many:                     # a stall of 0.8 s every 10th step
        r.times = [t + 0.8 * (k // 10) for k, t in enumerate(r.times)]
    e2 = window.end_to_end(many, 1.0, 6.0)
    assert e2["itl_p95_ms"] == pytest.approx(900.0)
    assert e2["tokens_per_s"] < base["tokens_per_s"]


def test_ttft_from_submission_in_window_only():
    recs = [rec(0.9, [1.2, 1.3]), rec(2.0, [2.05, 2.1]), rec(0.1, [0.5, 1.5])]
    assert sorted(window.ttfts(recs, 1.0, 3.0)) == pytest.approx([0.05, 0.3])


def test_processed_prefills_and_positions():
    recs = [rec(0.0, [0.5, 1.5, 2.5], prompt_len=7), rec(1.0, [1.2, 2.2], prompt_len=3)]
    prefills, positions = window.processed(recs, 1.0, 3.0)
    assert prefills == [3]
    assert sorted(positions) == [3, 7, 8]
