"""The port's workload generator (`repro_torch.serving.workload`) against
the JAX package's on the same seeds: the draw order is the contract, so
every trace must be the JAX trace byte for byte (prompt tokens, lengths,
deadlines, model tags, arrival offsets, frames)."""
import numpy as np
import pytest

from repro.serving import workload as jax_workload
from repro_torch.serving import workload
from repro_torch.serving.engine import Request

SEEDS = (0, 11, 2024)


def _trace(reqs):
    return [(r.rid, r.prompt.dtype.str, r.prompt.tobytes(), r.max_new_tokens,
             r.deadline_s, r.model) for r in reqs]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("deadlines", [None, workload.DEFAULT_DEADLINE_BANDS],
                         ids=["no-deadlines", "deadlines"])
@pytest.mark.parametrize("model", [None, "smollm-135m"])
def test_zipf_trace_is_the_jax_trace(seed, deadlines, model):
    kw = dict(max_new_tokens=12, rid0=5, deadline_bands=deadlines, model=model)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = workload.zipf_mix_requests(rng, 40, 49152, **kw)
    want = jax_workload.zipf_mix_requests(jrng, 40, 49152, **kw)
    assert all(isinstance(r, Request) for r in got)
    assert _trace(got) == _trace(want)
    # the caller's generator is left in the same state (later draws agree)
    assert rng.integers(0, 1 << 30, 4).tolist() == jrng.integers(0, 1 << 30, 4).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_wide_bands_and_arrivals_match_jax(seed):
    """Bands that cross the 64-512 prefill buckets, then Poisson arrivals
    drawn from the same generator after the trace."""
    bands = ((16, 63), (65, 127), (129, 255), (257, 500))
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = workload.zipf_mix_requests(rng, 24, 1000, bands=bands)
    want = jax_workload.zipf_mix_requests(jrng, 24, 1000, bands=bands)
    assert _trace(got) == _trace(want)
    for rate in (0.0, 3.5):
        a, b = workload.poisson_arrivals(rng, 24, rate), \
            jax_workload.poisson_arrivals(jrng, 24, rate)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_band_weights_frames_and_interleave_match_jax():
    for n in (1, 3, 5):
        assert workload.zipf_band_weights(n).tobytes() == \
            jax_workload.zipf_band_weights(n).tobytes()
    f = workload.synthetic_frames(np.random.default_rng(3), 7, 16)
    g = jax_workload.synthetic_frames(np.random.default_rng(3), 7, 16)
    assert f.dtype == g.dtype and f.tobytes() == g.tobytes()
    traces = [workload.zipf_mix_requests(np.random.default_rng(s), n, 97, model=m)
              for s, n, m in ((1, 3, "a"), (2, 5, "b"), (3, 1, "c"))]
    jtraces = [jax_workload.zipf_mix_requests(np.random.default_rng(s), n, 97, model=m)
               for s, n, m in ((1, 3, "a"), (2, 5, "b"), (3, 1, "c"))]
    got, want = workload.interleave_tagged(traces), jax_workload.interleave_tagged(jtraces)
    assert _trace(got) == _trace(want)
    assert [r.rid for r in got] == list(range(9))
    assert [r.model for r in got] == ["a", "b", "c", "a", "b", "a", "b", "b", "b"]
