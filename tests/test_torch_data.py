"""The port's data pipeline (`repro_torch.data.pipeline`, a copy of
`repro.data.pipeline`) against the JAX package's: `SyntheticLM` and
`FileLM` (over a token file under `tmp_path`) batches byte for byte
equal for several (seed, step), the prefetch thread handing out the
same batches, and the JAX tests of determinism and of the straggler
fallback (a never-started and a wedged prefetch worker) on the port."""
import threading

import numpy as np
import pytest

from repro.data import pipeline as jax_pipeline
from repro_torch.data.pipeline import DataConfig, DataPipeline


def _both(**kw):
    return (DataPipeline(DataConfig(**kw)),
            jax_pipeline.DataPipeline(jax_pipeline.DataConfig(**kw)))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        assert a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("seed", (0, 7, 1234))
def test_synthetic_batches_equal_jax(seed):
    port, ref = _both(vocab=512, seq_len=48, global_batch=4, seed=seed)
    for step in (0, 1, 17, 1000):
        _equal(port.batch(step), ref.batch(step))


@pytest.mark.parametrize("seed", (0, 3))
def test_file_batches_equal_jax(tmp_path, seed):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(9).integers(0, 300, size=5000).astype(np.int32).tofile(path)
    port, ref = _both(vocab=300, seq_len=32, global_batch=3, seed=seed, kind="file",
                      path=str(path))
    for step in (0, 5, 99):
        _equal(port.batch(step), ref.batch(step))


def test_prefetched_batches_equal_the_synchronous_ones():
    port, ref = _both(vocab=128, seq_len=16, global_batch=2, seed=5)
    port.start(3)
    try:
        for step in range(3, 9):
            _equal(port.next_batch(step), ref.batch(step))
    finally:
        port.stop()
    assert port.straggler_events == 0


def test_data_determinism_and_straggler_fallback():
    dcfg = DataConfig(vocab=128, seq_len=16, global_batch=4, seed=11,
                      straggler_timeout_s=0.01)
    p1, p2 = DataPipeline(dcfg), DataPipeline(dcfg)
    b1, b2 = p1.batch(17), p2.batch(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    # prefetcher never started -> timeout path -> synchronous fallback
    b3 = p1.next_batch(17)
    np.testing.assert_array_equal(b1["tokens"], b3["tokens"])
    assert p1.straggler_events == 1


def test_straggler_fallback_with_wedged_worker():
    """A running but wedged prefetch worker must not block the loop:
    next_batch times out, makes the batch synchronously and counts one
    straggler event; the batch is still the (seed, step) function's."""
    dcfg = DataConfig(vocab=128, seq_len=16, global_batch=4, seed=11,
                      straggler_timeout_s=0.05)
    p = DataPipeline(dcfg)
    release = threading.Event()
    real = p._src.batch
    main = threading.current_thread()

    def wedged(step):
        if threading.current_thread() is not main:
            release.wait()
        return real(step)

    p._src.batch = wedged
    p.start(0)
    try:
        b = p.next_batch(0)
        assert p.straggler_events == 1
        np.testing.assert_array_equal(b["tokens"], DataPipeline(dcfg).batch(0)["tokens"])
        assert p._q.empty()
    finally:
        release.set()
        p.stop()
    assert p._thread is None
