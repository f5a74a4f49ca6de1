"""Token data pipeline of the port, a copy of `repro.data.pipeline`
(numpy only; copied, not imported, so the port stands alone):
deterministic, shard-aware, straggler-tolerant.

Synthetic corpus (seeded Zipfian token stream with induced bigram
structure so losses actually go down) or a binary token file.  Batches
are a pure function of (seed, step) — exact resume after preemption needs
no data-loader state, only the step counter from the checkpoint.

Straggler mitigation: a background prefetch thread keeps a bounded queue;
`next_batch(timeout)` falls back to synchronous generation if the
prefetcher stalls (and logs the event) — the training loop never blocks
on a sick host.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 1234
    kind: str = "synthetic"       # synthetic | file
    path: str | None = None
    prefetch: int = 4
    straggler_timeout_s: float = 5.0


class SyntheticLM:
    """Zipfian unigram mixed with a deterministic bigram successor table:
    predictable structure a model can learn in a few hundred steps."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        self._succ = rng.integers(0, v, size=(v,), dtype=np.int32)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(cfg.vocab, size=b, p=self._p)
        follow = rng.random((b, s)) < 0.7      # 70% bigram-determined
        rand = rng.choice(cfg.vocab, size=(b, s), p=self._p)
        for t in range(s):
            nxt = self._succ[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class FileLM:
    """Memory-mapped flat int32 token file, strided deterministically."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._data = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        n = len(self._data) - (s + 1)
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n, size=b)
        toks = np.stack([self._data[i:i + s + 1] for i in starts])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class DataPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._src = FileLM(cfg) if cfg.kind == "file" else SyntheticLM(cfg)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._next_step = 0
        self.straggler_events = 0

    # -- synchronous API (always available) --
    def batch(self, step: int) -> dict:
        return self._src.batch(step)

    # -- prefetching API --
    def start(self, start_step: int = 0) -> None:
        self._next_step = start_step
        self._stop.clear()

        def worker():
            step = start_step
            while not self._stop.is_set():
                b = self._src.batch(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_batch(self, step: int) -> dict:
        """Prefetched batch for `step`; falls back to synchronous
        generation if the prefetcher is behind (straggler mitigation)."""
        deadline = time.monotonic() + self.cfg.straggler_timeout_s
        while time.monotonic() < deadline:
            try:
                got_step, b = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if got_step == step:
                return b
            if got_step > step:       # we resumed behind the prefetcher
                break
        self.straggler_events += 1
        return self._src.batch(step)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
