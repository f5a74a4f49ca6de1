"""Seeded serving workloads (the port's copy of `repro.serving.workload`).

One deterministic implementation of the request mixes that serving runs
and a cluster load generator draw from, so a fixed seed produces the
identical request trace, the JAX package's trace byte for byte, whether
it is replayed closed-loop or open-loop:

* `zipf_mix_requests` — the Zipf-weighted short/medium/long prompt mix
  (band i is drawn with weight 1/(i+1)): short prompts dominate, but the
  tail crosses every power-of-two prefill-bucket boundary, so the mix
  exercises each bucketed-prefill executable.
* `poisson_arrivals` — open-loop Poisson arrival offsets (exponential
  inter-arrival gaps at a fixed rate), independent of service times, the
  arrival process the paper's datacenter serving story assumes when it
  sizes fleets for heavy traffic.

Both take a caller-owned `numpy.random.Generator`: the caller seeds it,
and the draw ORDER here is part of the contract — reordering the calls
would silently change every fixed-seed benchmark baseline.
"""

from __future__ import annotations

import numpy as np

from .engine import Request

# short/medium/long prompt-length bands spanning the 16/32/64 prefill
# buckets of a max_len=64 engine
DEFAULT_BANDS: tuple[tuple[int, int], ...] = ((4, 15), (17, 31), (33, 60))


def zipf_band_weights(n_bands: int) -> np.ndarray:
    """Normalized Zipf weights 1/(i+1) over `n_bands` length bands."""
    w = 1.0 / (1.0 + np.arange(n_bands, dtype=np.float64))
    return w / w.sum()


# an SLO mix: most traffic is best-effort (None),
# a band of interactive requests carries tight-ish deadlines, a band of
# batch requests carries loose ones.  Seconds; None = no deadline.
DEFAULT_DEADLINE_BANDS: tuple[tuple[float, float] | None, ...] = (
    None,
    (0.5, 2.0),
    (10.0, 30.0),
)


def zipf_mix_requests(
    rng: np.random.Generator,
    n: int,
    vocab: int,
    *,
    bands: tuple[tuple[int, int], ...] = DEFAULT_BANDS,
    max_new_tokens: int = 16,
    rid0: int = 0,
    deadline_bands: tuple[tuple[float, float] | None, ...] | None = None,
    model: str | None = None,
) -> list[Request]:
    """`n` requests with Zipf-weighted prompt lengths over `bands`.

    Draw order per request: band choice, prompt length, prompt tokens —
    fixed, so a seeded `rng` reproduces the exact trace everywhere.
    `deadline_bands` (e.g. `DEFAULT_DEADLINE_BANDS`) adds a per-request
    SLO mix: a uniformly chosen band, then a uniform `deadline_s` inside
    it (`None` bands mean no deadline).  Deadlines draw from a SPAWNED
    child generator, never from `rng`'s own stream, so attaching an SLO
    mix leaves the prompt trace (and any draws the caller makes from
    `rng` afterwards, e.g. Poisson arrivals) byte-for-byte unchanged —
    and `deadline_bands=None` is the exact historical trace.
    `model` stamps every request's routing tag for mixed-family fleets
    (host-side metadata: the token trace is untouched).
    """
    weights = zipf_band_weights(len(bands))
    dl_rng = rng.spawn(1)[0] if deadline_bands is not None else None
    reqs = []
    for i in range(n):
        lo, hi = bands[int(rng.choice(len(bands), p=weights))]
        deadline = None
        prompt = rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).astype(
            np.int32
        )
        if dl_rng is not None:
            band = deadline_bands[int(dl_rng.integers(0, len(deadline_bands)))]
            if band is not None:
                deadline = float(dl_rng.uniform(band[0], band[1]))
        reqs.append(
            Request(
                rid=rid0 + i,
                prompt=prompt,
                max_new_tokens=max_new_tokens,
                deadline_s=deadline,
                model=model,
            )
        )
    return reqs


def synthetic_frames(
    rng: np.random.Generator, n_frames: int, d_model: int
) -> np.ndarray:
    """A (n_frames, d_model) float32 block of standard-normal encoder
    frame embeddings — the whisper requests' `Request.frames` payload
    (the serving layer pads/truncates it to the engine's fixed window).
    Drawn from the caller's `rng` so a seed pins the audio trace just
    like the token traces."""
    return rng.standard_normal((n_frames, d_model)).astype(np.float32)


def interleave_tagged(traces: list[list[Request]]) -> list[Request]:
    """Round-robin merge of per-model request traces into one submission
    order (trace i's requests keep their relative order), re-numbering
    `rid` so the merged trace has unique ids.  The deterministic mixer
    mixed-family clusters submit."""
    merged: list[Request] = []
    cursors = [0] * len(traces)
    while any(c < len(t) for c, t in zip(cursors, traces)):
        for j, t in enumerate(traces):
            if cursors[j] < len(t):
                merged.append(t[cursors[j]])
                cursors[j] += 1
    for i, r in enumerate(merged):
        r.rid = i
    return merged


def poisson_arrivals(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    """`n` open-loop arrival offsets (seconds from t0) of a Poisson
    process at `rate` requests/second: cumulative exponential gaps.
    `rate <= 0` means all-at-once (a closed-loop burst at t=0)."""
    if rate <= 0.0:
        return np.zeros(n, np.float64)
    gaps = rng.exponential(scale=1.0 / rate, size=n)
    return np.cumsum(gaps)
