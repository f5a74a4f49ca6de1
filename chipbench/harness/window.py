"""Window arithmetic: what the end-to-end metrics read off the token
record of a window (opened, closed], all from the host clock.

* tokens_per_s: output tokens stamped in the window / its seconds;
* itl_p95_ms: the 95th percentile of every gap between two consecutive
  tokens of a request whose later token falls in the window (a stall of
  the engine, an admitted prefill included, lengthens the gaps of every
  request it holds up);
* ttft_p90_ms: the 90th percentile, over the requests whose first token
  falls in the window, of first token less the client's submission.
"""
from __future__ import annotations


def percentile(values, q: float) -> float | None:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    r = q / 100.0 * (len(v) - 1)
    lo = int(r)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (r - lo)


def in_window(t: float, opened: float, closed: float) -> bool:
    return opened < t <= closed


def tokens(recs, opened: float, closed: float) -> int:
    return sum(1 for r in recs for t in r.times if in_window(t, opened, closed))


def gaps(recs, opened: float, closed: float) -> list[float]:
    return [b - a for r in recs for a, b in zip(r.times, r.times[1:])
            if in_window(b, opened, closed)]


def ttfts(recs, opened: float, closed: float) -> list[float]:
    return [r.times[0] - r.req.t_submit for r in recs
            if r.times and in_window(r.times[0], opened, closed)]


def end_to_end(recs, opened: float, closed: float) -> dict:
    """The window's end-to-end numbers and the sample counts behind them."""
    secs = closed - opened
    g, f = gaps(recs, opened, closed), ttfts(recs, opened, closed)
    p95, p90 = percentile(g, 95), percentile(f, 90)
    return {"tokens_per_s": tokens(recs, opened, closed) / secs,
            "itl_p95_ms": None if p95 is None else p95 * 1e3,
            "ttft_p90_ms": None if p90 is None else p90 * 1e3,
            "n_gaps": len(g), "n_first_tokens": len(f), "window_s": secs}


def processed(recs, opened: float, closed: float):
    """What the window computed: the prompt lengths of the prefills whose
    first token falls in it, and the position each decode step in it read
    (a token j >= 1 of a request came from the step over position
    prompt_len + j - 1)."""
    prefills, positions = [], []
    for r in recs:
        n = len(r.prompt)
        for j, t in enumerate(r.times):
            if in_window(t, opened, closed):
                if j == 0:
                    prefills.append(n)
                else:
                    positions.append(n + j - 1)
    return prefills, positions
