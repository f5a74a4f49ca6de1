"""Seeded traffic from a mix file (`chipbench/traffic/<mix>.json`).

A mix names how prompt and output lengths are drawn and how requests
arrive; one generator reads every mix, so a new mix is a new data file.

Lengths come from a *deck*: `deck` (prompt, output) pairs whose lengths
are the distribution's quantiles at (i + 0.5) / deck, prompt and output
stratified apart and paired by one fixed shuffle, so every seed sends
the same requests: the same amount of work.  The seed chooses the
deck's order (which requests fall together) and every prompt's token
ids (and the run's weights).

Length distributions (`prompt`, `output`):

* {"dist": "uniform", "min": a, "max": b}
* {"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}
  (clipped to [a, b])

The loop (`loop`) is "closed": one client a slot; a client sends its
next request the moment its reply completes.  Client c sends stream
items c, c + N, c + 2N, ... (N clients) after its warm-up request.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np


def quantile_lengths(spec: dict, k: int) -> list[int]:
    """The `k` stratified lengths of one distribution spec, ascending."""
    qs = [(i + 0.5) / k for i in range(k)]
    dist = spec["dist"]
    if dist == "uniform":
        vals = [spec["min"] + q * (spec["max"] - spec["min"]) for q in qs]
    elif dist == "lognormal":
        nd = statistics.NormalDist()
        vals = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(q)) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    lo, hi = spec.get("min", 1), spec.get("max", 1 << 30)
    return [int(min(max(round(v), lo), hi)) for v in vals]


@dataclasses.dataclass(frozen=True)
class Item:
    """One request of the stream: its index, prompt and output lengths."""
    index: int
    prompt_len: int
    output_len: int


class Traffic:
    """The seeded request stream of one mix for `clients` clients."""

    def __init__(self, mix: dict, seed: int, clients: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.clients = clients
        self.vocab = vocab
        self.loop = mix.get("loop", "closed")
        if self.loop != "closed":
            raise ValueError(f"unknown loop {self.loop!r}")
        k = int(mix["deck"])
        prompts = quantile_lengths(mix["prompt"], k)
        outputs = quantile_lengths(mix["output"], k)
        self.mean_output = sum(outputs) / k
        pairs = list(zip(prompts, (outputs[i] for i in np.random.default_rng(0).permutation(k))))
        order = np.random.default_rng([self.seed, 2]).permutation(k)
        self.deck = [pairs[i] for i in order]
        # the warm-up round, the same for every seed: the deck's longest
        # prompts (so set-up meets the largest prefill shapes), outputs
        # staggered evenly up to the deck's mean output, so that the
        # clients' next requests start out of phase, as in steady state
        longest = sorted(prompts, reverse=True)
        self.warmup = [Item(c, longest[c % k],
                            max(1, round(self.mean_output * (c + 1) / clients)))
                       for c in range(clients)]

    def item(self, j: int) -> Item:
        """Stream item j (j >= 0), after the warm-up round."""
        p, o = self.deck[j % len(self.deck)]
        return Item(self.clients + j, p, o)

    def client_item(self, client: int, n: int) -> Item:
        """The n-th request (n >= 1) a closed-loop client sends after its
        warm-up request."""
        return self.item(client + (n - 1) * self.clients)

    def prompt(self, it: Item) -> np.ndarray:
        """The token ids of an item's prompt (int32), from (seed, index)."""
        rng = np.random.default_rng([self.seed, 1, it.index])
        return rng.integers(0, self.vocab, size=it.prompt_len).astype(np.int32)
