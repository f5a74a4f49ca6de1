"""The traffic generator: fixed by the seed; every seed sends the same
requests (lengths and their pairing), in an order of its own."""
import json

import numpy as np
import pytest

from harness import traffic
from harness.bench import HERE

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_stream_fixed_by_seed(mix):
    spec = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    a, b = (traffic.Traffic(spec, 2**31 + 11, 8, 32000) for _ in range(2))
    items = [a.client_item(c, n) for c in range(8) for n in (1, 2, 3)]
    assert items == [b.client_item(c, n) for c in range(8) for n in (1, 2, 3)]
    assert all(np.array_equal(a.prompt(it), b.prompt(it)) for it in items[:5])
    assert a.warmup == b.warmup


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_sends_the_same_requests_in_its_own_order(mix):
    spec = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    t1, t2 = traffic.Traffic(spec, 1, 8, 32000), traffic.Traffic(spec, 2**31 + 2, 8, 32000)
    assert sorted(t1.deck) == sorted(t2.deck) and t1.deck != t2.deck
    assert t1.warmup == t2.warmup
    assert sorted(p for p, _ in t1.deck) == traffic.quantile_lengths(spec["prompt"], spec["deck"])
    it = t1.client_item(3, 2)
    assert not np.array_equal(t1.prompt(it), t2.prompt(it))
    p, o = spec["prompt"], spec["output"]
    assert all(p["min"] <= a <= p["max"] and o["min"] <= b <= o["max"] for a, b in t1.deck)


def test_quantile_lengths():
    u = traffic.quantile_lengths({"dist": "uniform", "min": 10, "max": 20}, 5)
    assert u == [11, 13, 15, 17, 19]
    ln = traffic.quantile_lengths({"dist": "lognormal", "median": 100, "sigma": 1.0,
                                   "min": 50, "max": 150}, 9)
    assert ln == sorted(ln) and ln[4] == 100 and ln[0] == 50 and ln[-1] == 150
    with pytest.raises(ValueError):
        traffic.quantile_lengths({"dist": "zipf_bands"}, 4)


def test_warmup_staggers_outputs_and_leads_with_long_prompts():
    spec = {"deck": 4, "prompt": {"dist": "uniform", "min": 100, "max": 200},
            "output": {"dist": "uniform", "min": 10, "max": 30}}
    t = traffic.Traffic(spec, 3, 4, 50)
    assert [w.output_len for w in t.warmup] == [5, 10, 15, 20]
    assert [w.prompt_len for w in t.warmup] == sorted((p for p, _ in t.deck), reverse=True)
    assert sorted(t.deck) == sorted(traffic.Traffic(spec, 4, 4, 50).deck)
    assert [t.client_item(1, n).index for n in (1, 2)] == [5, 9]


def _deck(mix):
    spec = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    return traffic.Traffic(spec, 0, 1, 10).deck


def test_longctx_deck_holds_mooncakes_means():
    deck = _deck("longctx")
    assert np.mean([p for p, _ in deck]) == pytest.approx(7590, rel=0.01)
    assert np.mean([o for _, o in deck]) == pytest.approx(182, rel=0.02)
    assert max(p + o for p, o in deck) <= 16384


def test_rag_deck_holds_the_azure_coding_medians():
    deck = _deck("rag")
    assert np.median([p for p, _ in deck]) == pytest.approx(1500, rel=0.02)
    assert np.median([o for _, o in deck]) == pytest.approx(13, abs=0.5)
    assert max(p for p, _ in deck) <= 4096
