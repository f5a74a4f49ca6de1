"""The port's deployment facade (`repro_torch.mozart`) against the JAX
package's (`repro.mozart`) on the CPU: for a fixed seed `compile(spec,
device="cpu").to_json()` is byte-identical to the reference's for the
chatbot, av_33ms and spec-decode specs, under every engine mode; an
artifact round-trips bit-exactly and either package's artifact loads to
the same policy in the other; and the launcher's policy module is the
codesign stack's."""
import json

import pytest
import torch

from repro import mozart as jmozart
from repro.core import engine as jengine
from repro.core import operators as jops
from repro.core.fusion import GAConfig as JGA
from repro.core.pool import SAConfig as JSA
from repro_torch import mozart as tmozart
from repro_torch.core import engine as tengine
from repro_torch.core import operators as tops
from repro_torch.core import policy as tcore_policy
from repro_torch.core.fusion import GAConfig as TGA
from repro_torch.core.pool import SAConfig as TSA
from repro_torch.launch import policy as tlaunch_policy

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_state():
    """Both engines on with empty caches; one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jengine.set_engine_enabled(True)
    tengine.set_engine_enabled(True)
    jengine.clear_all_caches()
    tengine.clear_all_caches()
    yield
    tengine.set_engine_enabled(True)
    jengine.clear_all_caches()
    tengine.clear_all_caches()
    torch.set_num_threads(threads)


def _spec(pkg: str, scenario: str, **kw):
    """The tests' tiny spec (`tests/test_mozart.py:tiny_spec`) built in
    one package; "spec_decode" takes the paper's pair: an OPT-1.3B draft
    decoding, an OPT-66B target verifying the k + 1 = 6 token window."""
    mz, ops, sa, ga = ((jmozart, jops, JSA, JGA) if pkg == "jax"
                       else (tmozart, tops, TSA, TGA))
    if scenario == "spec_decode":
        networks = {
            "draft": mz.NetworkSpec(workload=ops.lm_operator_graph(
                ops.OPT_1_3B, 512, "decode", cache_len=512), role="draft"),
            "target": mz.NetworkSpec(workload=ops.lm_operator_graph(
                ops.OPT_66B, 6, "prefill"), role="target"),
        }
    else:
        networks = {"resnet50": "resnet50",
                    "opt_dec": ops.lm_operator_graph(ops.OPT_1_3B, 512, "decode",
                                                     cache_len=512)}
    args = dict(networks=networks, scenario=scenario, pool_size=4, seq=512,
                sa=sa(iterations=1, inner_ga=ga(population=3, generations=1)),
                ga=ga(population=4, generations=2), baselines=("best_homogeneous",))
    args.update(kw)
    return mz.MozartSpec(**args)


# scenario -> the JAX artifact, computed once per test process.
# Single-writer: only `_reference` fills it, from the test's own thread.
_REFERENCE: dict[str, str] = {}


def _reference(scenario: str) -> str:
    if scenario not in _REFERENCE:
        jengine.clear_all_caches()
        _REFERENCE[scenario] = jmozart.compile(_spec("jax", scenario)).to_json()
    return _REFERENCE[scenario]


def _first_difference(a: str, b: str) -> str:
    for i, (x, y) in enumerate(zip(a.splitlines(), b.splitlines())):
        if x != y:
            return f"line {i}: {x.strip()} != {y.strip()}"
    return "lengths differ"


@pytest.mark.parametrize("scenario", ["chatbot", "av_33ms", "spec_decode"])
def test_compile_artifact_byte_identical_to_reference(scenario):
    got = tmozart.compile(_spec("torch", scenario), device=CPU).to_json()
    want = _reference(scenario)
    assert got == want, _first_difference(want, got)


@pytest.mark.parametrize("mode", ["engine_off", "threads_2", "process_2"])
def test_engine_modes_give_the_reference_artifact(mode):
    """Serial (above), the seed path with the engine off, two threads and
    two spawned workers with the option-column warmup: one artifact."""
    if mode == "engine_off":
        tengine.set_engine_enabled(False)
        spec = _spec("torch", "chatbot")
    else:
        spec = _spec("torch", "chatbot", workers=2,
                     executor="thread" if mode == "threads_2" else "process")
    try:
        got = json.loads(tmozart.compile(spec, device=CPU).to_json())
        stats = tengine.DEFAULT_ENGINE.stats()
    finally:
        tengine.DEFAULT_ENGINE.close()
    # the spec's echo records the fan-out it asked for; nothing else may differ
    assert (got["spec"]["workers"], got["spec"]["executor"]) == (
        spec.workers, spec.executor)
    got["spec"].update(workers=None, executor=None)
    got = json.dumps(got, indent=2)
    assert got == _reference("chatbot"), _first_difference(_reference("chatbot"), got)
    if mode == "process_2":
        assert stats["thread_fallbacks"] == 0 and stats["warmup_hits"] > 0


def test_save_load_round_trip_bit_exact(tmp_path):
    dep = tmozart.compile(_spec("torch", "av_33ms"), device=CPU)
    path = dep.save(tmp_path / "deployment.json")
    back = tmozart.load(path)
    assert back.to_json() == dep.to_json()
    assert back.summary() == dep.summary()
    assert back.policy("opt_dec").to_dict() == dep.policy("opt_dec").to_dict()
    # the reference package reads the port's artifact to the same bytes
    assert jmozart.load(path).to_json() == dep.to_json()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_load_policy_reads_either_packages_artifact(writer, tmp_path):
    if writer == "jax":
        dep = jmozart.compile(_spec("jax", "chatbot"))
    else:
        dep = tmozart.compile(_spec("torch", "chatbot"), device=CPU)
    path = dep.save(tmp_path / "deployment.json")
    for net in ("resnet50", "opt_dec"):
        want = jmozart.load_policy(path, net).to_dict()
        assert tmozart.load_policy(path, net).to_dict() == want
        assert tlaunch_policy.load_policy(path, net).to_dict() == want
    with pytest.raises(ValueError, match="name one"):
        tmozart.load_policy(path)
    bare = tmp_path / "policy.json"
    bare.write_text(dep.policy("opt_dec").to_json())
    assert tmozart.load_policy(bare).to_dict() == jmozart.load_policy(bare).to_dict()


def test_launch_policy_is_the_codesign_policy():
    """One policy copy: the launcher's module re-exports the codesign
    stack's classes and the artifact reader."""
    assert tlaunch_policy.ExecutionPolicy is tcore_policy.ExecutionPolicy
    assert tlaunch_policy.OperatorPolicy is tcore_policy.OperatorPolicy
    assert tlaunch_policy.load_policy is tmozart.load_policy
    assert tlaunch_policy.SCHEMA == jmozart.deployment.SCHEMA


def test_summary_and_metrics_match_reference():
    dep = tmozart.compile(_spec("torch", "av_33ms"), device=CPU)
    ref = jmozart.Deployment.from_dict(json.loads(_reference("av_33ms")))
    assert dep.summary() == ref.summary()
    assert dep.metrics() == ref.metrics()
    assert dep.chiplet_reuse() == ref.chiplet_reuse()


def test_compile_without_device_needs_cuda():
    """No device means the card: with none present, compile raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmozart.compile(_spec("torch", "chatbot"))
