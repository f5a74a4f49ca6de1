"""The unified Mozart deployment API.

One declarative flow from scenario to running engine:

    from repro_torch import mozart

    spec = mozart.MozartSpec(
        networks={"resnet50": "resnet50", "vit": "vit_b16"},
        scenario="av_33ms",
        pool_size=4,
    )
    dep = mozart.compile(spec)       # four-layer codesign on the card -> artifact
    dep.save("deployment.json")      # reusable, JSON, bit-exact reload
    dep.summary()                    # paper-style metric reductions

    # later / elsewhere:
    dep = mozart.load("deployment.json")
    pol = dep.policy("resnet50")     # feeds `serve --policy`

`compile(spec, device="cpu")` runs the same search on the host; for a
fixed seed the artifact is byte-identical to the reference package's.
Scenarios come from `repro_torch.core.scenarios` (chatbot,
summarization, av_10ms, av_33ms, spec_decode); `NetworkSpec(role="draft")`
selects per-role requirements from role-aware scenarios.
"""

from repro_torch.core.scenarios import SCENARIOS, Scenario, get_scenario

from .deployment import Deployment, compile, load, load_policy
from .spec import BASELINE_KINDS, MozartSpec, NetworkSpec, ResolvedSpec

__all__ = [
    "BASELINE_KINDS",
    "Deployment",
    "MozartSpec",
    "NetworkSpec",
    "ResolvedSpec",
    "SCENARIOS",
    "Scenario",
    "compile",
    "get_scenario",
    "load",
    "load_policy",
]
