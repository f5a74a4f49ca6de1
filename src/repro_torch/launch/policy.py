"""Execution policies, as the Mozart deployment artifact carries them.

The classes live in `repro_torch.core.policy` and the artifact reader in
`repro_torch.mozart.deployment`; this module re-exports them for the
serve launcher.  Per-operator-class batch sizes drive the engine's
max/decode batch, the tensor-parallel degree the mesh, and fusion groups
select the fused kernels.
"""
from repro_torch.core.policy import ExecutionPolicy, OperatorPolicy, policy_from_json
from repro_torch.mozart.deployment import SCHEMA, load_policy

__all__ = ["SCHEMA", "ExecutionPolicy", "OperatorPolicy", "load_policy",
           "policy_from_json"]
