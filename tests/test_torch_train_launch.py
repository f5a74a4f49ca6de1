"""The port's train launcher (`python -m repro_torch.launch.train`) on the
CPU, and `ModelConfig.validate` against the JAX package's:

* `--smoke --device cpu` trains smollm-135m's smoke config (the loss
  falls), checkpoints, and after a `--fail-at-step` drill resumes to the
  uninterrupted run's parameters bit for bit; whisper-base and
  qwen2-vl-2b (vision frontend) are refused, as the JAX launcher refuses
  them; without `--device` it asks for CUDA and raises where there is
  none;
* the configs JAX's `validate` refuses (MoE `top_k` of 0 or above
  `n_experts`, rglru `attn_every` < 2, whisper without encoder layers)
  the port refuses with ValueError, and one config of each family both
  accept.
"""
import os

import pytest
import torch

from repro import configs as jax_configs
from repro_torch import bridge, configs
from repro_torch.launch import train as train_cli

SMOKE = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch", "4",
         "--seq", "32"]


def test_smoke_training_on_the_cpu(tmp_path, capsys):
    out = train_cli.main(SMOKE + ["--steps", "20", "--ckpt-dir", str(tmp_path)])
    first, last = out["losses"][0][1], out["losses"][-1][1]
    assert [s for s, _ in out["losses"]] == [0, 10, 19]
    assert last < first - 0.3
    assert "[train] done: loss" in capsys.readouterr().out
    assert os.listdir(tmp_path) == ["step_000000020"]


def test_cli_failure_drill_resumes_bitwise(tmp_path):
    ref = train_cli.main(SMOKE + ["--steps", "8", "--ckpt-every", "4",
                                  "--ckpt-dir", str(tmp_path / "a")])
    drill = SMOKE + ["--steps", "8", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path / "b")]
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        train_cli.main(drill + ["--fail-at-step", "4"])
    res = train_cli.main(drill)
    for a, b in zip(bridge.tree_leaves(ref["params"]), bridge.tree_leaves(res["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ("whisper-base", "qwen2-vl-2b"))
def test_modality_stub_archs_are_refused(arch):
    with pytest.raises(SystemExit, match="modality-stub"):
        train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1"])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])


REFUSED = (("mixtral-8x7b", dict(top_k=0)), ("mixtral-8x7b", dict(top_k=9)),
           ("deepseek-v3-671b", dict(top_k=257)),
           ("recurrentgemma-2b", dict(attn_every=1)),
           ("recurrentgemma-2b", dict(attn_every=0)),
           ("whisper-base", dict(n_enc_layers=0)))
ACCEPTED = ("smollm-135m", "mixtral-8x7b", "rwkv6-3b", "recurrentgemma-2b",
            "whisper-base")


@pytest.mark.parametrize("arch,kw", REFUSED,
                         ids=[f"{a}-{k}={v}" for a, kw in REFUSED for k, v in kw.items()])
def test_validate_refuses_what_jax_refuses(arch, kw):
    with pytest.raises(AssertionError):
        jax_configs.get_config(arch).replace(**kw).validate()
    with pytest.raises(ValueError):
        configs.get_config(arch).replace(**kw).validate()


@pytest.mark.parametrize("arch", ACCEPTED)
def test_validate_accepts_what_jax_accepts(arch):
    jax_configs.get_config(arch).validate()
    configs.get_config(arch).validate()
    jax_configs.get_smoke_config(arch).validate()
    configs.get_smoke_config(arch).validate()
