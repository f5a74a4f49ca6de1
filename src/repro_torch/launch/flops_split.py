"""Where a dry-run cell's forward FLOPs go on rank 0: the whole forward
(`api.loss_fn` of a train cell, no remat, no backward; `api.prefill` of
a prefill cell) traced as `launch.dryrun` traces a cell, then again with the experts' products and with the attention
replaced by no-ops; the differences are their FLOPs.  Beside them, the
rank's share of the model's forward FLOPs (2 N D over the ranks).

    PYTHONPATH=src python -m repro_torch.launch.flops_split \\
        --arch mixtral-8x7b --shape train_4k --mesh multi
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.launch import analyze, dryrun, specs
from repro_torch.models import api, transformer
from repro_torch.parallel import sharding


def forward_flops(arch: str, shape_name: str, mesh_kind: str, *, experts: bool = True,
                  attention: bool = True) -> float:
    """Rank 0's traced forward FLOPs of a train or prefill cell; with
    `experts` or `attention` False, those parts compute nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    shape = configs.SHAPES[shape_name]
    pol = dryrun.arch_policy(arch)
    cfg = dryrun.tune_config(configs.get_config(arch), shape).replace(remat="none")
    hold = dryrun.hold_for(cfg, pol["fsdp"])
    real = transformer.expert_mlp, transformer.attention
    if not experts:
        transformer.expert_mlp = lambda c, p, buf: buf
    if not attention:
        transformer.attention = lambda c, q, k, v, causal=True: q[..., :v.shape[-1]].clone()
    try:
        with dryrun.fake_mesh(mesh_kind == "multi") as mesh:
            sharding.spec_maps(cfg, mesh, hold)
            with FakeTensorMode(allow_non_fake_inputs=True):
                params = api.init_params(cfg, 0, device="cpu", mesh=mesh, hold=hold)
                rows, dp = dryrun._rank_batch(specs.batch_specs(cfg, shape), mesh)
                with FlopCounterMode(display=False) as fc, torch.no_grad(), \
                        sharding.use_mesh(mesh, data_split=dp is not None, hold=hold):
                    if shape.kind == "train":
                        api.loss_fn(cfg, params, rows)
                    else:
                        api.prefill(cfg, params, rows, shape.seq_len)
    finally:
        transformer.expert_mlp, transformer.attention = real
    return float(fc.get_total_flops())


def split(arch: str, shape_name: str, mesh_kind: str) -> dict:
    total = forward_flops(arch, shape_name, mesh_kind)
    no_experts = forward_flops(arch, shape_name, mesh_kind, experts=False)
    no_attention = forward_flops(arch, shape_name, mesh_kind, attention=False)
    shape = configs.SHAPES[shape_name]
    cfg = configs.get_config(arch)
    n = 512 if mesh_kind == "multi" else 256
    per_kind = {"train": 3.0, "prefill": 1.0}[shape.kind]        # 6ND -> 2ND
    share = analyze.model_flops_for(cfg, shape, specs.params_specs(cfg)) / per_kind / n
    return {"forward": total, "experts": total - no_experts,
            "attention": total - no_attention, "model_share": share,
            "times_share": total / share}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=configs.ARCH_IDS, required=True)
    p.add_argument("--shape", choices=("train_4k", "prefill_32k"), required=True)
    p.add_argument("--mesh", choices=("single", "multi"), default="single")
    args = p.parse_args(argv)
    r = split(args.arch, args.shape, args.mesh)
    print(f"{args.arch} x {args.shape} x {args.mesh}, rank 0's forward: {r['forward']:.4g} "
          f"FLOP; experts {r['experts']:.4g}, attention {r['attention']:.4g}; the rank's share "
          f"of the model's {r['model_share']:.4g} ({r['times_share']:.1f}x)")


if __name__ == "__main__":
    main()
