"""Training launcher of the port (the CLI of `repro.launch.train`, plus
`--device`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --smoke --steps 200 --ckpt-dir build/ckpt [--device cuda|cpu]

--smoke uses the reduced same-family config (CPU-sized); otherwise the
full config of the arch.  Weights are random, from `--seed`.  Whisper
and the vision-frontend archs are refused, as the JAX launcher refuses
them: they train on embeddings a modality frontend would provide.

On CUDA with more than one card it trains on a mesh, as the JAX
launcher does with more than one device: one NCCL rank a card, on every
visible card (`mp.spawn`, `tcp://localhost:<free port>`), on
`make_host_mesh()`, rank 0 logging.  One card, or `--device cpu`, trains
unsharded on that device.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.training.loop import TrainConfig, train
from repro_torch.training.optimizer import OptimizerConfig


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-sized)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--optimizer", default="adamw",
                   choices=("adamw", "adafactor"))
    p.add_argument("--grad-compression", action="store_true")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--fail-at-step", type=int, default=None,
                   help="inject a failure (restart drill)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to train on (cuda, or cpu for the plain "
                        "PyTorch path)")
    return p


def _configs(args):
    """(model, optimizer, train, data) configs of the parsed arguments."""
    mcfg = configs.get_smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if mcfg.family == "whisper" or mcfg.frontend == "vision":
        raise SystemExit(
            f"{args.arch}: modality-stub archs train via input_specs-"
            "provided embeddings; use examples/ or the dry-run for them")
    ocfg = OptimizerConfig(name=args.optimizer, lr=args.lr,
                           warmup_steps=max(10, args.steps // 20),
                           total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       grad_compression=args.grad_compression,
                       seed=args.seed)
    dcfg = DataConfig(vocab=mcfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    return mcfg, ocfg, tcfg, dcfg


def _report(out: dict, log=print) -> None:
    first, last = out["losses"][0][1], out["losses"][-1][1]
    log(f"[train] done: loss {first:.4f} -> {last:.4f} in "
        f"{out['wall_s']:.1f}s; stragglers={out['straggler_events']}")


def main(argv=None) -> dict | None:
    """Train as the arguments say; the unsharded run's summary (None after
    a run on ranks, whose rank 0 reports)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    mcfg, ocfg, tcfg, dcfg = _configs(args)
    cards = torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 0
    if cards > 1:
        import torch.multiprocessing as mp

        from repro_torch.launch.serve import free_port
        mp.spawn(_train_rank, args=(cards, free_port(), argv), nprocs=cards, join=True)
        return None
    out = train(mcfg, ocfg, tcfg, dcfg, device=args.device,
                fail_at_step=args.fail_at_step)
    _report(out)
    return out


def _train_rank(rank: int, world: int, port: int, argv: list[str]) -> None:
    """One rank of `main` on a mesh: NCCL over `world` cards,
    `make_host_mesh()`; rank 0 logs and reports."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(backend="nccl")
        args = _parser().parse_args(argv)
        log = print if rank == 0 else (lambda _: None)
        out = train(*_configs(args), mesh=mesh, fail_at_step=args.fail_at_step, log_fn=log)
        _report(out, log)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
