"""Training launcher for the port, the JAX CLI's flags:

  python -m repro_torch.launch.train --arch qwen2-moe-2.7b-smoke \
      --steps 50 --batch 4 --seq 64
  torchrun --nproc_per_node 4 -m repro_torch.launch.train \
      --arch qwen2-moe-2.7b-smoke --mesh 2,2 --distributed --steps 50

Runs on the card; ``main(argv, device="cpu")`` runs the same on the CPU
(small configs). ``--distributed`` joins the process group torchrun
describes (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; NCCL on the card,
one GPU per LOCAL_RANK; gloo on the CPU), or uses the one already
initialised. ``--mesh data,model`` lays the process group's ranks out as
that mesh (sizes multiplying to its world size) and trains the mesh step.
Checkpoints are restart-safe (``training/trainer.py``). ``--plan-cache``
resolves every MoE layer's schedule from a tuned plan cache
(``launch/tune.py`` writes one), keyed by ``--plan-hw`` (default
h100_nvlink). ``--sp-residual`` carries the residual between blocks as
each model rank's slice of the sequence (``models/lm.sp_split``).
``--trace`` records the program's spans (``repro_torch/tracing.py``: the
step's ``train.grad``, ``train.guard`` and ``train.update``, the blocks'
``model.*`` and the MoE layer's ``moe.*``) over the run, and prints for
each span name its count, total and self host time (on rank 0), and the
run's calls of the head's logits product by path
(``models/common.HEAD_PRODUCT_CALLS``: ``bf16_exact``, ``fp32``) with
their count a step:

  python -m repro_torch.launch.train --arch qwen2-moe-2.7b-smoke \
      --steps 5 --batch 2 --seq 64 --trace
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

from repro_torch import tracing


def _join(device):
    """Joins the process group torchrun describes, unless one is already
    initialised. Returns (the device, whether this call initialised it)."""
    import torch
    import torch.distributed as dist
    cpu = device is not None and str(device) == "cpu"
    if dist.is_initialized():
        return device, False
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed: {missing} not set; run under "
                           f"torchrun")
    if not cpu:
        from repro_torch.device import resolve_device
        resolve_device("cuda")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
    return device, True


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="", help="e.g. 16,16 (data,model); "
                    "empty = single device, no mesh")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--impl", default="",
                    help="MoE transport override: naive|coarse|comet")
    ap.add_argument("--plan-cache", default="",
                    help="tuned adaptive-transport plan cache (JSON)")
    ap.add_argument("--plan-hw", default="",
                    help="hardware key for plan lookup (default "
                         "h100_nvlink)")
    ap.add_argument("--sp-residual", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun describes")
    ap.add_argument("--trace", action="store_true",
                    help="record the program's spans and print their "
                         "count, total and self time")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models.common import HEAD_PRODUCT_CALLS
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.training.trainer import Trainer, TrainerConfig

    owned = False
    if args.distributed:
        device, owned = _join(device)
    try:
        mesh = None
        if args.mesh:
            if not dist.is_initialized():
                raise RuntimeError("--mesh needs a process group: run under "
                                   "torchrun with --distributed")
            sizes = tuple(int(x) for x in args.mesh.split(","))
            axes = (("data", "model")[-len(sizes):] if len(sizes) <= 2
                    else ("pod", "data", "model"))
            mesh = make_mesh(sizes, axes)
        cfg = get_config(args.arch)
        if args.sp_residual:
            cfg = dataclasses.replace(cfg, sp_residual=True)
        if args.impl and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, impl=args.impl))
        shape = ShapeConfig("train", seq_len=args.seq,
                            global_batch=args.batch, kind="train")
        tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every,
                             plan_cache=args.plan_cache,
                             plan_hw=args.plan_hw)
        trainer = Trainer(cfg, shape, mesh, tcfg, device=device)
        heads0 = dict(HEAD_PRODUCT_CALLS)
        with tracing.recording() if args.trace else \
                contextlib.nullcontext():
            out = trainer.run(args.steps)
        spans = tracing.drain() if args.trace else []
        ls = [m["loss"] for m in out["metrics"]]
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"final_step={out['final_step']} restarts="
                  f"{out['restarts']} loss {ls[0]:.4f} -> {ls[-1]:.4f}"
                  if ls else "no steps run", flush=True)
            if args.trace:
                tracing.print_summary(spans)
                n = max(len(out["metrics"]), 1)
                print("head products: " + ", ".join(
                    f"{k} {v - heads0[k]} ({(v - heads0[k]) / n:g} a step)"
                    for k, v in HEAD_PRODUCT_CALLS.items()), flush=True)
        return out
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
