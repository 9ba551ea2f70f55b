"""Training launcher for the port, one GPU, the JAX CLI's flags:

  python -m repro_torch.launch.train --arch qwen2-moe-2.7b-smoke \
      --steps 50 --batch 4 --seq 64

Runs on the card; ``main(argv, device="cpu")`` runs the same on the CPU
(small configs). Checkpoints are restart-safe (``training/trainer.py``).
``--mesh``, ``--plan-cache``, ``--distributed`` and ``--sp-residual`` need
parts of the system that are not ported yet and raise: the model-level mesh
path and its train step (the ranked MoE layer itself is ported), the
plan-cache resolution, and the sequence-parallel residual.
"""
from __future__ import annotations

import argparse
import dataclasses


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
                    help="hardware key for plan lookup (with --plan-cache)")
    ap.add_argument("--sp-residual", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process training")
    args = ap.parse_args(argv)
    mesh_path = ("the model-level mesh path and its train step are not "
                 "ported yet (the ranked MoE layer is)")
    for flag, on, what in (
            ("--mesh", args.mesh, mesh_path),
            ("--distributed", args.distributed, mesh_path),
            ("--plan-cache", args.plan_cache,
             "the plan-cache resolution (core/adaptive.py) is not ported "
             "yet"),
            ("--sp-residual", args.sp_residual,
             "the sequence-parallel residual is not ported yet")):
        if on:
            raise NotImplementedError(f"{flag}: {what}")

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.impl and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=args.impl))
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    out = Trainer(cfg, shape, None, tcfg, device=device).run(args.steps)
    ls = [m["loss"] for m in out["metrics"]]
    print(f"final_step={out['final_step']} restarts={out['restarts']} "
          f"loss {ls[0]:.4f} -> {ls[-1]:.4f}" if ls else "no steps run")
    return out


if __name__ == "__main__":
    main()
