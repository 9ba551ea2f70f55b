"""End-to-end training driver (the port's counterpart of
``examples/train_moe.py``): a ~100M-parameter MoE transformer trained for a
few hundred steps on synthetic data with the full production loop —
grad-accumulation, AdamW + cosine schedule, async checkpointing, restart
safety, straggler monitoring.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_moe --steps 300   # the card
      PYTHONPATH=src python -m repro_torch.examples.train_moe --preset tiny \\
          --steps 4 --device cpu
Multi-rank: the same driver runs under a mesh — see
``repro_torch/launch/train.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Dict

from repro_torch.configs import AttnConfig, ModelConfig, MoEConfig, ShapeConfig
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.training.trainer import Trainer, TrainerConfig


def model_100m() -> ModelConfig:
    # ~104M params: granite-family MoE at reduced width
    return ModelConfig(
        name="comet-moe-100m", family="moe",
        n_layers=8, d_model=512, d_ff=0, vocab_size=32000,
        attn=AttnConfig(n_heads=8, n_kv_heads=2, head_dim=64,
                        q_block=128, kv_block=128),
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=1024, impl="comet"),
        activation="swiglu", param_dtype="float32", compute_dtype="float32",
        remat="none", tie_embeddings=True)


def model_tiny() -> ModelConfig:
    m = model_100m()
    return dataclasses.replace(
        m, name="comet-moe-tiny", n_layers=2, d_model=128, vocab_size=1024,
        attn=dataclasses.replace(m.attn, n_heads=4, n_kv_heads=2, head_dim=32),
        moe=dataclasses.replace(m.moe, num_experts=8, d_expert=128))


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=["100m", "tiny"], default="100m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=2,
                    help="microbatches a step (gradient accumulation)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--impl", default="comet",
                    choices=["comet", "naive", "coarse"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_100m() if args.preset == "100m" else model_tiny()
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl=args.impl))
    n = cfg.param_count()
    print(f"model {cfg.name}: {n/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active/token), "
          f"impl={cfg.moe.impl}")

    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train", microbatch=args.batch // args.accum)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="comet_train_")
    tcfg = TrainerConfig(ckpt_dir=ckpt, ckpt_every=args.ckpt_every,
                         log_every=10)
    optim = AdamW(lr=cosine_schedule(3e-4, warmup=20, total=args.steps))
    tr = Trainer(cfg, shape, mesh=None, tcfg=tcfg, optim=optim,
                 device=args.device)
    out = tr.run(args.steps)

    ls = [m["loss"] for m in out["metrics"]]
    print(f"\ndone: steps={out['final_step']} restarts={out['restarts']} "
          f"stragglers={len(out['stragglers'])} accum={tr.built['accum']}")
    if ls:
        print(f"loss: {ls[0]:.4f} -> {ls[-1]:.4f} "
              f"(ckpts in {ckpt})")
    return {**out, "ckpt_dir": ckpt, "accum": tr.built["accum"]}


if __name__ == "__main__":
    main()
