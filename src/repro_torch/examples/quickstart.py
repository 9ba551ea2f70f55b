"""Quickstart: the Comet MoE block as a PyTorch function (the port's
counterpart of ``examples/quickstart.py``).

Builds a small MoE FFN, runs the three transports (naive baseline, coarse
FasterMoE-style pipeline, comet fine-grained overlap) and shows they are
numerically identical — the schedule changes, the math doesn't. Then shows
the adaptive workload assignment picking the layer-1 column decomposition.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart            # the card
      PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
(The ranked collective schedule: ``python -m repro_torch.launch.selftest``.)
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.adaptive import HW, MoEShape, choose_n_col, layer_times
from repro_torch.core.moe_layer import moe_ffn
from repro_torch.device import resolve_device
from repro_torch.parallel.mesh import AxisCtx

IMPLS = ("naive", "coarse", "comet")


def make_inputs(cfg, seed: int = 0) -> Tuple[Dict, np.ndarray]:
    """The layer's weights (router (d, E), experts (1, E, ...)) and a
    (4, 32, d) input, fp32 numpy from ``seed``."""
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    rng = np.random.default_rng(seed)

    def draw(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    params = {"router": draw(d, E, scale=0.1),
              "experts": {"w_gate": draw(1, E, d, f, scale=0.05),
                          "w_up": draw(1, E, d, f, scale=0.05),
                          "w_down": draw(1, E, f, d, scale=0.05)}}
    return params, draw(4, 32, d, scale=1.0)


def run_transports(cfg, params_np: Dict, x_np: np.ndarray,
                   device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """(y, aux) of the one-rank MoE layer under each transport."""
    def t(a):
        return torch.as_tensor(a, device=device)
    params = {"router": t(params_np["router"]),
              "experts": {k: t(v) for k, v in params_np["experts"].items()}}
    x = t(x_np)
    outs = {}
    with torch.no_grad():
        for impl in IMPLS:
            mcfg = dataclasses.replace(cfg.moe, impl=impl)
            outs[impl] = moe_ffn(cfg, mcfg, params, x, AxisCtx())
    return outs


def n_col_table(hw_name: str, Ms=(1024, 4096, 16384, 65536)) -> List[Dict]:
    """The cost model's layer-1 N-decomposition at each M (paper Fig. 6/8):
    mixtral-8x7b's expert at EP 8."""
    hw = HW[hw_name]
    rows = []
    for M in Ms:
        s = MoEShape(M=M, N=4096, K=14336, E=8, topk=2, ep=8, etp=1)
        rows.append({"M": M, "n_col": choose_n_col(hw, s),
                     **layer_times(hw, s)})
    return rows


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m-smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", default="h100_nvlink", choices=sorted(HW))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    print(f"model: {cfg.name}  E={E} top_k={cfg.moe.top_k} d={d} "
          f"d_expert={f}  device={dev}")
    outs = run_transports(cfg, *make_inputs(cfg), dev)
    for impl, (y, aux) in outs.items():
        print(f"impl={impl:7s} out={tuple(y.shape)} aux_loss={float(aux):.5f}")
    err = float((outs["comet"][0] - outs["naive"][0]).abs().max())
    print(f"max |comet - naive| = {err:.2e}  (identical math, different "
          f"schedule)")

    print(f"\nadaptive layer-1 N-decomposition on {args.hw} "
          f"(paper Fig. 6/8):")
    table = n_col_table(args.hw)
    for r in table:
        print(f"  M={r['M']:6d}  n_col={r['n_col']}  per-chunk gemm="
              f"{r['t_chunk_compute']*1e6:7.1f}us  per-hop link="
              f"{r['t_hop']*1e6:7.1f}us  balance={r['dispatch_balance']:.2f}")
    return {"outs": outs, "max_err": err, "n_col": table}


if __name__ == "__main__":
    main()
