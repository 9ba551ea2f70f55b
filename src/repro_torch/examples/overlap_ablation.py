"""Overlap-mechanism ablation: sweep input length M and print each
mechanism's simulated single-layer latency + how much communication each
hides (the paper's Fig. 10/11, runnable at any shape; the port's
counterpart of ``examples/overlap_ablation.py``). The simulator is
arithmetic on the hardware presets: ``--device`` names where the example
runs, and nothing here touches it.

Run:  PYTHONPATH=src python -m repro_torch.examples.overlap_ablation --hw h100_nvlink
      PYTHONPATH=src python -m repro_torch.examples.overlap_ablation --hw tpu_v5e --tpu
"""
from __future__ import annotations

import argparse
from typing import List

from repro_torch.analysis.simulator import (sim_comet, sim_fastermoe,
                                            sim_megatron, sim_tutel)
from repro_torch.core.adaptive import HW, MoEShape
from repro_torch.device import resolve_device

MS = (1024, 2048, 4096, 8192, 16384, 32768, 65536)


def table(hw_name: str, N=4096, K=14336, E=8, topk=2, ep=8, etp=1,
          tpu=False) -> List[str]:
    """The ablation's rows, as printed."""
    hw = HW[hw_name]
    lines = [f"hw={hw.name}  experts {N}x{K}  E={E} topk={topk}  "
             f"EP{ep}xTP{etp}",
             f"{'M':>7s} {'megatron':>10s} {'fastermoe':>10s} {'tutel':>10s} "
             f"{'comet':>10s} {'speedup':>8s} {'hidden%':>8s} {'n_col':>6s}"]
    for M in MS:
        s = MoEShape(M=M, N=N, K=K, E=E, topk=topk, ep=ep, etp=etp)
        t_m = sim_megatron(hw, s)["total"]
        t_f = (sim_fastermoe(hw, s)["total"] if etp == 1 else
               float("nan"))
        t_t = sim_tutel(hw, s)["total"]
        c = sim_comet(hw, s, tpu=tpu)
        hide = 100 * c["overlapped"] / max(c["comm"], 1e-12)
        best_base = min(x for x in (t_m, t_f, t_t) if x == x)
        lines.append(f"{M:7d} {t_m*1e6:9.0f}u {t_f*1e6:9.0f}u "
                     f"{t_t*1e6:9.0f}u {c['total']*1e6:9.0f}u "
                     f"{best_base/c['total']:7.2f}x {hide:7.1f}% "
                     f"{c['n_col']:6d}")
    return lines


def main(argv=None) -> List[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default="h100_nvlink", choices=sorted(HW))
    ap.add_argument("--tpu", action="store_true",
                    help="model comet without SM-donation derate (TPU DMA)")
    ap.add_argument("--N", type=int, default=4096)
    ap.add_argument("--K", type=int, default=14336)
    ap.add_argument("--E", type=int, default=8)
    ap.add_argument("--topk", type=int, default=2)
    ap.add_argument("--ep", type=int, default=8)
    ap.add_argument("--etp", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    lines = table(args.hw, args.N, args.K, args.E, args.topk, args.ep,
                  args.etp, args.tpu)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
