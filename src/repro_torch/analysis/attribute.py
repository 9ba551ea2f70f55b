"""Per-bucket attribution of one (arch x shape) cell's count (the port's
counterpart of ``tools/attribute.py``).

The JAX tool compiles the cell on the production mesh and files each HLO
instruction's FLOPs, bytes and collective bytes under the bucket of its
``op_name``. The port runs the cell's step once on ``meta`` tensors over
PyTorch's ``"fake"`` process group (``launch/dryrun.py``: one rank of the
256, or 512 with ``--multi-pod``) under ``op_cost.count_cost(attribute=
True)``, which keys every op by the port's own call chain and files it
under ``op_cost.bucket_of`` of that key (the op_cost docstring). The
table is the JAX tool's: the top 20 buckets by bytes plus collective
bytes, in GFLOP (1e9) and GiB (2**30).

Usage:
  python -m repro_torch.analysis.attribute <arch> <shape> [impl] \\
      [--rank R] [--multi-pod] [--json PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List

TOP = 20


def attribute_cell(cfg, shape, mesh) -> Dict:
    """{"rows": ``op_cost.bucket_rows`` of one step of the cell on meta
    (one rank's cut on ``mesh``), "totals": the count's flops, mxu_flops,
    bytes and ici_bytes, "regions", "run_s"}."""
    from repro_torch.analysis.op_cost import bucket_rows, count_cost
    from repro_torch.launch import dryrun
    t0 = time.time()
    run, _, _ = dryrun.build_cell(cfg, shape, mesh)
    with dryrun.MetaOutputCache(), count_cost(attribute=True) as cost:
        run()
    return {"rows": bucket_rows(cost),
            "totals": {"flops": cost.flops, "mxu_flops": cost.mxu_flops,
                       "bytes": cost.bytes, "ici_bytes": cost.ici_bytes},
            "regions": cost.regions, "run_s": time.time() - t0}


def fmt_rows(rows: List[tuple], n: int = TOP) -> str:
    """The JAX tool's table of the first ``n`` rows."""
    out = [f"{'bucket':16s} {'GFLOP':>10s} {'GiB':>10s} {'coll GiB':>10s}"]
    for b, flops, _, nbytes, ici, _ in rows[:n]:
        out.append(f"{b:16s} {flops / 1e9:10.1f} {nbytes / 2**30:10.2f} "
                   f"{ici / 2**30:10.2f}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("impl", nargs="?", default="",
                    help="MoE transport override: naive|coarse|comet")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose shard is counted")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default="",
                    help="write the rows and totals to this JSON file")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs.base import (LM_SHAPES, get_config,
                                          shape_applicable)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(args.arch)
    if args.impl and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=args.impl))
    shape = LM_SHAPES[args.shape]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        print(f"== {args.arch}/{args.shape} == SKIPPED: {reason}")
        return 0
    dryrun.init_fake_group(512 if args.multi_pod else 256, args.rank)
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        res = attribute_cell(cfg, shape, mesh)
    finally:
        dist.destroy_process_group()
    print(f"== {args.arch}/{args.shape} rank {args.rank} of {mesh.size}: "
          f"{len(res['rows'])} buckets, {res['run_s']:.1f} s")
    print(fmt_rows(res["rows"]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": args.arch, "shape": args.shape,
                       "rank": args.rank, "n_chips": mesh.size, **res}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
