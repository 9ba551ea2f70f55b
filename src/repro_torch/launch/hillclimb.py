"""Hillclimb driver: run one (arch x shape) cell with config overrides
and print the three roofline terms (the port's counterpart of
``tools/hillclimb.py``, the JAX package's performance iteration tool).

The JAX tool compiles the cell on the production mesh; the port runs its
step once on ``meta`` tensors over PyTorch's ``"fake"`` process group
(``launch/dryrun.run_cell``: rank 0 of 256, or of 512 with
``multipod=1``). The keys and their meaning are the JAX tool's:

  impl=naive|coarse|comet   ring_group=G   n_col=N   ep=E   cap=F
  chunk=Q (an SSM's chunk)  remat=full|none   spres=0|1 (SP residual)
  padheads=0|1   dtype=<compute dtype>   multipod=0|1   accum=A
  fsdp=0|1   sp=0|1 (seq-shard the MoE tokens)   save=1

``save=1`` writes the report to ``experiments/perf/<arch>_<shape>_<the
other overrides, key then value, by key>.json``. The JAX report's
``compile_s`` is the port's ``run_s``.

Usage:
  python -m repro_torch.launch.hillclimb qwen3-moe-235b-a22b train_4k \\
      ring_group=4 n_col=2 accum=2 remat=full fsdp=1 chunk=64 impl=comet
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict


def apply_overrides(cfg, kw: Dict[str, str]):
    """``cfg`` with the config overrides of ``kw`` applied, as
    ``tools/hillclimb.py`` builds them: the MoE keys on an MoE config, the
    chunk on an SSM config, the heads' padding on an attention config."""
    over = {}
    if cfg.moe is not None:
        moe = cfg.moe
        if "impl" in kw:
            moe = dataclasses.replace(moe, impl=kw["impl"])
        if "ring_group" in kw:
            moe = dataclasses.replace(moe, ring_group=int(kw["ring_group"]))
        if "n_col" in kw:
            moe = dataclasses.replace(moe, n_col_blocks=int(kw["n_col"]))
        if "ep" in kw:
            moe = dataclasses.replace(moe, ep=int(kw["ep"]))
        if "cap" in kw:
            moe = dataclasses.replace(moe, capacity_factor=float(kw["cap"]))
        over["moe"] = moe
    if cfg.ssm is not None and "chunk" in kw:
        over["ssm"] = dataclasses.replace(cfg.ssm, chunk_size=int(kw["chunk"]))
    if "remat" in kw:
        over["remat"] = kw["remat"]
    if "spres" in kw:
        over["sp_residual"] = kw["spres"] == "1"
    if "padheads" in kw and cfg.attn is not None:
        over["attn"] = dataclasses.replace(cfg.attn,
                                           pad_heads=kw["padheads"] == "1")
    if "dtype" in kw:
        over["compute_dtype"] = kw["dtype"]
    return dataclasses.replace(cfg, **over) if over else cfg


def build_knobs(kw: Dict[str, str]) -> Dict:
    """``dryrun.build_cell``'s knobs from the overrides: ``accum`` (0:
    the shape's default), ``fsdp`` and ``seq_shard`` (``sp``), on unless
    set to anything but 1."""
    return {"accum": int(kw.get("accum", 0)),
            "fsdp": kw.get("fsdp", "1") == "1",
            "seq_shard": kw.get("sp", "1") == "1"}


def perf_path(arch: str, shape_name: str, kw: Dict[str, str]) -> str:
    return (f"experiments/perf/{arch}_{shape_name}_"
            + "_".join(f"{k}{v}" for k, v in sorted(kw.items())
                       if k != "save") + ".json")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or any("=" not in a for a in argv[2:]):
        print(__doc__, file=sys.stderr)
        return 2
    arch, shape_name = argv[0], argv[1]
    kw = dict(a.split("=", 1) for a in argv[2:])

    import torch.distributed as dist

    from repro_torch.analysis import roofline as RL
    from repro_torch.configs.base import LM_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = apply_overrides(get_config(arch), kw)
    shape = LM_SHAPES[shape_name]
    multi = kw.get("multipod", "0") == "1"
    dryrun.init_fake_group(512 if multi else 256, 0)
    try:
        mesh = make_production_mesh(multi_pod=multi)
        report = dryrun.run_cell(cfg, shape, mesh, mesh.size, "",
                                 verbose=False, **build_knobs(kw))
    finally:
        dist.destroy_process_group()
    report["overrides"] = kw
    if report["status"] == "skipped":
        print(f"== {arch}/{shape_name} {kw} == SKIPPED: {report['reason']}")
    else:
        print(RL.fmt_report(f"{arch}/{shape_name} {kw}", report))
        print(f"  run: {report['run_s']:.1f}s")
    if kw.get("save"):
        fn = perf_path(arch, shape_name, kw)
        os.makedirs(os.path.dirname(fn), exist_ok=True)
        with open(fn, "w") as f:
            json.dump(report, f, indent=1)
        print("saved:", fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
