"""Multi-pod dry run: every (arch x shape x mesh) cell's step on ``meta``
tensors over a fake process group (the port's counterpart of
``repro.launch.dryrun``).

The JAX tool forces 512 host devices, lowers and compiles each cell's
jitted step against abstract inputs and reads XLA's memory and cost
analyses. The port has no compiler to ask, so it runs the step itself,
on tensors that hold no data: ``torch.distributed`` is initialised with
PyTorch's ``"fake"`` backend at the mesh's world size (every collective
returns at once), this process plays one rank (``--rank``, default 0),
the state is made on ``meta`` from the schema's shapes (no RNG draw) and
cut to that rank by ``sharding.state_specs`` / ``cache_specs`` /
``prefill_cache_specs`` and ``local_shape``, and one step runs under
``analysis/op_cost.count_cost``. ``analysis/roofline.analyze`` turns the
count into the three roofline terms; the report adds the rank's bytes
(arguments and peak temporaries) against one card's 80 GB as ``fits``,
which is reported and is not a failure. A failure (a sharding mismatch, a
collective on the wrong group, an op meta cannot run) is a bug in the
system, and the exit code reflects it.

A meta tensor has no values, so a host read cannot run on it: the train
step's non-finite guard (``bool(...)`` of the loss and the norm) takes
the finite branch on meta (``train_step._all_finite``), and the AdamW
update's ops run on the state's meta tensors; the report lists this
under ``assumed``.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all          # single-pod
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
  python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b --shape train_4k \\
      --impl comet --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import dtype_of
from repro_torch.models.common import tree_leaves, tree_map_path

META = torch.device("meta")
# train batch entries that hold token ids (``data/synthetic.py``: int32)
_ID_ENTRIES = ("tokens", "labels")


def init_fake_group(world: int, rank: int = 0) -> None:
    """Initialise the default process group on PyTorch's ``"fake"``
    backend: ``world`` ranks, this process rank ``rank``; every
    collective returns at once. Process-global: one per process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _local(shape, spec, mesh):
    from repro_torch.parallel import sharding as SH
    return tuple(shape) if mesh is None else SH.local_shape(shape, spec,
                                                            mesh)


def meta_params(cfg, ctx, specs=None):
    """The parameter tree on ``meta`` from ``lm.model_schema`` (this rank's
    slice of each leaf where ``specs`` cut it on ``ctx``'s mesh)."""
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as SH
    dt = dtype_of(cfg.param_dtype)
    mesh = ctx.mesh if ctx is not None and ctx.active else None

    def leaf(path, d):
        spec = SH._spec_at(specs, path) if mesh is not None else None
        return torch.empty(_local(d.shape, spec, mesh),
                           dtype=d.leaf_dtype(dt), device=META)
    return tree_map_path(leaf, lm.model_schema(cfg, ctx if mesh else None))


def meta_batch(structs: Dict, pspecs: Optional[Dict], mesh,
               local: bool = True) -> Dict[str, torch.Tensor]:
    """A batch of ``structs``' shapes on ``meta``: token ids int32, frames
    and embeddings fp32 (as ``data/synthetic.py`` makes them); this rank's
    rows where ``local`` and ``pspecs`` cut them."""
    out = {}
    for k, shp in structs.items():
        dt = torch.int32 if k in _ID_ENTRIES else torch.float32
        if local and pspecs is not None and mesh is not None:
            shp = _local(shp, pspecs[k], mesh)
        out[k] = torch.empty(tuple(shp), dtype=dt, device=META)
    return out


def meta_cache(cache_shapes, cache_specs, mesh):
    """The decode cache on ``meta``: ``lm.cache_shapes``' entries, this
    rank's slice of each (``sharding.cache_specs``)."""
    return tuple({k: torch.empty(_local(shp, sp[k], mesh), dtype=dt,
                                 device=META)
                  for k, (shp, dt) in e.items()}
                 for e, sp in zip(cache_shapes, cache_specs))


# addmm with an fp32 output of bf16 operands (the head's tensor-core
# passes, ``models/common._mm_f32``): torch 2.11's meta kernel takes the
# out_dtype for beta and raises, so the dry run gives the output itself
_ADDMM_DTYPE = (torch.ops.aten.addmm.dtype, torch.ops.aten.addmm.dtype_out)


def _addmm_dtype_meta(args, kwargs):
    """addmm(self, mat1, mat2, out_dtype)'s result on ``meta``: ``out``
    when given, else a (rows of mat1, columns of mat2) tensor of
    out_dtype."""
    if kwargs.get("out") is not None:
        return kwargs["out"]
    mat1, mat2, out_dtype = args[1], args[2], args[3]
    return torch.empty((mat1.shape[0], mat2.shape[1]), dtype=out_dtype,
                       device=META)


class MetaOutputCache(TorchDispatchMode):
    """Reuses the outputs' metadata of a functional aten op on ``meta``
    tensors: a call whose arguments have the shapes, strides and dtypes of
    an earlier call's gets fresh outputs of the earlier call's shapes,
    strides and dtypes, without running the op's meta kernel again (most
    of them are Python decompositions, and a step repeats the same calls
    in every layer and every microbatch). Views and in-place ops always
    run. A counter entered inside it (``count_cost``) still sees every
    op first."""

    def __init__(self):
        super().__init__()
        self.memo: Dict = {}

    @staticmethod
    def _key(x):
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                raise TypeError("not a meta tensor")
            return ("T", tuple(x.shape), x.stride(), x.dtype,
                    x.storage_offset())
        if isinstance(x, (list, tuple)):
            return (type(x).__name__,) + tuple(
                MetaOutputCache._key(y) for y in x)
        if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                       torch.device, torch.memory_format,
                                       torch.layout)):
            return x
        raise TypeError(f"no key for {type(x).__name__}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _ADDMM_DTYPE:
            return _addmm_dtype_meta(args, kwargs)
        if (func.is_view or func._schema.is_mutable
                or func.namespace != "aten"):
            return func(*args, **kwargs)
        try:
            key = (func, self._key(args), self._key(sorted(kwargs.items())))
        except TypeError:
            return func(*args, **kwargs)
        spec = self.memo.get(key)
        if spec is not None:
            return spec()
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            meta = (tuple(out.shape), out.stride(), out.dtype)
            self.memo[key] = lambda: torch.empty_strided(
                meta[0], meta[1], dtype=meta[2], device=META)
        elif (isinstance(out, tuple) and out
              and all(isinstance(t, torch.Tensor) for t in out)):
            metas = [(tuple(t.shape), t.stride(), t.dtype) for t in out]
            self.memo[key] = lambda: tuple(
                torch.empty_strided(m[0], m[1], dtype=m[2], device=META)
                for m in metas)
        return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def build_cell(cfg, shape, mesh=None, accum: int = 0, fsdp: bool = True,
               seq_shard: bool = True):
    """(run, this rank's bytes by kind, assumed): ``run()`` takes one step
    of the cell's kind on ``meta`` arguments made from the shapes (one
    rank's cut on ``mesh``; the whole of them without one); ``assumed``
    lists what the step takes for granted on meta (the train step's host
    read takes the finite branch). ``accum`` (0: the shape's default
    microbatch count), ``fsdp`` and ``seq_shard`` go to the builders as
    ``tools/hillclimb.py`` passes them: all three to the train step
    (whose batch then leads with its (accum,) axis), ``fsdp`` to the
    prefill and decode steps."""
    from repro_torch.launch.train_step import (build_decode_step,
                                               build_prefill_step,
                                               build_train_step)
    from repro_torch.optim.adamw import AdamW
    mem: Dict[str, int] = {}
    assumed = []
    if shape.kind == "train":
        built = build_train_step(cfg, shape, mesh, accum=accum, fsdp=fsdp,
                                 seq_shard=seq_shard)
        ctx = built["ctx"]
        specs = built.get("state_specs", {}).get("params")
        params = meta_params(cfg, ctx, specs)
        opt = AdamW().init(params)
        state = {"params": params, "opt": opt, "step": 0}
        batch = meta_batch(built["batch_structs"],
                           built.get("batch_pspecs"), mesh)
        mem.update(param_bytes=_tree_bytes(params),
                   opt_bytes=_tree_bytes({"m": opt["m"], "v": opt["v"]}),
                   batch_bytes=_tree_bytes(batch),
                   grad_bytes=_tree_bytes(params))
        assumed.append("train step: the non-finite guard's host read "
                       "takes the finite branch on meta; the AdamW "
                       "update's ops run on the state's shapes")
        return (lambda: built["fn"](state, batch)), mem, assumed
    if shape.kind == "prefill":
        built = build_prefill_step(cfg, shape, mesh, fsdp=fsdp)
        params = meta_params(cfg, built["ctx"], built.get("param_specs"))
        # every rank is handed the global batch and takes its rows
        batch = meta_batch(built["batch_structs"], None, mesh, local=False)
        mem.update(param_bytes=_tree_bytes(params),
                   batch_bytes=_tree_bytes(batch))
        return (lambda: built["fn"](params, batch)), mem, assumed
    from repro_torch.launch import specs as SP
    built = build_decode_step(cfg, shape, mesh, fsdp=fsdp)
    ctx = built["ctx"]
    params = meta_params(cfg, ctx, built.get("param_specs"))
    shapes, _, _ = SP.decode_inputs(cfg, shape, ctx)
    cache = meta_cache(shapes, built["cache_specs"],
                       ctx.mesh if ctx.active else None)
    B = shape.global_batch
    tok = torch.empty((B, 1), dtype=torch.int64, device=META)
    pos = torch.empty((B,), dtype=torch.int64, device=META)
    live = torch.empty((B,), dtype=torch.bool, device=META)
    mem.update(param_bytes=_tree_bytes(params), cache_bytes=_tree_bytes(cache),
               batch_bytes=_tree_bytes([tok, pos, live]))
    return (lambda: built["fn"](params, cache, tok, pos, live)), mem, assumed


def _write(report, cfg, shape, n_chips, out_dir) -> None:
    os.makedirs(out_dir, exist_ok=True)
    fn = f"{cfg.name}_{shape.name}_{n_chips}_{report['impl']}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(report, f, indent=1)


def run_cell(cfg, shape, mesh, n_chips, impl, out_dir=None, verbose=True,
             **build):
    """One cell: the skip of ``shape_applicable``, else the step of the
    cell's kind run once on meta under ``count_cost``, its roofline report
    (``analyze``) and this rank's bytes against the card's: the
    arguments (parameters, AdamW moments, batch, cache) and the peak of
    the step's temporaries, which hold the gradients (``grad_bytes``,
    reported beside them). ``build``: ``build_cell``'s knobs. With
    ``out_dir`` the report (a skipped cell's too) is written to
    ``<arch>_<shape>_<chips>_<impl>.json`` there."""
    from repro_torch.analysis import roofline as RL
    from repro_torch.analysis.op_cost import count_cost
    from repro_torch.configs.base import shape_applicable

    if cfg.moe is not None and impl:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    impl = impl or (cfg.moe.impl if cfg.moe else "-")
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        report = {"status": "skipped", "reason": reason,
                  "n_chips": n_chips, "impl": impl}
        if out_dir:
            _write(report, cfg, shape, n_chips, out_dir)
        return report

    t0 = time.time()
    run, mem, assumed = build_cell(cfg, shape, mesh, **build)
    with MetaOutputCache(), count_cost() as cost:
        run()
    elapsed = time.time() - t0

    report = RL.analyze(cost, n_chips, cfg=cfg, shape=shape)
    args = sum(v for k, v in mem.items() if k != "grad_bytes")
    report["memory"] = {**mem, "argument_bytes": args,
                        "peak_temp_bytes": cost.peak_bytes,
                        "total_bytes": args + cost.peak_bytes,
                        "fits": args + cost.peak_bytes <= RL.HBM_BYTES}
    report["assumed"] = assumed
    report["status"] = "ok"
    report["run_s"] = elapsed
    report["impl"] = impl
    name = f"{cfg.name}/{shape.name}/{n_chips}chips"
    if verbose:
        print(RL.fmt_report(name, report))
        print(f"  run: {elapsed:.1f}s")
    if out_dir:
        _write(report, cfg, shape, n_chips, out_dir)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--impl", default="",
                    help="MoE transport override: naive|coarse|comet")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--include-paper-archs", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="fake world size (default: the largest mesh's)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose shard is reported")
    ap.add_argument("--summary", default="",
                    help="write every cell's outcome to this JSON file")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import (ASSIGNED_ARCHS, LM_SHAPES,
                                          PAPER_ARCHS, get_config)
    from repro_torch.launch.mesh import make_production_mesh

    archs = ([args.arch] if args.arch != "all" else
             list(ASSIGNED_ARCHS) +
             (PAPER_ARCHS if args.include_paper_archs else []))
    shapes = [args.shape] if args.shape != "all" else list(LM_SHAPES)
    meshes = []
    if args.both_meshes or not args.multi_pod:
        meshes.append(("single-pod", False))
    if args.both_meshes or args.multi_pod:
        meshes.append(("multi-pod", True))
    world = args.devices or (512 if any(m for _, m in meshes) else 256)
    init_fake_group(world, args.rank)

    failures, cells, summary = [], 0, []
    try:
        for mesh_name, multi in meshes:
            mesh = make_production_mesh(multi_pod=multi)
            n_chips = mesh.size
            print(f"\n#### mesh {mesh_name} {dict(mesh.shape)} "
                  f"({n_chips} chips, rank {args.rank}) ####")
            for arch in archs:
                cfg = get_config(arch)
                for shape_name in shapes:
                    shape = LM_SHAPES[shape_name]
                    cells += 1
                    row = {"mesh": mesh_name, "arch": arch,
                           "shape": shape_name}
                    try:
                        r = run_cell(cfg, shape, mesh, n_chips, args.impl,
                                     args.out or None)
                        row["status"] = r["status"]
                        if r["status"] == "skipped":
                            row["reason"] = r["reason"]
                            print(f"== {arch}/{shape_name} == SKIPPED: "
                                  f"{r['reason'][:90]}")
                        else:
                            row.update(
                                dominant=r["dominant"],
                                bound_ms=r["bound_time_s"] * 1e3,
                                t_compute_ms=r["t_compute_s"] * 1e3,
                                t_memory_ms=r["t_memory_s"] * 1e3,
                                t_collective_ms=r["t_collective_s"] * 1e3,
                                args_gb=r["memory"]["argument_bytes"] / 1e9,
                                temp_gb=r["memory"]["peak_temp_bytes"] / 1e9,
                                fits=r["memory"]["fits"],
                                run_s=r["run_s"])
                    except Exception as e:    # a failed cell is a bug: report
                        failures.append((mesh_name, arch, shape_name))
                        row.update(status="failed",
                                   error=f"{type(e).__name__}: {e}"[:300])
                        print(f"== {arch}/{shape_name} == FAILED: {e}")
                        traceback.print_exc()
                    summary.append(row)
    finally:
        dist.destroy_process_group()

    print(f"\n{cells} cells, {len(failures)} failures")
    for f in failures:
        print("  FAIL:", *f)
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(summary, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
