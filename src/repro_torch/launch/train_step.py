"""The train step: grad accumulation, AdamW, and the non-finite guard
(``repro.launch.train_step.make_train_fn`` and ``build_train_step``), at
one rank or on a mesh.

PyTorch runs eagerly, so there is nothing to compile: ``build_train_step``
returns the step function itself. The step updates the state in place
(see ``optim/adamw.py``).

On a mesh every rank runs the step on its rows of the batch and its shard
of the state (``parallel.sharding.state_specs``). Each leaf's gradient is
summed over exactly the ranks that computed it on different tokens: the
data axes, where the leaf is not cut over them (a leaf cut over them had
its gradient reduce-scattered in the backward). The gradient norm is
global (``adamw.global_norm``), and so is the loss, so the non-finite
guard decides the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.launch import specs as SP
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves, tree_map_path
from repro_torch.optim.adamw import AdamW, global_norm
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import AxisCtx

Tree = Any


def _with_plan_cache(cfg, plan_cache: Optional[str], plan_hw: str = "",
                     phase: str = "train"):
    """``cfg`` with a tuned-plan cache path, its hardware key and a latency
    phase threaded into the MoE config, so every ``moe_ffn`` under the step
    resolves its schedule from the phase's cache entry (train: fwd+bwd,
    prefill: chunk throughput, decode: per-step latency)."""
    if not plan_cache or cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, plan_cache=plan_cache,
                                     plan_hw=plan_hw, plan_override=False,
                                     plan_phase=phase))


def _unflatten(like: Tree, leaves):
    """The tree of ``like`` with its leaves, in ``tree_leaves`` order,
    replaced by ``leaves``."""
    by_path = dict(zip((p for p, _ in tree_leaves(like)), leaves))
    return tree_map_path(lambda path, _: by_path[path], like)


def _reduce_over_dp(ctx: AxisCtx, grads, specs) -> None:
    """Sum, in place, each gradient not cut over the data axes over them."""
    if ctx.dp_size == 1:
        return
    group = ctx.mesh.group(ctx.dp_axes)
    for g, sp in zip(grads, specs):
        if not set(sp.axes()) & set(ctx.dp_axes):
            CL.all_reduce_(g, group)


def make_train_fn(cfg, ctx: Optional[AxisCtx], optim: AdamW, accum: int,
                  fsdp: bool = True):
    """step(state, batch) -> (state, metrics). ``accum > 1`` takes batch
    entries with a leading (accum,) axis and sums the microbatches'
    gradients in fp32. A non-finite loss or gradient norm skips the whole
    update (parameters, moments and step counter stay as they were) and
    reports ``skipped``. ``ctx``: None or inactive at one rank; a ranked
    context runs the mesh step (the module docstring) on this rank's
    shard of the state and rows of the batch."""
    ranked = ctx is not None and ctx.active
    pspecs = SH.state_specs(cfg, ctx, fsdp)["params"] if ranked else None
    specs = [sp for _, sp in tree_leaves(pspecs)] if ranked else None

    def loss(params, b):
        if ranked:
            return lm.loss_fn(cfg, params, b, ctx, fsdp)
        return lm.loss_fn(cfg, params, b)

    def step(state: Dict, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        leaves = [t for _, t in tree_leaves(params)]
        for t in leaves:
            t.requires_grad_(True)
        if accum > 1:
            grads = [torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for t in leaves]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(accum):
                lo, _ = loss(params, {k: v[i] for k, v in batch.items()})
                for acc, g in zip(grads, torch.autograd.grad(lo, leaves)):
                    acc.add_(g.float())
                lsum = lsum + lo.detach()
            grads = [g / accum for g in grads]
            lo = lsum / accum
        else:
            lo, _ = loss(params, batch)
            grads = list(torch.autograd.grad(lo, leaves))
            lo = lo.detach()
        if ranked:
            _reduce_over_dp(ctx, grads, specs)
        gtree = _unflatten(params, grads)
        if ranked:
            gnorm = global_norm(gtree, pspecs, ctx.mesh)
            # every rank counts the ranks whose loss is not finite
            bad = CL.all_reduce_((~torch.isfinite(lo)).float().reshape(1),
                                 ctx.mesh.group(ctx.mesh.axis_names))
            ok = bool((bad[0] == 0) & torch.isfinite(gnorm))   # host sync
        else:
            gnorm = global_norm(gtree)
            ok = bool(torch.isfinite(lo) & torch.isfinite(gnorm))
        if ok:
            _, state["opt"], stats = optim.update(gtree, state["opt"], params,
                                                  gnorm=gnorm)
            state["step"] += 1
        else:
            stats = {"grad_norm": gnorm,
                     "lr": optim.lr(state["opt"]["count"] + 1)}
        del grads, gtree
        return state, {"loss": lo, **stats, "skipped": int(not ok)}

    return step


def build_train_step(cfg, shape, mesh=None, optim: Optional[AdamW] = None,
                     accum: int = 0, fsdp: bool = True,
                     seq_shard: bool = True,
                     plan_cache: Optional[str] = None, plan_hw: str = "",
                     schedule: str = ""):
    """Returns {"fn": step, "batch_structs": the global batch's entry
    shapes, "accum", "ctx"} and, on a mesh (a ``parallel.mesh.Mesh`` with
    ("data", "model") axes), "state_specs" and "batch_pspecs": how the
    state and the batch are cut over it. ``fsdp`` cuts the parameters'
    embed dimension over the data axes, ``seq_shard`` shards the MoE
    tokens over the sequence, as in the JAX package. ``plan_cache`` (and
    its hardware key ``plan_hw``) resolves every MoE layer's train-phase
    schedule from a tuned plan cache (``_with_plan_cache``). A block
    schedule raises (not ported)."""
    cfg = _with_plan_cache(cfg, plan_cache, plan_hw)
    if schedule:
        raise NotImplementedError("schedule: the whole-graph schedule is "
                                  "not ported yet")
    optim = optim or AdamW()
    accum = SP.legal_accum(shape.global_batch,
                           accum or SP.TRAIN_ACCUM.get(shape.name, 1))
    ctx = SH.make_ctx(cfg, mesh, seq_shard=seq_shard)
    built = {"fn": make_train_fn(cfg, ctx, optim, accum, fsdp),
             "batch_structs": SP.train_batch_specs(cfg, shape, accum),
             "accum": accum, "ctx": ctx, "fsdp": fsdp}
    if mesh is None:
        return built
    mb = shape.global_batch // accum
    if mb % max(1, ctx.dp_size):
        raise ValueError(f"a microbatch of {mb} rows does not split over "
                         f"{ctx.dp_size} data-parallel ranks")
    built["state_specs"] = SH.state_specs(cfg, ctx, fsdp)
    built["batch_pspecs"] = SP.train_batch_pspecs(cfg, shape, accum,
                                                  ctx.dp_axes)
    return built
