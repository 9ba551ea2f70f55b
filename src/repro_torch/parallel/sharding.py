"""Context construction, and one rank's share of a global batch and of the
packed expert weights.

The JAX package hands ``shard_map`` the global arrays with partition specs
(``moe_layer.moe_ffn``'s ``in_specs``): tokens split over dp (when B
divides) and over the model axis (under sequence sharding), the packed
expert storage (W, E_loc, ...) split over the model axis, the router
replicated. In torch each rank is handed its own share: ``shard_tokens``
and ``shard_experts`` cut it, ``gather_tokens`` and ``gather_experts``
assemble the global arrays back (for tests and the self-test).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.moe_layer import resolve_token_sharding
from repro_torch.parallel import collectives as CL
from repro_torch.parallel.mesh import AxisCtx, Mesh, choose_ep


def make_ctx(cfg, mesh: Optional[Mesh], seq_shard: bool = True) -> AxisCtx:
    if mesh is None:
        return AxisCtx()
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    msize = mesh.shape.get("model", 1)
    ep = etp = 1
    if cfg.moe is not None:
        ep, etp = choose_ep(cfg.moe.num_experts, msize, cfg.moe.ep)
        # d_expert must divide over etp too
        while etp > 1 and cfg.moe.d_expert % etp:
            etp //= 2
            ep = msize // etp
        if cfg.moe.num_experts % ep:
            raise ValueError(f"no valid (ep, etp) for "
                             f"E={cfg.moe.num_experts} on model axis {msize}")
    else:
        ep, etp = msize, 1
    return AxisCtx(mesh=mesh, dp_axes=dp_axes, model_axis="model",
                   ep=ep, etp=etp, seq_shard=seq_shard)


def _dp_index(ctx: AxisCtx, dp_axes, coords=None) -> int:
    """Row-major index over ``dp_axes`` of this rank (or of ``coords``)."""
    co = ctx.mesh.coords if coords is None else coords
    i = 0
    for a in dp_axes:
        i = i * ctx.mesh.shape[a] + co[a]
    return i


def shard_tokens(ctx: AxisCtx, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, AxisCtx]:
    """(this rank's tokens of the global (B, S, ...) batch x, the context
    that says how they were cut). B splits over the dp axes when it
    divides, S over the model axis under sequence sharding when it
    divides (``moe_layer.resolve_token_sharding``)."""
    B, S = x.shape[0], x.shape[1]
    seq_sharded, dp_axes = resolve_token_sharding(ctx, B, S)
    if dp_axes:
        b = B // ctx.dp_size
        x = x[_dp_index(ctx, dp_axes) * b:][:b]
    if seq_sharded:
        s = S // ctx.model_size
        x = x[:, ctx.model_rank * s:][:, :s]
    return x.contiguous(), dataclasses.replace(
        ctx, seq_shard=seq_sharded, dp_axes=dp_axes)


def shard_experts(ctx: AxisCtx, packed: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """This rank's entry (leading dim 1) of the packed (W, E_loc, ...)
    expert storage."""
    m = ctx.model_rank
    return {k: v[m:m + 1].clone() for k, v in packed.items()}


def gather_tokens(ctx: AxisCtx, y: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's share ``y``, cut as ``ctx`` (the
    context ``shard_tokens`` returned) says. Of the ranks that hold the
    same tokens, the one at coordinate 0 on the replicated axes gives
    them. Collective over every rank."""
    world = ctx.mesh.group(ctx.mesh.axis_names)
    parts = CL.all_gather(y, world)
    b, s = y.shape[0], y.shape[1]
    nb = ctx.dp_size if ctx.dp_axes else 1
    ns = ctx.model_size if ctx.seq_shard else 1
    out = y.new_empty((b * nb, s * ns) + tuple(y.shape[2:]))
    replicated = [a for a in ctx.mesh.axis_names if a not in ctx.dp_axes
                  and not (a == ctx.model_axis and ctx.seq_shard)]
    for rank, part in zip(world.ranks, parts):
        co = ctx.mesh.coords_of(rank)
        if any(co[a] for a in replicated):
            continue
        bi = _dp_index(ctx, ctx.dp_axes, co)
        si = co[ctx.model_axis] if ctx.seq_shard else 0
        out[bi * b:(bi + 1) * b, si * s:(si + 1) * s] = part
    return out


def gather_experts(ctx: AxisCtx, shard: torch.Tensor) -> torch.Tensor:
    """The packed (W, E_loc, ...) storage from every model rank's entry
    (leading dim 1). Collective over the model axis."""
    return CL.all_gather(shard[0], ctx.model_group)
