"""The MoE block: router -> shared-tensor dispatch -> transport -> combine.

Expert weights keep the JAX package's pre-sharded storage (W, E_loc, d, f)
with W the model-axis size, so a parameter tree bridged from the JAX
package is used as it is. With no context (or an inactive one) the block
runs at one rank. With an ``AxisCtx`` over torch.distributed, each rank
calls ``moe_ffn`` with its own tokens and its own entry of the expert
storage (leading dim 1), as the JAX package's ``shard_map`` body sees them;
``parallel/sharding.py`` cuts a global batch and the packed weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import adaptive as A
from repro_torch.core import routing as R
from repro_torch.core import transport as T
from repro_torch.models.common import ParamDecl, ffn_schema, is_glu
from repro_torch.parallel.mesh import AxisCtx

IMPLS = ("naive", "coarse", "comet", "comet_hier", "bcast", "dense")


def moe_schema(cfg, mcfg, W: int = 1, etp: int = 1) -> Dict:
    d = cfg.d_model
    E_loc = mcfg.num_experts // max(1, W // etp)
    f_loc = mcfg.d_expert // etp
    s: Dict = {
        "router": ParamDecl((d, mcfg.num_experts), ("embed_v", "experts_v")),
    }
    # BigMac descend-ascend: shared projections d -> wire before dispatch
    # and wire -> d after combine; the experts live at wire width
    wire = mcfg.wire_dim
    d_in = wire or d
    if wire:
        s["w_desc"] = ParamDecl((d, wire), ("embed_v", None))
        s["w_asc"] = ParamDecl((wire, d), (None, "embed_v"))
    ew: Dict[str, ParamDecl] = {}
    if is_glu(cfg.activation):
        ew["w_gate"] = ParamDecl((W, E_loc, d_in, f_loc),
                                 ("expert_shard", None, "embed", None))
    ew["w_up"] = ParamDecl((W, E_loc, d_in, f_loc),
                           ("expert_shard", None, "embed", None))
    ew["w_down"] = ParamDecl((W, E_loc, f_loc, d_in),
                             ("expert_shard", None, None, "embed"))
    s["experts"] = ew
    if mcfg.num_shared_experts:
        s["shared"] = ffn_schema(cfg, d,
                                 mcfg.d_expert * mcfg.num_shared_experts)
    return s


def pack_expert_weights(full: Dict[str, torch.Tensor], ep: int,
                        etp: int) -> Dict[str, torch.Tensor]:
    """Logical (..., E, d, f)/(..., E, f, d) weights -> the pre-sharded
    (..., W, E_loc, d, f_loc) storage layout, W = ep * etp in model-rank
    order (rank g * etp + t holds expert group g's f-slice t). Leading
    dimensions (the layers' (n_periods,) stacking) are kept."""
    out = {}
    for name, w in full.items():
        E_loc = w.shape[-3] // ep
        fdim = -2 if name == "w_down" else -1
        f_loc = w.shape[fdim] // etp
        packed = []
        for g in range(ep):
            sl = w.narrow(-3, g * E_loc, E_loc)
            for t in range(etp):
                packed.append(sl.narrow(fdim, t * f_loc, f_loc))
        out[name] = torch.stack(packed, dim=w.dim() - 3)
    return out


def unpack_expert_weights(packed: Dict[str, torch.Tensor], ep: int,
                          etp: int) -> Dict[str, torch.Tensor]:
    """The inverse of ``pack_expert_weights``: (..., W, E_loc, ...) ->
    the logical (..., E, ...) weights."""
    out = {}
    for name, w in packed.items():
        wdim = w.dim() - 4
        fdim = -2 if name == "w_down" else -1
        groups = [torch.cat([w.select(wdim, g * etp + t)
                             for t in range(etp)], dim=fdim)
                  for g in range(ep)]
        out[name] = torch.cat(groups, dim=-3)
    return out


def _moe_body(cfg, mcfg, n_col: int, gemm_impl: str, x, router_w, experts,
              w_desc=None, w_asc=None, ctx: Optional[AxisCtx] = None):
    """x: (B, S, d) this rank's tokens. Returns (y, aux). ``w_desc``/
    ``w_asc`` are the BigMac projections: the router sees full-width
    tokens, dispatch to combine runs at wire width, and the ascend restores
    d_model. ``ctx`` None (or inactive) is one rank; an active context's
    ``seq_shard`` and ``dp_axes`` say how the tokens are sharded."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    E = mcfg.num_experts
    ranked = ctx is not None and ctx.active
    token_group = None
    if ranked:
        token_axes = tuple(ctx.dp_axes)
        if ctx.seq_shard and S > 1:
            token_axes = token_axes + (ctx.model_axis,)
        if token_axes:
            token_group = ctx.mesh.group(token_axes)
    impl = mcfg.impl
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}")
    # the coarse schedule dispatches per token slice: the full-batch
    # dispatch is not built
    coarse = impl == "coarse" and ranked and ctx.world > 1
    with tracing.span("moe.route"):
        # one router product per sequence (S > 1): a sequence's routing
        # does not depend on the batch it shares the call with
        idx, wts, aux = R.router(xt, router_w, mcfg, token_group,
                                 seq_len=S if S > 1 else 0)
        C = R.capacity(B * S, mcfg.top_k, E, mcfg.capacity_factor)
        xe = xt if w_desc is None else (xt @ w_desc).to(xt.dtype)
        if not coarse:
            buf, info = R.build_dispatch(xe, idx, E, C)             # (E,C,dw)
    ep = ctx.ep if ranked else 1
    E_loc = E // ep
    w_local = {k: v[0] for k, v in experts.items()}       # strip the shard dim
    dw = xe.shape[-1]                                   # wire (or full) width

    def ascend(y):
        y = y if w_asc is None else (y @ w_asc).to(y.dtype)
        return y.reshape(B, S, d)

    if coarse:
        with tracing.span("moe.experts"):
            y = _coarse(cfg, mcfg, ctx, xe, idx, wts, E, C, w_local,
                        gemm_impl)
        return ascend(y), aux

    seq_shard = ranked and ctx.seq_shard
    if impl == "bcast" or (impl != "dense" and S == 1 and not seq_shard):
        with tracing.span("moe.experts"):
            out = T.transport_bcast(buf, w_local, cfg.activation, gemm_impl,
                                    ctx=ctx)
        with tracing.span("moe.combine"):
            y = R.combine(out.reshape(E * C, dw), info, wts, E_loc=E, C=C,
                          rot=None, ep=1)
    elif impl in ("comet", "comet_hier"):
        send = buf.reshape(ep, E_loc, C, dw)
        with tracing.span("moe.experts"):
            if impl == "comet_hier":
                blocks, rot = T.transport_comet_hier(
                    send, w_local, cfg.activation, n_col_blocks=n_col,
                    ring_group=mcfg.ring_group,
                    intra_group=mcfg.intra_group,
                    wire_dtype=mcfg.wire_dtype, gemm_impl=gemm_impl, ctx=ctx)
            else:
                blocks, rot = T.transport_comet_blocks(
                    send, w_local, cfg.activation, n_col_blocks=n_col,
                    ring_group=mcfg.ring_group, gemm_impl=gemm_impl, ctx=ctx)
        with tracing.span("moe.combine"):
            if mcfg.fused_combine:
                # streaming layer-1 consumer: one combine per column block
                parts = [R.combine(b.reshape(ep * E_loc * C, b.shape[-1]),
                                   info, wts, E_loc, C, rot, ep)
                         for b in blocks]
                y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            else:
                out = blocks[0] if len(blocks) == 1 else \
                    torch.cat(blocks, dim=-1)
                y = R.combine(out.reshape(ep * E_loc * C, dw), info, wts,
                              E_loc, C, rot, ep)
    else:                                               # naive/coarse/dense
        # at one rank coarse is the naive schedule on the one token slice
        # that matters
        send = buf.reshape(ep, E_loc, C, dw)
        with tracing.span("moe.experts"):
            out, rot = T.transport_naive(send, w_local, cfg.activation,
                                         gemm_impl, ctx=ctx)
        with tracing.span("moe.combine"):
            y = R.combine(out.reshape(ep * E_loc * C, dw), info, wts, E_loc,
                          C, rot, ep)
    # aux is already pmean'd over the token group inside the router
    return ascend(y), aux


def _coarse(cfg, mcfg, ctx, xt, idx, wts, E, C, w_local, gemm_impl=None):
    """FasterMoE-style: n token slices, each a full (all-to-all -> MLP ->
    all-to-all) round. ``C`` is the full-batch capacity of the outer
    routing pass, reused when the one slice is the batch (n == 1); n > 1
    takes each slice's own capacity."""
    n = max(1, mcfg.coarse_chunks)
    Tn, d = xt.shape
    while Tn % n:
        n -= 1
    Ts = Tn // n
    Cs = C if n == 1 else R.capacity(Ts, mcfg.top_k, E, mcfg.capacity_factor)
    ep = ctx.ep
    E_loc = E // ep
    outs = []
    for i in range(n):
        sl = slice(i * Ts, (i + 1) * Ts)
        buf, info = R.build_dispatch(xt[sl], idx[sl], E, Cs)
        send = buf.reshape(ep, E_loc, Cs, d)
        out, _ = T.transport_naive(send, w_local, cfg.activation, gemm_impl,
                                   ctx=ctx)
        outs.append(R.combine(out.reshape(ep * E_loc * Cs, d), info,
                              wts[sl], E_loc, Cs, None, ep))
    return torch.cat(outs, dim=0)


def resolve_token_sharding(ctx: Optional[AxisCtx], B: int, S: int):
    """(seq_sharded, dp_axes) for a global (B, S) batch: the one place the
    token sharding is decided. Sequence sharding needs S divisible by the
    model axis; a batch indivisible by dp is replicated over dp."""
    if ctx is None or not ctx.active:
        return False, ()
    seq_sharded = ctx.seq_shard and S > 1 and S % ctx.model_size == 0
    dp_axes = (ctx.dp_axes
               if ctx.dp_size > 1 and B % ctx.dp_size == 0 else ())
    return seq_sharded, dp_axes


def local_token_count(ctx: Optional[AxisCtx], B: int, S: int) -> int:
    """Tokens per model-axis group for a global (B, S) batch, from
    ``resolve_token_sharding``: the M of the plan-shape key."""
    seq_sharded, dp_axes = resolve_token_sharding(ctx, B, S)
    dp = ctx.dp_size if dp_axes else 1
    ms = ctx.model_size if seq_sharded else 1
    return max(1, B * S // (dp * ms))


def moe_ffn(cfg, mcfg, params, x, ctx: Optional[AxisCtx] = None,
            n_col: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) this rank's tokens. Returns (y, aux).

    With no context (or an inactive one) this is the one-rank layer. With
    a ranked context, ``params["experts"]`` holds this rank's entry of the
    packed storage (leading dim 1), and ``ctx.seq_shard``/``ctx.dp_axes``
    say how x was cut from the global batch, as
    ``parallel.sharding.shard_tokens`` returns them (the JAX package's
    ``moe_ffn`` resolves them from the global shape inside its jit).

    Schedule resolution, as in the JAX package: when ``mcfg.plan_cache``
    (or $REPRO_PLAN_CACHE) is set and ``mcfg.plan_override`` is not, the
    transport, ring_group, n_col and GroupGEMM backend come from the plan
    cache for this shape and ``mcfg.plan_phase`` (a missing cache or entry
    takes the cost model's plan); otherwise the explicit knobs apply, and
    an ``n_col`` of 0 (from the caller and the config) is the cost model's
    column split (``adaptive.resolve_n_col``). The plan's backend rides
    ``mcfg.gemm_impl`` into the body. The plan key's M is the tokens of
    one model-axis group, which is x's own count: the JAX package's
    ``local_token_count`` of the global batch."""
    toks_local = max(1, x.shape[0] * x.shape[1])
    ranked = ctx is not None and ctx.active
    ep, etp = (ctx.ep, ctx.etp) if ranked else (1, 1)
    if A.plan_lookup_enabled(mcfg):
        plan = A.resolve_plan(mcfg, cfg.d_model, toks_local, ep, etp)
        mcfg = plan.apply(mcfg)
        n_col = plan.n_col_blocks
    if n_col == 0:
        n_col = A.resolve_n_col(mcfg, cfg.d_model, toks_local, ep, etp)
    y, aux = _moe_body(cfg, mcfg, n_col, T._impl(mcfg.gemm_impl), x,
                       params["router"], params["experts"],
                       w_desc=params.get("w_desc"), w_asc=params.get("w_asc"),
                       ctx=ctx)
    return y, aux
