"""The train step: grad accumulation, AdamW, and the non-finite guard
(``repro.launch.train_step.make_train_fn`` and ``build_train_step``), at
one rank or on a mesh; and the serving engine's two steps on the same
terms (``build_prefill_chunk_step``, ``build_decode_step``).

PyTorch runs eagerly, so there is nothing to compile: ``build_train_step``
returns the step function itself; so does ``build_prefill_step``, the
monolithic prefill. The step updates the state in place (see
``optim/adamw.py``).

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


def _grad(lo: torch.Tensor, leaves):
    """d lo / d each leaf; a leaf the loss does not use (a VLM's token
    embedding under an ``embeds`` batch) gets zeros, as ``jax.grad``
    gives them."""
    return torch.autograd.grad(lo, leaves, allow_unused=True,
                               materialize_grads=True)


def _all_finite(flag: torch.Tensor) -> bool:
    """The non-finite guard's host read of ``flag``. A ``meta`` step (the
    dry run, ``launch/dryrun.py``) holds no values: it takes the finite
    branch, so the update's ops run on the state's shapes."""
    if flag.is_meta:
        return True
    return bool(flag)                                   # host sync


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
                for acc, g in zip(grads, _grad(lo, leaves)):
                    acc.add_(g.float())
                lsum = lsum + lo.detach()
            grads = [g / accum for g in grads]
            lo = lsum / accum
        else:
            lo, _ = loss(params, batch)
            grads = list(_grad(lo, leaves))
            lo = lo.detach()
        if ranked:
            _reduce_over_dp(ctx, grads, specs)
        gtree = _unflatten(params, grads)
        if ranked:
            gnorm = global_norm(gtree, pspecs, ctx.mesh)
            # every rank counts the ranks whose loss is not finite
            bad = CL.all_reduce_((~torch.isfinite(lo)).float().reshape(1),
                                 ctx.mesh.group(ctx.mesh.axis_names))
            ok = _all_finite((bad[0] == 0) & torch.isfinite(gnorm))
        else:
            gnorm = global_norm(gtree)
            ok = _all_finite(torch.isfinite(lo) & torch.isfinite(gnorm))
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
    schedule from a tuned plan cache (``_with_plan_cache``). ``schedule``:
    "" keeps the period-at-a-time forward, "sequential"/"overlap" run the
    step through the block-schedule IR (``cfg.block_schedule``, the
    layers unrolled and without remat: ``lm.forward_scheduled``); the
    numerics are the same either way."""
    cfg = _with_plan_cache(cfg, plan_cache, plan_hw)
    if schedule:
        cfg = dataclasses.replace(cfg, block_schedule=schedule)
    optim = optim or AdamW()
    # the shape's own microbatch size, else its name's default count
    default = (shape.global_batch // shape.microbatch if shape.microbatch
               else SP.TRAIN_ACCUM.get(shape.name, 1))
    accum = SP.legal_accum(shape.global_batch, accum or default)
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


# ---------------------------------------------------------------------------
# Serve: the prefill-chunk and decode steps
# ---------------------------------------------------------------------------


def build_prefill_step(cfg, shape, mesh=None, fsdp: bool = True,
                       plan_cache: Optional[str] = None, plan_hw: str = ""):
    """The monolithic prefill (``repro/launch/train_step.py:159-179``):
    ``fn(params, batch) -> (last-token logits (B, V) fp32, cache)``, the
    cache stacked (n_periods, B, S, ...) per period position
    (``lm.prefill``; ``serving.stitch_prefill_cache`` writes it into a
    decode cache). ``batch`` holds "tokens" (B, S) (an encoder-decoder's
    also "frames" (B, F, d)) and, for a left-padded batch of mixed
    lengths, "mask" (B, S); ``batch_structs`` gives the shapes of
    ``shape``. Prefill-phase plans resolve from ``plan_cache``.

    On a mesh (a ``parallel.mesh.Mesh`` with ("data", "model") axes) the
    context shards the MoE tokens over the sequence (``seq_shard``, as
    the JAX builder's), ``params`` is this rank's shard of the mesh tree
    (its data-axis cuts gathered per period, as the mesh train step
    gathers them) and every rank is handed the global batch: it takes its
    rows as ``batch_pspecs`` cut them (``specs.prefill_batch_pspecs``).
    The logits are the whole (B, V) on every rank, the cache this rank's
    slice (``cache_specs``: ``sharding.prefill_cache_specs``). Returns
    {"fn", "batch_structs", "ctx", "cfg"} and, on a mesh, "batch_pspecs",
    "param_specs", "cache_specs"."""
    cfg = _with_plan_cache(cfg, plan_cache, plan_hw, phase="prefill")
    ctx = SH.make_ctx(cfg, mesh, seq_shard=True)
    built = {"batch_structs": SP.prefill_batch_specs(cfg, shape),
             "ctx": ctx, "cfg": cfg}
    if mesh is None:
        built["fn"] = lambda params, batch: lm.prefill(cfg, params, batch)
        return built
    pspecs = SP.prefill_batch_pspecs(cfg, shape, ctx)
    B = shape.global_batch
    # the rows are this dp rank's where they are cut, every rank's alike
    # otherwise: the MoE then routes them within each model group
    run_ctx = ctx if SH.slots_cut(ctx, B) else dataclasses.replace(
        ctx, dp_axes=())

    def fn(params, batch):
        return lm.prefill(cfg, params, SP.local_batch(batch, pspecs, mesh),
                          run_ctx, fsdp)

    built.update(fn=fn, batch_pspecs=pspecs,
                 param_specs=SH.param_specs(lm.model_schema(cfg, ctx), mesh,
                                            fsdp),
                 cache_specs=SH.prefill_cache_specs(cfg, ctx, B))
    return built


def _serve_built(cfg, shape, mesh, fsdp, phase, plan_cache, plan_hw):
    """The parts both serving steps share: the phase's config, the
    context (``seq_shard`` off, as the JAX builders make it), the cache
    layout of ``shape`` (``specs.decode_inputs``) and, on a mesh, the
    parameter specs and the ``lm.ServeLayout`` every call runs under."""
    cfg = _with_plan_cache(cfg, plan_cache, plan_hw, phase)
    ctx = SH.make_ctx(cfg, mesh, seq_shard=False)
    _, cspecs, tok_spec = SP.decode_inputs(cfg, shape, ctx)
    built = {"cfg": cfg, "ctx": ctx, "cache_specs": cspecs,
             "tok_spec": tok_spec, "layout": None}
    if mesh is not None:
        built["param_specs"] = SH.param_specs(lm.model_schema(cfg, ctx),
                                              mesh, fsdp)
        built["layout"] = lm.serve_layout(cfg, ctx, shape.global_batch,
                                          shape.seq_len,
                                          built["param_specs"], shape.paged,
                                          SP.enc_len_decode(cfg))
    return built


def _check_tables(shape, block_tables):
    """A paged shape's steps need the block tables, a contiguous one's
    none: a pool read as a contiguous cache would be wrong silently."""
    if shape.paged != (block_tables is not None):
        raise ValueError(f"shape {shape.name!r}: block tables "
                         f"{'missing' if shape.paged else 'given'} for a "
                         f"{'paged' if shape.paged else 'contiguous'} cache")


def build_prefill_chunk_step(cfg, shape, mesh=None, chunk: int = 0,
                             fsdp: bool = True,
                             plan_cache: Optional[str] = None,
                             plan_hw: str = ""):
    """The continuous-batching engine's chunked-prefill step
    (``repro/launch/train_step.py:182-233``): ``fn(params, cache, tokens
    (A, C), pos_off (A,), valid_len (A,), slot (A,)) -> (logits (A, V),
    cache)`` against the decode cache that ``shape`` describes (the same
    layout as ``build_decode_step``'s); a paged ``shape`` takes the
    admission rows' block tables (A, max_blocks) as a last operand
    (``repro/launch/train_step.py:199-233``). Prefill-phase plans resolve
    from ``plan_cache`` when one is given.

    On a mesh (a ``parallel.mesh.Mesh`` with ("data", "model") axes) every
    rank is handed the whole stack, as the JAX builder replicates it; the
    rows' rule is ``lm.prefill_chunk``'s: each dp rank runs the rows whose
    slots it holds, and only it writes them. Returns {"fn", "ctx",
    "cache_specs", "param_specs" (on a mesh), "chunk", "cfg",
    "tok_spec"}."""
    built = _serve_built(cfg, shape, mesh, fsdp, "prefill", plan_cache,
                         plan_hw)
    cfg, ctx, layout = built["cfg"], built["ctx"], built["layout"]

    def fn(params, cache, tokens, pos_off, valid_len, slot,
           block_tables=None):
        _check_tables(shape, block_tables)
        if layout is None:
            return lm.prefill_chunk(cfg, params, cache, tokens, pos_off,
                                    valid_len, slot,
                                    block_tables=block_tables)
        return lm.prefill_chunk(cfg, params, cache, tokens, pos_off,
                                valid_len, slot, ctx, layout, block_tables)

    built.update(fn=fn, chunk=chunk or min(32, shape.seq_len))
    return built


def build_decode_step(cfg, shape, mesh=None, fsdp: bool = True,
                      plan_cache: Optional[str] = None, plan_hw: str = ""):
    """The slot-based decode step (``repro/launch/train_step.py:236-285``):
    ``fn(params, cache, tokens (B, 1), pos (B,), live (B,) or None) ->
    (next_tok (B, 1), logits, cache)``, per-row positions, the argmax of
    the fp32 logits (ties to the lower index, as ``jnp.argmax``) and 0
    where a slot is not live (``live`` None: no mask, for a caller that
    masks on the host). A paged ``shape`` takes every slot's block table
    (B, max_blocks) as a last operand (``repro/launch/train_step.py:
    236-290``). Decode-phase plans resolve from ``plan_cache``.

    ``health=True``: ``next_tok`` is (B, 2), its second column 1 where
    the row's logits are all finite, so the engine reads both in one
    device-to-host copy.

    On a mesh every rank is handed the global (B,) inputs and takes its
    slots (cut over the dp axes where ``shape``'s slots divide them,
    ``tok_spec``); ``logits`` are this rank's slots', and each rank's
    next tokens (with ``health``, and the rows' health) are all-gathered
    over the dp group in one collective, so every rank's host scheduler
    sees all B of them."""
    built = _serve_built(cfg, shape, mesh, fsdp, "decode", plan_cache,
                         plan_hw)
    cfg, ctx, layout = built["cfg"], built["ctx"], built["layout"]
    cut = layout is not None and layout.slots_cut

    def fn(params, cache, tokens, pos, live=None, block_tables=None,
           health=False):
        _check_tables(shape, block_tables)
        if layout is not None:
            if cut:
                tokens, pos = (SH.shard_leaf(t, SH.P(built["tok_spec"][0]),
                                             mesh)
                               for t in (tokens.reshape(-1), pos))
                if live is not None:
                    live = SH.shard_leaf(live, SH.P(built["tok_spec"][0]),
                                         mesh)
            logits, cache = lm.decode_step(cfg, params, cache,
                                           tokens.reshape(-1, 1), pos, ctx,
                                           layout, block_tables)
        else:
            logits, cache = lm.decode_step(cfg, params, cache, tokens, pos,
                                           block_tables=block_tables)
        next_tok = torch.argmax(logits, dim=-1)
        if live is not None:
            next_tok = torch.where(live, next_tok, 0)
        next_tok = (torch.stack([next_tok, torch.isfinite(logits).all(-1)
                                 .long()], -1) if health
                    else next_tok[:, None])
        if cut:
            next_tok = CL.all_gather(next_tok, ctx.mesh.group(
                ctx.dp_axes)).reshape(-1, next_tok.shape[1])
        return next_tok, logits, cache

    built["fn"] = fn
    return built
