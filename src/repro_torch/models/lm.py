"""Full model: schema, init, the training forward and loss (period by
period, or through the block-schedule IR: ``forward_scheduled``), the
monolithic prefill, prefill chunks and decode.

Layers are stacked by *period* as in the JAX package: ``params["layers"]``
is a list over period positions of trees whose leaves carry a leading
(n_periods,) axis, and the KV cache has the same stacking. Where JAX scans
over periods, the port loops in Python and takes views of period ``n``.
The cache is updated in place.

An encoder-decoder (whisper: ``cfg.n_enc_layers``) adds an ``encoder``
stack of bidirectional layers over the stub audio frontend's frames
(``encode``) whose output every decoder layer's cross-attention reads, and
sinusoid positions on both sides; it runs the training forward, the
scheduled forward, the monolithic prefill and the decode.

The training forward and loss also run on a mesh: with a ranked
``AxisCtx`` each rank holds its rows of the batch and its shard of the
parameters (``parallel.sharding.to_mesh``); see ``forward``. So does the
monolithic prefill (``prefill``), each rank keeping its slice of the
cache, and so do the serving calls, each rank also holding its slice of
the decode cache (``init_cache``, ``decode_step``, ``prefill_chunk``);
an encoder-decoder's as well. The decode cache is
contiguous (one ``seq_len`` region per slot) or paged (``init_paged_cache``:
K/V page pools shared by every slot, reached through block tables).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models.common import (ParamDecl, apply_norm,
                                       chunked_xent, ffn_schema,
                                       init_from_schema, model_sharded,
                                       norm_schema, sinusoid_at,
                                       sinusoid_positions, tree_leaves,
                                       tree_map, tree_map_path)
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import sharding as SH

Tree = Any


def period_of(cfg) -> int:
    p = max(1, len(cfg.layer_pattern))
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every_k_layers)
    return p


def _stack(schema: Tree, n: int) -> Tree:
    return tree_map(lambda d: ParamDecl((n,) + d.shape, ("layers",)
                                        + d.logical, d.init, d.scale),
                    schema)


def _enc_layer_schema(cfg) -> Dict:
    """One encoder layer (``repro/models/lm.py:43-49``): ln1 ->
    bidirectional self-attention -> ln2 -> dense FFN."""
    return {"ln1": norm_schema(cfg, cfg.d_model),
            "attn": A.attn_schema(cfg, cfg.attn),
            "ln2": norm_schema(cfg, cfg.d_model),
            "ffn": ffn_schema(cfg, cfg.d_model, cfg.d_ff)}


def model_schema(cfg, ctx=None) -> Dict:
    """The parameter tree's schema (``repro/models/lm.py:52-69``); an
    encoder-decoder adds the ``encoder`` stack (n_enc_layers, ...) and its
    final norm ``ln_enc``, and its decoder layers their cross-attention."""
    d, V = cfg.d_model, cfg.vocab_size
    s: Dict[str, Any] = {"embed": ParamDecl((V, d), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamDecl((d, V), ("embed", "vocab"))
    s["ln_f"] = norm_schema(cfg, d)
    p = period_of(cfg)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not stack "
                         f"by period {p}")
    n_periods = cfg.n_layers // p
    cross = cfg.n_enc_layers > 0
    s["layers"] = [_stack(B.layer_schema(cfg, pos, ctx, cross=cross),
                          n_periods) for pos in range(p)]
    if cross:
        s["encoder"] = _stack(_enc_layer_schema(cfg), cfg.n_enc_layers)
        s["ln_enc"] = norm_schema(cfg, d)
    return s


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> Tree:
    """Random weights from ``seed``, each leaf drawn in its final dtype on
    the device (``cuda`` unless the caller asks for the CPU). They differ
    from the JAX package's bits for the same seed; ``bridge.from_jax``
    carries JAX weights across instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_from_schema(model_schema(cfg), gen, dtype_of(cfg.param_dtype),
                            dev)


def output_head(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _logits(cfg, params, h, per_row: bool = False):
    """fp32 logits: h.float() @ W.float(), as the JAX package computes them.
    ``per_row``: one product per row of h (rows, d). On the card the fp32
    product's bits depend on its row count (cuBLAS takes another algorithm
    for one row than for two or more: ``chip_smoke.py --only
    build,stack_bits``), so a prefill's rows, one per admitted request,
    take one product each and a request's first token does not depend on
    how many requests were admitted with it."""
    w = output_head(cfg, params).float()
    if not per_row or h.shape[0] == 1:
        return h.float() @ w
    return torch.cat([h[i:i + 1].float() @ w for i in range(h.shape[0])])


def _period(tree: Tree, n: int) -> Tree:
    return tree_map(lambda a: a[n], tree)


def _periods(tree: Tree, count: int) -> List[Tree]:
    """``[_period(tree, n) for n in range(count)]`` by one ``unbind`` a
    leaf: under autograd its backward stacks the periods' gradients once,
    where each period's ``a[n]`` writes a gradient of the whole stacked
    leaf (``select_backward``), which the accumulation then adds:
    O(periods^2) bytes a step."""
    parts = {path: a.unbind(0) for path, a in tree_leaves(tree)}
    return [tree_map_path(lambda path, _, n=n: parts[path][n], tree)
            for n in range(count)]


def cache_shapes(cfg, batch_size: int, seq_len: int,
                 enc_len: int = 0) -> Tuple:
    """The decode cache's global layout, a tuple over period positions of
    {entry: (shape, dtype)}: an attention position holds {"k", "v"}
    (n_periods, batch, seq_len, Hkv, hd) in the param dtype, and an
    encoder-decoder's also {"xk", "xv"} (n_periods, batch, enc_len, Hkv,
    hd), the encoder output's K/V; an SSM position {"conv" (n_periods,
    batch, W-1, d_in + 2 ds) in the param dtype, "state" (n_periods,
    batch, nh, ds, hd) fp32} (``repro/models/lm.py:263-294``)."""
    p = period_of(cfg)
    n_periods = cfg.n_layers // p
    dt = dtype_of(cfg.param_dtype)
    out = []
    for pos in range(p):
        if cfg.layer_kind(pos) == "a":
            a = cfg.attn
            shape = (n_periods, batch_size, seq_len, a.n_kv_heads,
                     a.head_dim)
            e = {"k": (shape, dt), "v": (shape, dt)}
            if cfg.n_enc_layers:
                xshape = (n_periods, batch_size, enc_len, a.n_kv_heads,
                          a.head_dim)
                e.update(xk=(xshape, dt), xv=(xshape, dt))
            out.append(e)
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            nh = d_in // s.head_dim
            out.append({
                "conv": ((n_periods, batch_size, s.conv_width - 1,
                          d_in + 2 * s.d_state), dt),
                "state": ((n_periods, batch_size, nh, s.d_state,
                           s.head_dim), torch.float32)})
    return tuple(out)


def paged_cache_shapes(cfg, n_slots: int, n_pages: int,
                       page_size: int) -> Tuple:
    """The paged decode cache's global layout (``repro/models/lm.py:
    299-330``): an attention position holds {"k", "v"} page pools
    (n_periods, n_pages, page_size, Hkv, hd) shared by every slot, page 0
    the null page; an SSM position keeps ``cache_shapes``' dense per-slot
    {"conv", "state"} (O(1) per request, no per-token history). Decoder-
    only models, as the JAX package's (``repro/models/lm.py:306``)."""
    if cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: paged serving runs decoder-only models; the JAX "
            f"package asserts so (repro/models/lm.py:306)")
    n_periods = cfg.n_layers // period_of(cfg)
    out = []
    for pos, e in enumerate(cache_shapes(cfg, n_slots, 1)):
        if cfg.layer_kind(pos) == "a":
            shape = (n_periods, n_pages, page_size, cfg.attn.n_kv_heads,
                     cfg.attn.head_dim)
            e = {k: (shape, dt) for k, (_, dt) in e.items()}
        out.append(e)
    return tuple(out)


def _zeros(shapes, specs, device, ctx) -> Tuple:
    """Zero tensors of ``shapes``; with a ranked ``ctx``, this rank's
    slice of each, cut as ``specs`` says: the bytes a rank holds."""
    dev = resolve_device(device)
    if ctx is not None and ctx.active:
        shapes = tuple({k: (SH.local_shape(shp, sp[k], ctx.mesh), dt)
                        for k, (shp, dt) in e.items()}
                       for e, sp in zip(shapes, specs))
    return tuple({k: torch.zeros(shp, dtype=dt, device=dev)
                  for k, (shp, dt) in e.items()} for e in shapes)


def init_cache(cfg, batch_size: int, seq_len: int,
               device: DeviceLike = None, ctx=None,
               enc_len: int = 0) -> Tuple:
    """Zero contiguous decode cache of ``cache_shapes``' layout
    (``enc_len``: an encoder-decoder's rows of encoder K/V). With a
    ranked ``ctx``, this rank's slice of it, cut as
    ``parallel.sharding.cache_specs`` says."""
    ranked = ctx is not None and ctx.active
    return _zeros(cache_shapes(cfg, batch_size, seq_len, enc_len),
                  SH.cache_specs(cfg, ctx, batch_size, seq_len, enc_len)
                  if ranked else None, device, ctx)


def init_paged_cache(cfg, n_slots: int, n_pages: int, page_size: int,
                     device: DeviceLike = None, ctx=None) -> Tuple:
    """Zero paged decode cache of ``paged_cache_shapes``' layout. With a
    ranked ``ctx``, this rank's slice of it, cut as
    ``parallel.sharding.paged_cache_specs`` says: a pool cut on its kv
    heads or whole, one pool over the dp axes."""
    ranked = ctx is not None and ctx.active
    return _zeros(paged_cache_shapes(cfg, n_slots, n_pages, page_size),
                  SH.paged_cache_specs(cfg, ctx, n_slots)
                  if ranked else None, device, ctx)


def _embed(cfg, params, tokens):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def embed_inputs(cfg, params, batch, ctx=None):
    """Token embeddings (or the stub frontend's ``embeds``) in the compute
    dtype; an encoder-decoder's decoder adds the sinusoid of each index,
    0 .. S-1 (``repro/models/lm.py:86-94``), whatever the mask (left pads
    included)."""
    if "embeds" in batch:
        return batch["embeds"].to(dtype_of(cfg.compute_dtype))
    h = token_embeds(cfg, params, batch["tokens"], ctx)
    if cfg.n_enc_layers:
        h = h + sinusoid_positions(h.shape[1], cfg.d_model,
                                   h.device).to(h.dtype)
    return h


def token_embeds(cfg, params, tokens, ctx=None):
    """The rows of ``tokens`` in the embedding, in the compute dtype. With
    a ranked context whose vocab is stored cut over the model axis, each
    rank looks up the ids its slice holds (zeros elsewhere) and the rows
    are summed over the model group."""
    if not model_sharded(ctx, cfg.vocab_size):
        return _embed(cfg, params, tokens)
    table = params["embed"]
    Vl = table.shape[0]
    ids = tokens.long() - ctx.model_rank * Vl
    inside = (ids >= 0) & (ids < Vl)
    rows = table[ids.clamp(0, Vl - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=
                                                            rows.dtype))
    return CL.reduce_from(rows, ctx.model_group).to(
        dtype_of(cfg.compute_dtype))


def _enc_layer(cfg, p, x, positions, ctx=None):
    """One encoder layer: ln1 -> non-causal self-attention without RoPE
    (the flash kernel's region) -> residual -> ln2 -> dense FFN ->
    residual (``repro/models/lm.py:112-120``); on a mesh the attention
    and the FFN shard over the model axis as a decoder layer's do, the
    norms and the residual whole on every model rank."""
    h = apply_norm(cfg, p["ln1"], x)
    x = x + B.attn_apply(cfg, p["attn"], h, positions, False, False,
                         ctx=ctx)
    return x + B._ffn_out(cfg, p, x, ctx)


def encode(cfg, params, frames, ctx=None):
    """The encoder (``repro/models/lm.py:108-126``): frames (B, S_enc, d)
    in the compute dtype plus the sinusoid positions, every layer of the
    ``encoder`` stack, the final norm ``ln_enc``. Returns (B, S_enc, d).
    Under ``cfg.remat == "full"`` each layer runs under a non-reentrant
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of
    its scan body). ``ctx``: a ranked context, whose rank holds its rows
    of the frames and the encoder's leaves as ``sharding.param_specs``
    cuts them, their data-axis cuts gathered (``_forward`` gathers them):
    each layer's attention goes through ``blocks._attn_ranked``
    (``attn_case`` of the frame count) and its FFN column- then
    row-parallel; the encoder carries no sequence-parallel residual, as
    in the JAX package."""
    h = frames.to(dtype_of(cfg.compute_dtype))
    h = h + sinusoid_positions(h.shape[1], cfg.d_model, h.device).to(h.dtype)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for n, lp in enumerate(_periods(params["encoder"], cfg.n_enc_layers)):
        if cfg.remat == "full" and torch.is_grad_enabled():
            h = checkpoint(_enc_layer, cfg, lp, h, positions, ctx,
                           use_reentrant=False)
        else:
            h = _enc_layer(cfg, lp, h, positions, ctx)
    return apply_norm(cfg, params["ln_enc"], h)


def _forward_inputs(cfg, params, batch, ctx=None):
    """Embeddings, pad-aware positions, the mask, whether the positions
    are the default arange(S), and the encoder's output (an
    encoder-decoder's, from ``batch["frames"]``; else None): with
    ``mask`` (B, S) a row's position is its rank among its valid tokens
    (left padding starts at 0 at the first real token). The flag is known
    here, where the positions are built, so no layer has to compare them
    on the device (``repro/models/lm.py:133-151``)."""
    h = embed_inputs(cfg, params, batch, ctx)
    Bsz, Ssz, _ = h.shape
    mask = batch.get("mask")
    arange = False
    if "positions" in batch:
        positions = batch["positions"]
    elif mask is not None:
        positions = torch.clamp(torch.cumsum(mask.long(), dim=1) - 1, min=0)
    else:
        positions = torch.arange(Ssz, device=h.device)[None, :].expand(
            Bsz, Ssz)
        arange = True
    enc_out = (encode(cfg, params, batch["frames"], ctx)
               if cfg.n_enc_layers else None)
    return h, positions, mask, arange, enc_out


def sp_split(cfg, ctx, S: int) -> bool:
    """Whether the residual between blocks is carried as each model rank's
    slice of the sequence (``cfg.sp_residual``): on a model axis of more
    than one rank that divides the sequence, as the JAX package constrains
    it (``repro/models/blocks.py:343-346``); otherwise it stays whole on
    every model rank."""
    return bool(cfg.sp_residual and ctx is not None and ctx.active
                and ctx.model_size > 1 and S > 1
                and S % ctx.model_size == 0)


def _period_body(cfg, h, lp, positions, mask, arange, ctx=None, specs=None,
                 sp: bool = False, return_cache: bool = False,
                 enc_out=None):
    """The layers of one period: returns (h, the period's aux loss, its
    cache entries per period position with ``return_cache``, else None).
    ``enc_out``: the encoder's output, which the cross-attention reads.
    On a mesh the period's leaves cut over the data axes are gathered
    first (inside the remat region: the recompute gathers them again).
    ``sp``: h is this rank's slice of the sequence (``sp_split``)."""
    if specs is not None:
        lp = SH.fsdp_gather_tree(lp, specs, ctx, drop=1)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    for pos in range(period_of(cfg)):
        h, a, ce = B.apply_layer(cfg, pos, lp[pos], h, positions, mask=mask,
                                 arange_positions=arange, ctx=ctx, sp=sp,
                                 return_cache=return_cache, enc_out=enc_out)
        aux = aux + a
        caches.append(ce)
    return h, aux, caches if return_cache else None


def _scheduled_layers(cfg, params, h, positions, mask, arange, ctx=None,
                      specs=None, sp: bool = False, enc_out=None):
    """Every layer through the block-schedule IR (``repro/models/lm.py:
    196-240``): each layer lowered to its executed segments
    (``blocks.block_segments``), the whole list ordered by
    ``core/schedule.exec_order`` under ``cfg.block_schedule``
    ("sequential": program order, "overlap": the greedy earliest-start
    scheduler), the race detector run on the order unless
    ``REPRO_VERIFY_SCHEDULE=0``, and the order run against one env.
    Returns (h, aux loss fp32).

    The layers are unrolled and nothing is recomputed (no remat): the
    scheduler needs segments of different blocks in one window. On a mesh
    every period's leaves cut over the data axes are gathered first, in
    period order on every rank, so each segment finds its leaves whole."""
    from repro_torch.core import schedule as SCH
    p = period_of(cfg)
    segs = []
    periods = [_periods(params["layers"][pos], cfg.n_layers // p)
               for pos in range(p)]
    for n in range(cfg.n_layers // p):
        lp = [periods[pos][n] for pos in range(p)]
        if specs is not None:
            lp = SH.fsdp_gather_tree(lp, specs, ctx, drop=1)
        for pos in range(p):
            i = n * p + pos
            segs += B.block_segments(cfg, pos, lp[pos], positions, mask,
                                     block=i, x_in=f"x{i}",
                                     x_out=f"x{i + 1}", ctx=ctx, sp=sp,
                                     arange_positions=arange,
                                     enc_out=enc_out)
    program = segs
    segs = SCH.exec_order(segs, cfg.block_schedule)
    if os.environ.get("REPRO_VERIFY_SCHEDULE", "1") != "0":
        # re-derive RAW/WAR/WAW hazards from the segments' declared
        # reads/writes (not the deps the scheduler used) and refuse any
        # order that violates one, before a segment runs
        from repro_torch.analysis.verify.schedule_check import \
            assert_exec_order_safe
        assert_exec_order_safe(program, segs)
    env = B.run_segments(segs, {"x0": h})
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        a = env.get(f"L{i}.aux")
        if a is not None:
            aux = aux + a
    return env[f"x{cfg.n_layers}"], aux


def _stack_caches(cfg, caches):
    """Per-period lists of per-position cache entries -> a tuple over
    period positions of {entry: (n_periods, B, ...)}, the JAX scan's
    stacking."""
    return tuple({k: torch.stack([c[pos][k] for c in caches])
                  for k in caches[0][pos]}
                 for pos in range(period_of(cfg)))


def _top_level(cfg, params, ctx, specs, encoder: bool = True):
    """The embedding, head and final norm (and an encoder-decoder's
    encoder stack, unless ``encoder`` is false: a serving step's), the
    data-axis cuts gathered."""
    skip = ("layers",) if encoder else ("layers", "encoder", "ln_enc")
    top = {k: v for k, v in params.items() if k not in skip}
    if specs is None:
        return top
    return SH.fsdp_gather_tree(top, {k: specs[k] for k in top}, ctx)


def _forward(cfg, params, batch, ctx=None, fsdp: bool = True,
             return_cache: bool = False):
    """Returns (h_final (B, S, d), aux loss fp32, the top-level leaves as
    used, the caches with ``return_cache`` or None). With
    ``cfg.remat == "full"`` every period runs under a non-reentrant
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of its
    scan body): its activations are recomputed in the backward. With
    ``cfg.block_schedule`` set and no cache asked for, the layers run
    through the block-schedule IR instead (``_scheduled_layers``: unrolled,
    no remat), as the JAX package's ``forward_scheduled``.

    ``return_cache`` (the monolithic prefill): each layer's cache entry,
    stacked per period position as ``(n_periods, B, S, ...)``
    (attention {"k", "v"} after RoPE, and an encoder-decoder's {"xk",
    "xv"} (n_periods, B, S_enc, Hkv, hd); the SSM's {"conv", "state"}); no
    remat. An encoder-decoder runs ``encode`` on ``batch["frames"]``
    first (its layers under remat as well) and every decoder layer reads
    its output.

    ``ctx``: None (or inactive) at one rank. A ranked context is the JAX
    package's mesh step, one rank of it: ``params`` is this rank's shard
    as ``parallel.sharding.param_specs(..., fsdp)`` cuts the mesh tree,
    ``batch`` this rank's rows, the same on every model rank. The leaves
    cut over the data axes are gathered per period (their gradients
    reduce-scattered); everything else follows ``models/blocks.py``. The
    recompute under remat issues the same collectives in the same order
    on every rank. Under the sequence-parallel residual (``sp_split``)
    the embeddings are cut to this rank's slice of the sequence, every
    period carries (and under remat saves) the slice, and the final norm's
    output is gathered whole. An encoder-decoder's frames are this rank's
    rows, as its tokens are, and its encoder runs on every model rank
    (``encode``). With ``return_cache`` each rank keeps its slice of the
    caches, as ``sharding.prefill_cache_specs`` cuts them (whole over
    the sequence, also under ``sp_split``)."""
    ranked = ctx is not None and ctx.active
    specs = None
    if ranked:
        specs = SH.param_specs(model_schema(cfg, ctx), ctx.mesh, fsdp)
    params = {**_top_level(cfg, params, ctx, specs),
              "layers": params["layers"]}
    h, positions, mask, arange, enc_out = _forward_inputs(cfg, params,
                                                          batch, ctx)
    sp = sp_split(cfg, ctx, h.shape[1])
    if sp:
        h = CL.scatter_to(h, ctx.model_group, 1)
    lspecs = None if specs is None else specs["layers"]
    caches = None
    if cfg.block_schedule and not return_cache:
        h, aux = _scheduled_layers(cfg, params, h, positions, mask, arange,
                                   ctx, lspecs, sp, enc_out)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        caches = []
        p = period_of(cfg)
        periods = [_periods(params["layers"][pos], cfg.n_layers // p)
                   for pos in range(p)]
        for n in range(cfg.n_layers // p):
            lp = [periods[pos][n] for pos in range(p)]
            if (cfg.remat == "full" and torch.is_grad_enabled()
                    and not return_cache):
                h, a, _ = checkpoint(_period_body, cfg, h, lp, positions,
                                     mask, arange, ctx, lspecs, sp, False,
                                     enc_out, use_reentrant=False)
            else:
                h, a, ce = _period_body(cfg, h, lp, positions, mask, arange,
                                        ctx, lspecs, sp, return_cache,
                                        enc_out)
                caches.append(ce)
            aux = aux + a
        caches = _stack_caches(cfg, caches) if return_cache else None
    h = B.sp_norm(cfg, params["ln_f"], h, ctx, sp)
    if sp:
        h = CL.gather_from(h, ctx.model_group, 1)
    return h, aux, params, caches


def forward(cfg, params, batch, ctx=None, fsdp: bool = True,
            return_cache: bool = False):
    """Returns (h_final (B, S, d), aux loss fp32, caches or None):
    ``_forward``. batch may carry a "mask" (B, S) bool, the pad-token
    validity of a left-padded batch of mixed lengths: pad keys are
    excluded from attention, pad steps of the SSM are identities, and each
    row's positions count its valid tokens from 0, so the padded forward
    is exact."""
    h, aux, _, caches = _forward(cfg, params, batch, ctx, fsdp,
                                 return_cache)
    return h, aux, caches


def forward_scheduled(cfg, params, batch, ctx=None, fsdp: bool = True):
    """The block-schedule-IR forward (``repro/models/lm.py:196-240``):
    ``forward`` with ``cfg.block_schedule`` ("sequential" | "overlap")
    required. Returns (h_final, aux loss fp32, None)."""
    if not cfg.block_schedule:
        raise ValueError("forward_scheduled: cfg.block_schedule is not set "
                         "(\"sequential\" or \"overlap\")")
    return forward(cfg, params, batch, ctx, fsdp)


def loss_fn(cfg, params, batch, ctx=None, fsdp: bool = True):
    """Mean next-token cross-entropy (labels -1 ignored) plus the MoE aux
    loss. Returns (loss, {"xent", "aux", "tokens"}). With a ranked
    context (``forward``) every rank returns the global loss: the mean
    over every rank's tokens, as the JAX package's mesh step computes it
    from the global batch."""
    h, aux, top, _ = _forward(cfg, params, batch, ctx, fsdp)
    with tracing.span("model.head"):
        loss, cnt = chunked_xent(h, output_head(cfg, top), batch["labels"],
                                 ctx=ctx, vocab=cfg.vocab_size)
    return loss + aux, {"xent": loss, "aux": aux, "tokens": cnt}


@torch.no_grad()
def prefill(cfg, params, batch, ctx=None, fsdp: bool = True):
    """The monolithic prefill (``repro/models/lm.py:248-257``): returns
    (last-token logits (B, V) fp32, the cache: a tuple over period
    positions of {entry: (n_periods, B, S, ...)}, ``forward(...,
    return_cache=True)``). A batch of mixed lengths is left-padded (every
    prompt ends at index S-1, where the logits are read) and passes
    "mask" (B, S): the padded forward is then exact. The logits are one
    fp32 product per row (``_logits(per_row=True)``), so a request's bits
    do not depend on the batch it came in. ``serving.stitch_prefill_cache``
    writes the cache into a decode cache.

    ``ctx``: a ranked context (``seq_shard`` on, as the JAX builder makes
    it), or None at one rank. ``params`` is then this rank's shard of the
    mesh tree and ``batch`` its rows: cut over the dp axes where
    ``ctx.dp_axes`` is set (``train_step.build_prefill_step`` cuts them
    as the decode cache's slots of the same count are cut and clears
    ``dp_axes`` otherwise), the same on every model rank. The logits are
    the whole (B, V) on every rank: gathered over the model axis where
    the vocab is stored cut, and over dp where the rows are. The cache is
    this rank's slice, as ``sharding.prefill_cache_specs`` cuts it."""
    ranked = ctx is not None and ctx.active
    h, _, top, caches = _forward(cfg, params, batch, ctx, fsdp,
                                 return_cache=True)
    logits = _serve_logits(cfg, top, h[:, -1], ctx if ranked else None,
                           per_row=True)
    if ranked and ctx.dp_size > 1:
        logits = CL.all_gather(logits, ctx.mesh.group(ctx.dp_axes)).reshape(
            -1, logits.shape[-1])
    return logits, caches


# ---------------------------------------------------------------------------
# Serving: decode steps and prefill chunks, at one rank or on a mesh
# ---------------------------------------------------------------------------


class ServeLayout(NamedTuple):
    """How a ranked serving call's state is cut, worked out once per step
    builder (``serve_layout``): the parameter specs whose data-axis cuts
    each call gathers (None where no data axis holds more than one rank:
    nothing is then stored cut over one), each period position's K/V cut
    (``sharding.kv_cut``), whether the cache's slots are cut over the dp
    axes (``sharding.slots_cut``), how many slots this rank holds, and
    each period position's "xk"/"xv" cut (an encoder-decoder's: the kv
    cut of its ``enc_len`` rows, which may differ from ``cuts``')."""
    gather_specs: Optional[Tree]
    cuts: Tuple[str, ...]
    slots_cut: bool
    local_slots: int
    xcuts: Tuple[str, ...] = ()


def serve_layout(cfg, ctx, batch: int, seq_len: int,
                 param_specs: Tree, paged: bool = False,
                 enc_len: int = 0) -> ServeLayout:
    """The ``ServeLayout`` of a decode cache of ``batch`` slots and
    ``seq_len`` positions (and an encoder-decoder's ``enc_len`` rows of
    encoder K/V) on ``ctx``'s mesh, the parameters stored as
    ``param_specs`` (``sharding.param_specs``) cut them; ``paged``: its
    K/V are page pools, never cut over positions."""
    def cuts(n, paged_):
        return tuple(SH.kv_cut(ctx, cfg.attn.n_kv_heads, n, paged_)
                     if cfg.layer_kind(pos) == "a" else "replicated"
                     for pos in range(period_of(cfg)))

    cut_data = any(n > 1 for a, n in ctx.mesh.shape.items()
                   if a != ctx.model_axis)
    cut = SH.slots_cut(ctx, batch)
    return ServeLayout(param_specs if cut_data else None,
                       cuts(seq_len, paged), cut,
                       batch // ctx.dp_size if cut else batch,
                       cuts(enc_len, False) if cfg.n_enc_layers else ())


def _ranked_layout(ctx, layout: Optional[ServeLayout]) -> bool:
    """Whether a serving call is ranked; a ranked one needs its layout."""
    ranked = ctx is not None and ctx.active
    if ranked and layout is None:
        raise ValueError("a ranked serving call needs its cache's layout "
                         "(lm.serve_layout)")
    return ranked


def _serve_layers(cfg, params, specs, ctx, h, layer):
    """Runs ``layer(pos, layer params, n, h) -> h`` over every layer; on a
    mesh each period's leaves cut over the data axes gathered first."""
    p = period_of(cfg)
    for n in range(cfg.n_layers // p):
        lp = [_period(params["layers"][pos], n) for pos in range(p)]
        if specs is not None:
            lp = SH.fsdp_gather_tree(lp, specs["layers"], ctx, drop=1)
        for pos in range(p):
            h = layer(pos, lp[pos], n, h)
    return h


def _serve_logits(cfg, top, h, ctx, per_row: bool = False):
    """fp32 logits of h (rows, d) over the whole vocab (``per_row``: as
    ``_logits``): on a mesh whose vocab is stored cut, each model rank's
    slice gathered."""
    with tracing.span("model.head"):
        logits = _logits(cfg, top, h, per_row)
        if model_sharded(ctx, cfg.vocab_size):
            logits = CL.gather_from(logits, ctx.model_group, -1)
    return logits


def _page_size(cfg, cache) -> int:
    """The page size of a paged cache's pools (0 where no layer has
    attention: an SSM model's cache has no pool)."""
    for pos in range(period_of(cfg)):
        if cfg.layer_kind(pos) == "a":
            return cache[pos]["k"].shape[2]
    return 0


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, t_pos, ctx=None,
                layout: Optional[ServeLayout] = None, block_tables=None,
                rope_pos=None, kv_start=None):
    """tokens: (B, 1) int; t_pos: (B,) int per-row cache write indices
    (every slot decodes at its own position). Returns (logits (B, V) fp32,
    cache), the cache updated in place: K/V at each row's index, and every
    row's SSM carry (free slots decode too, as in the JAX engine).
    ``rope_pos``: optional (B,) RoPE positions where they differ from the
    cache index, and ``kv_start``: optional (B,) first valid cache index
    per row: a left-padded monolithic prefill's rows (``prefill``) decode
    at their real positions with their pads excluded (``repro/models/
    lm.py:334-350``). An encoder-decoder (at one rank) adds the sinusoid
    of each row's write index ``t_pos`` (not ``rope_pos``: the JAX
    package's ``sinusoid_at(t_vec)``, ``repro/models/lm.py:353-356``) and
    runs every decoder layer's cross-attention over the cache's {"xk",
    "xv"} (``blocks.decode_layer(has_cross=True)``; on a mesh cut as
    ``layout.xcuts`` says).

    ``ctx``: a ranked context (``seq_shard`` off), or None at one rank.
    ``params`` is then this rank's shard of the mesh tree
    (``sharding.to_mesh``), ``cache`` its slice of the cache
    (``sharding.cache_specs``), both cut as ``layout`` says, and tokens,
    t_pos and the logits returned are this rank's slots: cut over the dp
    axes where the cache's slots are, every slot otherwise. The leaves
    cut over the data axes are gathered per period, the embedding and
    head are vocab-parallel where the vocab is cut, and every layer
    follows its cache entry's cut (``blocks.decode_layer``).

    ``block_tables``: (B, max_blocks), every slot's table: the cache is
    then paged (``init_paged_cache``); each row writes its K/V at its
    position through its table (a free slot's all-zero row into the null
    page) and reads its logical view through it (``repro/models/lm.py:
    335-382``). On a mesh every rank is handed the whole table, as every
    rank holds a whole pool (cut on kv heads at most); where the slots
    are cut over dp, each dp rank writes every slot's K/V (its own rows'
    summed with the other dp ranks' over the dp group, ``PagedKV``)."""
    ranked = _ranked_layout(ctx, layout)
    cuts = ["replicated"] * period_of(cfg)
    specs, xcuts, top = None, cuts, params
    if ranked:
        specs, cuts = layout.gather_specs, layout.cuts
        xcuts = layout.xcuts or cuts
        top = _top_level(cfg, params, ctx, specs, encoder=False)
        if not layout.slots_cut:       # every dp rank holds every slot
            ctx = dataclasses.replace(ctx, dp_axes=())
    Bsz = tokens.shape[0]

    def vec(v):
        return None if v is None else torch.as_tensor(
            v, device=tokens.device).long().reshape(-1).expand(Bsz)

    t_vec, rope_vec, start_vec = vec(t_pos), vec(rope_pos), vec(kv_start)
    h = token_embeds(cfg, top, tokens, ctx if ranked else None)
    if cfg.n_enc_layers:
        h = h + sinusoid_at(t_vec, cfg.d_model)[:, None, :].to(h.dtype)
    paged = None
    page = _page_size(cfg, cache) if block_tables is not None else 0
    if page:
        table = block_tables.long()
        if ranked and layout.slots_cut:    # this dp rank's rows of the table
            base = SH._dp_index(ctx, ctx.dp_axes) * Bsz
            mine = torch.arange(base, base + Bsz, device=tokens.device)
            rows = table.new_zeros(table.shape[0])
            rows[mine] = A.decode_rows(t_vec, table[mine], page)
            paged = B.PagedKV(table[mine], CL.all_reduce_(
                rows, ctx.data_group), mine, table.shape[0], ctx.data_group)
        else:
            paged = B.PagedKV(table, A.decode_rows(t_vec, table, page))

    def layer(pos, lp, n, h):
        return B.decode_layer(cfg, pos, lp, h, _period(cache[pos], n), t_vec,
                              ctx if ranked else None, cuts[pos], paged,
                              rope_vec, start_vec, cfg.n_enc_layers > 0,
                              xcuts[pos])

    h = _serve_layers(cfg, params, specs, ctx, h, layer)
    h = apply_norm(cfg, top["ln_f"], h)
    return _serve_logits(cfg, top, h[:, 0], ctx if ranked else None), cache


def _owned_rows(ctx, slots, n_local: int):
    """(the stack's rows this rank runs, their indices into its slots, how
    many of them write the cache) where the slots are cut over dp: the
    rows whose slot this rank's dp index holds, or one stand-in row (row
    0 on slot 0, writing nothing) when it holds none, so that every rank
    runs every layer's collectives."""
    base = SH._dp_index(ctx, ctx.dp_axes) * n_local
    mine = [i for i, s in enumerate(slots.tolist())
            if base <= s < base + n_local]
    if not mine:
        return (torch.zeros(1, dtype=torch.long, device=slots.device),
                torch.zeros(1, dtype=torch.long, device=slots.device), 0)
    rows = torch.tensor(mine, device=slots.device)
    return rows, slots[rows] - base, len(mine)


@torch.no_grad()
def prefill_chunk(cfg, params, cache, tokens, pos_off, valid_len,
                  slot: Optional[torch.Tensor] = None, ctx=None,
                  layout: Optional[ServeLayout] = None, block_tables=None):
    """Prompt chunks against per-slot cache regions: one admission row or a
    stack of them. tokens: (A, C) int, tail-padded past valid_len; pos_off:
    (A,) cache index of each row's first token; valid_len: (A,) valid
    tokens per row (0 = an identity row); slot: (A,) cache row of each
    admission row (default: row a is slot a). Returns (logits (A, V) fp32
    at each row's last valid position, cache), the cache updated in place.

    Where the JAX package gathers the admission rows' SSM carry, resets it
    where pos_off == 0 and scatters it back after the chunk
    (``repro/models/lm.py:416-433, 460-473``), the port does the same per
    layer (``blocks.chunk_layer``) and writes back with an in-place
    ``index_copy_``. Tokens past a row's valid_len are identity steps of
    the SSM scan (mask false).

    ``ctx``, ``layout``: as ``decode_step``, but every rank is handed the
    whole stack (the JAX builder replicates it). Where the cache's slots
    are cut over dp, each dp rank runs the rows whose slots it holds and
    only it writes them (a rank holding none runs one stand-in row and
    writes nothing); the MoE then routes each dp rank's rows within its
    model group. Each row's logits come from the rank that ran it, summed
    over the dp group into the whole (A, V) on every rank. Every row is
    run once, exactly as at one rank.

    ``block_tables``: (A, max_blocks), each admission row's table: the
    cache is then paged (``init_paged_cache``); the chunk's K/V go into
    the pools through the tables (tail pads and identity rows into the
    null page) and ``slot`` indexes the SSM entries only (``repro/models/
    lm.py:385-473``). Where the slots are cut over dp, each dp rank writes
    every row's K/V, as ``decode_step`` does."""
    if cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the chunked prefill runs decoder-only models; the "
            f"JAX package asserts so (repro/models/lm.py:407)")
    Ac, C = tokens.shape
    dev = tokens.device

    def vec(v):
        return torch.as_tensor(v, device=dev).long().reshape(-1).expand(Ac)

    pos_off, valid_len = vec(pos_off), vec(valid_len)
    slots = torch.arange(Ac, device=dev) if slot is None else vec(slot)
    ranked = _ranked_layout(ctx, layout)
    specs, cuts, top = None, ["replicated"] * period_of(cfg), params
    n_write, slots_cut = -1, False
    page = _page_size(cfg, cache) if block_tables is not None else 0
    paged = None
    if page:                        # every row's tokens, on every rank
        table = block_tables.long()
        valid = torch.arange(C, device=dev)[None, :] < valid_len[:, None]
        paged = B.PagedKV(table, A.chunk_rows(pos_off, table, valid, page))
    if ranked:
        specs, cuts, slots_cut = layout[:3]
        top = _top_level(cfg, params, ctx, specs, encoder=False)
        if slots_cut:
            rows, slots, n_write = _owned_rows(ctx, slots,
                                               layout.local_slots)
            tokens, pos_off, valid_len = (t[rows] for t in (
                tokens, pos_off, valid_len))
            if paged is not None:
                paged = paged._replace(table=paged.table[rows],
                                       mine=rows[:n_write], n_all=Ac,
                                       group=ctx.data_group)
        # each dp rank's rows are its own: the MoE's tokens are not cut
        # over the dp axes
        ctx = dataclasses.replace(ctx, dp_axes=())
    A_run = tokens.shape[0]
    q_pos = pos_off[:, None] + torch.arange(C, device=dev)[None, :]
    mask = torch.arange(C, device=dev)[None, :] < valid_len[:, None]
    h = token_embeds(cfg, top, tokens, ctx if ranked else None)

    def layer(pos, lp, n, h):
        return B.chunk_layer(cfg, pos, lp, h, _period(cache[pos], n), slots,
                             pos_off, q_pos, mask, valid_len,
                             ctx if ranked else None, cuts[pos], n_write,
                             paged)

    h = _serve_layers(cfg, params, specs, ctx, h, layer)
    h = apply_norm(cfg, top["ln_f"], h)
    h_last = h[torch.arange(A_run, device=dev),
               torch.clamp(valid_len - 1, min=0)]
    logits = _serve_logits(cfg, top, h_last, ctx if ranked else None,
                           per_row=True)
    if slots_cut:
        whole = logits.new_zeros((Ac, logits.shape[1]))
        whole[rows[:n_write]] = logits[:n_write]
        logits = CL.all_reduce_(whole, ctx.data_group)
    return logits, cache
