"""Full model: schema, init, the training forward and loss, prefill chunks
and decode.

Layers are stacked by *period* as in the JAX package: ``params["layers"]``
is a list over period positions of trees whose leaves carry a leading
(n_periods,) axis, and the KV cache has the same stacking. Where JAX scans
over periods, the port loops in Python and takes views of period ``n``.
The cache is updated in place.

The training forward and loss also run on a mesh: with a ranked
``AxisCtx`` each rank holds its rows of the batch and its shard of the
parameters (``parallel.sharding.to_mesh``); see ``forward``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import ssm as SSM
from repro_torch.models.common import (ParamDecl, apply_norm,
                                       chunked_xent, init_from_schema,
                                       model_sharded, norm_schema, tree_map)
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


def model_schema(cfg, ctx=None) -> Dict:
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
    s["layers"] = [_stack(B.layer_schema(cfg, pos, ctx), n_periods)
                   for pos in range(p)]
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


def _logits(cfg, params, h):
    """fp32 logits: h.float() @ W.float(), as the JAX package computes them."""
    return h.float() @ output_head(cfg, params).float()


def _period(tree: Tree, n: int) -> Tree:
    return tree_map(lambda a: a[n], tree)


def init_cache(cfg, batch_size: int, seq_len: int,
               device: DeviceLike = None) -> Tuple:
    """Zero contiguous decode cache, a tuple over period positions: an
    attention position holds {"k", "v"} (n_periods, batch, seq_len, Hkv,
    hd) in the param dtype, an SSM position {"conv" (n_periods, batch,
    W-1, d_in + 2 ds) in the param dtype, "state" (n_periods, batch, nh,
    ds, hd) fp32} (``repro/models/lm.py:285-294``)."""
    if cfg.n_enc_layers:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet (init_cache)")
    dev = resolve_device(device)
    p = period_of(cfg)
    n_periods = cfg.n_layers // p
    dt = dtype_of(cfg.param_dtype)
    caches = []
    for pos in range(p):
        if cfg.layer_kind(pos) == "a":
            a = cfg.attn
            shape = (n_periods, batch_size, seq_len, a.n_kv_heads,
                     a.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)})
        else:
            c = SSM.init_ssm_cache(cfg, cfg.ssm, n_periods * batch_size, dt,
                                   dev)
            caches.append({k: v.reshape((n_periods, batch_size)
                                        + v.shape[1:]) for k, v in c.items()})
    return tuple(caches)


def _embed(cfg, params, tokens):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def embed_inputs(cfg, params, batch, ctx=None):
    """Token embeddings (or the stub frontend's ``embeds``) in the compute
    dtype. With a ranked context whose vocab is stored cut over the model
    axis, each rank looks up the ids its slice holds (zeros elsewhere) and
    the rows are summed over the model group."""
    if cfg.n_enc_layers:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet")
    if "embeds" in batch:
        return batch["embeds"].to(dtype_of(cfg.compute_dtype))
    if not model_sharded(ctx, cfg.vocab_size):
        return _embed(cfg, params, batch["tokens"])
    table = params["embed"]
    Vl = table.shape[0]
    ids = batch["tokens"].long() - ctx.model_rank * Vl
    inside = (ids >= 0) & (ids < Vl)
    rows = table[ids.clamp(0, Vl - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=
                                                            rows.dtype))
    return CL.reduce_from(rows, ctx.model_group).to(
        dtype_of(cfg.compute_dtype))


def _forward_inputs(cfg, params, batch, ctx=None):
    """Embeddings, pad-aware positions, the mask, and whether the
    positions are the default arange(S): with ``mask`` (B, S) a row's
    position is its rank among its valid tokens (left padding starts at 0
    at the first real token). The flag is known here, where the positions
    are built, so no layer has to compare them on the device."""
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
    return h, positions, mask, arange


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
                 sp: bool = False):
    """The layers of one period: returns (h, the period's aux loss). On a
    mesh the period's leaves cut over the data axes are gathered first
    (inside the remat region: the recompute gathers them again). ``sp``:
    h is this rank's slice of the sequence (``sp_split``)."""
    if specs is not None:
        lp = SH.fsdp_gather_tree(lp, specs, ctx, drop=1)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for pos in range(period_of(cfg)):
        h, a = B.apply_layer(cfg, pos, lp[pos], h, positions, mask=mask,
                             arange_positions=arange, ctx=ctx, sp=sp)
        aux = aux + a
    return h, aux


def _top_level(cfg, params, ctx, specs):
    """The embedding, head and final norm, the data-axis cuts gathered."""
    top = {k: v for k, v in params.items() if k != "layers"}
    if specs is None:
        return top
    return SH.fsdp_gather_tree(top, {k: specs[k] for k in top}, ctx)


def _forward(cfg, params, batch, ctx=None, fsdp: bool = True):
    """Returns (h_final (B, S, d), aux loss fp32, the top-level leaves as
    used). With
    ``cfg.remat == "full"`` every period runs under a non-reentrant
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of its
    scan body): its activations are recomputed in the backward.

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
    output is gathered whole."""
    if cfg.block_schedule:
        raise NotImplementedError("block_schedule: the whole-graph schedule "
                                  "is not ported yet")
    specs = None
    if ctx is not None and ctx.active:
        specs = SH.param_specs(model_schema(cfg, ctx), ctx.mesh, fsdp)
    params = {**_top_level(cfg, params, ctx, specs),
              "layers": params["layers"]}
    h, positions, mask, arange = _forward_inputs(cfg, params, batch, ctx)
    sp = sp_split(cfg, ctx, h.shape[1])
    if sp:
        h = CL.scatter_to(h, ctx.model_group, 1)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    p = period_of(cfg)
    for n in range(cfg.n_layers // p):
        lp = [_period(params["layers"][pos], n) for pos in range(p)]
        lspecs = None if specs is None else specs["layers"]
        if cfg.remat == "full" and torch.is_grad_enabled():
            h, a = checkpoint(_period_body, cfg, h, lp, positions, mask,
                              arange, ctx, lspecs, sp, use_reentrant=False)
        else:
            h, a = _period_body(cfg, h, lp, positions, mask, arange, ctx,
                                lspecs, sp)
        aux = aux + a
    h = B.sp_norm(cfg, params["ln_f"], h, ctx, sp)
    if sp:
        h = CL.gather_from(h, ctx.model_group, 1)
    return h, aux, params


def forward(cfg, params, batch, ctx=None, fsdp: bool = True):
    """Returns (h_final (B, S, d), aux loss fp32, None): ``_forward``."""
    return _forward(cfg, params, batch, ctx, fsdp)[:2] + (None,)


def loss_fn(cfg, params, batch, ctx=None, fsdp: bool = True):
    """Mean next-token cross-entropy (labels -1 ignored) plus the MoE aux
    loss. Returns (loss, {"xent", "aux", "tokens"}). With a ranked
    context (``forward``) every rank returns the global loss: the mean
    over every rank's tokens, as the JAX package's mesh step computes it
    from the global batch."""
    h, aux, top = _forward(cfg, params, batch, ctx, fsdp)
    loss, cnt = chunked_xent(h, output_head(cfg, top), batch["labels"],
                             ctx=ctx, vocab=cfg.vocab_size)
    return loss + aux, {"xent": loss, "aux": aux, "tokens": cnt}


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, t_pos):
    """tokens: (B, 1) int; t_pos: (B,) int per-row cache write indices
    (every slot decodes at its own position). Returns (logits (B, V) fp32,
    cache), the cache updated in place: K/V at each row's index, and every
    row's SSM carry (free slots decode too, as in the JAX engine)."""
    Bsz = tokens.shape[0]
    t_vec = torch.as_tensor(t_pos, device=tokens.device).long().reshape(
        -1).expand(Bsz)
    h = _embed(cfg, params, tokens)
    p = period_of(cfg)
    for n in range(cfg.n_layers // p):
        for pos in range(p):
            h = B.decode_layer(cfg, pos, _period(params["layers"][pos], n),
                               h, _period(cache[pos], n), t_vec)
    h = apply_norm(cfg, params["ln_f"], h)
    return _logits(cfg, params, h[:, 0]), cache


@torch.no_grad()
def prefill_chunk(cfg, params, cache, tokens, pos_off, valid_len,
                  slot: Optional[torch.Tensor] = None):
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
    the SSM scan (mask false)."""
    Ac, C = tokens.shape
    dev = tokens.device

    def vec(v):
        return torch.as_tensor(v, device=dev).long().reshape(-1).expand(Ac)

    pos_off, valid_len = vec(pos_off), vec(valid_len)
    slots = torch.arange(Ac, device=dev) if slot is None else vec(slot)
    q_pos = pos_off[:, None] + torch.arange(C, device=dev)[None, :]
    mask = torch.arange(C, device=dev)[None, :] < valid_len[:, None]
    h = _embed(cfg, params, tokens)
    p = period_of(cfg)
    for n in range(cfg.n_layers // p):
        for pos in range(p):
            h = B.chunk_layer(cfg, pos, _period(params["layers"][pos], n), h,
                              _period(cache[pos], n), slots, pos_off, q_pos,
                              mask, valid_len)
    h = apply_norm(cfg, params["ln_f"], h)
    h_last = h[torch.arange(Ac, device=dev), torch.clamp(valid_len - 1, min=0)]
    return _logits(cfg, params, h_last), cache
