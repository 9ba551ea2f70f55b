"""Shared model building blocks: schema-driven params, norms, RoPE, FFN.

Parameters are declared through a *schema* (nested dicts and lists of
``ParamDecl``), the same one ``repro.models.common`` declares, so the port's
parameter tree has the JAX package's nesting, shapes and dtypes leaf for leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.parallel import collectives as CL
# the plain model norm and the activations live beside the kernels whose
# plain versions they are; the model layer names them here, as the JAX
# package's models/common does
from repro_torch.kernels.ref import (activate, activate_vjp,  # noqa: F401
                                     is_glu, rms_norm)

Tree = Any


# ---------------------------------------------------------------------------
# Param schema
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]      # logical axis names, len == ndim
    init: str = "normal"                    # normal | zeros | ones
    scale: float = 1.0

    def leaf_dtype(self, dtype: torch.dtype) -> torch.dtype:
        # norm scales/biases kept fp32 for stability
        return torch.float32 if self.init in ("ones", "zeros") else dtype

    def initialize(self, gen: torch.Generator, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
        """Drawn directly in its final dtype on ``device``: a full-size
        bf16 model never gets an fp32 copy."""
        dt = self.leaf_dtype(dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale / math.sqrt(max(1, fan_in))
        out = torch.empty(self.shape, dtype=dt, device=device)
        return out.normal_(0.0, std, generator=gen)


def tree_leaves(tree: Tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of a nested dict/list tree, dict keys sorted (the
    order ``jax.tree_util`` flattens in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map_path(fn, tree: Tree, path: Tuple = ()) -> Tree:
    """tree_map with fn(path, leaf), paths as ``tree_leaves`` gives them."""
    if isinstance(tree, dict):
        return {k: tree_map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def init_from_schema(schema: Tree, gen: torch.Generator, dtype: torch.dtype,
                     device: torch.device) -> Tree:
    return tree_map(lambda d: d.initialize(gen, dtype, device), schema)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def layer_norm(x, scale, bias, eps):
    h = x.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, keepdim=True, unbiased=False)
    out = (h - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def apply_norm(cfg, p, x):
    """A norm region of the model: RMSNorm through ``ops.rms_norm`` (the
    hand-written kernel on a CUDA tensor, the plain ``rms_norm`` on the
    CPU); LayerNorm stays plain, as no TPU kernel computes it."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return ops.rms_norm(x, p["scale"], cfg.norm_eps)


def norm_schema(cfg, d) -> Dict[str, ParamDecl]:
    s = {"scale": ParamDecl((d,), ("embed_v",), "ones")}
    if cfg.norm == "layernorm":
        s["bias"] = ParamDecl((d,), ("embed_v",), "zeros")
    return s


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def ffn_schema(cfg, d, hidden) -> Dict[str, ParamDecl]:
    s: Dict[str, ParamDecl] = {}
    if is_glu(cfg.activation):
        s["w_gate"] = ParamDecl((d, hidden), ("embed", "ffn"))
    s["w_up"] = ParamDecl((d, hidden), ("embed", "ffn"))
    s["w_down"] = ParamDecl((hidden, d), ("ffn", "embed"), scale=1.0)
    return s


def model_sharded(ctx, full: int) -> bool:
    """Whether a dimension of ``full`` entries mapped to the model axis is
    stored cut over it (``parallel.sharding.decl_spec``: when it divides);
    never on a model axis of one rank."""
    return (ctx is not None and ctx.active and ctx.model_size > 1
            and full % ctx.model_size == 0)


def ffn_apply(cfg, p, x, ctx=None, hidden: int = 0):
    """The dense FFN. With a ranked context and its ``hidden`` (ffn) width
    stored cut over the model axis: column-parallel gate/up, row-parallel
    down, the partial outputs all-reduced (Megatron); otherwise every rank
    computes it whole. x is the same on every model rank."""
    tp = model_sharded(ctx, hidden)
    if tp:
        x = CL.copy_to(x, ctx.model_group)
    gate = x @ p["w_gate"] if "w_gate" in p else None
    up = x @ p["w_up"]
    h = activate(cfg.activation, gate, up)
    y = h @ p["w_down"]
    return CL.reduce_from(y, ctx.model_group) if tp else y


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Sinusoid positions (the encoder-decoder's absolute positions)
# ---------------------------------------------------------------------------


def sinusoid_at(pos, d: int):
    """fp32 sinusoid embeddings of the positions ``pos`` (a tensor of any
    shape): (..., d), sin on the even columns and cos on the odd ones
    (``repro/models/common.py:176-182``, vectorized over ``pos``)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[..., None] / torch.pow(10000.0, dim / d)
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(
        pos.shape + (d,))


def sinusoid_positions(S: int, d: int, device=None):
    """(S, d) fp32 sinusoid embeddings of positions 0 .. S-1
    (``repro/models/common.py:168-173``); cast to the activations' dtype
    where they are added."""
    return sinusoid_at(torch.arange(S, device=device), d)


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy: never keeps (tokens, vocab) logits alive
# ---------------------------------------------------------------------------


def _xent_chunk(hc, w_out, lc, logit_dtype):
    logits = hc.to(logit_dtype) @ w_out.to(logit_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).to(logit_dtype)
    return ((lse - tgt) * mask).sum(), mask.sum()


def _xent_chunk_vocab(hc, w_out, lc, logit_dtype, group):
    """One chunk against this rank's vocab slice ``w_out`` (d, V / m): the
    logsumexp's max and sum of exponentials reduced over the model group,
    the target logit from the rank whose slice holds it."""
    hc = CL.copy_to(hc, group)
    logits = hc.to(logit_dtype) @ w_out.to(logit_dtype)
    Vl = logits.shape[-1]
    # the max only steadies the exponentials: its gradient cancels
    gmax = CL.all_reduce_(logits.detach().amax(dim=-1), group, op="max")
    sumexp = CL.reduce_from(torch.exp(logits - gmax[..., None]).sum(dim=-1),
                            group)
    lse = gmax + torch.log(sumexp)
    ids = lc.long() - group.index * Vl
    inside = (ids >= 0) & (ids < Vl)
    tgt = torch.gather(logits, -1, ids.clamp(0, Vl - 1)[..., None])[..., 0]
    tgt = CL.reduce_from(torch.where(inside, tgt, torch.zeros_like(tgt)),
                         group)
    mask = (lc >= 0).to(logit_dtype)
    return ((lse - tgt) * mask).sum(), mask.sum()


def chunked_xent(h, w_out, labels, chunk: int = 1024,
                 logit_dtype=torch.float32, ctx=None, vocab: int = 0):
    """h: (B, S, d); w_out: (d, V); labels: (B, S), -1 = ignore. Returns
    (mean loss over the kept labels, their count), as
    ``repro.models.common.chunked_xent``. Each sequence chunk's
    (B, chunk, V) logits are recomputed in the backward
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``), so
    only one chunk's logits are alive at a time.

    With a ranked context, h holds this rank's rows of the batch (the same
    on every model rank), and ``w_out`` this rank's vocab slice when the
    ``vocab`` size is stored cut over the model axis. The sums and counts
    are reduced over the dp axes, so every rank returns the global mean
    (what the JAX package's jit computes from the global batch)."""
    S = h.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=logit_dtype, device=h.device)
    cnt = torch.zeros((), dtype=logit_dtype, device=h.device)
    vocab_cut = model_sharded(ctx, vocab)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        if vocab_cut:
            l, c = checkpoint(_xent_chunk_vocab, h[:, sl], w_out,
                              labels[:, sl], logit_dtype, ctx.model_group,
                              use_reentrant=False)
        else:
            l, c = checkpoint(_xent_chunk, h[:, sl], w_out, labels[:, sl],
                              logit_dtype, use_reentrant=False)
        tot, cnt = tot + l, cnt + c
    if ctx is not None and ctx.active and ctx.dp_size > 1:
        dp = ctx.mesh.group(ctx.dp_axes)
        tot = CL.reduce_from(tot, dp)
        cnt = CL.all_reduce_(cnt.detach().clone(), dp)
    return tot / torch.clamp(cnt, min=1.0), cnt
