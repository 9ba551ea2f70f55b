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


def ffn_apply(cfg, p, x):
    gate = x @ p["w_gate"] if "w_gate" in p else None
    up = x @ p["w_up"]
    h = activate(cfg.activation, gate, up)
    return h @ p["w_down"]


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
# Chunked softmax cross-entropy: never keeps (tokens, vocab) logits alive
# ---------------------------------------------------------------------------


def _xent_chunk(hc, w_out, lc, logit_dtype):
    logits = hc.to(logit_dtype) @ w_out.to(logit_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).to(logit_dtype)
    return ((lse - tgt) * mask).sum(), mask.sum()


def chunked_xent(h, w_out, labels, chunk: int = 1024,
                 logit_dtype=torch.float32):
    """h: (B, S, d); w_out: (d, V); labels: (B, S), -1 = ignore. Returns
    (mean loss over the kept labels, their count), as
    ``repro.models.common.chunked_xent``. Each sequence chunk's
    (B, chunk, V) logits are recomputed in the backward
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``), so
    only one chunk's logits are alive at a time."""
    S = h.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=logit_dtype, device=h.device)
    cnt = torch.zeros((), dtype=logit_dtype, device=h.device)
    for s0 in range(0, S, chunk):
        l, c = checkpoint(_xent_chunk, h[:, s0:s0 + chunk], w_out,
                          labels[:, s0:s0 + chunk], logit_dtype,
                          use_reentrant=False)
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp(cnt, min=1.0), cnt
