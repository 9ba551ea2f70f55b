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
# The head's fp32 product of bf16 operands, on bf16 tensor cores
# ---------------------------------------------------------------------------


# the longest K that one tensor-core pass sums. Each product of two bf16
# values is exact in fp32, but the tensor cores' fp32 accumulation loses
# bits as K grows, so a longer product is cut into passes of this K, each
# pass's result added to the last in the pass's fp32 epilogue. Swept at the
# training head's chunk (``chip_smoke.py --only build,head_product``): dh
# over its vocab of 151,936 reads 15-32x the fp32 cuBLAS product's error in
# one pass, 0.5-1.0x in passes of 4,096, 1.0-2.1x of 8,192; passes of 512
# bring the logits' and dW's K of 2,048 under 1x too, at 2.5x the time
K_PASS = 4096


def _on_cpu(*tensors) -> bool:
    return any(t.device.type == "cpu" for t in tensors)


def _mm_f32(x, y, acc=None, alpha: float = 1.0, k_pass: int = K_PASS):
    """x @ y of bf16 matrices in fp32, or with ``acc`` acc + alpha * (x @
    y) written into acc: off the CPU (the card, and ``meta`` for the dry
    run), bf16 tensor-core passes of at most ``k_pass`` along K with fp32
    accumulation; on the CPU, the widened operands' product."""
    if _on_cpu(x, y):
        p = x.float() @ y.float()
        return p if acc is None else acc.add_(p, alpha=alpha)
    for k0 in range(0, x.shape[1], k_pass):
        xk, yk = x[:, k0:k0 + k_pass], y[k0:k0 + k_pass]
        if acc is None:
            acc, alpha = torch.mm(xk, yk, out_dtype=torch.float32), 1.0
        else:
            torch.addmm(acc, xk, yk, alpha=alpha, out_dtype=torch.float32,
                        out=acc)
    return acc


def split_grads_f32(a, b, g, need=(True, True), k_pass: int = K_PASS):
    """The fp32 gradients (g @ b.T, a.T @ g) of bf16 a (rows, d), b (d, V)
    and an fp32 g (rows, V): g's three bf16 pieces (``ops.split3_bf16``: g
    == (p[0] - p[1]) - p[2] exactly), each times a bf16 operand on bf16
    tensor cores (every product of two values exact in fp32), summed in
    fp32 by ``_mm_f32`` passes. ``need``: which of the two to compute (None
    for the other)."""
    pieces = ops.split3_bf16(g)                         # (3, rows, V)
    da = db = None
    if need[0]:
        # the three pieces stacked as rows of one product
        p = _mm_f32(pieces.view(-1, g.shape[-1]), b.t(),
                    k_pass=k_pass).view(3, *a.shape)
        da = (p[0] - p[1]) - p[2]
    if need[1]:
        # one product a piece, each added to the last in fp32
        db = _mm_f32(a.t(), pieces[0], k_pass=k_pass)
        for k in (1, 2):
            _mm_f32(a.t(), pieces[k], acc=db, alpha=-1.0, k_pass=k_pass)
    return da, db


class _Bf16ExactMM(torch.autograd.Function):
    """The fp32 product of two bf16 matrices on bf16 tensor cores. A
    product of two bf16 values is exact in fp32, so one bf16 pass with fp32
    accumulation multiplies the numbers the fp32 product of the widened
    operands multiplies; only the fp32 sums differ, in order and in the
    tensor cores' rounding (at the training head's chunk the logits, dh
    and dW read at most 1.6x, 1.1x and 3.1x the fp32 cuBLAS product's max
    error against fp64, ``chip_smoke.py --only build,head_product``). The
    backward's products take the fp32 gradient in three exact pieces
    (``split_grads_f32``) and return their sums in the operands' dtype, as
    the widened product's backward does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = split_grads_f32(a, b, g, ctx.needs_input_grad)
        return (None if da is None else da.to(a.dtype),
                None if db is None else db.to(b.dtype))


def bf16_exact_mm(a, b):
    """a (rows, d) @ b (d, V), both bf16, as fp32: ``_Bf16ExactMM``."""
    return _Bf16ExactMM.apply(a, b)


# calls of the head's logits product by path (``head_logits``), forward
# and checkpoint recompute alike; ``launch/train.py --trace`` prints them
HEAD_PRODUCT_CALLS = {"bf16_exact": 0, "fp32": 0}


def head_logits(hc, w_out, logit_dtype):
    """A chunk's logits hc (..., d) @ w_out (d, V) in ``logit_dtype``.
    bf16 operands off the CPU (on the card, and on ``meta`` tensors, so
    that the dry run counts what the card runs) with fp32 logits take
    ``bf16_exact_mm``: the fp32 product on the tensor cores. Every other
    case (the CPU, fp32 parameters, other logit dtypes) the widened
    operands' product."""
    if (not _on_cpu(hc, w_out) and hc.dtype == torch.bfloat16
            and w_out.dtype == torch.bfloat16
            and logit_dtype == torch.float32):
        HEAD_PRODUCT_CALLS["bf16_exact"] += 1
        out = bf16_exact_mm(hc.reshape(-1, hc.shape[-1]), w_out)
        return out.view(*hc.shape[:-1], w_out.shape[-1])
    HEAD_PRODUCT_CALLS["fp32"] += 1
    return hc.to(logit_dtype) @ w_out.to(logit_dtype)


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy: never keeps (tokens, vocab) logits alive
# ---------------------------------------------------------------------------


def _xent_chunk(hc, w_out, lc, logit_dtype):
    logits = head_logits(hc, w_out, logit_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).to(logit_dtype)
    return ((lse - tgt) * mask).sum(), mask.sum()


def _xent_chunk_vocab(hc, w_out, lc, logit_dtype, group):
    """One chunk against this rank's vocab slice ``w_out`` (d, V / m): the
    logsumexp's max and sum of exponentials reduced over the model group,
    the target logit from the rank whose slice holds it."""
    hc = CL.copy_to(hc, group)
    logits = head_logits(hc, w_out, logit_dtype)
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
