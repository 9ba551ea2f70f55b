"""Int8 gradient compression with error feedback
(``repro.optim.compression``), on dicts and lists of tensors.

The data-parallel gradient all-reduce crosses the slowest links of a
large run. A gradient (plus the residual carried from the last step) is
quantized per tensor to int8 with a symmetric fp32 scale; what the
quantization dropped becomes the next step's residual, so the sum of what
was sent plus the last residual is the sum of the true gradients (error
feedback). ``allreduce_compressed`` reduces over one process group: every
member re-quantizes its payload to the group's largest scale, the int8
values are summed exactly in int32, and the sum is dequantized and
divided by the group size.

Numerics are the JAX package's: fp32 throughout, ``torch.round`` (half to
even, as ``jnp.round``) before the clip to +-127. ``torch.distributed``
has no max of an int8 scale, so the scales travel as fp32 through one
``MAX`` all-reduce, and the payloads of every leaf through one int32
``SUM`` all-reduce. A gloo group takes CPU tensors, an NCCL group CUDA
ones. As in the JAX package the train step does not call this module.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map, tree_map_path
from repro_torch.parallel import collectives as CL
from repro_torch.parallel.mesh import Group

Tree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q int8, scale fp32 0-d)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, resid: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(q, scale, new_resid), new_resid = (grad + resid) - dequant(q)."""
    g = grad.float() + resid
    q, scale = quantize_int8(g)
    return q, scale, g - dequantize_int8(q, scale)


def init_residuals(grads: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_pytree(grads: Tree, resids: Tree) -> Tuple[Dict, Tree]:
    """({"q": tree, "scale": tree}, new residual tree)."""
    rs = dict(tree_leaves(resids))
    out = {p: compress_with_feedback(g, rs[p]) for p, g in tree_leaves(grads)}
    return ({"q": tree_map_path(lambda p, _: out[p][0], grads),
             "scale": tree_map_path(lambda p, _: out[p][1], grads)},
            tree_map_path(lambda p, _: out[p][2], grads))


def decompress_pytree(packed: Dict) -> Tree:
    scales = dict(tree_leaves(packed["scale"]))
    return tree_map_path(lambda p, q: dequantize_int8(q, scales[p]),
                         packed["q"])


def allreduce_compressed(grads: Tree, resids: Tree, group: Group
                         ) -> Tuple[Tree, Tree]:
    """The mean over ``group`` (a ``parallel.mesh.Group``, e.g. a mesh's
    data axis) of int8-compressed gradients with error feedback: (reduced
    fp32 tree, new residual tree). Collective: every member calls it with
    trees of one structure and shapes. Each member's payload lies within
    one quantum of the common scale."""
    packed, new_resids = compress_pytree(grads, resids)
    qs = list(tree_leaves(packed["q"]))
    if not qs:
        return {}, new_resids
    scales = torch.stack([s for _, s in tree_leaves(packed["scale"])])
    CL.check_device("allreduce_compressed", group, scales)
    s_max = scales.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group.pg)
    # re-quantize to the common scale so the int32 sum is coherent; one
    # buffer carries every leaf
    flat = torch.empty(sum(q.numel() for _, q in qs), dtype=torch.int32,
                       device=scales.device)
    spans, off = [], 0
    for (_, q), s, m in zip(qs, scales, s_max):
        part = flat[off:off + q.numel()].view(q.shape)
        part.copy_(torch.clamp(torch.round(q.float() * (s / m)), -127, 127))
        spans.append(part)
        off += q.numel()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.pg)
    n = group.size
    out = {p: tot.float() * m / n
           for (p, _), tot, m in zip(qs, spans, s_max)}
    return tree_map_path(lambda p, _: out[p], grads), new_resids

