"""Carry a JAX parameter tree across to the port.

``from_jax(params_np, cfg)`` takes the JAX package's ``lm.init_params``
tree with every leaf converted by ``np.asarray`` and returns the port's
parameters with the same nesting and the same stacked (n_periods, ...)
layer leaves. bf16 goes through fp32, which is exact. Every leaf's shape
and dtype is checked against the port's ``model_schema``, or against
``schema`` when one is given (e.g. ``core.moe_layer.moe_schema`` for one
MoE layer's tree). ``from_jax_sharded`` goes on to this rank's shard of
the port's mesh tree (``parallel.sharding.to_mesh``), so a ranked test
hands both packages the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves

Tree = Any


def _to_torch(arr: np.ndarray, want: torch.dtype,
              dev: torch.device) -> torch.Tensor:
    if str(arr.dtype) == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))   # a writable copy
    if t.dtype != want:
        raise TypeError(f"dtype {t.dtype}, the schema wants {want}")
    return t.to(dev)


def _set(tree: Tree, path, value) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def _skeleton(schema: Tree) -> Tree:
    if isinstance(schema, dict):
        return {k: _skeleton(v) for k, v in schema.items()}
    if isinstance(schema, list):
        return [_skeleton(v) for v in schema]
    return None


def from_jax(params_np: Tree, cfg, device: DeviceLike = None,
             schema: Tree = None) -> Tree:
    dev = resolve_device(device)
    schema = lm.model_schema(cfg) if schema is None else schema
    dt = dtype_of(cfg.param_dtype)
    out = _skeleton(schema)
    src = dict(tree_leaves(params_np))
    want = dict(tree_leaves(schema))
    if set(src) != set(want):
        raise ValueError(f"leaf paths differ: only in JAX "
                         f"{sorted(set(src) - set(want))}, only in the port "
                         f"{sorted(set(want) - set(src))}")
    for path, decl in want.items():
        arr = np.asarray(src[path])
        if tuple(arr.shape) != decl.shape:
            raise ValueError(f"{path}: shape {arr.shape}, the schema wants "
                             f"{decl.shape}")
        try:
            _set(out, path, _to_torch(arr, decl.leaf_dtype(dt), dev))
        except TypeError as e:
            raise TypeError(f"{path}: {e}") from None
    return out


def from_jax_sharded(params_np: Tree, cfg, ctx, fsdp: bool = True,
                     device: DeviceLike = None) -> Tree:
    """This rank's shard of the mesh tree under ``ctx`` (a ranked
    ``AxisCtx``), from the JAX package's one-rank tree as numpy."""
    from repro_torch.parallel import sharding as SH
    return SH.to_mesh(from_jax(params_np, cfg, device), cfg, ctx, fsdp)


def to_numpy(params: Tree) -> Tree:
    """The port's parameters as numpy arrays (bf16 leaves as fp32, exact)."""
    def conv(t):
        return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()
    out = _skeleton(params)
    for path, t in tree_leaves(params):
        _set(out, path, conv(t))
    return out
