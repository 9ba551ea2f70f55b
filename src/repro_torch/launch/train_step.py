"""The train step at one rank: grad accumulation, AdamW, and the
non-finite guard (``repro.launch.train_step.make_train_fn`` and
``build_train_step``).

PyTorch runs eagerly, so there is nothing to compile: ``build_train_step``
returns the step function itself. The step updates the state in place
(see ``optim/adamw.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.launch import specs as SP
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves, tree_map_path
from repro_torch.optim.adamw import AdamW, global_norm

Tree = Any


def _unflatten(like: Tree, leaves):
    """The tree of ``like`` with its leaves, in ``tree_leaves`` order,
    replaced by ``leaves``."""
    by_path = dict(zip((p for p, _ in tree_leaves(like)), leaves))
    return tree_map_path(lambda path, _: by_path[path], like)


def make_train_fn(cfg, optim: AdamW, accum: int):
    """step(state, batch) -> (state, metrics). ``accum > 1`` takes batch
    entries with a leading (accum,) axis and sums the microbatches'
    gradients in fp32. A non-finite loss or gradient norm skips the whole
    update (parameters, moments and step counter stay as they were) and
    reports ``skipped``."""

    def step(state: Dict, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        leaves = [t for _, t in tree_leaves(params)]
        for t in leaves:
            t.requires_grad_(True)
        if accum > 1:
            grads = [torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for t in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(accum):
                lo, _ = lm.loss_fn(cfg, params,
                                   {k: v[i] for k, v in batch.items()})
                for acc, g in zip(grads, torch.autograd.grad(lo, leaves)):
                    acc.add_(g.float())
                loss = loss + lo.detach()
            grads = [g / accum for g in grads]
            loss = loss / accum
        else:
            lo, _ = lm.loss_fn(cfg, params, batch)
            grads = list(torch.autograd.grad(lo, leaves))
            loss = lo.detach()
        gtree = _unflatten(params, grads)
        gnorm = global_norm(gtree)
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))  # host sync
        if ok:
            _, state["opt"], stats = optim.update(gtree, state["opt"], params,
                                                  gnorm=gnorm)
            state["step"] += 1
        else:
            stats = {"grad_norm": gnorm,
                     "lr": optim.lr(state["opt"]["count"] + 1)}
        del grads, gtree
        return state, {"loss": loss, **stats, "skipped": int(not ok)}

    return step


def _not_ported(what: str):
    return NotImplementedError(
        f"{what}: the model-level mesh path (parameters and caches sharded "
        f"over a mesh, and its train step) is not ported yet; the ranked "
        f"MoE layer is (core.moe_layer.moe_ffn with a parallel.mesh."
        f"AxisCtx)")


def build_train_step(cfg, shape, mesh=None, optim: Optional[AdamW] = None,
                     accum: int = 0, schedule: str = ""):
    """Returns {"fn": step, "batch_structs": the batch's entry shapes,
    "accum"}. One rank only: a mesh or a block schedule raises."""
    if mesh is not None:
        raise _not_ported("a mesh")
    if schedule:
        raise NotImplementedError("schedule: the whole-graph schedule is "
                                  "not ported yet")
    optim = optim or AdamW()
    accum = SP.legal_accum(shape.global_batch,
                           accum or SP.TRAIN_ACCUM.get(shape.name, 1))
    return {"fn": make_train_fn(cfg, optim, accum),
            "batch_structs": SP.train_batch_specs(cfg, shape, accum),
            "accum": accum}
