"""AdamW with global-norm clipping and a cosine schedule, on dicts and
lists of tensors (``repro.optim.adamw`` with the same defaults).

fp32 ``m``/``v`` for every leaf, the update computed in fp32 and cast back
to the parameter's dtype. The update is IN PLACE: parameters and moments
are overwritten, which saves the second copy of the state that JAX's
``donate_argnums`` saved by donating the old one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

Tree = Any


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable[[int], float]:
    def lr(step: int) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * min(1.0, step / max(1, warmup))
        prog = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
        return base_lr * (min_ratio + (1 - min_ratio) * 0.5
                          * (1 + math.cos(math.pi * prog)))
    return lr


def global_norm(tree: Tree, specs: Tree = None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor).

    Sharded (``specs`` and the ``mesh`` they cut over): ``tree`` holds this
    rank's slice of every leaf, each slice the same on the ranks that hold
    it. Each rank sums its slices' squares, each divided by the number of
    ranks that hold that slice, and the sums are all-reduced over every
    rank: each distinct slice counts once, a replicated leaf once, so the
    norm (and the clip) is the one-rank norm of the whole tree. A
    non-finite slice on any rank makes the norm non-finite on every rank."""
    leaves = [t for _, t in tree_leaves(tree)]
    if specs is None:
        return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in leaves))
    from repro_torch.parallel import collectives as CL
    from repro_torch.parallel import sharding as SH
    spec_leaves = [sp for _, sp in tree_leaves(specs)]
    sq = sum(torch.sum(t.float() ** 2) / SH.replicas(sp, mesh)
             for t, sp in zip(leaves, spec_leaves))
    sq = CL.all_reduce_(sq.reshape(1), mesh.group(mesh.axis_names))
    return torch.sqrt(sq[0])


@dataclass(frozen=True)
class AdamW:
    lr: Callable = cosine_schedule(3e-4, 100, 10000)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Tree) -> Dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": 0}

    @torch.no_grad()
    def update(self, grads: Tree, state: Dict, params: Tree,
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Tree, Dict, Dict]:
        """One step, in place: ``params`` and ``state`` are overwritten and
        returned. ``gnorm`` is the gradients' global norm if the caller has
        it already. Returns (params, state, {"grad_norm", "lr"})."""
        count = state["count"] + 1
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = self.lr(count)
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        leaves = [[t for _, t in tree_leaves(tree)]
                  for tree in (params, grads, state["m"], state["v"])]
        for p, g, m, v in zip(*leaves):
            g = g.float().mul_(scale)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            del g
            step = m / c1
            step.div_((v / c2).sqrt_().add_(self.eps))
            p32 = p.float()
            step.add_(p32, alpha=self.weight_decay)
            p.copy_(step.mul_(-lr).add_(p32))         # p - lr * step
        state["count"] = count
        return params, state, {"grad_norm": gnorm, "lr": lr}
