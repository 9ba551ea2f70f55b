"""The reference's training steps: the plain loss and gradients of
``model.py`` and AdamW written out, in fp32.

AdamW as the configuration states it: the gradients clipped to a global
norm, fp32 moments, bias correction, decoupled weight decay
p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p), the update taken in fp32
and the parameters stored in the dtype they come in (the configuration's
parameter dtype): in bf16 an update under half a unit in the last place
of a parameter is rounded away, as it is wherever the parameters are
stored so.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import model as M


def steps(model: Dict, weights: Dict, batches: List[Dict], opt: Dict,
          prec: M.Prec = M.FP32, remat: bool = True,
          against: Optional[Dict] = None, keep: bool = False) -> Dict:
    """len(batches) steps from ``weights`` (any dtype, kept between steps;
    computed in fp32).
    Returns {"loss": [per step], "grad_norm": {path: ||clipped g|| of the
    first step}, "change": {path: ||p_last - p_0||}}. ``weights`` is left
    as it was. ``against`` ({"grad": {path: t}, "param": {path: t}},
    tensors anywhere): also {"grad_diff": ||g - against grad||, "param_diff":
    ||p_last - against param||} by leaf. ``keep``: also "grad_host" and
    "param_host", host copies of the first clipped gradient and the last
    parameters."""
    paths = [p for p, _ in M.leaves(weights)]
    w0 = [t for _, t in M.leaves(weights)]
    ps = [t.detach().float().clone().requires_grad_(True) for t in w0]
    by_path = dict(zip(paths, ps))

    def tree(node, path=()):
        if isinstance(node, dict):
            return {k: tree(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [tree(v, path + (i,)) for i, v in enumerate(node)]
        return by_path[path]

    params = tree(weights)
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    b1, b2 = opt["b1"], opt["b2"]
    out: Dict = {"loss": [], "grad_norm": {}, "change": {}, "grad_diff": {},
                 "param_diff": {}, "grad_host": {}, "param_host": {}}
    for i, b in enumerate(batches, start=1):
        lo = M.loss(model, params, b["tokens"], b["labels"], prec, remat)
        grads = torch.autograd.grad(lo, ps)
        out["loss"].append(float(lo.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(opt["clip_norm"] / gnorm.clamp(min=1e-9),
                                max=1.0)
            c1, c2 = 1 - b1 ** i, 1 - b2 ** i
            for j, (p, g) in enumerate(zip(ps, grads)):
                g = g * scale
                if i == 1:
                    out["grad_norm"][paths[j]] = float(g.norm())
                    if against is not None:
                        a = against["grad"][paths[j]].to(g.device).float()
                        out["grad_diff"][paths[j]] = float(
                            (g - a.reshape(g.shape)).norm())
                    if keep:
                        out["grad_host"][paths[j]] = g.to("cpu", copy=True)
                m[j].mul_(b1).add_(g, alpha=1 - b1)
                v[j].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[j] / c1) / ((v[j] / c2).sqrt() + opt["eps"])
                upd = upd + opt["weight_decay"] * p
                p.sub_(opt["lr"] * upd)
                if w0[j].dtype != torch.float32:
                    p.copy_(p.to(w0[j].dtype))
        del grads
    with torch.no_grad():
        for path, p, p0 in zip(paths, ps, w0):
            out["change"][path] = float((p - p0.float()).norm())
            if against is not None:
                a = against["param"][path].to(p.device).float()
                out["param_diff"][path] = float((p - a.reshape(p.shape))
                                                .norm())
            if keep:
                out["param_host"][path] = p.detach().to("cpu", copy=True)
    return out
