"""The seam between the benchmark and the program under test.

Builds the program's ``ModelConfig`` from a configuration file (the
program's registered architecture, then every number of the file's
``model`` section and the settings of its ``program`` section laid over
it) and hands the benchmark's weights to the program in the layout its
parameter tree has. Both are checked: the program's schema has to hold
exactly the leaves and shapes that the reference's layout holds, the
experts stored (n_periods, 1, E, d, f) at one rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from portbench.reference.model import leaves, param_layout

_SUB = ("attn", "moe", "ssm")


def program_config(conf: Dict):
    from repro_torch.configs import get_config
    base = get_config(conf["arch"])
    over: Dict = {}
    for sec in (conf["model"], conf.get("program", {})):
        for k, v in sec.items():
            if k in _SUB and isinstance(v, dict):
                over.setdefault(k, {}).update(v)
            else:
                over[k] = v
    top = {k: v for k, v in over.items() if k not in _SUB}
    for k in _SUB:
        if k in over:
            cur = getattr(base, k)
            if cur is None:
                raise ValueError(f"{conf['arch']} has no {k} block")
            top[k] = dataclasses.replace(cur, **over[k])
    cfg = dataclasses.replace(base, name=conf["name"], **top)
    check_schema(cfg, conf["model"])
    return cfg


def check_schema(cfg, model: Dict) -> None:
    """Raises unless the program's parameter tree has the reference
    layout's leaves with its shapes (experts with the one-rank W axis)."""
    from repro_torch.models import lm
    want = {p: tuple(decl[0]) for p, decl in leaves(param_layout(model))}
    got = {}
    for p, d in leaves(lm.model_schema(cfg)):
        shape = tuple(d.shape)
        if "experts" in p:
            if shape[1] != 1:
                raise ValueError(f"{p}: experts not stored at one rank")
            shape = shape[:1] + shape[2:]
        got[p] = shape
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()), key=str)
        raise ValueError(f"program schema differs from the reference "
                         f"layout: {diff[:6]}")


def program_params(weights: Dict) -> Dict:
    """The program's tree over the same storage: views, no copies."""
    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v, path + (i,)) for i, v in enumerate(node)]
        return node.unsqueeze(1) if "experts" in path else node
    return conv(weights, ())


def param_dtype(conf: Dict):
    """The dtype the configuration stores its matrices in."""
    import torch
    return getattr(torch, conf.get("program", {}).get("param_dtype",
                                                       "bfloat16"))
