"""Weights from the seed, made on the device by the benchmark.

Each leaf of the reference's layout (``reference.model.param_layout``) is
drawn by one call on a generator of its own, seeded from (seed, the leaf's
path): any leaf can be drawn again alone, so the reference and the checks
regenerate what they need instead of keeping a copy. Matrices are drawn in
bf16, the dtype they are served and trained in, with std 1/sqrt(fan_in)
(fan_in the second-to-last axis), or the std that the configuration's
``init_std`` gives the leaf by its path ("embed": 1.0 draws the embedding
at unit scale); norm scales and other "ones"/"zeros" leaves are fp32.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Tuple

import torch

from portbench.reference.model import leaves


def leaf_seed(seed: int, path: Tuple) -> int:
    key = f"{int(seed)}/" + "/".join(str(p) for p in path)
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8],
                          "little") & (2 ** 63 - 1)


def make_leaf(decl, seed: int, path: Tuple, device,
              dtype: torch.dtype = torch.bfloat16,
              init_std: Optional[Dict[str, float]] = None) -> torch.Tensor:
    shape, init = decl
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (init_std or {}).get("/".join(str(p) for p in path),
                               1.0 / math.sqrt(max(1, fan_in)))
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, float(std), generator=gen)


def make(layout: Dict, seed: int, device,
         dtype: torch.dtype = torch.bfloat16,
         init_std: Optional[Dict[str, float]] = None) -> Dict:
    """The whole tree of ``layout``."""
    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, path + (i,)) for i, v in enumerate(node)]
        return make_leaf(node, seed, path, device, dtype, init_std)
    return build(layout, ())


def leaf_paths(layout: Dict):
    return [p for p, _ in leaves(layout)]


def decl_at(layout: Dict, path: Tuple):
    node = layout
    for p in path:
        node = node[p]
    return node
