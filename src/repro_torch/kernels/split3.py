"""Wrapper of the three-piece bf16 split kernel (``csrc/split3.cu``): one
pass that reads an fp32 tensor and writes its three exact bf16 pieces,
for the backward of the head's fp32 product on bf16 tensor cores
(``models/common.bf16_exact_mm``). ``launch_plan`` sizes the persistent
grid.

The plain version is ``kernels/ref.split3_bf16_ref``;
``kernels/ops.split3_bf16`` picks between the two by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

THREADS = 256        # csrc/split3.cu, kThreads
RESIDENT_BLOCKS = 8  # blocks per SM the persistent grid is capped at
launches = 0         # kernel launches since the last reset()


def reset() -> None:
    global launches  # verify: ignore[mutable-global] -- launch counter chip_smoke.py reads
    launches = 0


def launch_plan(n: int, vec: bool, sm_count: int = 132) -> dict:
    """The launch for n values: 8 a thread when ``vec`` (n a multiple of
    8, 16-byte aligned bases), else 1; tiles of ``THREADS`` threads' values
    and a persistent grid of at most ``RESIDENT_BLOCKS`` blocks an SM
    walking them."""
    per = 8 if vec else 1
    tiles = -(-n // (THREADS * per))
    return {"per_thread": per, "tiles": tiles,
            "blocks": max(1, min(tiles, sm_count * RESIDENT_BLOCKS)),
            "instance": "vec" if vec else "scalar"}


def split3_bf16(g: torch.Tensor) -> torch.Tensor:
    """g: fp32, any shape, on the card -> (3, *g.shape) bf16 pieces p with
    g == (p[0] - p[1]) - p[2] in fp32 (``ref.split3_bf16_ref``)."""
    global launches  # verify: ignore[mutable-global] -- launch counter chip_smoke.py reads
    name = "split3_bf16"
    build.require_cuda(name, g)
    if g.dtype != torch.float32:
        raise TypeError(f"{name}: g must be fp32, got {g.dtype}")
    g = g.contiguous()
    out = torch.empty((3,) + tuple(g.shape), dtype=torch.bfloat16,
                      device=g.device)
    n = g.numel()
    if n == 0:
        return out
    vec = n % 8 == 0 and g.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = launch_plan(n, vec, build.sm_count(g.device.index or 0))
    lib = build.load()
    err = lib.lib.repro_split3_bf16(g.data_ptr(), out.data_ptr(), n,
                                    int(vec), plan["blocks"],
                                    build.stream_ptr(g))
    lib.check(name, err)
    launches += 1
    return out
