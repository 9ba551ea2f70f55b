"""Wrapper of the top-k combine CUDA kernel (``csrc/topk_combine.cu``).

The plain version is ``kernels/ref.topk_combine_ref``; ``kernels/ops.py``
picks between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0        # kernel launches since the last reset()


def reset() -> None:
    global launches
    launches = 0


def topk_combine(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """rows: (T, k, d) fp32 or bf16; weights: (T, k) fp32 -> (T, d) in the
    rows' dtype, summed in fp32."""
    global launches
    name = "topk_combine"
    build.require_cuda(name, rows, weights)
    code = build.dtype_code(name, rows)
    if weights.dtype != torch.float32:
        raise TypeError(f"{name}: weights must be fp32, got {weights.dtype}")
    if rows.dim() != 3 or weights.shape != rows.shape[:2]:
        raise ValueError(f"{name}: rows {tuple(rows.shape)} and weights "
                         f"{tuple(weights.shape)} are not (T, k, d), (T, k)")
    if not (rows.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"{name}: rows and weights must be contiguous")
    T, k, d = rows.shape
    out = torch.empty((T, d), dtype=rows.dtype, device=rows.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    err = lib.lib.repro_topk_combine(rows.data_ptr(), weights.data_ptr(),
                                     out.data_ptr(), T, k, d, code,
                                     build.stream_ptr(rows))
    lib.check(name, err)
    launches += 1
    return out
