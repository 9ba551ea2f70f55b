"""Dispatch of the three kernels by the tensors' device.

A CPU tensor goes to the plain version in ``kernels/ref.py``. A CUDA tensor
goes to the hand-written kernel; if the kernel cannot be built, loaded or
launched, the call raises. There is no fallback from the card to the plain
version.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import fused_mlp as _fm
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import ref
from repro_torch.kernels import topk_combine as _tc


def _on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"operands on unsupported or mixed devices {kinds}")


def topk_combine(rows, weights):
    if _on_cuda(rows, weights):
        return _tc.topk_combine(rows, weights)
    return ref.topk_combine_ref(rows, weights)


def grouped_gemm(lhs, rhs, order: str = "expert_major"):
    if _on_cuda(lhs, rhs):
        return _gg.grouped_gemm(lhs, rhs, order=order)
    return ref.grouped_gemm_ref(lhs, rhs)


def fused_mlp(rows, w: Dict[str, torch.Tensor], activation: str,
              col_slice: Optional[Tuple[int, int]] = None,
              order: str = "expert_major"):
    """``w`` is the expert-weight dict (w_gate optional, w_up, w_down);
    ``col_slice=(start, width)`` computes only that block of output
    columns, from a strided view of w_down."""
    wd = w["w_down"]
    if col_slice is not None:
        wd = wd[:, :, col_slice[0]:col_slice[0] + col_slice[1]]
    wg = w.get("w_gate")
    if _on_cuda(rows, wg, w["w_up"], wd):
        return _fm.fused_mlp(rows, wg, w["w_up"], wd, activation, order)
    return ref.fused_mlp_ref(rows, wg, w["w_up"], wd, activation)
