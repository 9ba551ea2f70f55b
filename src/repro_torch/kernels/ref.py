"""Plain PyTorch versions of the three hand-written kernels.

They mirror ``repro.kernels.ref``: the CPU path runs them, and the tests and
``chip_smoke.py`` hold each CUDA kernel against them. Nothing on the main
path calls them with a CUDA tensor (``kernels/ops.py`` sends those to the
kernels).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activate


def grouped_gemm_ref(lhs, rhs, out_dtype=None):
    """lhs: (E, M, K); rhs: (E, K, N) -> (E, M, N), fp32 accumulation."""
    out = torch.bmm(lhs.float(), rhs.float())
    return out.to(out_dtype or lhs.dtype)


def fused_mlp_ref(rows, w_gate, w_up, w_down, activation):
    """Unfused expert MLP with the hidden materialized, rounding where the
    fused kernel (and the TPU kernel, fused_mlp.py:80-81) rounds: GEMM1 with
    fp32 accumulation, the activation in fp32, the hidden cast to the input
    dtype, GEMM2 with fp32 accumulation, the output cast to the input dtype.
    In fp32 it is the JAX oracle ``repro.kernels.ref.fused_mlp_ref``.
    rows: (E, R, d); w_gate/w_up: (E, d, f) (w_gate None if not GLU);
    w_down: (E, f, N) -> (E, R, N)."""
    x = rows.float()
    up = torch.bmm(x, w_up.float())
    gate = torch.bmm(x, w_gate.float()) if w_gate is not None else None
    h = activate(activation, gate, up).to(rows.dtype)
    return torch.bmm(h.float(), w_down.float()).to(rows.dtype)


def topk_combine_ref(rows, weights):
    """rows: (T, k, d); weights: (T, k) -> (T, d), fp32 sum cast to the
    rows' dtype."""
    out = torch.einsum("tkd,tk->td", rows.float(), weights.float())
    return out.to(rows.dtype)
