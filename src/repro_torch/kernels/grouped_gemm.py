"""Wrapper of the grouped GEMM CUDA kernel (``csrc/grouped_gemm.cu``).

The plain version is ``kernels/ref.grouped_gemm_ref``; ``kernels/ops.py``
picks between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

ORDERS = {"expert_major": 0, "n_major": 1}
launches = 0        # kernel launches since the last reset()


def reset() -> None:
    global launches
    launches = 0


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor,
                 order: str = "expert_major") -> torch.Tensor:
    """lhs: (E, M, K); rhs: (E, K, N) -> (E, M, N) in the inputs' dtype,
    fp32 accumulation. Both operands need a unit last stride; their other
    strides are free (a column slice of rhs is taken as it is)."""
    global launches
    name = "grouped_gemm"
    build.require_cuda(name, lhs, rhs)
    code = build.dtype_code(name, lhs, rhs)
    if order not in ORDERS:
        raise ValueError(f"{name}: unknown order {order!r}")
    if lhs.dim() != 3 or rhs.dim() != 3 or lhs.shape[0] != rhs.shape[0] \
            or lhs.shape[2] != rhs.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(lhs.shape)} x "
                         f"{tuple(rhs.shape)} are not (E,M,K) x (E,K,N)")
    if lhs.stride(2) != 1 or rhs.stride(2) != 1:
        raise ValueError(f"{name}: operands need a unit last stride")
    E, M, K = lhs.shape
    N = rhs.shape[2]
    out = torch.empty((E, M, N), dtype=lhs.dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.load()
    err = lib.lib.repro_grouped_gemm(
        lhs.data_ptr(), lhs.stride(0), lhs.stride(1),
        rhs.data_ptr(), rhs.stride(0), rhs.stride(1), out.data_ptr(),
        E, M, K, N, ORDERS[order], code, build.stream_ptr(lhs))
    lib.check(name, err)
    launches += 1
    return out
