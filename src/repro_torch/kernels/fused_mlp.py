"""Wrapper of the fused expert-MLP CUDA kernel (``csrc/fused_mlp.cu``).

The plain version is ``kernels/ref.fused_mlp_ref``; ``kernels/ops.py``
picks between the two by the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_gemm import ORDERS
from repro_torch.models.common import is_glu

ACTIVATIONS = {"swiglu": 0, "geglu": 1, "gelu": 2, "relu2": 3}
launches = 0        # kernel launches since the last reset()


def reset() -> None:
    global launches
    launches = 0


def fused_mlp(rows: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_up: torch.Tensor, w_down: torch.Tensor, activation: str,
              order: str = "expert_major") -> torch.Tensor:
    """rows: (E, R, d); w_gate/w_up: (E, d, f) (w_gate None for non-GLU
    activations); w_down: (E, f, N), which may be a column slice of the
    full weight -> (E, R, N) in the inputs' dtype. The hidden stays in
    shared memory; products accumulate in fp32. Scratch for the fp32
    partial sums of the f-chunks is allocated here."""
    global launches
    name = "fused_mlp"
    if activation not in ACTIVATIONS:
        raise ValueError(f"{name}: unknown activation {activation!r}")
    if is_glu(activation) != (w_gate is not None):
        raise ValueError(f"{name}: {activation} needs w_gate "
                         f"{'' if is_glu(activation) else 'to be None'}")
    if order not in ORDERS:
        raise ValueError(f"{name}: unknown order {order!r}")
    ws = [w for w in (w_gate, w_up) if w is not None]
    build.require_cuda(name, rows, w_down, *ws)
    code = build.dtype_code(name, rows, w_down, *ws)
    if rows.dim() != 3 or w_down.dim() != 3 or any(
            w.shape != w_up.shape or w.dim() != 3 for w in ws):
        raise ValueError(f"{name}: expected 3-d rows and weights")
    E, R, d = rows.shape
    f = w_up.shape[2]
    N = w_down.shape[2]
    if w_up.shape[:2] != (E, d) or w_down.shape[:2] != (E, f):
        raise ValueError(f"{name}: shapes rows {tuple(rows.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)} do not chain")
    if rows.stride(2) != 1 or w_down.stride(2) != 1:
        raise ValueError(f"{name}: rows and w_down need a unit last stride")
    if not all(w.is_contiguous() for w in ws):
        raise ValueError(f"{name}: w_gate and w_up must be contiguous")
    out = torch.empty((E, R, N), dtype=rows.dtype, device=rows.device)
    if out.numel() == 0:
        return out
    if f == 0:
        return out.zero_()
    lib = build.load()
    # fp32 partial sums, one (E, R, N) plane per f-chunk (split-f design)
    n_chunks = -(-f // lib.lib.repro_fused_mlp_chunk())
    part = torch.empty((n_chunks, E, R, N), dtype=torch.float32,
                       device=rows.device)
    err = lib.lib.repro_fused_mlp(
        rows.data_ptr(), rows.stride(0), rows.stride(1),
        None if w_gate is None else w_gate.data_ptr(), w_up.data_ptr(),
        w_up.stride(0), w_up.stride(1),
        w_down.data_ptr(), w_down.stride(0), w_down.stride(1),
        part.data_ptr(), out.data_ptr(), E, R, d, f, N,
        ACTIVATIONS[activation],
        ORDERS[order], code, build.stream_ptr(rows))
    lib.check(name, err)
    launches += 1
    return out
