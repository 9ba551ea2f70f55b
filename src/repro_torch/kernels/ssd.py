"""Wrapper of the Mamba-2 SSD CUDA kernel (``csrc/ssd.cu``).

The plain versions are ``kernels/ref.ssd_chunked_ref`` (the chunked dual
form from a zero state, y only) and ``kernels/ref.ssd_state_ref`` (from a
given state, with the final state); ``kernels/ops.py`` picks between kernel
and plain version by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

CHUNK = 64          # the kernel's own chunk (csrc/ssd.cu, kQ)
MAX_STATE = 128     # d_state the kernel's shared-memory tiles hold
MAX_HEAD_DIM = 64
launches = 0        # kernel launches since the last reset()


def reset() -> None:
    global launches
    launches = 0


def _launch(name, x, dt, A, Bm, Cm, D, h0, h_final) -> torch.Tensor:
    """Check the operands, launch the kernel, return y (B, S, nh, hd)."""
    global launches
    tensors = [t for t in (x, dt, A, Bm, Cm, D, h0, h_final) if t is not None]
    build.require_cuda(name, *tensors)
    xcode = build.dtype_code(name, x)
    bcode = build.dtype_code(name, Bm, Cm)
    for label, t in (("dt", dt), ("A", A), ("D", D), ("h0", h0),
                     ("h_final", h_final)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be fp32, got {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (B, S, nh, hd)")
    B, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, nh) or tuple(A.shape) != (nh,)
            or tuple(D.shape) != (nh,) or tuple(Bm.shape) != (B, S, ds)
            or tuple(Cm.shape) != (B, S, ds)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D "
                         f"{tuple(D.shape)} do not match")
    if not (0 < ds <= MAX_STATE and 0 < hd <= MAX_HEAD_DIM):
        raise ValueError(f"{name}: d_state {ds} / head_dim {hd} exceed the "
                         f"kernel's {MAX_STATE} / {MAX_HEAD_DIM}")
    if (x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1
            or not (A.is_contiguous() and D.is_contiguous())):
        raise ValueError(f"{name}: x, Bm and Cm need a unit last stride, "
                         f"A and D must be contiguous")
    if h0 is not None and (tuple(h0.shape) != (B, nh, ds, hd)
                           or not h0.is_contiguous()):
        raise ValueError(f"{name}: h0 {tuple(h0.shape)} is not a contiguous "
                         f"(B, nh, ds, hd) = {(B, nh, ds, hd)}")
    y = torch.empty((B, S, nh, hd), dtype=x.dtype, device=x.device)
    if y.numel() == 0:                 # S == 0: the state passes through
        if h_final is not None and h0 is not None:
            h_final.copy_(h0)
        elif h_final is not None:
            h_final.zero_()
        return y
    lib = build.load()
    err = lib.lib.repro_ssd_forward(
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
        dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
        A.data_ptr(), Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
        Cm.data_ptr(), Cm.stride(0), Cm.stride(1), D.data_ptr(),
        y.data_ptr(), None if h0 is None else h0.data_ptr(),
        None if h_final is None else h_final.data_ptr(),
        B, S, nh, hd, ds, xcode, bcode, build.stream_ptr(x))
    lib.check(name, err)
    launches += 1
    return y


def ssd_forward(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """y of the chunked SSD from a zero state. x: (B, S, nh, hd) fp32 or
    bf16; dt: (B, S, nh) fp32; A, D: (nh,) fp32; Bm, Cm: (B, S, ds) fp32 or
    bf16 (one dtype for both), shared by all heads. x, Bm and Cm may be
    strided views with a unit last stride (the model passes slices of its
    conv output). Returns a contiguous (B, S, nh, hd) in x's dtype. The
    kernel runs its own chunk of CHUNK steps: the result is chunk-invariant
    up to rounding."""
    return _launch("ssd_forward", x, dt, A, Bm, Cm, D, None, None)


def ssd_forward_state(x, dt, A, Bm, Cm, D, h0=None):
    """(y, h_final) of the chunked SSD from the initial state ``h0``
    ((B, nh, ds, hd) fp32 contiguous; None = a zero state): the serving
    chunks' form. The operands are those of ``ssd_forward``; h_final is
    the state after the last step, (B, nh, ds, hd) fp32. One launch,
    counted in ``launches`` with ``ssd_forward``'s."""
    B, _, nh, hd = x.shape
    h_final = torch.empty((B, nh, Bm.shape[-1], hd), dtype=torch.float32,
                          device=x.device)
    y = _launch("ssd_forward_state", x, dt, A, Bm, Cm, D, h0, h_final)
    return y, h_final
