"""Wrapper of the Mamba-2 SSD CUDA kernels.

Two CUDA paths, chosen by the operands before the launch
(``hopper_path``): bf16 x, B and C with 16-byte aligned bases and strides,
head_dim a multiple of 32 and d_state a multiple of 16 up to 128, fp32 dt,
A and D (mamba2-780m's and jamba-v0.1-52b's SSM layers, as the model passes
them) take the tensor-core kernel (``csrc/ssd_hopper.cu``: one block per
(batch, head, slab of HOPPER_SLAB head_dim columns)); every other call the
general kernel (``csrc/ssd.cu``).
``launches`` counts one per call on either path, ``hopper_launches`` the
tensor-core path's share.

The plain versions are ``kernels/ref.ssd_chunked_ref`` (the chunked dual
form from a zero state, y only) and ``kernels/ref.ssd_state_ref`` (from a
given state, with the final state); ``kernels/ops.py`` picks between kernel
and plain version by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

CHUNK = 64          # the kernel's own chunk (csrc/ssd.cu, kQ)
MAX_STATE = 128     # d_state the kernels' shared-memory tiles hold
MAX_HEAD_DIM = 64   # head_dim the general kernel holds
# kernel launches since the last reset(), and the tensor-core path's share
launches = 0
hopper_launches = 0

# The tensor-core kernel (csrc/ssd_hopper.cu): a block of 128 threads owns
# a slab of HOPPER_SLAB head_dim columns of one (batch, head) (its kP);
# each fp32 operand of its products is split into HOPPER_TERMS bf16 terms
# (its kTerms).
HOPPER_SLAB = 32
HOPPER_TERMS = 2
# Its precision rule, against the fp64 sequential oracle
# (ref.ssd_ref(..., acc=torch.float64)) over seeded draws: y's max error at
# most ORACLE_MAX_RATIO x the general kernel's and its pooled rel L2 at
# most ORACLE_L2_RATIO x; h_final's pooled rel L2 at most ORACLE_STATE_L2.
# Two terms leave at most 2^-18 of each fp32 operand, so y stays the
# general kernel's to about 1e-6 and h_final near 2^-18; with one term
# (ref.ssd_split_ref(..., terms=1)) y's rel L2 is about 1.4x the general
# kernel's and h_final's about 2^-9, so each margin tells one term from two.
ORACLE_MAX_RATIO = 2.0
ORACLE_L2_RATIO = 1.1
ORACLE_STATE_L2 = 2.0 ** -16


def reset() -> None:
    global launches, hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    launches = hopper_launches = 0


def _aligned(t: torch.Tensor) -> bool:
    """bf16, a 16-byte aligned base, a unit last stride and every other
    stride (of a dimension longer than 1) a multiple of 8 elements."""
    return (t.dtype == torch.bfloat16 and t.stride(-1) == 1
            and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for n, st in zip(t.shape[:-1],
                                                 t.stride()[:-1]) if n > 1))


def hopper_path(x, dt, A, Bm, Cm, D, h0=None) -> bool:
    """Whether a call takes the tensor-core kernel: x, Bm and Cm bf16 and
    aligned (``_aligned``: strided slices of the conv output qualify), dt,
    A and D fp32, head_dim a multiple of HOPPER_SLAB and d_state a
    multiple of 16 up to 128, an initial state (if any) 8-byte aligned
    (the kernel moves it in pairs of fp32). Decided from the operands
    alone, before any launch; the other calls take the general kernel."""
    if x.dim() != 4 or Bm.dim() != 3:
        return False
    hd, ds = x.shape[3], Bm.shape[-1]
    if hd <= 0 or hd % HOPPER_SLAB or ds <= 0 or ds % 16 or ds > MAX_STATE:
        return False
    return (all(t.dtype == torch.float32 for t in (dt, A, D))
            and all(_aligned(t) for t in (x, Bm, Cm))
            and (h0 is None or h0.data_ptr() % 8 == 0))


def _launch(name, x, dt, A, Bm, Cm, D, h0, h_final) -> torch.Tensor:
    """Check the operands, launch the kernel, return y (B, S, nh, hd)."""
    global launches, hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
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
    hopper = hopper_path(x, dt, A, Bm, Cm, D, h0)
    if not (hopper or (0 < ds <= MAX_STATE and 0 < hd <= MAX_HEAD_DIM)):
        raise ValueError(f"{name}: d_state {ds} / head_dim {hd} exceed the "
                         f"general kernel's {MAX_STATE} / {MAX_HEAD_DIM}")
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
    args = (x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
            dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
            A.data_ptr(), Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
            Cm.data_ptr(), Cm.stride(0), Cm.stride(1), D.data_ptr(),
            y.data_ptr(), None if h0 is None else h0.data_ptr(),
            None if h_final is None else h_final.data_ptr(),
            B, S, nh, hd, ds)
    if hopper:
        err = lib.lib.repro_ssd_forward_hopper(*args, build.stream_ptr(x))
    else:
        err = lib.lib.repro_ssd_forward(*args, xcode, bcode,
                                        build.stream_ptr(x))
    lib.check(name, err)
    launches += 1
    hopper_launches += hopper
    return y


def ssd_forward(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """y of the chunked SSD from a zero state. x: (B, S, nh, hd) fp32 or
    bf16; dt: (B, S, nh) fp32; A, D: (nh,) fp32; Bm, Cm: (B, S, ds) fp32 or
    bf16 (one dtype for both), shared by all heads. x, Bm and Cm may be
    strided views with a unit last stride (the model passes slices of its
    conv output). Returns a contiguous (B, S, nh, hd) in x's dtype. The
    kernels run their own chunk of CHUNK steps: the result is
    chunk-invariant up to rounding. Calls that ``hopper_path`` accepts take
    the tensor-core kernel, the others the general one."""
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
