"""Wrapper of the flash-attention CUDA kernels.

Two CUDA paths, chosen by the operands before the launch
(``hopper_path``): bf16 q, k, v with head_dim 64 or 128, 16-byte aligned
bases and strides that are multiples of 8 elements (every main-path call)
take the wgmma kernel (``csrc/flash_attention_hopper.cu``); fp32 and other
head widths the general kernel (``csrc/flash_attention.cu``).

The plain version is ``kernels/ref.flash_attention_ref``;
``kernels/ops.py`` picks between kernel and plain version by the tensors'
device. ``launches`` counts both paths, ``hopper_launches`` the wgmma
path's share.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128
HOPPER_HEAD_DIMS = (64, 128)
# kernel launches since the last reset(), and the wgmma path's share
launches = 0
hopper_launches = 0


def reset() -> None:
    global launches, hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    launches = hopper_launches = 0


def hopper_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a call takes the wgmma kernel: q, k, v bf16 with head_dim
    64 or 128, 16-byte aligned bases, a unit last stride and the other
    strides multiples of 8 elements. Decided from the operands alone,
    before the launch; the other calls take the general kernel."""
    if q.shape[-1] not in HOPPER_HEAD_DIMS:
        return False
    return all(t.dtype == torch.bfloat16 and t.stride(-1) == 1
               and t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:-1])
               for t in (q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd), fp32 or bf16, any strides
    with a unit last one (the model passes transposed views of its
    (B, S, H, hd) tensors). Returns (B, Hq, Sq, hd) in q's dtype: a view of
    a contiguous (B, Sq, Hq, hd) tensor. Causal masking compares positions
    from 0 of queries and keys, as the TPU kernel does."""
    global launches, hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    name = "flash_attention"
    build.require_cuda(name, q, k, v)
    code = build.dtype_code(name, q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, H, S, hd)")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (GQA needs Hq a "
                         f"multiple of Hkv)")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} not in 1..{MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v need a unit last stride")
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out.transpose(1, 2)
    if Sk == 0:
        raise ValueError(f"{name}: no keys")
    lib = build.load()
    args = (q.data_ptr(), q.stride(0), q.stride(2), q.stride(1),
            k.data_ptr(), k.stride(0), k.stride(2), k.stride(1),
            v.data_ptr(), v.stride(0), v.stride(2), v.stride(1),
            out.data_ptr(), B, Hq, Hkv, Sq, Sk, hd, int(causal))
    hopper = hopper_path(q, k, v)
    if hopper:
        err = lib.lib.repro_flash_attention_hopper(*args,
                                                   build.stream_ptr(q))
    else:
        err = lib.lib.repro_flash_attention(*args, code,
                                            build.stream_ptr(q))
    lib.check(name, err)
    launches += 1
    hopper_launches += hopper
    return out.transpose(1, 2)
