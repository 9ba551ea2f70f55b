"""Wrapper of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

The plain version is ``kernels/ref.flash_attention_ref``;
``kernels/ops.py`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128
launches = 0        # kernel launches since the last reset()


def reset() -> None:
    global launches
    launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd), fp32 or bf16, any strides
    with a unit last one (the model passes transposed views of its
    (B, S, H, hd) tensors). Returns (B, Hq, Sq, hd) in q's dtype: a view of
    a contiguous (B, Sq, Hq, hd) tensor. Causal masking compares positions
    from 0 of queries and keys, as the TPU kernel does."""
    global launches
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
    err = lib.lib.repro_flash_attention(
        q.data_ptr(), q.stride(0), q.stride(2), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(2), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(2), v.stride(1),
        out.data_ptr(), B, Hq, Hkv, Sq, Sk, hd, int(causal), code,
        build.stream_ptr(q))
    lib.check(name, err)
    launches += 1
    return out.transpose(1, 2)
