"""Wrapper of the grouped GEMM CUDA kernels.

Two CUDA paths, chosen by the operands before the launch
(``hopper_path``): bf16 operands with 16-byte aligned bases and strides
and K, N multiples of 8 (every main-path call, column slices of w_down
included) take the wgmma kernel (``csrc/grouped_gemm_hopper.cu``), whose
tiling ``hopper_plan`` decides; fp32 and other calls the general kernel
(``csrc/grouped_gemm.cu``).

The plain version is ``kernels/ref.grouped_gemm_ref``; ``kernels/ops.py``
picks between the two by the tensors' device. ``launches`` counts both
paths, ``hopper_launches`` the wgmma path's share.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

ORDERS = {"expert_major": 0, "n_major": 1}
# kernel launches since the last reset(), and the wgmma path's share
launches = 0
hopper_launches = 0

# The wgmma kernel's tiling (csrc/grouped_gemm_hopper.cu): a tile is one
# expert's 256 output columns (128 when it has four fragments: their sums
# would not fit the registers) by up to 256 rows, m64 fragments of them,
# each of two consumer warpgroups on half the columns; a ring stage holds
# one 64-deep K slice of the tile's lhs rows (one 8 KB panel per fragment)
# and of its rhs columns (one panel per 64), as many stages as fit the
# 227 KB a block may use, at most 8.
HOPPER_BN, HOPPER_BN_WIDE, HOPPER_MAX_WIDE_FRAGS = 128, 256, 3
HOPPER_FRAG, HOPPER_MAX_FRAGS = 64, 4
HOPPER_PANEL = 64 * 128
HOPPER_SMEM_MAX = 232448
HOPPER_MAX_STAGES = 8
HOPPER_BAR_BYTES = 2 * HOPPER_MAX_STAGES * 8


def reset() -> None:
    global launches, hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    launches = hopper_launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def hopper_path(lhs: torch.Tensor, rhs: torch.Tensor) -> bool:
    """Whether a call takes the wgmma kernel: both operands bf16 with a
    16-byte aligned base, a unit last stride and positive leading strides
    that are multiples of 8 elements, and K, N positive multiples of 8 (a
    column slice of w_down qualifies when its first column is a multiple
    of 8). Decided from the operands alone, before any launch; the other
    calls take the general kernel."""
    K, N = lhs.shape[2], rhs.shape[2]
    if min(K, N) <= 0 or K % 8 or N % 8:
        return False
    return all(t.dtype == torch.bfloat16 and t.stride(-1) == 1
               and t.data_ptr() % 16 == 0
               and all(s > 0 and s % 8 == 0 for s in t.stride()[:-1])
               for t in (lhs, rhs))


def hopper_plan(E: int, M: int, N: int, sm_count: int = 132) -> dict:
    """The wgmma kernel's launch: m_tiles of up to 256 rows (each rhs
    byte leaves device memory once per M tile, so once for M <= 256),
    ``frags`` m64 fragments a stage holds lhs panels for (every row of the
    expert up to 256), n_tiles of ``bn`` columns (256, or 128 at four
    fragments), one persistent block per SM (at most one per tile)
    walking the tiles, and the ring's stages and shared-memory bytes."""
    bm = HOPPER_FRAG * HOPPER_MAX_FRAGS
    frags = min(HOPPER_MAX_FRAGS, _cdiv(M, HOPPER_FRAG))
    bn = HOPPER_BN_WIDE if frags <= HOPPER_MAX_WIDE_FRAGS else HOPPER_BN
    m_tiles, n_tiles = _cdiv(M, bm), _cdiv(N, bn)
    slot = (frags + bn // 64) * HOPPER_PANEL
    stages = min(HOPPER_MAX_STAGES,
                 (HOPPER_SMEM_MAX - 1024 - HOPPER_BAR_BYTES) // slot)
    tiles = E * m_tiles * n_tiles
    return {"m_tiles": m_tiles, "n_tiles": n_tiles, "tiles": tiles,
            "blocks": min(tiles, sm_count), "bn": bn, "frags": frags,
            "stages": stages,
            "smem_bytes": 1024 + stages * slot + HOPPER_BAR_BYTES}


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor,
                 order: str = "expert_major") -> torch.Tensor:
    """lhs: (E, M, K); rhs: (E, K, N) -> (E, M, N) in the inputs' dtype,
    fp32 accumulation. Both operands need a unit last stride; their other
    strides are free (a column slice of rhs is taken as it is)."""
    global launches, hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
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
    hopper = hopper_path(lhs, rhs)
    if hopper:
        plan = hopper_plan(E, M, N, build.sm_count(lhs.device.index or 0))
        err = lib.lib.repro_grouped_gemm_hopper(
            lhs.data_ptr(), lhs.stride(0), lhs.stride(1),
            rhs.data_ptr(), rhs.stride(0), rhs.stride(1), out.data_ptr(),
            E, M, K, N, ORDERS[order], plan["bn"], plan["frags"],
            plan["stages"], plan["blocks"], build.stream_ptr(lhs))
    else:
        err = lib.lib.repro_grouped_gemm(
            lhs.data_ptr(), lhs.stride(0), lhs.stride(1),
            rhs.data_ptr(), rhs.stride(0), rhs.stride(1), out.data_ptr(),
            E, M, K, N, ORDERS[order], code, build.stream_ptr(lhs))
    lib.check(name, err)
    launches += 1
    hopper_launches += hopper
    return out
