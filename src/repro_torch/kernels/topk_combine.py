"""Wrapper of the top-k combine CUDA kernel (``csrc/topk_combine.cu``).

The plain version is ``kernels/ref.topk_combine_ref``; ``kernels/ops.py``
picks between the two by the tensors' device. The kernel sums in j order
(``ref.topk_combine_ordered`` gives its bits); ``launch_plan`` sizes its
launch.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

launches = 0        # kernel launches since the last reset()

# the k with an instance of their own (mixtral, phi3.5 and jamba 2; qwen2
# 4; granite and qwen3 8); other k take the generic one
TEMPLATED_K = (2, 4, 8)
_CODES = {torch.float32: 0, torch.bfloat16: 1}
# block sizes, largest first: the plan takes the largest that still gives
# two blocks per SM
BLOCK_THREADS = (256, 128, 64, 32)


def reset() -> None:
    global launches  # verify: ignore[mutable-global] -- launch counter chip_smoke.py reads
    launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def launch_plan(T: int, k: int, d: int, itemsize: int = 2, vec: bool = True,
                sm_count: int = 132) -> dict:
    """The kernel's launch for (T, k, d): ``pieces`` per row (16 bytes each
    when ``vec``, else one element), ``per`` pieces per thread (two at
    k <= 2 when the rows fill the card's threads at one, so a thread keeps
    four loads in flight), ``threads`` per block (the largest of
    BLOCK_THREADS that gives T * col_blocks >= 2 * sm_count, no wider than
    a row needs; else the smallest) and ``col_blocks`` blocks per row; the
    grid is (T, col_blocks). ``instance`` is the kernel's k template, or
    "generic"."""
    pieces = d * itemsize // 16 if vec else d
    per = 2 if vec and k <= 2 and T * pieces >= 2048 * sm_count else 1
    row_threads = max(32, _cdiv(_cdiv(pieces, per), 32) * 32)
    threads = next((t for t in BLOCK_THREADS if t <= row_threads
                    and T * _cdiv(pieces, t * per) >= 2 * sm_count),
                   BLOCK_THREADS[-1])
    col_blocks = _cdiv(pieces, threads * per)
    return {"vec": vec, "pieces": pieces, "per": per, "threads": threads,
            "col_blocks": col_blocks, "blocks": T * col_blocks,
            "instance": k if vec and k in TEMPLATED_K else "generic"}


def topk_combine(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """rows: (T, k, d) fp32 or bf16; weights: (T, k) fp32 -> (T, d) in the
    rows' dtype, summed in fp32 in j order. The checks are those of every
    wrapper, written for a call of a few microseconds (decode calls it
    once per MoE layer and token step)."""
    global launches  # verify: ignore[mutable-global] -- launch counter chip_smoke.py reads
    name = "topk_combine"
    dev = rows.device
    if dev.type != "cuda" or weights.device != dev:
        build.require_cuda(name, rows, weights)        # raises
    code = _CODES.get(rows.dtype)
    if code is None:
        build.dtype_code(name, rows)                   # raises
    if weights.dtype != torch.float32:
        raise TypeError(f"{name}: weights must be fp32, got {weights.dtype}")
    if rows.dim() != 3 or weights.shape != rows.shape[:2]:
        raise ValueError(f"{name}: rows {tuple(rows.shape)} and weights "
                         f"{tuple(weights.shape)} are not (T, k, d), (T, k)")
    if not (rows.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"{name}: rows and weights must be contiguous")
    T, k, d = rows.shape
    out = torch.empty((T, d), dtype=rows.dtype, device=dev)
    if out.numel() == 0:
        return out
    isz = 2 if code else 4
    vec = ((d * isz) % 16 == 0 and rows.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    plan = launch_plan(T, k, d, isz, vec, build.sm_count(dev.index or 0))
    lib = build.load()
    err = lib.lib.repro_topk_combine(
        rows.data_ptr(), weights.data_ptr(), out.data_ptr(), T, k, d, code,
        vec, plan["threads"], plan["per"], plan["col_blocks"],
        build.stream_ptr(rows))
    if err:
        lib.check(name, err)
    launches += 1
    return out
