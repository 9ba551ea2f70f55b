"""Wrapper of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``): warps own
rows, persistent blocks stride over them, and ``launch_plan`` sizes the
launch from the width and the row count.

The plain versions are ``kernels/ref.rmsnorm_ref`` (the ``tpu`` epilogue,
the TPU kernel's function) and ``kernels/ref.rms_norm`` (the ``model``
epilogue, the model's norm); ``kernels/ops.rms_norm`` picks between the
plain model form and the kernel by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

EPILOGUES = {"tpu": 0, "model": 1}
MAX_THREADS = 512   # csrc/rmsnorm.cu, kMaxThreads
MAX_VECTORS = 8     # the most vectors (or scalars) a lane holds
# the kernel's instantiations: warps per row, vectors (or scalars) per lane
WARPS_PER_ROW = (1, 2, 4, 8, 16)
VECTORS_PER_LANE = (1, 2, 4, 6, 8)
BLOCK_WARPS = 8       # warps per block when a row takes fewer
RESIDENT_WARPS = 16   # warps per SM the persistent grid is capped at
# fewer rows than SMs (decode): a row spreads over up to this many warps,
# one load a lane where the width allows, since a lone row per SM has no
# other rows to hide its arithmetic behind; its scale then sits in the
# lanes' registers when a lane holds at most REG_SCALE_VECTORS loads (the
# kernel's instantiations)
LATENCY_WARPS = 8
REG_SCALE_VECTORS = 2
launches = 0        # kernel launches since the last reset()


def reset() -> None:
    global launches  # verify: ignore[mutable-global] -- launch counter chip_smoke.py reads
    launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(T: int, d: int, itemsize: int, vec: bool,
                sm_count: int = 132) -> dict:
    """The kernel's launch for T rows of width d: ``lanes`` values per
    load (a 16-byte vector when ``vec``, else 1), the fewest warps per row
    (1, 2, 4, 8 or 16) that leave a lane at most 8 loads of the row (for
    fewer rows than SMs, up to ``LATENCY_WARPS`` for one load a lane), the
    loads per lane (rounded up to an instantiation), rows per block (up to
    8 warps' worth, fewer when T is small, so a few rows still spread over
    the SMs), the threads per block, and the persistent grid: one block
    per ``rows_per_block`` rows, at most ``RESIDENT_WARPS`` warps' worth
    per SM. scale_in_registers: for fewer rows than SMs (a block per row,
    at most ``REG_SCALE_VECTORS`` loads a lane) each lane loads its own
    part of the scale beside its part of the row, with no block barrier;
    otherwise a block shares the scale in shared memory (smem_bytes,
    fp32). Raises on a width above the kernel's limit (512 threads x 8
    loads of ``lanes`` values)."""
    lanes = 16 // itemsize if vec else 1
    if d <= 0 or d % lanes:
        raise ValueError(f"rmsnorm: width {d} is not a positive multiple "
                         f"of {lanes}")
    nvec = d // lanes
    if nvec > MAX_THREADS * MAX_VECTORS:
        raise ValueError(f"rmsnorm: width {d} exceeds the kernel's "
                         f"{MAX_THREADS * MAX_VECTORS * lanes}")
    wpr = next(w for w in WARPS_PER_ROW
               if _cdiv(nvec, 32 * w) <= MAX_VECTORS)
    if T < sm_count:
        wpr = max(wpr, next(w for w in WARPS_PER_ROW
                            if 32 * w >= nvec or w == LATENCY_WARPS))
    nv = next(v for v in VECTORS_PER_LANE if v >= _cdiv(nvec, 32 * wpr))
    groups = max(1, min(BLOCK_WARPS // wpr, _cdiv(T, sm_count)))
    warps = wpr * groups
    blocks = max(1, min(_cdiv(T, groups),
                        sm_count * max(1, RESIDENT_WARPS // warps)))
    regs = T < sm_count and nv <= REG_SCALE_VECTORS
    return {"lanes": lanes, "vectors": nvec, "warps_per_row": wpr,
            "vectors_per_lane": nv, "rows_per_block": groups,
            "threads": 32 * warps, "blocks": blocks,
            "scale_in_registers": regs, "smem_bytes": 0 if regs else 4 * d}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            epilogue: str = "tpu") -> torch.Tensor:
    """x: (T, d) fp32 or bf16, contiguous; scale: (d,) fp32 or x's dtype
    -> (T, d) in x's dtype, with fp32 statistics. ``epilogue``: "tpu"
    multiplies by the scale in fp32 and rounds once (the TPU kernel);
    "model" rounds the normalised row to x's dtype, multiplies by the scale
    rounded to x's dtype and rounds again (the model's norm)."""
    global launches  # verify: ignore[mutable-global] -- launch counter chip_smoke.py reads
    name = "rmsnorm"
    build.require_cuda(name, x, scale)
    code = build.dtype_code(name, x)
    if scale.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"{name}: scale must be fp32 or {x.dtype}, got "
                        f"{scale.dtype}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"{name}: unknown epilogue {epilogue!r}")
    if x.dim() != 2 or tuple(scale.shape) != (x.shape[1],):
        raise ValueError(f"{name}: x {tuple(x.shape)} and scale "
                         f"{tuple(scale.shape)} are not (T, d), (d,)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: x and scale must be contiguous")
    T, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    # 16-byte vectors where the width and every base allow, else values
    vec = (d % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
           and scale.data_ptr() % 16 == 0)
    plan = launch_plan(T, d, x.element_size(), vec,
                       build.sm_count(x.device.index or 0))
    lib = build.load()
    err = lib.lib.repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), T, d, float(eps),
        code, 0 if scale.dtype == torch.float32 else 1, EPILOGUES[epilogue],
        int(vec), plan["warps_per_row"], plan["vectors_per_lane"],
        plan["rows_per_block"], plan["blocks"],
        int(plan["scale_in_registers"]), build.stream_ptr(x))
    lib.check(name, err)
    launches += 1
    return out
