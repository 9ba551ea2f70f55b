"""Wrapper of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

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
MAX_VECTORS = 8     # the most vectors (or scalars) a thread holds, kNV
launches = 0        # kernel launches since the last reset()


def reset() -> None:
    global launches
    launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            epilogue: str = "tpu") -> torch.Tensor:
    """x: (T, d) fp32 or bf16, contiguous; scale: (d,) fp32 or x's dtype
    -> (T, d) in x's dtype, with fp32 statistics. ``epilogue``: "tpu"
    multiplies by the scale in fp32 and rounds once (the TPU kernel);
    "model" rounds the normalised row to x's dtype, multiplies by the scale
    rounded to x's dtype and rounds again (the model's norm)."""
    global launches
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
    lanes = 16 // x.element_size()
    if d % lanes:
        lanes = 1                  # the kernel's scalar path
    if d > MAX_THREADS * MAX_VECTORS * lanes:
        raise ValueError(f"{name}: width {d} exceeds the kernel's "
                         f"{MAX_THREADS * MAX_VECTORS * lanes}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = build.load()
    err = lib.lib.repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), T, d, float(eps),
        code, 0 if scale.dtype == torch.float32 else 1, EPILOGUES[epilogue],
        build.stream_ptr(x))
    lib.check(name, err)
    launches += 1
    return out
