"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``"cuda"``, and with no GPU present they raise instead
of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        # fp32 products stay fp32 on the card: the router logits and the LM
        # logits are fp32 by contract, and TF32 would keep ~3 digits of them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def dtype_of(name: Optional[str]) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32", ...) -> torch.dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
