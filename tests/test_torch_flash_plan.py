"""The flash-attention wrapper's path choice, in plain Python on the CPU:
bf16 q, k, v with head_dim 64 or 128, aligned bases and strides that are
multiples of 8 elements take the wgmma kernel; the rest the general one.
The kernels themselves run in the gpu-marked
tests/test_torch_cuda_kernels.py."""
import pytest
import torch

from repro_torch.kernels import flash_attention


def _views(B=2, S=7, Hq=4, Hkv=2, hd=128, dtype=torch.bfloat16, width=None):
    """q, k, v as the model passes them: (B, H, S, hd) transposed views of
    (B, S, H, width) buffers cut to hd columns."""
    width = width or hd

    def make(H):
        return torch.zeros((B, S, H, width), dtype=dtype)[..., :hd] \
            .transpose(1, 2)
    return make(Hq), make(Hkv), make(Hkv)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)])
def test_aligned_bf16_views_take_the_hopper_path(hd, heads):
    q, k, v = _views(Hq=heads[0], Hkv=heads[1], hd=hd)
    assert flash_attention.hopper_path(q, k, v)


@pytest.mark.parametrize("case", ["fp32", "hd 96", "hd 80", "hd 32",
                                  "row stride 132", "base 4 bytes in"])
def test_other_calls_take_the_general_path(case):
    kw = {"fp32": dict(dtype=torch.float32), "hd 96": dict(hd=96),
          "hd 80": dict(hd=80), "hd 32": dict(hd=32),
          "row stride 132": dict(width=132)}.get(case, {})
    q, k, v = _views(**kw)
    if case == "base 4 bytes in":           # k two elements past its buffer
        k = torch.zeros((2, 7, 2, 136), dtype=torch.bfloat16)[..., 2:130] \
            .transpose(1, 2)
    assert not flash_attention.hopper_path(q, k, v)


def test_the_train_shape_takes_the_hopper_path():
    """qwen2-moe-2.7b's training attention: (4, 1024, 16, 128) views."""
    q, k, v = _views(B=4, S=1024, Hq=16, Hkv=16)
    assert flash_attention.hopper_path(q, k, v)
