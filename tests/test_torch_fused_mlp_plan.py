"""The fused-MLP wrappers' planning, in plain Python on the CPU: which CUDA
path a call takes (the wgmma kernels for aligned bf16 operands, the
general kernels otherwise), the wgmma forward's split of the hidden at the
main paths' shapes, and both kernels' scratch. The kernels themselves run
in the gpu-marked tests/test_torch_cuda_kernels.py."""
import pytest
import torch

from repro_torch.kernels import fused_mlp


def _operands(dtype=torch.bfloat16, E=2, R=5, d=64, f=136, N=72, glu=True):
    x = torch.zeros((E, R, d), dtype=dtype)
    wg = torch.zeros((E, d, f), dtype=dtype) if glu else None
    wu = torch.zeros((E, d, f), dtype=dtype)
    wd = torch.zeros((E, f, N), dtype=dtype)
    dy = torch.zeros((E, R, N), dtype=dtype)
    return x, wg, wu, wd, dy


@pytest.mark.parametrize("glu", [True, False])
def test_aligned_bf16_takes_the_hopper_path(glu):
    x, wg, wu, wd, dy = _operands(glu=glu)
    assert fused_mlp.hopper_path(x, wg, wu, wd)
    assert fused_mlp.hopper_path(x, wg, wu, wd, dy)


@pytest.mark.parametrize("case", ["fp32", "d=17", "f=19", "N=12",
                                  "slice at 3", "rows stride 68"])
def test_other_calls_take_the_general_path(case):
    kw = {"fp32": dict(dtype=torch.float32), "d=17": dict(d=17),
          "f=19": dict(f=19), "N=12": dict(N=12)}.get(case, {})
    x, wg, wu, wd, dy = _operands(**kw)
    if case == "slice at 3":            # 6 bytes past a 16-byte boundary
        wd = torch.zeros((2, 136, 80), dtype=torch.bfloat16)[:, :, 3:75]
        dy = torch.zeros((2, 5, 80), dtype=torch.bfloat16)[:, :, 3:75]
    if case == "rows stride 68":        # rows of a wider buffer, 136 B apart
        x = torch.zeros((2, 5, 68), dtype=torch.bfloat16)[:, :, :64]
    assert not fused_mlp.hopper_path(x, wg, wu, wd)
    assert not fused_mlp.hopper_path(x, wg, wu, wd, dy)


def test_aligned_column_slice_takes_the_hopper_path():
    """ops.fused_mlp's column blocks of w_down: 512 columns into 2048 is
    1024 bytes, 16-byte aligned."""
    x, wg, wu, _, _ = _operands()
    wd = torch.zeros((2, 136, 2048), dtype=torch.bfloat16)[:, :, 512:1536]
    dy = torch.zeros((2, 5, 2048), dtype=torch.bfloat16)[:, :, 512:1536]
    assert fused_mlp.hopper_path(x, wg, wu, wd, dy)


# (E, R, d, f, N): qwen2-moe-2.7b's decode (8 slots, top-4, 64 experts ->
# 4 rows per expert), prefill (a 2048-token step at capacity factor 1.25)
# and train (4096 tokens: 320 rows) shapes, and jamba-v0.1-52b's expert
# width at 320 rows; F_s, S, blocks and the fp32 partials' bytes on an H100
# (132 SMs)
@pytest.mark.parametrize("shape,fs,splits,blocks,scratch", [
    ((64, 4, 2048, 1408, 2048), 256, 6, 384, 6 * 64 * 4 * 2048 * 4),
    ((64, 160, 2048, 1408, 2048), 768, 2, 384, 167_772_160),
    ((64, 320, 2048, 1408, 2048), 768, 2, 640, 335_544_320),
    ((16, 320, 4096, 14336, 4096), 768, 19, 1520, 1_593_835_520),
])
def test_forward_plan_at_the_main_shapes(shape, fs, splits, blocks, scratch):
    plan = fused_mlp.fused_mlp_plan(*shape, sm_count=132)
    assert plan == {"fs": fs, "splits": splits, "blocks": blocks,
                    "scratch_bytes": scratch}
    # at least two waves of blocks, and each split within shared memory
    assert plan["blocks"] >= 2 * 132
    assert plan["fs"] % 128 == 0 and plan["fs"] <= 768
    E, R, d, f, N = shape
    assert (plan["splits"] - 1) * plan["fs"] < f <= plan["splits"] * fs


def test_forward_plan_shrinks_the_scratch_against_the_general_path():
    """At jamba's width the general path keeps 112 planes (9.4 GB at 320
    rows), the wgmma path 19 (1.6 GB); at the prefill shape 11 against 2."""
    assert fused_mlp.general_scratch_bytes(16, 320, 14336, 4096) == \
        112 * 16 * 320 * 4096 * 4
    assert fused_mlp.general_scratch_bytes(64, 160, 1408, 2048) == \
        11 * 64 * 160 * 2048 * 4
    plan = fused_mlp.fused_mlp_plan(64, 160, 2048, 1408, 2048)
    assert plan["splits"] == 2


def test_forward_plan_few_experts_split_finer():
    """With few blocks per split the plan lowers F_s down to 128."""
    plan = fused_mlp.fused_mlp_plan(3, 150, 200, 640, 136)
    assert (plan["fs"], plan["splits"], plan["blocks"]) == (128, 5, 45)


@pytest.mark.parametrize("glu,scratch", [(True, 173_015_040),
                                         (False, 115_343_360)])
def test_wgrad_scratch_at_the_train_shape(glu, scratch):
    """h, dup (and dgate) in bf16: 173 MB at the train shape, against the
    general path's 2.2 GB of fp32 running sums."""
    assert fused_mlp.wgrad_scratch_bytes(64, 320, 1408, glu) == scratch


@pytest.mark.parametrize("glu,scratch", [(True, 115_343_360),
                                         (False, 57_671_680)])
def test_dgrad_scratch_at_the_train_shape(glu, scratch):
    """dup (and dgate) in bf16: 115 MB at the train shape for swiglu,
    against the general path's 1.85 GB of fp32 dX partials (one (E, R, d)
    plane per 128 hidden columns: 11 at f = 1408)."""
    assert fused_mlp.dgrad_scratch_bytes(64, 320, 1408, glu) == scratch
    assert fused_mlp.general_scratch_bytes(64, 320, 1408, 2048) == \
        11 * 64 * 320 * 2048 * 4 == 1_845_493_760


def test_dgrad_column_block_takes_the_hopper_path():
    """_mlp_bwd's column blocks at qwen2's width: col_slice=(1024, 1024) of
    w_down and dy, 2048 bytes in, aligned; the same predicate as wgrad's
    decides for dgrad."""
    x, wg, wu, _, _ = _operands(d=2048, f=1408)
    wd = torch.zeros((2, 1408, 2048), dtype=torch.bfloat16)[:, :, 1024:]
    dy = torch.zeros((2, 5, 2048), dtype=torch.bfloat16)[:, :, 1024:]
    assert fused_mlp.hopper_path(x, wg, wu, wd, dy)
    assert not fused_mlp.hopper_path(x.float(), wg.float(), wu.float(),
                                     wd.float(), dy.float())
