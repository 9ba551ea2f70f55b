"""The grouped-GEMM wrapper's planning, in plain Python on the CPU: which
CUDA path a call takes (the wgmma kernel for aligned bf16 operands, the
general kernel otherwise) and the wgmma kernel's tiles, grid and ring at
the main paths' shapes. The kernels themselves run in the gpu-marked
tests/test_torch_cuda_kernels.py."""
import pytest
import torch

from repro_torch.kernels import grouped_gemm


def _operands(dtype=torch.bfloat16, E=2, M=5, K=64, N=72):
    return (torch.zeros((E, M, K), dtype=dtype),
            torch.zeros((E, K, N), dtype=dtype))


@pytest.mark.parametrize("M", [1, 4, 37, 160, 300])
def test_aligned_bf16_takes_the_hopper_path(M):
    """Ragged M included: rows past M arrive as zeros from TMA."""
    assert grouped_gemm.hopper_path(*_operands(M=M))


def test_aligned_column_slice_takes_the_hopper_path():
    """gemm2 on a column block of w_down: 1024 of 2048 columns from column
    1024 (2048 bytes in, 16-byte aligned), the row stride 2048."""
    h = torch.zeros((2, 5, 1408), dtype=torch.bfloat16)
    wd = torch.zeros((2, 1408, 2048), dtype=torch.bfloat16)[:, :, 1024:]
    assert grouped_gemm.hopper_path(h, wd)


@pytest.mark.parametrize("case", ["fp32", "K=68", "N=12", "N=100",
                                  "slice at 3", "lhs base 4 bytes in",
                                  "rows stride 68"])
def test_other_calls_take_the_general_path(case):
    kw = {"fp32": dict(dtype=torch.float32), "K=68": dict(K=68),
          "N=12": dict(N=12), "N=100": dict(N=100)}.get(case, {})
    lhs, rhs = _operands(**kw)
    if case == "slice at 3":            # 6 bytes past a 16-byte boundary
        rhs = torch.zeros((2, 64, 80), dtype=torch.bfloat16)[:, :, 3:75]
    if case == "lhs base 4 bytes in":   # two elements past its buffer
        lhs = torch.zeros((2, 5, 66), dtype=torch.bfloat16)[:, :, 2:]
    if case == "rows stride 68":        # rows of a wider buffer, 136 B apart
        lhs = torch.zeros((2, 5, 68), dtype=torch.bfloat16)[:, :, :64]
    assert not grouped_gemm.hopper_path(lhs, rhs)


def test_expanded_operand_takes_the_general_path():
    """A stride-0 expert axis (an expanded view) is no tensor map."""
    lhs, _ = _operands()
    rhs = torch.zeros((1, 64, 72), dtype=torch.bfloat16).expand(2, 64, 72)
    assert not grouped_gemm.hopper_path(lhs, rhs)


# (E, M, N): qwen2-moe-2.7b's gemm1 (N = f 1408) and gemm2 (N = d 2048) at
# a 2048-token prefill step (C = 160 rows per expert) and at decode (8
# slots, top-4: C = 4), gemm2 on a column block of 1024, a ragged M and an
# M past one tile; the tile width, m_tiles, n_tiles, blocks, fragments and
# stages on an H100 (132 SMs)
@pytest.mark.parametrize("shape,bn,m_tiles,n_tiles,blocks,frags,stages", [
    ((64, 160, 1408), 256, 1, 6, 132, 3, 4),
    ((64, 160, 2048), 256, 1, 8, 132, 3, 4),
    ((64, 4, 1408), 256, 1, 6, 132, 1, 5),
    ((64, 4, 2048), 256, 1, 8, 132, 1, 5),
    ((64, 160, 1024), 256, 1, 4, 132, 3, 4),
    ((64, 37, 1408), 256, 1, 6, 132, 1, 5),
    ((64, 256, 1408), 128, 1, 11, 132, 4, 4),
    ((64, 320, 1408), 128, 2, 11, 132, 4, 4),
    ((2, 5, 72), 256, 1, 1, 2, 1, 5),
])
def test_hopper_plan_at_the_main_shapes(shape, bn, m_tiles, n_tiles, blocks,
                                        frags, stages):
    E, M, N = shape
    plan = grouped_gemm.hopper_plan(E, M, N, sm_count=132)
    assert (plan["bn"], plan["m_tiles"], plan["n_tiles"], plan["blocks"],
            plan["frags"], plan["stages"]) == (bn, m_tiles, n_tiles, blocks,
                                               frags, stages)
    assert plan["tiles"] == E * m_tiles * n_tiles
    # every row of an expert up to 256 in one tile: each rhs byte leaves
    # device memory once per 256 rows
    assert (m_tiles - 1) * 256 < M <= m_tiles * 256
    assert (n_tiles - 1) * bn < N <= n_tiles * bn
    assert frags * 64 >= min(M, 256)
    # a warpgroup's sums in registers: at most three m64 fragments of 128
    # columns or four of 64
    assert frags * bn // 2 <= 3 * 128
    # the ring fits the 227 KB a block may use, with at least 4 stages and
    # at least 64 KB of rhs in flight per SM
    assert plan["smem_bytes"] <= 232448
    assert plan["stages"] >= 4
    assert plan["stages"] * (bn // 64) * 64 * 128 >= 64 * 1024


def test_hopper_plan_grid_never_exceeds_the_tiles_or_the_sms():
    for sms in (1, 78, 132):
        for E, M, N in ((1, 4, 128), (64, 160, 1408), (3, 37, 200)):
            plan = grouped_gemm.hopper_plan(E, M, N, sm_count=sms)
            assert plan["blocks"] == min(plan["tiles"], sms)
