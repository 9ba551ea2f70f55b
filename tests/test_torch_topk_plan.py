"""The top-k combine kernel's launch plan and its summation order, in plain
Python on the CPU.

``topk_combine.launch_plan`` covers every row with whole 16-byte pieces
(or single elements where the width or base rules them out), spreads a
row over several blocks when T is small (decode), and picks the kernel's
instance for k in (2, 4, 8). ``ref.topk_combine_ordered`` is the kernel's
j-order sum, whose bits the kernel gives on the card (gpu-marked
tests/test_torch_cuda_kernels.py); here it is held against the JAX Pallas
kernel in interpret mode.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk_combine as jtc
from repro_torch.kernels import ref, topk_combine

TS = (1, 3, 8, 37, 1000, 2048, 4096)
KS = (1, 2, 4, 6, 8)
DS = (64, 100, 896, 1408, 2048, 3000, 4096)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("vec", [True, False])
def test_plan_covers_every_row_with_whole_pieces(itemsize, vec):
    for T, k, d in itertools.product(TS, KS, DS):
        if vec and (d * itemsize) % 16:
            continue
        p = topk_combine.launch_plan(T, k, d, itemsize, vec)
        span = p["threads"] * p["per"]
        assert p["pieces"] * (16 if vec else itemsize) == d * itemsize
        assert p["col_blocks"] * span >= p["pieces"] > \
            (p["col_blocks"] - 1) * span, (T, k, d, p)
        assert p["blocks"] == T * p["col_blocks"]
        assert p["threads"] in topk_combine.BLOCK_THREADS
        assert p["per"] in (1, 2) and (vec or p["per"] == 1)


@pytest.mark.parametrize("d", [2048, 4096])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_decode_spreads_rows_over_blocks(d, k):
    """At T = 8 (decode, 8 slots) a row is spread over several blocks:
    more than 8 blocks issue loads."""
    assert topk_combine.launch_plan(8, k, d)["blocks"] > 8


def test_prefill_plan():
    """At a 2048-token prefill step (qwen2: k 4, d 2048) one block of 256
    threads per row, a piece each; at k = 2 two pieces a thread."""
    p = topk_combine.launch_plan(2048, 4, 2048)
    assert (p["threads"], p["per"], p["col_blocks"]) == (256, 1, 1)
    assert topk_combine.launch_plan(2048, 2, 2048)["per"] == 2


@pytest.mark.parametrize("k", KS)
def test_instance_by_k(k):
    want = k if k in topk_combine.TEMPLATED_K else "generic"
    assert topk_combine.launch_plan(2048, k, 2048)["instance"] == want
    assert topk_combine.launch_plan(5, k, 100, 2, False)["instance"] \
        == "generic"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4, 6, 8])
def test_ordered_sum_matches_jax(dtype, k):
    """The j-order sum against the JAX kernel (interpret mode) and the
    port's plain version, at the repo's tolerances."""
    rng = np.random.default_rng(k)
    rows = rng.standard_normal((37, k, 96), dtype=np.float32)
    w = rng.random((37, k), dtype=np.float32)
    tdt = getattr(torch, dtype)
    trows = torch.from_numpy(rows).to(tdt)
    got = ref.topk_combine_ordered(trows, torch.from_numpy(w))
    want = jtc.topk_combine(jnp.asarray(rows).astype(getattr(jnp, dtype)),
                            jnp.asarray(w), interpret=True)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(
        got.float().numpy(),
        ref.topk_combine_ref(trows, torch.from_numpy(w)).float().numpy(),
        rtol=tol, atol=tol)
