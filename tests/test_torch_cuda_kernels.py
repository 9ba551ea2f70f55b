"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes: every activation, both orders, a column slice, fp32
(1e-4, TF32 off) and bf16 (2e-2); the backward pair (dgrad, wgrad) also
at two row tiles and through ops.fused_mlp's autograd. Needs an NVIDIA
Hopper GPU and nvcc; skips elsewhere. On the card:

  python -m pytest -m gpu tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, device="cuda", generator=gen)
            * scale).to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("R,order,col", [(3, "expert_major", None),
                                         (37, "n_major", (40, 72)),
                                         (70, "expert_major", (0, 136))])
def test_fused_mlp(cuda, dtype, act, R, order, col):
    from repro_torch.kernels import fused_mlp, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(R)
    E, d, f, N = 3, 200, 136, 136
    x = _randn(gen, (E, R, d), dtype)
    wg = (_randn(gen, (E, d, f), dtype, d ** -0.5)
          if act in ("swiglu", "geglu") else None)
    wu = _randn(gen, (E, d, f), dtype, d ** -0.5)
    wd = _randn(gen, (E, f, N), dtype, f ** -0.5)
    if col is not None:
        wd = wd[:, :, col[0]:col[0] + col[1]]
    got = fused_mlp.fused_mlp(x, wg, wu, wd, act, order=order)
    _close(got, ref.fused_mlp_ref(x, wg, wu, wd, act), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", ["expert_major", "n_major"])
@pytest.mark.parametrize("E,M,K,N", [(3, 37, 72, 200), (2, 4, 2048, 64)])
def test_grouped_gemm(cuda, dtype, order, E, M, K, N):
    from repro_torch.kernels import grouped_gemm, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M)
    lhs = _randn(gen, (E, M, K), dtype)
    rhs = _randn(gen, (E, K, N), dtype, K ** -0.5)
    got = grouped_gemm.grouped_gemm(lhs, rhs, order=order)
    _close(got, ref.grouped_gemm_ref(lhs, rhs), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,k,d", [(5, 4, 2048), (33, 2, 100), (1, 8, 3000)])
def test_topk_combine(cuda, dtype, T, k, d):
    from repro_torch.kernels import ref, topk_combine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(T)
    rows = _randn(gen, (T, k, d), dtype)
    w = torch.rand((T, k), device="cuda", generator=gen)
    _close(topk_combine.topk_combine(rows, w),
           ref.topk_combine_ref(rows, w), dtype)


def _mlp_operands(gen, dtype, act, E, R, d, f, N, col):
    x = _randn(gen, (E, R, d), dtype)
    wg = (_randn(gen, (E, d, f), dtype, d ** -0.5)
          if act in ("swiglu", "geglu") else None)
    wu = _randn(gen, (E, d, f), dtype, d ** -0.5)
    wd = _randn(gen, (E, f, N), dtype, f ** -0.5)
    dy = _randn(gen, (E, R, N), dtype)
    if col is not None:
        wd = wd[:, :, col[0]:col[0] + col[1]]
        dy = dy[:, :, col[0]:col[0] + col[1]]
    return x, wg, wu, wd, dy


# R = 70 spans two row tiles of the wgrad kernel (running sums in device
# memory), R = 3 one; f = 136 and 19 are ragged f-chunks; the column slices
# are strided views of w_down and dy
_BWD_SHAPES = [(3, 200, 136, 136, None), (70, 200, 136, 136, (40, 72)),
               (37, 17, 19, 17, None), (130, 64, 200, 96, (0, 48))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("R,d,f,N,col", _BWD_SHAPES)
def test_fused_mlp_dgrad(cuda, dtype, act, R, d, f, N, col):
    from repro_torch.kernels import fused_mlp, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(R + f)
    x, wg, wu, wd, dy = _mlp_operands(gen, dtype, act, 3, R, d, f, N, col)
    got = fused_mlp.fused_mlp_dgrad(x, wg, wu, wd, dy, act)
    _close(got, ref.fused_mlp_dgrad_ref(x, wg, wu, wd, dy, act), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("R,d,f,N,col", _BWD_SHAPES)
def test_fused_mlp_wgrad(cuda, dtype, act, R, d, f, N, col):
    from repro_torch.kernels import fused_mlp, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(R + f + 1)
    x, wg, wu, wd, dy = _mlp_operands(gen, dtype, act, 3, R, d, f, N, col)
    got = fused_mlp.fused_mlp_wgrad(x, wg, wu, wd, dy, act)
    want = ref.fused_mlp_wgrad_ref(x, wg, wu, wd, dy, act)
    assert (got[0] is None) == (want[0] is None)
    for g, w in zip(got, want):
        if w is not None:
            _close(g, w, dtype)


def test_fused_mlp_backward_is_the_kernels(cuda):
    """ops.fused_mlp's autograd backward launches dgrad and wgrad once each
    and gives the plain versions' gradients."""
    from repro_torch.kernels import fused_mlp, ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x, wg, wu, wd, dy = _mlp_operands(gen, torch.float32, "swiglu", 2, 40,
                                      64, 72, 64, None)
    w = {"w_gate": wg.requires_grad_(), "w_up": wu.requires_grad_(),
         "w_down": wd.requires_grad_()}
    xr = x.requires_grad_()
    fused_mlp.reset()
    y = ops.fused_mlp(xr, w, "swiglu")
    grads = torch.autograd.grad(y, [xr, w["w_gate"], w["w_up"],
                                    w["w_down"]], dy)
    assert (fused_mlp.launches, fused_mlp.dgrad_launches,
            fused_mlp.wgrad_launches) == (1, 1, 1)
    want_x = ref.fused_mlp_dgrad_ref(x, wg, wu, wd, dy, "swiglu")
    want_w = ref.fused_mlp_wgrad_ref(x, wg, wu, wd, dy, "swiglu")
    for g, want in zip(grads, (want_x,) + want_w):
        _close(g, want, torch.float32)
    # a loss of .sum() hands the backward an expanded (stride-0) cotangent
    gx, = torch.autograd.grad(ops.fused_mlp(xr, w, "swiglu").sum(), [xr])
    _close(gx, ref.fused_mlp_dgrad_ref(x, wg, wu, wd, torch.ones_like(dy),
                                       "swiglu"), torch.float32)


def test_wrappers_count_launches(cuda):
    from repro_torch.kernels import ops, topk_combine
    topk_combine.reset()
    rows = torch.ones((2, 3, 8), device="cuda")
    ops.topk_combine(rows, torch.ones((2, 3), device="cuda"))
    assert topk_combine.launches == 1
