"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes: every activation, both orders, a column slice, fp32
(1e-4, TF32 off) and bf16 (2e-2); the backward pair (dgrad, wgrad) also
at two row tiles and through ops.fused_mlp's autograd; the forward's,
dgrad's and wgrad's wgmma paths (ragged M tiles, split hidden, aligned
slices, their counters, identical bits on a second call) beside the
general kernels; flash attention (MHA, GQA, MQA, ragged lengths, causal
and not, strided views, non-causal with Sq != Sk at whisper-small's
cross-attention and encoder lengths; the wgmma path within twice the
general kernel's error, its counter, identical bits) and the SSD (ragged
lengths, small and model-size states, strided views, mixed dtypes, an initial and a final state) with their autograd
backward; the SSD's tensor-core path at phase 2's shapes with and without
a state (its counter, the same bits, its error against the fp64 oracle
within twice the general kernel's) and the general path for the rest;
the top-k combine for every k the archs use, with the bits of the plain
j-order sum; the grouped GEMM's wgmma path at the main paths' shapes (both
orders, the same bits) and its refusal of gradients; the rmsnorm in both
epilogues (vector and scalar widths, rows of several warps, fp32 and bf16
scales) and its autograd op; the head's fp32 product on bf16 tensor
cores (``models/common.bf16_exact_mm``) against fp64, the path each
dtype takes, and its split kernel against the plain version's bits. Needs an NVIDIA Hopper GPU and
nvcc; skips elsewhere. On the card:

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


# (E, M, K, N, column slice): qwen2-moe-2.7b's gemm1 and gemm2 at the
# prefill step (C = 160) and at decode (C = 4), a ragged M, gemm2 on a
# column block (1024 of 2048 from column 1024), and an M past one tile
@pytest.mark.parametrize("E,M,K,N,col", [
    (64, 160, 2048, 1408, None), (64, 160, 1408, 2048, None),
    (64, 4, 2048, 1408, None), (64, 4, 1408, 2048, None),
    (64, 37, 2048, 1408, None), (8, 160, 1408, 2048, (1024, 1024)),
    (3, 300, 136, 200, None)])
def test_grouped_gemm_hopper_path(cuda, E, M, K, N, col):
    """bf16 on the wgmma kernel in both orders, within 2e-2 of the plain
    version; the two orders (and a second call) give the same bits, and
    the counters show the path."""
    from repro_torch.kernels import grouped_gemm, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M + N)
    lhs = _randn(gen, (E, M, K), torch.bfloat16)
    rhs = _randn(gen, (E, K, N), torch.bfloat16, K ** -0.5)
    if col is not None:
        rhs = rhs[:, :, col[0]:col[0] + col[1]]
    assert grouped_gemm.hopper_path(lhs, rhs)
    grouped_gemm.reset()
    got = {o: grouped_gemm.grouped_gemm(lhs, rhs, order=o)
           for o in ("expert_major", "n_major")}
    assert grouped_gemm.launches == grouped_gemm.hopper_launches == 2
    want = ref.grouped_gemm_ref(lhs, rhs)
    for o in got:
        _close(got[o], want, torch.bfloat16)
    assert torch.equal(got["expert_major"], got["n_major"])
    assert torch.equal(grouped_gemm.grouped_gemm(lhs, rhs, "n_major"),
                       got["n_major"])


def test_grouped_gemm_fp32_takes_the_general_kernel(cuda):
    from repro_torch.kernels import grouped_gemm, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    lhs = _randn(gen, (4, 37, 136), torch.float32)
    rhs = _randn(gen, (4, 136, 200), torch.float32, 136 ** -0.5)
    grouped_gemm.reset()
    got = grouped_gemm.grouped_gemm(lhs, rhs)
    assert (grouped_gemm.launches, grouped_gemm.hopper_launches) == (1, 0)
    _close(got, ref.grouped_gemm_ref(lhs, rhs), torch.float32)


def test_grouped_gemm_op_refuses_gradients_on_the_card(cuda):
    """The "pallas" backend has no backward: ops.grouped_gemm raises under
    grad mode for a CUDA operand that requires grad (the kernel's output
    would carry no grad_fn), and runs without grad mode."""
    from repro_torch.kernels import grouped_gemm, ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    lhs = _randn(gen, (2, 4, 64), torch.bfloat16)
    rhs = _randn(gen, (2, 64, 128), torch.bfloat16).requires_grad_()
    grouped_gemm.reset()
    with pytest.raises(RuntimeError, match='"pallas" GroupGEMM backend'):
        ops.grouped_gemm(lhs, rhs)
    assert grouped_gemm.launches == 0
    with torch.no_grad():
        out = ops.grouped_gemm(lhs, rhs)
    assert grouped_gemm.hopper_launches == 1 and out.shape == (2, 4, 128)


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


# In bf16 the shapes with d, f, N multiples of 8 take the wgmma kernels
# (R = 70 and 130 span two and three row tiles of the recompute, reduced in
# registers by the products), d = 17 the general ones (R = 37 two row tiles,
# running sums in device memory); f = 136 and 19 are ragged f-chunks; the
# column slices are strided views of w_down and dy
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


def _close_or_floor(got, want, floor):
    """bf16 wgrad: within 2e-2 of the plain version, or, as chip_smoke.py
    holds the bf16 weight gradients, within 3x the distance between two
    plain routes (fp32 and fp64 products with the same bf16 rounding
    points) in max error, and in rel L2 within 3x that distance or under
    1e-3 (a quarter of bf16's relative spacing). A weight gradient is a sum
    over the rows of products of bf16-rounded factors; where two routes
    round an intermediate (h, dh, dup, dgate) to neighbouring bf16 values,
    one summand moves by an ulp of its own size, which can exceed 2e-2 of a
    sum that cancels. At these small shapes only a handful of elements
    differ between the two plain routes, so their rel L2 is a noisy floor
    (3.7e-5 where the kernel's fp32 tensor-core sums gave 1.3e-4); a wrong
    tile, slice or mask moves rel L2 by 1e-2 or more."""
    torch.cuda.synchronize()
    g, w, fl = got.float(), want.float(), floor.float()
    if torch.allclose(g, w, rtol=2e-2, atol=2e-2):
        return
    err, f_err = (g - w).abs().max(), (fl - w).abs().max()
    l2, f_l2 = (g - w).norm() / w.norm(), (fl - w).norm() / w.norm()
    assert err <= 3 * f_err and l2 <= max(3 * f_l2, 1e-3), (
        f"max err {err:.3e} (floor {f_err:.3e}), rel L2 {l2:.3e} "
        f"(floor {f_l2:.3e})")


# Shapes of the wgmma paths (bf16; d, f, N multiples of 8): several M tiles
# with a ragged last one (R = 150, and R = 520: 9 tiles), f split over
# blocks (S > 1: with 3 experts the plan lowers F_s to 128 to fill the
# SMs), ragged f and N tails, an aligned column slice of w_down (and dy),
# a single 8-wide tile
_HOPPER_SHAPES = [(150, 200, 640, 136, None), (3, 64, 136, 520, None),
                  (70, 256, 1024, 512, (128, 264)), (64, 8, 8, 8, None),
                  (520, 64, 192, 72, None)]


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("R,d,f,N,col", _HOPPER_SHAPES)
def test_fused_mlp_hopper_path(cuda, act, R, d, f, N, col):
    """bf16 aligned calls launch the wgmma forward (counted beside the
    total), match the plain version, and give the same bits twice."""
    from repro_torch.kernels import fused_mlp, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(R + f + 2)
    x, wg, wu, wd, _ = _mlp_operands(gen, torch.bfloat16, act, 3, R, d, f,
                                     N, col)
    assert fused_mlp.hopper_path(x, wg, wu, wd)
    fused_mlp.reset()
    got = fused_mlp.fused_mlp(x, wg, wu, wd, act)
    assert (fused_mlp.launches, fused_mlp.hopper_launches) == (1, 1)
    _close(got, ref.fused_mlp_ref(x, wg, wu, wd, act), torch.bfloat16)
    assert torch.equal(got, fused_mlp.fused_mlp(x, wg, wu, wd, act))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("R,d,f,N,col", _HOPPER_SHAPES)
def test_fused_mlp_wgrad_hopper_path(cuda, act, R, d, f, N, col):
    """bf16 aligned calls launch the wgmma wgrad, match the plain version,
    and give the same bits twice."""
    from repro_torch.kernels import fused_mlp, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(R + f + 3)
    x, wg, wu, wd, dy = _mlp_operands(gen, torch.bfloat16, act, 3, R, d, f,
                                      N, col)
    dy = dy.contiguous()
    assert fused_mlp.hopper_path(x, wg, wu, wd, dy)
    fused_mlp.reset()
    got = fused_mlp.fused_mlp_wgrad(x, wg, wu, wd, dy, act)
    assert (fused_mlp.wgrad_launches, fused_mlp.wgrad_hopper_launches) == \
        (1, 1)
    want = ref.fused_mlp_wgrad_ref(x, wg, wu, wd, dy, act)
    # the second plain route (fp64 products, the same bf16 rounding points)
    floor = ref.fused_mlp_wgrad_ref(x, wg, wu, wd, dy, act,
                                    acc=torch.float64)
    again = fused_mlp.fused_mlp_wgrad(x, wg, wu, wd, dy, act)
    for g, w, fl, a in zip(got, want, floor, again):
        assert (g is None) == (w is None)
        if w is not None:
            _close_or_floor(g, w, fl)
            assert torch.equal(g, a)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("R,d,f,N,col", _HOPPER_SHAPES)
def test_fused_mlp_dgrad_hopper_path(cuda, act, R, d, f, N, col):
    """bf16 aligned calls launch the wgmma dgrad (the shared recompute,
    then one product over the hidden), match the plain version, and give
    the same bits twice."""
    from repro_torch.kernels import fused_mlp, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(R + f + 4)
    x, wg, wu, wd, dy = _mlp_operands(gen, torch.bfloat16, act, 3, R, d, f,
                                      N, col)
    assert fused_mlp.hopper_path(x, wg, wu, wd, dy)
    fused_mlp.reset()
    got = fused_mlp.fused_mlp_dgrad(x, wg, wu, wd, dy, act)
    assert (fused_mlp.dgrad_launches, fused_mlp.dgrad_hopper_launches) == \
        (1, 1)
    want = ref.fused_mlp_dgrad_ref(x, wg, wu, wd, dy, act)
    floor = ref.fused_mlp_dgrad_ref(x, wg, wu, wd, dy, act,
                                    acc=torch.float64)
    _close_or_floor(got, want, floor)
    assert torch.equal(got, fused_mlp.fused_mlp_dgrad(x, wg, wu, wd, dy, act))


@pytest.mark.parametrize("case", ["fp32", "d=17", "misaligned slice"])
def test_general_path_takes_the_rest(cuda, case):
    """fp32, widths that are not multiples of 8 and column slices that do
    not start 16-byte aligned run the general kernels, counted as such."""
    from repro_torch.kernels import fused_mlp, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    d = 17 if case == "d=17" else 64
    col = (4, 64) if case == "misaligned slice" else None
    x, wg, wu, wd, dy = _mlp_operands(gen, dtype, "swiglu", 2, 70, d, 136,
                                      72, col)
    dy = dy.contiguous()
    assert not fused_mlp.hopper_path(x, wg, wu, wd, dy)
    fused_mlp.reset()
    got = fused_mlp.fused_mlp(x, wg, wu, wd, "swiglu")
    gw = fused_mlp.fused_mlp_wgrad(x, wg, wu, wd, dy, "swiglu")
    gx = fused_mlp.fused_mlp_dgrad(x, wg, wu, wd, dy, "swiglu")
    assert (fused_mlp.launches, fused_mlp.hopper_launches,
            fused_mlp.wgrad_launches, fused_mlp.wgrad_hopper_launches,
            fused_mlp.dgrad_launches,
            fused_mlp.dgrad_hopper_launches) == (1, 0, 1, 0, 1, 0)
    _close(got, ref.fused_mlp_ref(x, wg, wu, wd, "swiglu"), dtype)
    _close(gx, ref.fused_mlp_dgrad_ref(x, wg, wu, wd, dy, "swiglu"), dtype)
    for g, w in zip(gw, ref.fused_mlp_wgrad_ref(x, wg, wu, wd, dy,
                                                "swiglu")):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,hd", [(1, 4, 4, 128, 64),
                                           (2, 8, 2, 200, 128),
                                           (1, 4, 1, 77, 32),
                                           (2, 2, 2, 1, 128)])
def test_flash_attention(cuda, dtype, causal, B, Hq, Hkv, S, hd):
    """The kernel reads (B, S, H, hd) tensors through transposed views, as
    the model passes them."""
    from repro_torch.kernels import flash_attention, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S + hd)
    q = _randn(gen, (B, S, Hq, hd), dtype).transpose(1, 2)
    k = _randn(gen, (B, S, Hkv, hd), dtype).transpose(1, 2)
    v = _randn(gen, (B, S, Hkv, hd), dtype).transpose(1, 2)
    got = flash_attention.flash_attention(q, k, v, causal)
    _close(got, ref.flash_attention_ref(q, k, v, causal), dtype)


# (B, Hq, Hkv, Sq, Sk, hd): MHA, GQA and MQA, a single query, ragged
# lengths (partial q and kv tiles), fewer queries than keys, both head
# widths of the wgmma path
_FLASH_HOPPER_SHAPES = [(1, 4, 4, 128, 128, 64), (2, 8, 2, 200, 200, 128),
                        (1, 4, 1, 77, 77, 64), (2, 2, 2, 1, 1, 128),
                        (1, 2, 1, 300, 300, 128), (2, 4, 2, 100, 300, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd", _FLASH_HOPPER_SHAPES)
def test_flash_attention_hopper_path(cuda, monkeypatch, causal, B, Hq, Hkv,
                                     Sq, Sk, hd):
    """bf16 views with head_dim 64 or 128 launch the wgmma kernel (counted
    beside the total), match the plain version within 2e-2, give the same
    bits twice, and stay within twice the general kernel's error: the
    largest over 6 seeded draws on both sides, as chip_smoke.py phase 2
    holds it (one draw's max error is the ulp of whichever element's bf16
    rounding happened to flip)."""
    from repro_torch.kernels import flash_attention, ref
    err = g_err = 0.0
    for seed in range(6):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(Sq + Sk + hd + 1000 * seed)
        q = _randn(gen, (B, Sq, Hq, hd), torch.bfloat16).transpose(1, 2)
        k = _randn(gen, (B, Sk, Hkv, hd), torch.bfloat16).transpose(1, 2)
        v = _randn(gen, (B, Sk, Hkv, hd), torch.bfloat16).transpose(1, 2)
        assert flash_attention.hopper_path(q, k, v)
        flash_attention.reset()
        got = flash_attention.flash_attention(q, k, v, causal)
        assert (flash_attention.launches,
                flash_attention.hopper_launches) == (1, 1)
        want = ref.flash_attention_ref(q, k, v, causal)
        _close(got, want, torch.bfloat16)
        assert torch.equal(got,
                           flash_attention.flash_attention(q, k, v, causal))
        with monkeypatch.context() as mp:
            mp.setattr(flash_attention, "hopper_path", lambda *a: False)
            general = flash_attention.flash_attention(q, k, v, causal)
        assert flash_attention.hopper_launches == 2
        err = max(err, float((got.float() - want.float()).abs().max()))
        g_err = max(g_err, float((general.float() - want.float()).abs().max()))
    assert err <= 2 * g_err, (err, g_err)


# (B, Hq, Hkv, Sq, Sk, hd), non-causal: whisper-small's cross-attention
# (375 and 32 queries against 1500 keys, the last kv tile partial) and
# encoder (1500 against 1500) at a few heads, more queries than keys, a
# GQA case, and the general kernel's head widths
_FLASH_CROSS_SHAPES = [(1, 4, 4, 375, 1500, 64), (2, 4, 4, 32, 1500, 64),
                       (1, 2, 2, 1500, 1500, 64), (1, 4, 2, 300, 77, 64),
                       (2, 4, 1, 130, 200, 128), (1, 2, 2, 33, 70, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd", _FLASH_CROSS_SHAPES)
def test_flash_attention_non_causal_cross_lengths(cuda, dtype, B, Hq, Hkv,
                                                  Sq, Sk, hd):
    """Non-causal attention of Sq queries over Sk keys: keys past Sk in the
    last tile excluded, the kernel's path by the operands (bf16 at
    head_dim 64 or 128: the wgmma kernel)."""
    from repro_torch.kernels import flash_attention, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(Sq + 7 * Sk + hd)
    q = _randn(gen, (B, Sq, Hq, hd), dtype).transpose(1, 2)
    k = _randn(gen, (B, Sk, Hkv, hd), dtype).transpose(1, 2)
    v = _randn(gen, (B, Sk, Hkv, hd), dtype).transpose(1, 2)
    flash_attention.reset()
    got = flash_attention.flash_attention(q, k, v, False)
    hopper = dtype == torch.bfloat16 and hd in (64, 128)
    assert (flash_attention.launches,
            flash_attention.hopper_launches) == (1, int(hopper))
    assert got.shape == (B, Hq, Sq, hd)
    _close(got, ref.flash_attention_ref(q, k, v, False), dtype)


def _ssd_operands(gen, B, S, nh, hd, ds, xdt, bdt):
    x = _randn(gen, (B, S, nh, hd), xdt)
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, nh),
                                             torch.float32))
    A = -torch.exp(_randn(gen, (nh,), torch.float32, 0.3))
    Bm = _randn(gen, (B, S, ds), bdt)
    Cm = _randn(gen, (B, S, ds), bdt)
    D = torch.full((nh,), 0.5, device="cuda")
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("xdt,bdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,S,nh,hd,ds", [(1, 64, 2, 16, 8),
                                          (2, 200, 3, 64, 128),
                                          (1, 5, 1, 8, 4),
                                          (2, 130, 4, 32, 16)])
def test_ssd_forward(cuda, xdt, bdt, B, S, nh, hd, ds):
    from repro_torch.kernels import ref, ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S + ds)
    ins = _ssd_operands(gen, B, S, nh, hd, ds, xdt, bdt)
    got = ssd.ssd_forward(*ins)
    dtype = torch.bfloat16 if torch.bfloat16 in (xdt, bdt) else xdt
    _close(got, ref.ssd_chunked_ref(*ins, chunk=ssd.CHUNK), dtype)
    _close(got, ref.ssd_ref(*ins), dtype)


def test_ssd_reads_slices_of_the_conv_output(cuda):
    """x, B and C as the model passes them: strided slices of one conv
    output, the dt of a softplus."""
    from repro_torch.kernels import ref, ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    B, S, nh, hd, ds = 2, 100, 4, 64, 128
    conv = _randn(gen, (B, S, nh * hd + 2 * ds), torch.bfloat16)
    x = conv[..., :nh * hd].reshape(B, S, nh, hd)
    Bm, Cm = conv[..., nh * hd:nh * hd + ds], conv[..., nh * hd + ds:]
    _, dt, A, _, _, D = _ssd_operands(gen, B, S, nh, hd, 1, torch.float32,
                                      torch.float32)
    got = ssd.ssd_forward(x, dt, A, Bm, Cm, D)
    _close(got, ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, ssd.CHUNK),
           torch.bfloat16)


def test_flash_and_ssd_backward_recompute_the_plain_versions(cuda):
    """ops' autograd functions launch the kernel once forward and give the
    plain versions' gradients (fp32); the SSD's at the kernel's own chunk,
    whatever chunk the caller names."""
    from repro_torch.kernels import flash_attention, ops, ref, ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    q = _randn(gen, (2, 4, 96, 64), torch.float32).requires_grad_()
    k = _randn(gen, (2, 2, 96, 64), torch.float32).requires_grad_()
    v = _randn(gen, (2, 2, 96, 64), torch.float32).requires_grad_()
    ct = _randn(gen, (2, 4, 96, 64), torch.float32)
    flash_attention.reset()
    got = torch.autograd.grad(ops.flash_attention(q, k, v), [q, k, v], ct)
    assert flash_attention.launches == 1
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v), [q, k, v],
                               ct)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)
    ins = [t.requires_grad_() for t in _ssd_operands(
        gen, 2, 128, 3, 32, 16, torch.float32, torch.float32)]
    ct = _randn(gen, (2, 128, 3, 32), torch.float32)
    ssd.reset()
    got = torch.autograd.grad(ops.ssd_forward(*ins, chunk=32), ins, ct)
    assert ssd.launches == 1
    want = torch.autograd.grad(ref.ssd_chunked_ref(*ins, chunk=ssd.CHUNK),
                               ins, ct)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)


@pytest.mark.parametrize("xdt,bdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B,S,nh,hd,ds", [(2, 200, 3, 64, 128),
                                          (1, 5, 1, 8, 4),
                                          (2, 64, 4, 32, 16)])
def test_ssd_forward_with_state(cuda, xdt, bdt, B, S, nh, hd, ds):
    """y and the final state from a given initial state, against the plain
    chunked form; a state handed through two calls equals one call over
    the whole length."""
    from repro_torch.kernels import ref, ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S + hd)
    ins = _ssd_operands(gen, B, S, nh, hd, ds, xdt, bdt)
    h0 = _randn(gen, (B, nh, ds, hd), torch.float32)
    ssd.reset()
    y, hf = ssd.ssd_forward_state(*ins, h0)
    assert ssd.launches == 1 and hf.dtype == torch.float32
    want_y, want_h = ref.ssd_state_ref(*ins, h0, chunk=ssd.CHUNK)
    dtype = torch.bfloat16 if torch.bfloat16 in (xdt, bdt) else xdt
    _close(y, want_y, dtype)
    _close(hf, want_h, torch.float32 if dtype == torch.float32 else dtype)
    if S < 2:
        return
    cut = S // 2
    x, dt, A, Bm, Cm, D = ins
    y1, h1 = ssd.ssd_forward_state(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                                   Cm[:, :cut], D, h0)
    y2, h2 = ssd.ssd_forward_state(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                                   Cm[:, cut:], D, h1)
    _close(torch.cat([y1, y2], dim=1), y, dtype)
    _close(h2, hf, torch.float32 if dtype == torch.float32 else dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["tpu", "model"])
@pytest.mark.parametrize("T,d", [(100, 896), (8, 64), (3, 1536), (5, 8192),
                                 (4, 100), (2, 3000),
                                 (3, 1001)])
def test_rmsnorm(cuda, dtype, epilogue, T, d):
    """Vector widths, scalar ones (d not a multiple of the 16-byte
    vector), up to jamba's gated norm width; a non-unit fp32 scale."""
    from repro_torch.kernels import ref, rmsnorm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(T + d)
    x = _randn(gen, (T, d), dtype)
    scale = 1.0 + 0.1 * _randn(gen, (d,), torch.float32)
    got = rmsnorm.rmsnorm(x, scale, 1e-5, epilogue=epilogue)
    plain = ref.rmsnorm_ref if epilogue == "tpu" else ref.rms_norm
    assert got.dtype == dtype
    _close(got, plain(x, scale, 1e-5), dtype)
    if dtype == torch.bfloat16:      # a scale in x's dtype
        s16 = scale.to(dtype)
        _close(rmsnorm.rmsnorm(x, s16, 1e-5, epilogue=epilogue),
               plain(x, s16, 1e-5), dtype)


@pytest.mark.parametrize("epilogue", ["tpu", "model"])
@pytest.mark.parametrize("T,d,dtype", [(2048, 3072, torch.bfloat16),
                                       (2048, 1536, torch.float32),
                                       (8192, 1536, torch.bfloat16),
                                       (7, 8192, torch.float32)])
def test_rmsnorm_rows_of_several_warps_and_strided_rows(cuda, T, d, dtype,
                                                        epilogue):
    """Widths whose rows take several warps (mamba2's gated 3072 in bf16,
    1536 and 8192 in fp32) and a row count past the persistent grid
    (8192 rows: each row group takes two and more), against the plain
    version; two calls give the same bits."""
    from repro_torch.kernels import build, ref, rmsnorm
    plan = rmsnorm.launch_plan(T, d, torch.finfo(dtype).bits // 8, True,
                               build.sm_count(0))
    assert plan["warps_per_row"] > 1 or plan["blocks"] * \
        plan["rows_per_block"] < T
    gen = torch.Generator(device="cuda")
    gen.manual_seed(T + d)
    x = _randn(gen, (T, d), dtype)
    scale = 1.0 + 0.1 * _randn(gen, (d,), torch.float32)
    got = rmsnorm.rmsnorm(x, scale, 1e-5, epilogue=epilogue)
    plain = ref.rmsnorm_ref if epilogue == "tpu" else ref.rms_norm
    _close(got, plain(x, scale, 1e-5), dtype)
    assert torch.equal(rmsnorm.rmsnorm(x, scale, 1e-5, epilogue=epilogue),
                       got)


def test_rms_norm_op_is_the_kernel_forward(cuda):
    """ops.rms_norm on (B, S, d) launches the model epilogue once and its
    gradient is the plain form's (fp32)."""
    from repro_torch.kernels import ops, ref, rmsnorm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    x = _randn(gen, (2, 9, 1536), torch.float32).requires_grad_()
    scale = (1.0 + 0.1 * _randn(gen, (1536,), torch.float32)
             ).requires_grad_()
    ct = _randn(gen, (2, 9, 1536), torch.float32)
    rmsnorm.reset()
    y = ops.rms_norm(x, scale, 1e-6)
    assert rmsnorm.launches == 1 and y.shape == x.shape
    got = torch.autograd.grad(y, [x, scale], ct)
    want_y = ref.rms_norm(x, scale, 1e-6)
    want = torch.autograd.grad(want_y, [x, scale], ct)
    _close(y, want_y, torch.float32)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)


def _ssd_conv_operands(gen, B, S, nh, hd, ds, state):
    """bf16 x, B and C as slices of one conv output (the model's layout),
    fp32 dt, A, D; an fp32 initial state when ``state``."""
    conv = _randn(gen, (B, S, nh * hd + 2 * ds), torch.bfloat16)
    x = conv[..., :nh * hd].reshape(B, S, nh, hd)
    Bm, Cm = conv[..., nh * hd:nh * hd + ds], conv[..., nh * hd + ds:]
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, nh),
                                             torch.float32))
    A = -torch.exp(_randn(gen, (nh,), torch.float32, 0.3))
    D = torch.ones((nh,), device="cuda")
    h0 = _randn(gen, (B, nh, ds, hd), torch.float32) if state else None
    return (x, dt, A, Bm, Cm, D), h0


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("B,S,nh,hd,ds", [(4, 2048, 48, 64, 128),
                                          (8, 256, 48, 64, 128),
                                          (2, 1000, 8, 64, 128),
                                          (1, 2048, 128, 64, 16)])
def test_ssd_hopper_path(cuda, state, B, S, nh, hd, ds):
    """The tensor-core SSD at phase 2's shapes (mamba2-780m's train shape
    and serving chunk, a ragged length, jamba's SSM layers) against the
    plain chunked form, y and the final state; its counter; the same bits
    on a second call."""
    from repro_torch.kernels import ref, ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S + nh + ds)
    ins, h0 = _ssd_conv_operands(gen, B, S, nh, hd, ds, state)
    assert ssd.hopper_path(*ins)
    ssd.reset()
    y, hf = ssd.ssd_forward_state(*ins, h0)
    y2 = ssd.ssd_forward(*ins) if h0 is None else None
    assert ssd.launches == ssd.hopper_launches == (1 if state else 2)
    want_y, want_h = ref.ssd_state_ref(*ins, h0, chunk=ssd.CHUNK)
    _close(y, want_y, torch.bfloat16)
    _close(hf, want_h, torch.bfloat16)
    again_y, again_h = ssd.ssd_forward_state(*ins, h0)
    assert torch.equal(again_y, y) and torch.equal(again_h, hf)
    if y2 is not None:
        assert torch.equal(y2, y)


def test_ssd_hopper_error_beside_the_general_kernel(cuda, monkeypatch):
    """Over 8 seeded draws at a small shape, the tensor-core kernel's y is
    within its rule of the general kernel's error against the fp64
    sequential oracle: max error ORACLE_MAX_RATIO x, pooled rel L2
    ORACLE_L2_RATIO x."""
    from repro_torch.kernels import ref, ssd
    err = g_err = num = g_num = den = 0.0
    for seed in range(8):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(100 + seed)
        ins, _ = _ssd_conv_operands(gen, 2, 130, 3, 64, 32, False)
        want = ref.ssd_ref(*ins, acc=torch.float64)
        got = ssd.ssd_forward(*ins).double()
        with monkeypatch.context() as mp:
            mp.setattr(ssd, "hopper_path", lambda *a: False)
            general = ssd.ssd_forward(*ins).double()
        err = max(err, float((got - want).abs().max()))
        g_err = max(g_err, float((general - want).abs().max()))
        num += float((got - want).norm() ** 2)
        g_num += float((general - want).norm() ** 2)
        den += float(want.norm() ** 2)
    assert err <= ssd.ORACLE_MAX_RATIO * g_err, (err, g_err)
    assert num <= ssd.ORACLE_L2_RATIO ** 2 * g_num, (num / den, g_num / den)


@pytest.mark.parametrize("B,S,state", [(4, 2048, False), (8, 256, True)])
def test_ssd_hopper_oracle_at_the_main_shapes(cuda, monkeypatch, B, S,
                                              state):
    """The same rule over 3 seeded draws at mamba2-780m's train shape and
    its serving chunk from a state, where h_final's pooled rel L2 against
    the oracle is held to ORACLE_STATE_L2 too."""
    from repro_torch.kernels import ref, ssd
    err = g_err = num = g_num = den = h_num = h_den = 0.0
    for seed in range(3):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(200 + seed)
        ins, h0 = _ssd_conv_operands(gen, B, S, 48, 64, 128, state)
        want, want_h = ref.ssd_ref(*ins, acc=torch.float64, h0=h0,
                                   return_state=True)
        got, got_h = ssd.ssd_forward_state(*ins, h0)
        with monkeypatch.context() as mp:
            mp.setattr(ssd, "hopper_path", lambda *a: False)
            general = ssd.ssd_forward_state(*ins, h0)[0].double()
        got = got.double()
        err = max(err, float((got - want).abs().max()))
        g_err = max(g_err, float((general - want).abs().max()))
        num += float((got - want).norm() ** 2)
        g_num += float((general - want).norm() ** 2)
        den += float(want.norm() ** 2)
        h_num += float((got_h.double() - want_h).norm() ** 2)
        h_den += float(want_h.norm() ** 2)
        del want, want_h, got, got_h, general
    assert err <= ssd.ORACLE_MAX_RATIO * g_err, (err, g_err)
    assert num <= ssd.ORACLE_L2_RATIO ** 2 * g_num, (num / den, g_num / den)
    assert (h_num / h_den) ** 0.5 <= ssd.ORACLE_STATE_L2, h_num / h_den


def test_ssd_general_path_takes_the_rest(cuda):
    """fp32 operands, a head_dim that is no multiple of 32 and an initial
    state 4 bytes off an 8-byte boundary take the general kernel; its
    counter stays."""
    from repro_torch.kernels import ref, ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    ins = _ssd_operands(gen, 2, 100, 3, 24, 32, torch.bfloat16,
                        torch.bfloat16)
    ins32 = _ssd_operands(gen, 2, 100, 3, 64, 32, torch.float32,
                          torch.float32)
    ssd.reset()
    for args, dtype in ((ins, torch.bfloat16), (ins32, torch.float32)):
        assert not ssd.hopper_path(*args)
        _close(ssd.ssd_forward(*args),
               ref.ssd_chunked_ref(*args, chunk=ssd.CHUNK), dtype)
    assert ssd.launches == 2 and ssd.hopper_launches == 0
    conv_ins, _ = _ssd_conv_operands(gen, 2, 100, 3, 64, 32, False)
    h0 = _randn(gen, (2 * 3 * 32 * 64 + 1,), torch.float32)[1:] \
        .view(2, 3, 32, 64)
    assert ssd.hopper_path(*conv_ins)
    assert not ssd.hopper_path(*conv_ins, h0)
    y, hf = ssd.ssd_forward_state(*conv_ins, h0)
    want_y, want_h = ref.ssd_state_ref(*conv_ins, h0, chunk=ssd.CHUNK)
    _close(y, want_y, torch.bfloat16)
    _close(hf, want_h, torch.bfloat16)
    assert ssd.launches == 3 and ssd.hopper_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("T,d", [(2048, 2048), (8, 4096), (37, 100)])
def test_topk_combine_bits(cuda, dtype, k, T, d):
    """Every k the archs use, the templated (2, 4, 8) and the generic
    instance, prefill and decode rows and a width of no whole 16-byte
    pieces: within the tolerance of topk_combine_ref, the bits of the
    plain j-order sum, the same bits twice."""
    from repro_torch.kernels import ref, topk_combine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(T + k + d)
    rows = _randn(gen, (T, k, d), dtype)
    w = torch.softmax(_randn(gen, (T, k), torch.float32), dim=-1)
    got = topk_combine.topk_combine(rows, w)
    _close(got, ref.topk_combine_ref(rows, w), dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.topk_combine_ordered(rows, w))
    assert torch.equal(topk_combine.topk_combine(rows, w), got)


@pytest.fixture
def world1(tmp_path):
    """A default process group of one rank on the given backend, and the
    (data 1, model 1) context over it; destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.parallel.mesh import AxisCtx, make_mesh
    made = []

    def init(backend, seq_shard=False):
        dist.init_process_group(backend, init_method=f"file://{tmp_path}/"
                                f"{backend}", world_size=1, rank=0)
        made.append(backend)
        return AxisCtx(mesh=make_mesh((1, 1), ("data", "model")),
                       dp_axes=("data",), model_axis="model",
                       seq_shard=seq_shard)
    yield init
    if made:
        dist.destroy_process_group()


def test_gloo_context_refuses_cuda_tensors(cuda, world1):
    """A gloo communicator takes CPU tensors: a CUDA tensor raises by name,
    in a collective and through moe_ffn's router statistics."""
    from repro_torch.launch import selftest as ST
    from repro_torch.parallel import collectives as CL
    ctx = world1("gloo", seq_shard=True)
    with pytest.raises(ValueError, match="gloo communicator takes cpu"):
        CL.psum(torch.ones(4, device="cuda"), ctx.model_group)
    prob = ST.problem()
    with pytest.raises(ValueError, match="gloo communicator takes cpu"):
        ST.run_cell(prob, ctx, "naive", seq_shard=True, device="cuda")


@pytest.mark.parametrize("dtype,gemm_impl", [(torch.float32, "xla"),
                                             (torch.bfloat16,
                                              "pallas_fused")])
def test_world1_nccl_moe_ffn_gives_the_contextless_bits(cuda, world1, dtype,
                                                        gemm_impl):
    """At world 1 the ranked moe_ffn takes the one-rank arms, as the JAX
    package does: outputs, aux and gradients with the context-less bits,
    for naive, coarse and comet (two column blocks, fused combine)."""
    import dataclasses

    from repro_torch.core import moe_layer as M
    from repro_torch.launch import selftest as ST
    ctx = world1("nccl")
    prob = ST.problem("qwen2-moe-2.7b-smoke", E=0, f=0, top_k=0)
    x = torch.from_numpy(prob["x"]).cuda().to(dtype)
    for impl, kw in (("naive", {}), ("coarse", {}),
                     ("comet", dict(n_col_blocks=2, fused_combine=True))):
        mcfg = dataclasses.replace(prob["mcfg"], impl=impl,
                                   gemm_impl=gemm_impl, **kw)
        runs = []
        for c in (None, ctx):
            router, packed = ST._params(prob, 1, 1, "cuda")
            params = {"router": router.to(dtype).requires_grad_(True),
                      "experts": {k: v.to(dtype).requires_grad_(True)
                                  for k, v in packed.items()}}
            y, aux = M.moe_ffn(prob["cfg"], mcfg, params, x, c)
            ((y.float() ** 2).sum() + aux).backward()
            runs.append([y, aux, params["router"].grad]
                        + [params["experts"][k].grad for k in sorted(packed)])
        for a, b in zip(*runs):
            assert a.is_cuda and torch.equal(a, b), impl


def _max_rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("tied", [False, True])
def test_head_product_bf16_exact(cuda, tied):
    """The head's fp32 product on bf16 tensor cores (``models/common``):
    logits, dh and dW against fp64 within 4x the fp32 cuBLAS product's
    error, dh over more than one ``K_PASS`` pass; the returned gradients
    in the operands' dtype."""
    from repro_torch.models import common
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rows, d, V = 256, 512, 3 * common.K_PASS + 123
    a = _randn(gen, (rows, d), torch.bfloat16)
    b = (_randn(gen, (V, d), torch.bfloat16, d ** -0.5).t() if tied
         else _randn(gen, (d, V), torch.bfloat16, d ** -0.5))
    g = torch.softmax(a.float() @ b.float() * 4, -1) / rows
    g[torch.arange(rows, device="cuda"),
      torch.randint(0, V, (rows,), device="cuda", generator=gen)] -= 1 / rows
    want = a.double() @ b.double()
    assert (_max_rel(common.bf16_exact_mm(a, b), want)
            <= 4 * _max_rel(a.float() @ b.float(), want))
    da, db = common.split_grads_f32(a, b, g)
    for got, fp32, want in (
            (da, g @ b.float().t(), g.double() @ b.double().t()),
            (db, a.float().t() @ g, a.double().t() @ g.double())):
        assert _max_rel(got, want) <= 4 * _max_rel(fp32, want)
    ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    common.bf16_exact_mm(ag, bg).backward(g)
    torch.cuda.synchronize()
    assert ag.grad.dtype == bg.grad.dtype == torch.bfloat16
    for got, p32 in ((ag.grad, da), (bg.grad, db)):
        assert bool(((got.float() - p32).abs() <= p32.abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "bf16_exact"),
                                        (torch.float32, "fp32")])
def test_head_product_path_on_the_card(cuda, dtype, path):
    """bf16 operands on the card take the bf16-exact product, fp32 ones the
    widened product: two calls a chunk (forward and recompute)."""
    from repro_torch.models import common
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    h = _randn(gen, (2, 48, 64), dtype).requires_grad_(True)
    w = _randn(gen, (64, 200), dtype, 0.125).requires_grad_(True)
    labels = torch.randint(-1, 200, (2, 48), device="cuda", generator=gen)
    before = dict(common.HEAD_PRODUCT_CALLS)
    loss, _ = common.chunked_xent(h, w, labels, chunk=16)
    loss.backward()
    calls = {k: v - before[k] for k, v in common.HEAD_PRODUCT_CALLS.items()}
    want_calls = {"bf16_exact": 0, "fp32": 0}
    want_calls[path] = 6
    assert calls == want_calls
    with torch.no_grad():
        want, _ = common.chunked_xent(h.double(), w.double(), labels,
                                      chunk=16, logit_dtype=torch.float64)
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("shape,strided", [((96, 1000), False),   # vectors
                                           ((7, 333), False),     # scalar
                                           ((64, 130), True)])
def test_split3_kernel_matches_plain_bits(cuda, shape, strided):
    """The split kernel's three pieces are the plain version's bit for
    bit, signed zeros and every magnitude included, and rebuild g."""
    from repro_torch.kernels import ref, split3
    gen = torch.Generator(device="cuda")
    gen.manual_seed(shape[1])
    g = torch.randn(shape, device="cuda", generator=gen) * torch.exp(
        8 * torch.randn(shape, device="cuda", generator=gen))
    g.view(-1)[:4] = torch.tensor([0.0, -0.0, 1.0, -3e-30], device="cuda")
    if strided:
        g = g.t()
    n0 = split3.launches
    got = split3.split3_bf16(g)
    torch.cuda.synchronize()
    assert split3.launches == n0 + 1
    want = ref.split3_bf16_ref(g)
    assert got.shape == (3, *g.shape)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    p = got.float()
    back = (p[0] - p[1]) - p[2]
    assert torch.equal(back.view(torch.int32), g.contiguous().view(torch.int32))
