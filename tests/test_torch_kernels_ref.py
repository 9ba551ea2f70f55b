"""The port's plain kernel versions (``repro_torch.kernels.ref``) and its
CPU dispatch (``repro_torch.kernels.ops``) against the JAX package's
oracles and its Pallas kernels in interpret mode, on the same numpy
inputs. Tolerances are the repo's own (tests/test_kernels.py): fp32 1e-4,
bf16 2e-2."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ACTS = ["swiglu", "geglu", "gelu", "relu2"]
DTYPES = {"fp32": (np.float32, torch.float32, 1e-4),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16, 2e-2)}


def _arrays(seed, dtype, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    np_dt = DTYPES[dtype][0]
    return [(rng.standard_normal(s) * scale).astype(np.float32).astype(np_dt)
            for s in shapes]


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _mlp_inputs(seed, dtype, act, E, R, d, f, N):
    x, wg, wu, wd = _arrays(seed, dtype, (E, R, d), (E, d, f), (E, d, f),
                            (E, f, N))
    wg = wg / np.sqrt(d).astype(wg.dtype)
    wu = wu / np.sqrt(d).astype(wu.dtype)
    wd = wd / np.sqrt(f).astype(wd.dtype)
    glu = act in ("swiglu", "geglu")
    return x, (wg if glu else None), wu, wd


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("R", [4, 37])
def test_fused_mlp_ref_matches_jax_ref(act, dtype, R):
    """fp32: the JAX oracle. bf16: the JAX Pallas kernel (interpret mode),
    whose rounding points (fp32 activation, hidden cast to bf16) the port's
    plain version shares; the JAX oracle rounds gate/up to bf16 instead."""
    x, wg, wu, wd = _mlp_inputs(1, dtype, act, 3, R, 32, 48, 40)
    jx, jwu, jwd = jnp.asarray(x), jnp.asarray(wu), jnp.asarray(wd)
    jwg = None if wg is None else jnp.asarray(wg)
    if dtype == "fp32":
        want = jref.fused_mlp_ref(jx, jwg, jwu, jwd, act)
    else:
        w = {"w_up": jwu, "w_down": jwd}
        if jwg is not None:
            w["w_gate"] = jwg
        want = jops.fused_mlp(jx, w, act, bm=64, bf=48, interpret=True)
    got = ref.fused_mlp_ref(_t(x, dtype), None if wg is None
                            else _t(wg, dtype), _t(wu, dtype), _t(wd, dtype),
                            act)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (3, R, 40)
    _close(got, want, dtype)


@pytest.mark.parametrize("act,order,col_slice,R,dtype", [
    ("swiglu", "expert_major", None, 37, "fp32"),
    ("swiglu", "n_major", (16, 24), 4, "fp32"),
    ("geglu", "n_major", None, 20, "fp32"),
    ("gelu", "expert_major", (0, 16), 9, "fp32"),
    ("relu2", "expert_major", None, 4, "fp32"),
    ("swiglu", "expert_major", (8, 32), 12, "bf16"),
])
def test_fused_mlp_ops_matches_pallas_interpret(act, order, col_slice, R,
                                                dtype):
    x, wg, wu, wd = _mlp_inputs(2, dtype, act, 2, R, 32, 48, 40)
    jw = {"w_up": jnp.asarray(wu), "w_down": jnp.asarray(wd)}
    tw = {"w_up": _t(wu, dtype), "w_down": _t(wd, dtype)}
    if wg is not None:
        jw["w_gate"] = jnp.asarray(wg)
        tw["w_gate"] = _t(wg, dtype)
    want = jops.fused_mlp(jnp.asarray(x), jw, act, col_slice=col_slice,
                          order=order, bm=16, bf=16, bn=16, interpret=True)
    got = ops.fused_mlp(_t(x, dtype), tw, act, col_slice=col_slice,
                        order=order)
    width = 40 if col_slice is None else col_slice[1]
    assert got.shape == (2, R, width)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("order", ["expert_major", "n_major"])
@pytest.mark.parametrize("E,M,K,N", [(3, 37, 48, 40), (2, 4, 64, 32)])
def test_grouped_gemm_matches_jax(E, M, K, N, order, dtype):
    lhs, rhs = _arrays(3, dtype, (E, M, K), (E, K, N))
    want_ref = jref.grouped_gemm_ref(jnp.asarray(lhs), jnp.asarray(rhs))
    _close(ref.grouped_gemm_ref(_t(lhs, dtype), _t(rhs, dtype)), want_ref,
           dtype)
    want = jops.grouped_gemm(jnp.asarray(lhs), jnp.asarray(rhs), bm=16,
                             bn=16, bk=16, order=order, interpret=True)
    got = ops.grouped_gemm(_t(lhs, dtype), _t(rhs, dtype), order=order)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("T,k,d", [(8, 4, 64), (37, 2, 24)])
def test_topk_combine_matches_jax(T, k, d, dtype):
    rows, = _arrays(4, dtype, (T, k, d))
    w = np.random.default_rng(5).random((T, k)).astype(np.float32)
    want_ref = jref.topk_combine_ref(jnp.asarray(rows), jnp.asarray(w))
    got_ref = ref.topk_combine_ref(_t(rows, dtype), torch.from_numpy(w))
    _close(got_ref, want_ref, dtype)
    want = jops.topk_combine(jnp.asarray(rows), jnp.asarray(w), bt=16,
                             interpret=True)
    got = ops.topk_combine(_t(rows, dtype), torch.from_numpy(w))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (T, d)
    _close(got, want, dtype)
