"""The backward of the fused expert MLP and of the top-k combine: the port's
plain dgrad/wgrad (``kernels/ref.py``) and its CPU dispatch
(``kernels/ops.py``) against the JAX package's Pallas dgrad/wgrad kernels
in interpret mode, for every activation at the ragged shape of
``tests/test_backward_overlap.py`` (E, R, d, f) = (3, 21, 17, 19): fp32
rtol 1e-4 / atol 1e-5 (that test's own), bf16 2e-2. Column blocks sum to
the full result, and the autograd functions ``ops.fused_mlp`` and
``ops.topk_combine_diff`` give ``jax.grad``'s gradients of their JAX
counterparts."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ACTS = ["swiglu", "geglu", "gelu", "relu2"]
E, R, D, F = 3, 21, 17, 19
DTYPES = {"fp32": (np.float32, torch.float32, dict(rtol=1e-4, atol=1e-5)),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16,
                   dict(rtol=2e-2, atol=2e-2))}


def _problem(act, dtype, seed=0, N=D):
    """rows, the weight dict and dy as numpy arrays in ``dtype``."""
    rng = np.random.default_rng(seed)
    np_dt = DTYPES[dtype][0]

    def nrm(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(
            np.float32).astype(np_dt)

    w = {"w_up": nrm(E, D, F, scale=0.3), "w_down": nrm(E, F, N, scale=0.3)}
    if act in ("swiglu", "geglu"):
        w["w_gate"] = nrm(E, D, F, scale=0.3)
    return nrm(E, R, D), w, nrm(E, R, N)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _j(a):
    return jnp.asarray(a)


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_dgrad_wgrad_match_jax_kernels(act, dtype):
    x, w, dy = _problem(act, dtype)
    jw = {k: _j(v) for k, v in w.items()}
    want_dx = jops.fused_mlp_dgrad(_j(x), jw, _j(dy), act, interpret=True)
    want_w = jops.fused_mlp_wgrad(_j(x), jw, _j(dy), act, interpret=True)
    tw = {k: _t(v, dtype) for k, v in w.items()}
    xt, dyt = _t(x, dtype), _t(dy, dtype)
    wg = tw.get("w_gate")
    for dx, dws in ((ref.fused_mlp_dgrad_ref(xt, wg, tw["w_up"],
                                             tw["w_down"], dyt, act),
                     ref.fused_mlp_wgrad_ref(xt, wg, tw["w_up"],
                                             tw["w_down"], dyt, act)),
                    (ops.fused_mlp_dgrad(xt, tw, dyt, act),
                     ops.fused_mlp_wgrad(xt, tw, dyt, act))):
        assert dx.dtype == DTYPES[dtype][1]
        _close(dx, want_dx, dtype, "dx")
        assert (dws[0] is None) == (want_w[0] is None)
        for name, got, want in zip(("w_gate", "w_up", "w_down"), dws,
                                   want_w):
            if want is not None:
                assert got.dtype == DTYPES[dtype][1]
                _close(got, want, dtype, name)


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
def test_column_blocks_sum_to_the_full_backward(act):
    """Per-column-block dgrad/wgrad (the comet backward's consumption of
    dY block by block): dX, dw_up and dw_gate partials sum to the full
    result, the dw_down blocks concatenate to it; each block also matches
    the JAX kernels' column-sliced call."""
    x, w, dy = _problem(act, "fp32", seed=1, N=24)
    tw = {k: _t(v, "fp32") for k, v in w.items()}
    xt, dyt = _t(x, "fp32"), _t(dy, "fp32")
    full_dx = ops.fused_mlp_dgrad(xt, tw, dyt, act)
    full_w = ops.fused_mlp_wgrad(xt, tw, dyt, act)
    blk = 8
    dx = dws = None
    dwd = []
    for b in range(3):
        cs = (b * blk, blk)
        dy_b = dyt[:, :, b * blk:(b + 1) * blk]
        dx_b = ops.fused_mlp_dgrad(xt, tw, dy_b, act, col_slice=cs)
        g_b, u_b, d_b = ops.fused_mlp_wgrad(xt, tw, dy_b, act, col_slice=cs)
        want = jops.fused_mlp_dgrad(_j(x), {k: _j(v) for k, v in w.items()},
                                    _j(dy[:, :, b * blk:(b + 1) * blk]), act,
                                    col_slice=cs, interpret=True)
        _close(dx_b, want, "fp32", f"dx block {b}")
        dx = dx_b if dx is None else dx + dx_b
        parts = (g_b, u_b)
        dws = parts if dws is None else tuple(
            None if a is None else a + p for a, p in zip(dws, parts))
        dwd.append(d_b)
    torch.testing.assert_close(dx, full_dx, rtol=1e-5, atol=1e-5)
    for got, want in zip(dws, full_w[:2]):
        if want is not None:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat(dwd, dim=2), full_w[2])


@pytest.mark.parametrize("act", ACTS)
def test_fused_mlp_autograd_matches_jax_grad(act):
    x, w, dy = _problem(act, "fp32", seed=2)
    keys = sorted(w)

    def jloss(xx, ww):
        return jnp.vdot(jops.fused_mlp(xx, ww, act, interpret=True), _j(dy))

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(
        _j(x), {k: _j(v) for k, v in w.items()})
    xt = _t(x, "fp32").requires_grad_()
    tw = {k: _t(w[k], "fp32").requires_grad_() for k in keys}
    y = ops.fused_mlp(xt, tw, act)
    grads = torch.autograd.grad(y, [xt] + [tw[k] for k in keys],
                                _t(dy, "fp32"))
    _close(grads[0], jgx, "fp32", "x")
    for k, g in zip(keys, grads[1:]):
        _close(g, jgw[k], "fp32", k)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_topk_combine_autograd_matches_jax_grad(dtype):
    rng = np.random.default_rng(3)
    T, k, d = 13, 4, 40
    rows = rng.standard_normal((T, k, d)).astype(np.float32).astype(
        DTYPES[dtype][0])
    wts = rng.random((T, k)).astype(np.float32)
    ct = rng.standard_normal((T, d)).astype(np.float32).astype(
        DTYPES[dtype][0])

    def jloss(r, wv):
        out = jops.topk_combine_diff(r, wv, interpret=True)
        return jnp.vdot(out.astype(jnp.float32), _j(ct).astype(jnp.float32))

    jgr, jgw = jax.grad(jloss, argnums=(0, 1))(_j(rows), _j(wts))
    rt = _t(rows, dtype).requires_grad_()
    wt = torch.from_numpy(wts).requires_grad_()
    out = ops.topk_combine_diff(rt, wt)
    assert out.dtype == DTYPES[dtype][1]
    gr, gw = torch.autograd.grad(out, [rt, wt], _t(ct, dtype))
    assert gr.dtype == DTYPES[dtype][1] and gw.dtype == torch.float32
    _close(gr, jgr, dtype, "rows")
    _close(gw, jgw, dtype, "weights")
