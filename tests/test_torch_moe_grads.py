"""Gradients of the MoE layer at one rank: ``jax.grad`` of the JAX package's
``moe_ffn`` (the comet custom VJP; the Pallas dgrad/wgrad kernels in
interpret mode) against ``torch.autograd`` through the port's ``moe_ffn``
(the comet arm's ``autograd.Function``, the plain dgrad/wgrad on the CPU),
for the router, every expert weight and the input, fp32 1e-4. The grid is
the non-slow part of ``tests/test_backward_overlap.py``'s ``_GRID``, with
two column blocks, plus capacity drops."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import moe_layer as JM
from repro.parallel.mesh import AxisCtx
from repro_torch.configs import get_config
from repro_torch.core import moe_layer as M

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)


def _problem(activation, E=8, d=32, f=16, B=2, S=16, k=2, cap=None, seed=0):
    """The JAX test's problem (test_backward_overlap._problem), with numpy
    inputs."""
    rng = np.random.default_rng(seed)

    def nrm(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    experts = {"w_up": nrm(1, E, d, f), "w_down": nrm(1, E, f, d)}
    if activation in ("swiglu", "geglu"):
        experts["w_gate"] = nrm(1, E, d, f)
    params = {"router": nrm(d, E), "experts": experts}
    x = nrm(B, S, d, scale=1.0)
    moe = dict(num_experts=E, d_expert=f, top_k=k,
               capacity_factor=cap if cap else float(E))
    return moe, params, x


def _cfgs(activation, d, moe):
    jc, tc = jax_config(ARCH), get_config(ARCH)
    jc = dataclasses.replace(jc, d_model=d, activation=activation,
                             moe=dataclasses.replace(jc.moe, **moe))
    tc = dataclasses.replace(tc, d_model=d, activation=activation,
                             moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _jax_grads(jc, params, x):
    def loss(p, xx):
        y, aux = JM.moe_ffn(jc, jc.moe, p, xx, AxisCtx())
        return jnp.sum(y ** 2) + aux
    gp, gx = jax.grad(loss, argnums=(0, 1))(_tree(params, jnp.asarray),
                                            jnp.asarray(x))
    return _tree(gp, np.asarray), np.asarray(gx)


def _torch_grads(tc, params, x):
    p = _tree(params, lambda a: torch.from_numpy(a).requires_grad_())
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = M.moe_ffn(tc, tc.moe, p, xt)
    (torch.sum(y ** 2) + aux).backward()
    return _tree(p, lambda t: t.grad.numpy()), xt.grad.numpy()


def _compare(activation, moe, **prob):
    moe_p, params, x = _problem(activation, **prob)
    moe = {**moe_p, **moe}
    jc, tc = _cfgs(activation, x.shape[-1], moe)
    jp, jx = _jax_grads(jc, params, x)
    tp, tx = _torch_grads(tc, params, x)
    np.testing.assert_allclose(tx, jx, err_msg="x", **TOL)
    np.testing.assert_allclose(tp["router"], jp["router"], err_msg="router",
                               **TOL)
    for k in jp["experts"]:
        np.testing.assert_allclose(tp["experts"][k], jp["experts"][k],
                                   err_msg=f"experts[{k}]", **TOL)
    assert np.abs(jx).max() > 0 and np.abs(jp["router"]).max() > 0


@pytest.mark.parametrize("gemm,activation,fused_combine", [
    ("xla", "swiglu", False),
    ("xla", "swiglu", True),
    ("xla", "gelu", False),
    ("pallas_fused", "swiglu", True),
    ("pallas_fused", "gelu", False),
])
def test_comet_grads_match_jax(gemm, activation, fused_combine):
    _compare(activation, dict(impl="comet", n_col_blocks=2,
                              fused_combine=fused_combine, gemm_impl=gemm))


@pytest.mark.parametrize("gemm", ["xla", "pallas_fused"])
def test_comet_grads_with_capacity_drops_match_jax(gemm):
    """capacity factor 0.5: a quarter of the (token, choice) pairs and
    more are dropped, so the dispatch gather and the combine's keep-mask
    shape the gradient."""
    _compare("swiglu", dict(impl="comet", n_col_blocks=2,
                            fused_combine=True, gemm_impl=gemm), cap=0.5)


@pytest.mark.parametrize("gemm", ["xla", "pallas_fused"])
def test_naive_grads_match_jax(gemm):
    """The naive transport differentiates through ops.fused_mlp's own
    backward (the dgrad/wgrad pair) or through torch.bmm."""
    _compare("geglu", dict(impl="naive", gemm_impl=gemm))
