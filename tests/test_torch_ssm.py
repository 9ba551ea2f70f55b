"""The port's Mamba-2 SSD against the JAX package, on inputs from a seeded
numpy RNG: the plain forms of ``kernels/ref.py`` (``ssd_chunked``, y and
the final state at several chunks and with an initial state, and the
sequential oracle ``ssd_ref``) and ``ops.ssd_forward`` (CPU: the plain
chunked form) against the JAX Pallas kernel in interpret mode,
``_causal_conv``, the block's ``ssm_forward`` with and without a pad mask,
and the op's gradient against ``jax.grad`` of JAX ``ssd_chunked``.
fp32 1e-4, bf16 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.models import ssm as S

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ARCH = "mamba2-780m-smoke"


def _inputs(seed, B, Sq, nh, hd, ds):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Sq, nh, hd), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, Sq, nh),
                                             dtype=np.float32)))
    A = -np.exp(rng.standard_normal(nh).astype(np.float32) * 0.3)
    Bm = rng.standard_normal((B, Sq, ds), dtype=np.float32)
    Cm = rng.standard_normal((B, Sq, ds), dtype=np.float32)
    D = np.full((nh,), 0.5, np.float32)
    return x, dt, A, Bm, Cm, D


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    x, dt, A, Bm, Cm, D = _inputs(chunk, 2, 64, 4, 16, 8)
    h0 = (np.random.default_rng(1).standard_normal((2, 4, 8, 16))
          .astype(np.float32) if with_h0 else None)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)), chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    ty, th = ref.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, D)), chunk,
                           h0=None if h0 is None else _t(h0))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL["float32"])


# the shapes of tests/test_kernels.py::test_ssd_forward
KERNEL_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 64),
                 (1, 32, 1, 8, 4, 32), (2, 96, 2, 16, 8, 32)]


@pytest.mark.parametrize("B,Sq,nh,hd,ds,chunk", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_forward_matches_jax_kernel(B, Sq, nh, hd, ds, chunk, dtype):
    """ops.ssd_forward (CPU: the plain chunked form) against the JAX
    Pallas kernel (interpret mode) at the same chunk, and the port's
    sequential oracle against the JAX oracle."""
    x, dt, A, Bm, Cm, D = _inputs(Sq + ds, B, Sq, nh, hd, ds)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    jin = (jx, jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
           jnp.asarray(Cm), jnp.asarray(D))
    tin = (_t(x, tdt), _t(dt), _t(A), _t(Bm), _t(Cm), _t(D))
    want = jops.ssd_forward(*jin, chunk=chunk, interpret=True)
    got = ops.ssd_forward(*tin, chunk=chunk)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(ref.ssd_ref(*tin)),
                               np.asarray(jref.ssd_ref(*jin), np.float32),
                               **TOL[dtype])


def test_ssd_forward_pads_a_ragged_length():
    """ops.ssd_forward on the CPU at a length its chunk does not divide:
    the plain version pads the last chunk with identity steps, as the
    kernel does, and agrees with the JAX package's sequential oracle."""
    x, dt, A, Bm, Cm, D = _inputs(21, 2, 80, 3, 16, 8)
    got = ops.ssd_forward(*map(_t, (x, dt, A, Bm, Cm, D)), chunk=32)
    want = jref.ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)))
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    b = rng.standard_normal(6, dtype=np.float32)
    st = rng.standard_normal((2, 3, 6), dtype=np.float32)
    for state in (None, st):
        jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if state is None else jnp.asarray(state))
        ty, ts = S._causal_conv(_t(x), _t(w), _t(b),
                                None if state is None else _t(state))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL["float32"])
        np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL["float32"])


def _ssm_layer(seed):
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    from repro.models import lm as jlm
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0]["ssm"])
    tl = {k: v[0] for k, v in tp["layers"][0]["ssm"].items()}
    return jcfg, cfg, jl, tl


@pytest.mark.parametrize("masked", [False, True])
def test_ssm_forward_matches_jax(masked):
    jcfg, cfg, jl, tl = _ssm_layer(4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, cfg.d_model), dtype=np.float32)
    mask = None
    if masked:      # left padding of 7 in row 0, a full row 1
        mask = np.ones((2, 40), bool)
        mask[0, :7] = False
    jy, _ = JS.ssm_forward(jcfg, jcfg.ssm, jl, jnp.asarray(x),
                           mask=None if mask is None else jnp.asarray(mask))
    ty, cache = S.ssm_forward(cfg, cfg.ssm, tl, _t(x),
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    assert cache is None
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL["float32"])


def test_ssd_op_gradient_matches_jax():
    """The op's backward (ssd_chunked recomputed under autograd) against
    jax.grad of JAX ssd_chunked, for all six inputs."""
    x, dt, A, Bm, Cm, D = _inputs(11, 2, 48, 3, 8, 4)
    ct = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32)
    chunk = 16

    def jloss(*a):
        return jnp.sum(JS.ssd_chunked(*a, chunk)[0] * jnp.asarray(ct))

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm, D)))
    tin = [_t(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm, D)]
    (ops.ssd_forward(*tin, chunk=chunk) * _t(ct)).sum().backward()
    for name, t, g in zip(("x", "dt", "A", "Bm", "Cm", "D"), tin, jg):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), err_msg=name,
                                   **TOL["float32"])


def test_ssd_chunked_gradient_is_finite_on_long_decaying_chunks():
    """A chunk whose decay sums far below -88 overflows exp above the
    diagonal; the mask goes in before the exp, so the gradient stays
    finite and equals the one at a short chunk."""
    x, dt, A, Bm, Cm, D = _inputs(13, 1, 128, 2, 8, 4)
    A = np.full_like(A, -4.0)                  # about -4 * 0.8 per step
    grads = []
    for chunk in (128, 16):
        tin = [_t(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm, D)]
        ref.ssd_chunked(*tin, chunk)[0].sum().backward()
        grads.append([t.grad for t in tin])
    for g128, g16 in zip(*grads):
        assert torch.isfinite(g128).all()
        np.testing.assert_allclose(_np(g128), _np(g16), **TOL["float32"])


def test_ssm_configs_reach_the_kernel_op(monkeypatch):
    """The training forward of an SSM layer goes through ops.ssd_forward
    at the config's chunk."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    p = lm.init_params(cfg, 0, "cpu")
    calls = []
    real = ops.ssd_forward
    monkeypatch.setattr(ops, "ssd_forward",
                        lambda *a, **k: calls.append(a[-1]) or real(*a, **k))
    toks = torch.randint(0, cfg.vocab_size, (2, 32))
    lm.loss_fn(cfg, p, {"tokens": toks, "labels": toks})
    assert calls == [cfg.ssm.chunk_size] * cfg.n_layers
