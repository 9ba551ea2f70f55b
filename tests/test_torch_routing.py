"""Routing parity: the port's router, dispatch and combine against
``repro.core.routing`` on the same numpy inputs. Dispatch is bit-exact in
fp32 (same stable sort, same capacity drops)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import routing as JR
from repro_torch.core import routing as R

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)


def _mcfg(top_k, E, cf):
    base = jax_config("qwen2-moe-2.7b-smoke").moe
    return dataclasses.replace(base, num_experts=E, top_k=top_k,
                               capacity_factor=cf)


@pytest.mark.parametrize("T,E,k,cf,norm", [(24, 8, 4, 1.25, True),
                                           (24, 8, 2, 0.5, False),
                                           (7, 4, 1, 1.0, True)])
def test_router_and_dispatch(T, E, k, cf, norm):
    rng = np.random.default_rng(T * E + k)
    d = 16
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.standard_normal((d, E)).astype(np.float32)
    mcfg = dataclasses.replace(_mcfg(k, E, cf), router_norm_topk=norm)
    j_idx, j_w, j_aux = JR.router(jnp.asarray(x), jnp.asarray(w), mcfg)
    idx, wts, aux = R.router(torch.from_numpy(x), torch.from_numpy(w), mcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(wts.numpy(), np.asarray(j_w), rtol=1e-5,
                               atol=1e-6)
    assert wts.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)

    C = R.capacity(T, k, E, cf)
    assert C == JR.capacity(T, k, E, cf) and C % 4 == 0
    j_buf, j_info = JR.build_dispatch(jnp.asarray(x), j_idx, E, C)
    buf, info = R.build_dispatch(torch.from_numpy(x), idx, E, C)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(j_buf))
    np.testing.assert_array_equal(info.flat_e.numpy(),
                                  np.asarray(j_info.flat_e))
    np.testing.assert_array_equal(info.pos.numpy(), np.asarray(j_info.pos))
    np.testing.assert_array_equal(info.keep.numpy(),
                                  np.asarray(j_info.keep))
    if cf < 1:
        assert not info.keep.all(), "the case must exercise capacity drops"


@pytest.mark.parametrize("ep,rot", [(1, None), (2, None), (2, 1), (4, 3)])
def test_combine(ep, rot):
    rng = np.random.default_rng(ep)
    T, k, E, d = 12, 2, 8, 24
    E_loc = E // ep
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    x = rng.standard_normal((T, d)).astype(np.float32)
    C = R.capacity(T, k, E, 0.75)
    _, j_info = JR.build_dispatch(jnp.asarray(x), jnp.asarray(idx), E, C)
    _, info = R.build_dispatch(torch.from_numpy(x), torch.from_numpy(idx),
                               E, C)
    recv = rng.standard_normal((ep * E_loc * C, d)).astype(np.float32)
    wts = rng.random((T, k)).astype(np.float32)
    want = JR.combine(jnp.asarray(recv), j_info, jnp.asarray(wts), E_loc, C,
                      None if rot is None else jnp.int32(rot), ep)
    got = R.combine(torch.from_numpy(recv), info, torch.from_numpy(wts),
                    E_loc, C, rot, ep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
