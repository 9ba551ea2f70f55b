"""The port's attention (dense, chunked online-softmax, decode) against the
JAX package's, fp32 1e-4, on GQA inputs from a seeded numpy RNG: rows at
different absolute positions, and block sizes that tile the sequence or
leave the chunked path to fall back to the dense one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as A

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, H, HKV, HD = 2, 4, 2, 8


def _inputs(seed, Sq, Sk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, HD), dtype=np.float32)
    k = rng.standard_normal((B, Sk, HKV, HD), dtype=np.float32)
    v = rng.standard_normal((B, Sk, HKV, HD), dtype=np.float32)
    # each row's chunk starts at its own cache offset
    off = rng.integers(0, Sk - Sq + 1, size=B)
    q_pos = (off[:, None] + np.arange(Sq)[None, :]).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    return q, k, v, q_pos, kv_pos


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("Sq,Sk,q_block,kv_block", [
    (8, 32, 4, 8),        # tiles: the online-softmax loop
    (8, 32, 8, 32),       # one block each way
    (6, 20, 4, 8),        # does not tile: the dense fallback
])
def test_chunked_attention_matches_jax(Sq, Sk, q_block, kv_block):
    q, k, v, q_pos, kv_pos = _inputs(Sq * Sk, Sq, Sk)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), True, q_block, kv_block,
                                q_pos=jnp.asarray(q_pos),
                                kv_pos=jnp.asarray(kv_pos))
    got = A.chunked_attention(_t(q), _t(k), _t(v), q_block, kv_block,
                              _t(q_pos).long(), _t(kv_pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = A.dense_attention(_t(q), _t(k), _t(v), _t(q_pos).long(),
                              _t(kv_pos).long())
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **TOL)


def test_decode_attention_matches_jax():
    S = 16
    q, k, v, _, _ = _inputs(7, 1, S)
    pos = np.array([3, 15], np.int32)            # per-row current index
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(pos))
    got = A.decode_attention(_t(q), _t(k), _t(v), _t(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
