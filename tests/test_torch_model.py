"""Whole-model parity on qwen2-moe-2.7b-smoke: a stacked ``prefill_chunk``
(rows of different valid lengths, slot gather/scatter, a second chunk on
top of the first) and ``decode_step`` at per-row positions, logits and KV
caches against the JAX package, fp32 1e-4, with bridged weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ARCH = "qwen2-moe-2.7b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _i(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _check_cache(jc, tc):
    for je, te in zip(jc, tc):
        for k in ("k", "v"):
            np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                       **TOL)


def test_prefill_chunks_then_decode_match_jax(models):
    jcfg, cfg, jp, tp = models
    rng = np.random.default_rng(0)
    B, S, A, C = 4, 64, 3, 16
    slots = np.array([2, 0, 3], np.int32)
    jc = jlm.init_cache(jcfg, B, S)
    tc = lm.init_cache(cfg, B, S, "cpu")
    # two stacked chunk steps: row 1 ends in the first chunk and rides the
    # second as an identity row (valid_len 0)
    plens = np.array([27, 9, 16], np.int32)
    for j in range(2):
        toks = rng.integers(0, cfg.vocab_size, (A, C)).astype(np.int32)
        valid = np.clip(plens - j * C, 0, C).astype(np.int32)
        off = np.full((A,), j * C, np.int32)
        jl, jc = jlm.prefill_chunk(jcfg, jp, jc, jnp.asarray(toks),
                                   jnp.asarray(off), jnp.asarray(valid),
                                   slot=jnp.asarray(slots))
        tl, tc = lm.prefill_chunk(cfg, tp, tc, _i(toks), _i(off), _i(valid),
                                  _i(slots))
        assert tl.dtype == torch.float32 and tl.shape == (A, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _check_cache(jc, tc)
    # decode every slot at its own position (slot 1 is a free slot)
    pos = np.array([9, 5, 27, 16], np.int32)
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(toks),
                                 jnp.asarray(pos))
        tl, tc = lm.decode_step(cfg, tp, tc, _i(toks), _i(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _check_cache(jc, tc)
        pos = pos + 1


def test_init_params_follows_the_schema():
    cfg = get_config(ARCH)
    p = lm.init_params(cfg, seed=0, device="cpu")
    from repro_torch.models.common import tree_leaves
    schema = dict(tree_leaves(lm.model_schema(cfg)))
    leaves = dict(tree_leaves(p))
    assert set(leaves) == set(schema)
    for path, decl in schema.items():
        assert tuple(leaves[path].shape) == decl.shape, path
        want = torch.float32
        assert leaves[path].dtype == want, path
    again = lm.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], p["embed"])
