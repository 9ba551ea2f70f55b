"""The bridge carries every JAX leaf across with its shape and dtype, and
bf16 weights come back bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-moe-2.7b-smoke", "float32"),
    ("qwen2-moe-2.7b-smoke", "bfloat16"),
    ("granite-moe-bigmac-smoke", "bfloat16"),
])
def test_round_trip(arch, dtype):
    jcfg = dataclasses.replace(jax_config(arch), param_dtype=dtype)
    cfg = dataclasses.replace(get_config(arch), param_dtype=dtype)
    pnp = jax.tree.map(np.asarray, jlm.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))
    tp = bridge.from_jax(pnp, cfg, "cpu")
    schema = dict(tree_leaves(lm.model_schema(cfg)))
    back = dict(tree_leaves(bridge.to_numpy(tp)))
    src = dict(tree_leaves(pnp))
    assert set(back) == set(src) == set(schema)
    for path, t in tree_leaves(tp):
        decl = schema[path]
        assert tuple(t.shape) == decl.shape, path
        assert t.dtype == decl.leaf_dtype(getattr(torch, dtype)), path
        assert str(src[path].dtype) == str(t.dtype).replace("torch.", ""), \
            path
        np.testing.assert_array_equal(back[path],
                                      src[path].astype(np.float32))


def test_rejects_mismatched_trees():
    arch = "qwen2-moe-2.7b-smoke"
    cfg = get_config(arch)
    pnp = jax.tree.map(np.asarray,
                       jlm.init_params(jax_config(arch),
                                       jax.random.PRNGKey(0)))
    bad = dict(pnp, embed=pnp["embed"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        bridge.from_jax(bad, cfg, "cpu")
    bad = dict(pnp, embed=pnp["embed"].astype(np.float16))
    with pytest.raises(TypeError, match="embed"):
        bridge.from_jax(bad, cfg, "cpu")
    bad = {k: v for k, v in pnp.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="lm_head"):
        bridge.from_jax(bad, cfg, "cpu")
