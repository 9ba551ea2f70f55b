"""The MoE layer at one rank: the port's ``moe_ffn`` against
``repro.core.moe_layer.moe_ffn`` for every transport and GroupGEMM backend
(the JAX kernel backends in interpret mode), on the same numpy weights."""
import dataclasses

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


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    dw = m.wire_dim or d

    def nrm(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    p = {"router": nrm(d, m.num_experts, fan_in=d),
         "experts": {"w_gate": nrm(1, m.num_experts, dw, m.d_expert,
                                   fan_in=dw),
                     "w_up": nrm(1, m.num_experts, dw, m.d_expert, fan_in=dw),
                     "w_down": nrm(1, m.num_experts, m.d_expert, dw,
                                   fan_in=m.d_expert)}}
    if m.wire_dim:
        p["w_desc"] = nrm(d, dw, fan_in=d)
        p["w_asc"] = nrm(dw, d, fan_in=dw)
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _run(arch, S, **moe_kw):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **moe_kw))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    p = _params(cfg, 7)
    x = np.random.default_rng(8).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jy, jaux = JM.moe_ffn(jcfg, jcfg.moe, _tree(p, jnp.asarray),
                          jnp.asarray(x), AxisCtx())
    y, aux = M.moe_ffn(cfg, cfg.moe, _tree(p, torch.from_numpy),
                       torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("gemm_impl", ["xla", "pallas", "pallas_fused"])
@pytest.mark.parametrize("impl,S", [("naive", 6), ("comet", 6), ("bcast", 1),
                                    ("dense", 6)])
def test_moe_ffn_matches_jax(impl, S, gemm_impl):
    _run("qwen2-moe-2.7b-smoke", S, impl=impl, gemm_impl=gemm_impl)


@pytest.mark.parametrize("gemm_impl", ["xla", "pallas_fused"])
def test_moe_ffn_fused_combine_matches_jax(gemm_impl):
    _run("qwen2-moe-2.7b-smoke", 6, impl="comet", fused_combine=True,
         n_col_blocks=2, gemm_impl=gemm_impl)


@pytest.mark.parametrize("impl,S", [("comet", 6), ("naive", 1)])
def test_moe_ffn_bigmac_wire_dim_matches_jax(impl, S):
    _run("granite-moe-bigmac-smoke", S, impl=impl)


def test_pack_expert_weights_matches_jax():
    rng = np.random.default_rng(0)
    full = {"w_up": rng.standard_normal((4, 6, 8)).astype(np.float32),
            "w_down": rng.standard_normal((4, 8, 6)).astype(np.float32)}
    want = JM.pack_expert_weights(_tree(full, jnp.asarray), ep=2, etp=2)
    got = M.pack_expert_weights(_tree(full, torch.from_numpy), ep=2, etp=2)
    for k in full:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("gemm_impl", ["xla", "pallas", "pallas_fused"])
def test_mlp_col_blocks_concatenate_to_the_full_mlp(gemm_impl):
    """The layer-1 producer interface of the comet ring: per-column-block
    outputs concatenate to the full-width expert MLP, for every backend."""
    from repro_torch.core import transport as T
    cfg = get_config("qwen2-moe-2.7b-smoke")
    p = _tree(_params(cfg, 9), torch.from_numpy)
    w = {k: v[0] for k, v in p["experts"].items()}
    rows = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (w["w_up"].shape[0], 12, cfg.d_model)).astype(np.float32))
    full = T._mlp_out(rows, w, cfg.activation, gemm_impl)
    blocks = T.mlp_col_blocks(rows, w, cfg.activation, 4, cfg.d_model // 4,
                              gemm_impl)
    torch.testing.assert_close(torch.cat(blocks, dim=-1), full, rtol=1e-5,
                               atol=1e-5)


_WIRES = ["fp32", "bf16", "fp8_e4m3"]


@pytest.mark.parametrize("fused_combine", [False, True])
@pytest.mark.parametrize("wire_dtype", _WIRES)
def test_comet_hier_wire_matches_jax(wire_dtype, fused_combine):
    """At one rank comet_hier quantizes the dispatch buffer to the wire
    format, one scale per chunk, before the comet arm."""
    _run("qwen2-moe-2.7b-smoke", 6, impl="comet_hier", wire_dtype=wire_dtype,
         fused_combine=fused_combine, n_col_blocks=2)


def _jax_and_torch_grads(S, **moe_kw):
    """jax.grad of the JAX layer and torch.autograd through the port's, for
    x and every parameter, on qwen2-moe-2.7b-smoke in fp32: (JAX params'
    grads, JAX x grad, port params with .grad, port x with .grad)."""
    import jax
    arch = "qwen2-moe-2.7b-smoke"
    jcfg, cfg = jax_config(arch), get_config(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **moe_kw))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    p = _params(cfg, 7)
    x = np.random.default_rng(8).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)

    def jloss(pp, xx):
        y, aux = JM.moe_ffn(jcfg, jcfg.moe, pp, xx, AxisCtx())
        return jnp.sum(y ** 2) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_tree(p, jnp.asarray),
                                               jnp.asarray(x))
    tp = _tree(p, lambda a: torch.from_numpy(a).requires_grad_())
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = M.moe_ffn(cfg, cfg.moe, tp, xt)
    (torch.sum(y ** 2) + aux).backward()
    return jgp, jgx, tp, xt


def _assert_expert_grads_match(jgp, jgx, tp, xt):
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4, err_msg="x")
    for k in jgp["experts"]:
        np.testing.assert_allclose(tp["experts"][k].grad.numpy(),
                                   np.asarray(jgp["experts"][k]), rtol=1e-4,
                                   atol=1e-4, err_msg=f"experts[{k}]")
    assert np.abs(np.asarray(jgx)).max() > 0


@pytest.mark.parametrize("fused_combine", [False, True])
@pytest.mark.parametrize("wire_dtype", _WIRES)
def test_comet_hier_wire_grads_match_jax(wire_dtype, fused_combine):
    """The quantization is straight through: jax.grad of the JAX layer
    against torch.autograd through the port's, for x and every expert
    weight, fp32 1e-4."""
    _assert_expert_grads_match(*_jax_and_torch_grads(
        6, impl="comet_hier", wire_dtype=wire_dtype,
        fused_combine=fused_combine, n_col_blocks=2))


@pytest.mark.parametrize("impl,S", [("naive", 6), ("dense", 6),
                                    ("bcast", 1)])
def test_pallas_backend_refuses_gradients_as_jax_does(impl, S):
    """The "pallas" grouped GEMM has no backward: jax.grad through the JAX
    layer raises in pallas_call, and torch.autograd through the port's
    raises by name (on the card its kernel's output would carry no
    grad_fn, and the expert weights would get no gradient)."""
    with pytest.raises(AssertionError):
        _jax_and_torch_grads(S, impl=impl, gemm_impl="pallas")
    arch = "qwen2-moe-2.7b-smoke"
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl=impl, gemm_impl="pallas"))
    p = _tree(_params(cfg, 7), lambda a: torch.from_numpy(a)
              .requires_grad_())
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    with pytest.raises(RuntimeError, match='"pallas" GroupGEMM backend'):
        M.moe_ffn(cfg, cfg.moe, p, x)
    # the same layer without gradients (serving) runs
    with torch.no_grad():
        y, _ = M.moe_ffn(cfg, cfg.moe, p, x)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("n_col_blocks,fused_combine", [(1, False),
                                                        (2, True)])
def test_comet_pallas_grads_match_jax(n_col_blocks, fused_combine):
    """The comet arm calls the grouped GEMM with grad mode off and has a
    hand-written backward, in both packages: under "pallas" the gradients
    of x and every expert weight match JAX at fp32 1e-4."""
    _assert_expert_grads_match(*_jax_and_torch_grads(
        6, impl="comet", gemm_impl="pallas", n_col_blocks=n_col_blocks,
        fused_combine=fused_combine))


def test_comet_hier_rejects_an_unknown_wire_dtype():
    arch = "qwen2-moe-2.7b-smoke"
    jcfg, cfg = jax_config(arch), get_config(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, impl="comet_hier", wire_dtype="int3"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="comet_hier", wire_dtype="int3"))
    p = _params(cfg, 7)
    x = np.zeros((2, 6, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="int3"):
        JM.moe_ffn(jcfg, jcfg.moe, _tree(p, jnp.asarray), jnp.asarray(x),
                   AxisCtx())
    with pytest.raises(ValueError, match="int3"):
        M.moe_ffn(cfg, cfg.moe, _tree(p, torch.from_numpy),
                  torch.from_numpy(x))
