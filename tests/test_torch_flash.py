"""The port's flash attention against the JAX package, on inputs from a
seeded numpy RNG: ``ref.flash_attention_ref`` and ``ops.flash_attention``
(CPU: the plain version) against the JAX Pallas kernel in interpret mode at
the cases of tests/test_kernels.py::test_flash_attention (MHA, GQA, MQA, a
sequence that is no power of two; causal and not; fp32 1e-4, bf16 2e-2),
the gradient through the op against ``jax.grad`` of JAX
``ref.flash_attention_ref``, and the training forward's routing: causal
attention with default positions and no mask goes through the op, a masked
forward keeps the plain attention."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import lm

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(seed, B, Hq, Hkv, S, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, hd), dtype=np.float32),
            rng.standard_normal((B, Hkv, S, hd), dtype=np.float32),
            rng.standard_normal((B, Hkv, S, hd), dtype=np.float32))


@pytest.mark.parametrize("B,Hq,Hkv,S,hd", [
    (1, 4, 4, 128, 64),        # MHA
    (2, 8, 2, 256, 64),        # GQA 4:1
    (1, 4, 1, 128, 128),       # MQA
    (2, 2, 2, 384, 32),        # non-pow2 seq
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel(B, Hq, Hkv, S, hd, causal,
                                            dtype):
    q, k, v = _qkv(S + Hq, B, Hq, Hkv, S, hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jin = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    tin = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    want = np.asarray(jops.flash_attention(*jin, causal=causal,
                                           interpret=True), np.float32)
    got = ops.flash_attention(*tin, causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    np.testing.assert_allclose(
        ref.flash_attention_ref(*tin, causal=causal).float().numpy(),
        np.asarray(jref.flash_attention_ref(*jin, causal=causal),
                   np.float32), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradient_matches_jax(causal):
    q, k, v = _qkv(9, 2, 4, 2, 24, 16)
    ct = np.random.default_rng(10).standard_normal(q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, causal=causal)
                       * jnp.asarray(ct))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (ops.flash_attention(*tin, causal=causal)
     * torch.from_numpy(ct)).sum().backward()
    for name, t, g in zip("qkv", tin, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=name, **TOL["float32"])


def test_flash_reference_equals_the_model_attention():
    """On the model's layout (B, S, H, hd), the plain flash version and the
    model's dense attention with positions arange(S) agree: the route the
    training forward switches to computes the same function."""
    q, k, v = _qkv(3, 2, 4, 2, 40, 8)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    pos = torch.arange(40)[None, :].expand(2, 40)
    dense = A.dense_attention(tq, tk, tv, pos, pos, causal=True)
    flash = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("batch_extra,want_calls", [
    ({}, 2),                              # default positions, 2 layers
    ({"mask": True}, 0),                             # a pad mask
    ({"positions": True}, 0),                        # given positions
])
def test_training_attention_routes_through_flash(monkeypatch, batch_extra,
                                                 want_calls):
    cfg = get_config("qwen2-moe-2.7b-smoke")
    p = lm.init_params(cfg, 0, "cpu")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    toks = torch.randint(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": toks, "labels": toks}
    if "mask" in batch_extra:
        batch["mask"] = torch.ones((2, 16), dtype=torch.bool)
    if "positions" in batch_extra:
        batch["positions"] = torch.arange(16)[None, :].expand(2, 16)
    lm.loss_fn(cfg, p, batch)
    assert len(calls) == want_calls
