"""The port's RMSNorm against the JAX package, on inputs from a seeded numpy
RNG: the plain version of the TPU kernel (``ref.rmsnorm_ref``, the kernel's
``tpu`` epilogue) against the JAX Pallas kernel in interpret mode and its
oracle, at the JAX test's shapes (``tests/test_kernels.py:91-92``); the
model's norm ``ops.rms_norm`` (the ``model`` epilogue; the plain form on
the CPU) against the JAX ``models.common.rms_norm`` with non-unit scales,
and its gradient against ``jax.grad``; the model's norm regions go through
``ops.rms_norm``. fp32 1e-4, bf16 2e-2. The kernel itself runs only on the
card (``test_torch_cuda_kernels.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref, rmsnorm
from repro_torch.models import lm

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, T, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d), dtype=np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, s


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("T,d", [(256, 128), (100, 896), (8, 64),
                                 (1024, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_jax_kernel(T, d, dtype):
    """The plain version of the TPU kernel against the JAX Pallas kernel
    (interpret mode) and the JAX oracle."""
    x, s = _inputs(T + d, T, d)
    jx = jnp.asarray(x).astype(JDT[dtype])
    want = jops.rmsnorm(jx, jnp.asarray(s), interpret=True)
    got = ref.rmsnorm_ref(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(s))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(
        _np(got), np.asarray(jref.rmsnorm_ref(jx, jnp.asarray(s)),
                             np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 96), (5, 1536)])
def test_rms_norm_op_matches_jax_model_norm(dtype, shape):
    """ops.rms_norm (the model epilogue's plain form on the CPU) against
    the JAX model's norm, which rounds twice in bf16: the same bits up to
    the reduction order."""
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape, dtype=np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x).astype(JDT[dtype]),
                            jnp.asarray(s), 1e-6)
    got = ops.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(s), 1e-6)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    # the two epilogues agree in fp32 and differ by the rounding in bf16
    tpu = ref.rmsnorm_ref(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(_np(got), _np(tpu), **TOL[dtype])


def test_rms_norm_gradient_matches_jax():
    x, s = _inputs(3, 6, 80)
    ct = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)

    def jloss(x_, s_):
        return jnp.sum(jcommon.rms_norm(x_, s_, 1e-5) * jnp.asarray(ct))

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    (ops.rms_norm(tx, ts, 1e-5) * torch.from_numpy(ct)).sum().backward()
    for name, t, g in (("x", tx, jg[0]), ("scale", ts, jg[1])):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g),
                                   err_msg=name, **TOL["float32"])


@pytest.mark.parametrize("arch,per_layer", [("qwen2-moe-2.7b-smoke", 2),
                                            ("mamba2-780m-smoke", 2)])
def test_every_model_norm_goes_through_the_op(arch, per_layer, monkeypatch):
    """apply_norm (ln1, ln2, ln_f) and the SSM block's gated norm call
    ops.rms_norm: 2 per layer + ln_f in one forward, the count the card's
    launch counters are held to."""
    cfg = get_config(arch)
    p = lm.init_params(cfg, 0, "cpu")
    calls = []
    real = ops.rms_norm
    monkeypatch.setattr(ops, "rms_norm",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    toks = torch.randint(1, cfg.vocab_size, (2, 16))
    lm.forward(cfg, p, {"tokens": toks})
    assert len(calls) == per_layer * cfg.n_layers + 1


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: a CPU tensor never reaches a plain
    version through it."""
    x = torch.ones((4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm.rmsnorm(x, torch.ones(64), epilogue="model")


# (T, d, itemsize, vec): mamba2-780m's prefill step (2048 rows of 1536, its
# gated norm at 3072), qwen2's 2048, decode (8 rows: a row over up to 8
# warps, at 1536 and at the gated 3072), a train step's 8192 rows, jamba's
# gated width 8192, fp32, and scalar widths; warps per row, loads per lane, rows per block, threads and
# blocks on an H100 (132 SMs)
@pytest.mark.parametrize("T,d,isz,vec,wpr,nv,groups,threads,blocks", [
    (2048, 1536, 2, True, 1, 6, 8, 256, 256),
    (2048, 2048, 2, True, 1, 8, 8, 256, 256),
    (2048, 3072, 2, True, 2, 6, 4, 256, 264),
    (8, 1536, 2, True, 8, 1, 1, 256, 8),
    (8, 3072, 2, True, 8, 2, 1, 256, 8),
    (8192, 1536, 2, True, 1, 6, 8, 256, 264),
    (5, 8192, 2, True, 8, 4, 1, 256, 5),
    (2048, 1536, 4, True, 2, 6, 4, 256, 264),
    (5, 8192, 4, True, 8, 8, 1, 256, 5),
    (3, 1001, 2, False, 8, 4, 1, 256, 3),
    (4, 100, 2, False, 4, 1, 1, 128, 4),
    (8, 64, 2, True, 1, 1, 1, 32, 8),
])
def test_rmsnorm_launch_plan(T, d, isz, vec, wpr, nv, groups, threads,
                             blocks):
    plan = rmsnorm.launch_plan(T, d, isz, vec, sm_count=132)
    assert (plan["warps_per_row"], plan["vectors_per_lane"],
            plan["rows_per_block"], plan["threads"], plan["blocks"]) == \
        (wpr, nv, groups, threads, blocks)
    lanes = 16 // isz if vec else 1
    assert plan["lanes"] == lanes and plan["vectors"] * lanes == d
    # the lanes of a row cover it, each with at most 8 loads (for fewer
    # rows than SMs, one load where 8 warps' lanes cover the row); a block
    # is at most 512 threads; every row has a group, and no more than
    # RESIDENT_WARPS warps' worth of blocks per SM are launched
    assert 32 * wpr * nv >= plan["vectors"]
    assert nv <= rmsnorm.MAX_VECTORS and threads <= rmsnorm.MAX_THREADS
    if T < 132 and plan["vectors"] <= 32 * rmsnorm.LATENCY_WARPS:
        assert nv == 1
    assert -(-T // groups) >= blocks
    assert blocks * threads // 32 <= 132 * rmsnorm.RESIDENT_WARPS
    # a block per row for fewer rows than SMs, the scale then in each
    # lane's registers; else shared by the block's rows in shared memory
    regs = plan["scale_in_registers"]
    assert regs == (T < 132 and nv <= rmsnorm.REG_SCALE_VECTORS)
    if regs:
        assert (groups, blocks) == (1, T)
    assert plan["smem_bytes"] == (0 if regs else 4 * d)


@pytest.mark.parametrize("d,isz,vec", [(32768 + 8, 2, True),
                                       (4097, 2, False), (16388, 4, True)])
def test_rmsnorm_launch_plan_refuses_widths_past_the_limit(d, isz, vec):
    """The same limit as before the redesign: 512 threads x 8 loads."""
    with pytest.raises(ValueError, match="exceeds"):
        rmsnorm.launch_plan(4, d, isz, vec)
    lanes = 16 // isz if vec else 1
    widest = rmsnorm.launch_plan(4, 512 * 8 * lanes, isz, vec)
    assert (widest["warps_per_row"], widest["vectors_per_lane"]) == (16, 8)
