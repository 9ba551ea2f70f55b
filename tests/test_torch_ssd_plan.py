"""The SSD wrapper's path choice and the tensor-core kernel's arithmetic, in
plain Python on the CPU.

``ssd.hopper_path`` sends bf16 x, B and C (strided slices of a conv output,
as the model passes them) with head_dim a multiple of 32 and d_state a
multiple of 16 to the tensor-core kernel (csrc/ssd_hopper.cu) and
everything else to the general one. ``_hopper_emulation``
(``ref.ssd_split_ref``) repeats that kernel's arithmetic in plain torch:
chunks of 64, slabs of head_dim columns, the cumsum as a rounded product
and a sequential fp32 sum, every fp32 operand of a product split into
``ssd.HOPPER_TERMS`` bf16 terms beside an exact bf16 one, the products
summed in fp32. It is held against the JAX Pallas kernel (interpret mode)
and against the sequential oracle beside the plain chunked form's own
error, by the kernel's rule (``ssd.ORACLE_*``). The kernels themselves run in the gpu-marked
tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro_torch.kernels import ref, ssd

torch.set_num_threads(1)

BF16 = dict(rtol=2e-2, atol=2e-2)


def _conv_slices(B, S, nh, hd, ds, dtype=torch.bfloat16, extra=0, skip=0):
    """x (B, S, nh, hd), Bm, Cm (B, S, ds) as slices of one conv output of
    width nh * hd + 2 * ds + extra, starting ``skip`` elements in; fp32
    dt, A, D."""
    conv = torch.empty((B, S, skip + nh * hd + 2 * ds + extra),
                       dtype=dtype)[..., skip:]
    x = conv[..., :nh * hd].reshape(B, S, nh, hd)
    Bm, Cm = conv[..., nh * hd:nh * hd + ds], conv[..., nh * hd + ds:
                                                   nh * hd + 2 * ds]
    f32 = dict(dtype=torch.float32)
    return (x, torch.empty((B, S, nh), **f32), torch.empty((nh,), **f32),
            Bm, Cm, torch.empty((nh,), **f32))


@pytest.mark.parametrize("shape", [(4, 2048, 48, 64, 128),   # mamba2 train
                                   (8, 256, 48, 64, 128),    # serve chunk
                                   (1, 2048, 128, 64, 16)])  # jamba's SSM
def test_conv_slices_take_the_hopper_path(shape):
    assert ssd.hopper_path(*_conv_slices(*shape))


@pytest.mark.parametrize("case", ["fp32", "base 2 bytes in",
                                  "row stride 3336 + 2", "hd 24", "ds 200",
                                  "ds 8", "bf16 dt", "hd 48"])
def test_other_calls_take_the_general_path(case):
    kw = {"fp32": dict(dtype=torch.float32), "base 2 bytes in": dict(skip=1),
          "row stride 3336 + 2": dict(extra=2), "hd 24": dict(hd=24),
          "ds 200": dict(ds=200), "ds 8": dict(ds=8),
          "hd 48": dict(hd=48)}.get(case, {})
    shape = dict(B=2, S=70, nh=4, hd=64, ds=128)
    shape.update({k: v for k, v in kw.items() if k in shape})
    ins = _conv_slices(**shape, **{k: v for k, v in kw.items()
                                   if k not in shape})
    if case == "bf16 dt":
        ins = (ins[0], ins[1].bfloat16()) + ins[2:]
    assert not ssd.hopper_path(*ins)


def test_an_initial_state_off_eight_bytes_takes_the_general_path():
    """The kernel moves the state in pairs of fp32: an initial state 4
    bytes off an 8-byte boundary takes the general kernel."""
    ins = _conv_slices(2, 70, 4, 64, 128)
    h0 = torch.empty(2 * 4 * 128 * 64 + 1)
    assert ssd.hopper_path(*ins, h0[:-1].view(2, 4, 128, 64))
    assert not ssd.hopper_path(*ins, h0[1:].view(2, 4, 128, 64))


def test_hopper_plan():
    """One slab of HOPPER_SLAB = 32 head_dim columns per block: head_dim
    32, 64 and 128 take the tensor-core kernel, 16 and 48 the general
    one."""
    assert ssd.HOPPER_SLAB == 32
    for hd, hopper in ((32, True), (64, True), (128, True), (16, False),
                       (48, False)):
        assert ssd.hopper_path(*_conv_slices(2, 70, 4, hd, 64)) == hopper


def _hopper_emulation(x, dt, A, Bm, Cm, D, h0=None, terms=None):
    """(y, h_final) by the tensor-core kernel's arithmetic, at its terms
    and slab unless ``terms`` is given."""
    return ref.ssd_split_ref(x, dt, A, Bm, Cm, D, h0,
                             terms=terms or ssd.HOPPER_TERMS,
                             slab=ssd.HOPPER_SLAB, chunk=ssd.CHUNK)


def _inputs(seed, B, S, nh, hd, ds, state=False):
    """Seeded numpy inputs: x, B, C rounded to bf16 (the tensor-core
    path's operands), fp32 dt (a softplus), A < 0, D; an fp32 h0."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, nh, hd), dtype=f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh), dtype=f32)))
    A = -np.exp(rng.standard_normal(nh).astype(f32) * 0.3)
    Bm = rng.standard_normal((B, S, ds), dtype=f32)
    Cm = rng.standard_normal((B, S, ds), dtype=f32)
    D = np.full((nh,), 0.5, f32)
    h0 = rng.standard_normal((B, nh, ds, hd), dtype=f32) if state else None
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)]
    for i in (0, 3, 4):
        t[i] = t[i].bfloat16()
    return t, (None if h0 is None else torch.from_numpy(h0))


def test_emulation_matches_the_jax_kernel():
    """The emulated tensor-core arithmetic against the JAX Pallas kernel
    (interpret mode) at its own chunk of 64, bf16 x, B and C."""
    ins, _ = _inputs(0, 2, 128, 3, 64, 32)
    x, dt, A, Bm, Cm, D = ins
    want = jops.ssd_forward(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), *(jnp.asarray(t.float().numpy())
                         for t in (dt, A, Bm, Cm, D)),
        chunk=ssd.CHUNK, interpret=True)
    got, _ = _hopper_emulation(*ins)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("seed", [1, 2])
def test_emulation_error_beside_the_plain_chunked_form(seed):
    """Against the fp64 sequential oracle, the emulated kernel's y is
    within the kernel's rule of the plain chunked form's own error (max
    error ORACLE_MAX_RATIO x, rel L2 ORACLE_L2_RATIO x) at a ragged
    length; both round y to bf16."""
    ins, _ = _inputs(seed, 2, 130, 3, 64, 32)
    oracle = ref.ssd_ref(*ins, acc=torch.float64)
    got = _hopper_emulation(*ins)[0].double()
    plain = ref.ssd_chunked_ref(*ins, chunk=ssd.CHUNK).double()
    err, p_err = ((t - oracle).abs().max() for t in (got, plain))
    l2, p_l2 = ((t - oracle).norm() / oracle.norm() for t in (got, plain))
    assert err <= ssd.ORACLE_MAX_RATIO * p_err, (float(err), float(p_err))
    assert l2 <= ssd.ORACLE_L2_RATIO * p_l2, (float(l2), float(p_l2))


@pytest.mark.parametrize("S", [130, 100])
def test_emulation_with_a_state(S):
    """y and the final state from an initial state against the plain
    version with a state (ref.ssd_state_ref), and a state handed through
    two calls equal to one call over the whole length."""
    ins, h0 = _inputs(S, 2, S, 3, 32, 16, state=True)
    y, h = _hopper_emulation(*ins, h0)
    want_y, want_h = ref.ssd_state_ref(*ins, h0, chunk=ssd.CHUNK)
    np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                               **BF16)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **BF16)
    cut = 64
    first = [t[:, :cut] if t.dim() > 1 else t for t in ins]
    rest = [t[:, cut:] if t.dim() > 1 else t for t in ins]
    y1, h1 = _hopper_emulation(*first, h0)
    y2, h2 = _hopper_emulation(*rest, h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).float().numpy(),
                               y.float().numpy(), **BF16)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [1, 3])
def test_two_terms_are_the_fewest(seed):
    """Why HOPPER_TERMS is 2: from a state, with one bf16 term per fp32
    operand the emulated y's rel L2 against the fp64 oracle is about 1.4x
    the plain chunked form's and h_final's about 2^-9, failing the
    kernel's rule (ORACLE_L2_RATIO, ORACLE_STATE_L2); with two, y is the
    plain form's to 1e-4 and h_final within the rule."""
    ins, h0 = _inputs(seed, 2, 130, 3, 64, 32, state=True)
    oy, oh = ref.ssd_ref(*ins, acc=torch.float64, h0=h0, return_state=True)
    py = ref.ssd_state_ref(*ins, h0, chunk=ssd.CHUNK)[0]
    p_l2 = (py.double() - oy).norm() / oy.norm()
    y_ratio, h_l2 = {}, {}
    for terms in (1, 2):
        y, h = _hopper_emulation(*ins, h0, terms=terms)
        y_ratio[terms] = float((y.double() - oy).norm() / oy.norm() / p_l2)
        h_l2[terms] = float((h.double() - oh).norm() / oh.norm())
    assert y_ratio[1] > ssd.ORACLE_L2_RATIO, y_ratio
    assert h_l2[1] > ssd.ORACLE_STATE_L2, h_l2
    assert abs(y_ratio[2] - 1) < 1e-4, y_ratio
    assert h_l2[2] <= ssd.ORACLE_STATE_L2, h_l2
