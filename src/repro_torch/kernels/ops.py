"""Dispatch of the kernels by the tensors' device, and the autograd
functions around them.

A CPU tensor goes to the plain version in ``kernels/ref.py``. A CUDA tensor
goes to the hand-written kernel; if the kernel cannot be built, loaded or
launched, the call raises. There is no fallback from the card to the plain
version.

``grouped_gemm`` (the "pallas" backend) is forward only, as the JAX
package's ``pallas_call`` is: under grad mode it refuses an operand that
requires grad. ``fused_mlp`` is differentiable: its backward runs the
dgrad and wgrad kernels (the counterpart of the JAX package's custom VJP,
``repro.kernels.fused_mlp._diff_fused``). ``topk_combine_diff`` is the
combine kernel with the analytic fp32 backward of
``repro.kernels.topk_combine._diff_combine``, plain tensor code on both
devices. ``flash_attention`` and ``ssd_forward`` run their kernels forward;
their backward recomputes the plain version under autograd, on both
devices, because the JAX package has no backward kernel for either
(``jax.grad`` differentiates its jnp attention and ``ssd_chunked``).
``rms_norm`` is the model's norm: the rmsnorm kernel's ``model`` epilogue
forward, the plain form recomputed under autograd backward, for the same
reason. ``ssd_forward_state`` is the serving chunks' SSD, with an initial
and a final state, under ``no_grad``. ``split3_bf16`` cuts the head's fp32
logit gradient into three bf16 pieces (``models/common.bf16_exact_mm``'s
backward).

A ``meta`` tensor goes to the plain version too: on ``meta`` it only
propagates shapes (the dry run, ``launch/dryrun.py``). Each kernel call
(forward, and the fused MLP's dgrad and wgrad) runs through ``_kernel``:
under ``analysis/op_cost.count_cost`` it is one region, priced by the
kernel's cost function and not by what runs inside it, so a step counts
the same on CPU, CUDA and ``meta`` tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_mlp as _fm
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import split3 as _s3
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import topk_combine as _tc


def _on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds in ({"cpu"}, {"meta"}):
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"operands on unsupported or mixed devices {kinds}")


def _kernel(name: str, fn: Callable, *operands):
    """``fn()``, one call of kernel ``name`` on ``operands``: under a cost
    counter (a dispatch mode with a ``kernel_region``) the counter runs it
    as one region, else it just runs."""
    for mode in _get_current_dispatch_mode_stack():
        region = getattr(mode, "kernel_region", None)
        if region is not None:
            return region(name, operands, fn)
    return fn()


def topk_combine(rows, weights):
    def run():
        if _on_cuda(rows, weights):
            return _tc.topk_combine(rows, weights)
        return ref.topk_combine_ref(rows, weights)
    return _kernel("topk_combine", run, rows, weights)


def grouped_gemm(lhs, rhs, order: str = "expert_major"):
    """The "pallas" GroupGEMM backend's product, forward only: the JAX
    package's ``pallas_call`` has no VJP, so ``jax.grad`` through it raises.
    The same here on both devices: under grad mode an operand that
    requires grad raises, where the card's kernel would otherwise return
    an output without a ``grad_fn`` and drop the expert gradients. The
    comet arms call it inside their ``autograd.Function`` forward (grad
    mode off) and differentiate by hand; serving's weights never require
    grad."""
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        raise RuntimeError(
            'grouped_gemm: the "pallas" GroupGEMM backend has no backward '
            '(as in the JAX package); differentiate through gemm_impl='
            '"xla" or "pallas_fused", or through impl="comet"')
    def run():
        if _on_cuda(lhs, rhs):
            return _gg.grouped_gemm(lhs, rhs, order=order)
        return ref.grouped_gemm_ref(lhs, rhs)
    return _kernel("grouped_gemm", run, lhs, rhs)


class _TopkCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, weights):
        ctx.save_for_backward(rows, weights)
        return topk_combine(rows, weights)

    @staticmethod
    def backward(ctx, ct):
        rows, weights = ctx.saved_tensors
        g = ct.float()[:, None, :]                              # (T, 1, d)
        d_rows = (weights.float()[..., None] * g).to(rows.dtype)
        d_w = (rows.float() * g).sum(dim=-1).to(weights.dtype)  # (T, k)
        return d_rows, d_w


def topk_combine_diff(rows, weights):
    """Differentiable top-k combine: the kernel forward, the analytic fp32
    backward (topk_combine.py:38-45 of the JAX package)."""
    return _TopkCombine.apply(rows, weights)


def _sliced_wd(w, col_slice):
    wd = w["w_down"]
    if col_slice is not None:
        wd = wd[:, :, col_slice[0]:col_slice[0] + col_slice[1]]
    return wd


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, w_gate, w_up, w_down, activation, order):
        ctx.save_for_backward(rows, w_gate, w_up, w_down)
        ctx.activation = activation

        def run():
            if _on_cuda(rows, w_gate, w_up, w_down):
                return _fm.fused_mlp(rows, w_gate, w_up, w_down, activation,
                                     order)
            return ref.fused_mlp_ref(rows, w_gate, w_up, w_down, activation)
        return _kernel("fused_mlp", run, rows, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, ct):
        rows, w_gate, w_up, w_down = ctx.saved_tensors
        w = {"w_up": w_up, "w_down": w_down}
        if w_gate is not None:
            w["w_gate"] = w_gate
        ct = ct.to(rows.dtype)
        dx = fused_mlp_dgrad(rows, w, ct, ctx.activation)
        dwg, dwu, dwd = fused_mlp_wgrad(rows, w, ct, ctx.activation)
        return dx, dwg, dwu, dwd, None, None


def fused_mlp(rows, w: Dict[str, torch.Tensor], activation: str,
              col_slice: Optional[Tuple[int, int]] = None,
              order: str = "expert_major"):
    """``w`` is the expert-weight dict (w_gate optional, w_up, w_down);
    ``col_slice=(start, width)`` computes only that block of output
    columns, from a strided view of w_down. Differentiable: the backward is
    the dgrad and wgrad kernels (plain versions on the CPU)."""
    return _FusedMLP.apply(rows, w.get("w_gate"), w["w_up"],
                           _sliced_wd(w, col_slice), activation, order)


def fused_mlp_dgrad(rows, w: Dict[str, torch.Tensor], dy, activation: str,
                    col_slice: Optional[Tuple[int, int]] = None):
    """dX (E, R, d) of the fused expert MLP for the cotangent dy, which
    covers the output columns ``col_slice`` (all of them when None). Per
    column block calls sum to the full dX."""
    wd, wg = _sliced_wd(w, col_slice), w.get("w_gate")

    def run():
        if _on_cuda(rows, wg, w["w_up"], wd, dy):
            # an autograd cotangent may be an expanded (stride-0) tensor
            return _fm.fused_mlp_dgrad(rows, wg, w["w_up"], wd,
                                       dy.contiguous(), activation)
        return ref.fused_mlp_dgrad_ref(rows, wg, w["w_up"], wd, dy,
                                       activation)
    return _kernel("fused_mlp_dgrad", run, rows, wg, w["w_up"], wd, dy)


def fused_mlp_wgrad(rows, w: Dict[str, torch.Tensor], dy, activation: str,
                    col_slice: Optional[Tuple[int, int]] = None):
    """(dw_gate | None, dw_up, dw_down) for the cotangent dy of the output
    columns ``col_slice``: dw_down covers that column block, dw_up/dw_gate
    are the block's partials (they sum over blocks to the full gradient)."""
    wd, wg = _sliced_wd(w, col_slice), w.get("w_gate")

    def run():
        if _on_cuda(rows, wg, w["w_up"], wd, dy):
            return _fm.fused_mlp_wgrad(rows, wg, w["w_up"], wd,
                                       dy.contiguous(), activation)
        return ref.fused_mlp_wgrad_ref(rows, wg, w["w_up"], wd, dy,
                                       activation)
    return _kernel("fused_mlp_wgrad", run, rows, wg, w["w_up"], wd, dy)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal

        def run():
            if _on_cuda(q, k, v):
                return _fa.flash_attention(q, k, v, causal)
            return ref.flash_attention_ref(q, k, v, causal)
        return _kernel("flash_attention", run, q, k, v, causal)

    @staticmethod
    def backward(ctx, ct):
        q, k, v = ctx.saved_tensors
        return (*ref.flash_attention_vjp(q, k, v, ctx.causal, ct), None)


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd) -> (B, Hq, Sq, hd):
    causal GQA attention with fp32 scores and softmax, positions from 0
    (``repro.kernels.ops.flash_attention``). Differentiable: the backward
    is the plain attention recomputed under autograd."""
    return _Flash.apply(q, k, v, causal)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        on_cuda = _on_cuda(x, dt, A, Bm, Cm, D)
        # the backward differentiates the form the forward ran
        ctx.chunk = _ssd.CHUNK if on_cuda else chunk

        def run():
            if on_cuda:
                return _ssd.ssd_forward(x, dt, A, Bm, Cm, D)
            return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk)
        return _kernel("ssd_forward", run, x, dt, A, Bm, Cm, D, None, False)

    @staticmethod
    def backward(ctx, ct):
        grads = ref.ssd_vjp(*ctx.saved_tensors, ctx.chunk, ct,
                            ctx.needs_input_grad[:6])
        return (*grads, None)


def ssd_forward(x, dt, A, Bm, Cm, D, chunk: int = 64):
    """y (B, S, nh, hd) of the Mamba-2 chunked SSD from a zero state
    (``repro.kernels.ops.ssd_forward``). x: (B, S, nh, hd); dt: (B, S, nh)
    fp32; A/D: (nh,) fp32; Bm/Cm: (B, S, ds). On the CPU the plain chunked
    form runs at ``chunk``; the CUDA kernel runs its own chunk of
    ``kernels/ssd.CHUNK`` (chunk-invariant up to rounding). Differentiable:
    the backward is the plain chunked form recomputed under autograd at
    the chunk the forward ran (``chunk`` on the CPU, ``ssd.CHUNK`` on the
    card)."""
    return _SSD.apply(x, dt, A, Bm, Cm, D, chunk)


@torch.no_grad()
def ssd_forward_state(x, dt, A, Bm, Cm, D, chunk: int = 64,
                      h0: Optional[torch.Tensor] = None):
    """(y (B, S, nh, hd), h_final (B, nh, ds, hd) fp32) of the Mamba-2
    chunked SSD from the initial state h0 ((B, nh, ds, hd) fp32; None = a
    zero state): the serving chunks' form (the JAX package's
    ``ssd_chunked(..., h0)`` in ``repro/models/ssm.py:180-188``). On the
    CPU the plain chunked form runs at ``chunk``; the CUDA kernel runs its
    own chunk of ``kernels/ssd.CHUNK``. Not differentiable."""
    def run():
        if _on_cuda(x, dt, A, Bm, Cm, D, h0):
            return _ssd.ssd_forward_state(
                x, dt, A, Bm, Cm, D, None if h0 is None else h0.contiguous())
        return ref.ssd_state_ref(x, dt, A, Bm, Cm, D, h0, chunk)
    return _kernel("ssd_forward", run, x, dt, A, Bm, Cm, D, h0, True)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps

        def run():
            if _on_cuda(x, scale):
                y = _rn.rmsnorm(x.reshape(-1, x.shape[-1]).contiguous(),
                                scale.contiguous(), eps, epilogue="model")
                return y.reshape(x.shape)
            return ref.rms_norm(x, scale, eps)
        return _kernel("rmsnorm", run, x, scale)

    @staticmethod
    def backward(ctx, ct):
        x, scale = ctx.saved_tensors
        return (*ref.rms_norm_vjp(x, scale, ctx.eps, ct), None)


def rms_norm(x, scale, eps: float):
    """The model's RMSNorm over the last axis (``models/common.rms_norm``):
    x (..., d), scale (d,) -> x's shape and dtype. On a CUDA tensor the
    rmsnorm kernel with the ``model`` epilogue, over the flattened leading
    dimensions. Differentiable: the backward is the plain form recomputed
    under autograd."""
    return _RMSNorm.apply(x, scale, eps)


def split3_bf16(g):
    """The fp32 g's three exact bf16 pieces, stacked (3, *g.shape), with g
    == (p[0] - p[1]) - p[2] (``ref.split3_bf16_ref``): one pass of the
    split kernel on a CUDA tensor, the plain form otherwise."""
    def run():
        if _on_cuda(g):
            return _s3.split3_bf16(g)
        return ref.split3_bf16_ref(g)
    return _kernel("split3", run, g)
