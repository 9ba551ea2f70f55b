"""Plain PyTorch versions of the hand-written kernels.

They mirror ``repro.kernels.ref``: the CPU path runs them, and the tests and
``chip_smoke.py`` hold each CUDA kernel against them. Nothing on the main
path calls them with a CUDA tensor (``kernels/ops.py`` sends those to the
kernels).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activate, activate_vjp


def grouped_gemm_ref(lhs, rhs, out_dtype=None):
    """lhs: (E, M, K); rhs: (E, K, N) -> (E, M, N), fp32 accumulation."""
    out = torch.bmm(lhs.float(), rhs.float())
    return out.to(out_dtype or lhs.dtype)


def fused_mlp_ref(rows, w_gate, w_up, w_down, activation):
    """Unfused expert MLP with the hidden materialized, rounding where the
    fused kernel (and the TPU kernel, fused_mlp.py:80-81) rounds: GEMM1 with
    fp32 accumulation, the activation in fp32, the hidden cast to the input
    dtype, GEMM2 with fp32 accumulation, the output cast to the input dtype.
    In fp32 it is the JAX oracle ``repro.kernels.ref.fused_mlp_ref``.
    rows: (E, R, d); w_gate/w_up: (E, d, f) (w_gate None if not GLU);
    w_down: (E, f, N) -> (E, R, N)."""
    x = rows.float()
    up = torch.bmm(x, w_up.float())
    gate = torch.bmm(x, w_gate.float()) if w_gate is not None else None
    h = activate(activation, gate, up).to(rows.dtype)
    return torch.bmm(h.float(), w_down.float()).to(rows.dtype)


def _bwd_preacts(rows, w_gate, w_up, w_down, dy, acc):
    """(x, gate | None, up, dh) in the dtype ``acc``: the recomputed
    pre-activations and the hidden's cotangent dh = dy . w_down^T rounded
    to the input dtype, as the backward kernels compute them (the TPU
    kernels' fused_mlp.py:210-213)."""
    x = rows.to(acc)
    up = torch.bmm(x, w_up.to(acc))
    gate = torch.bmm(x, w_gate.to(acc)) if w_gate is not None else None
    dh = torch.bmm(dy.to(acc), w_down.to(acc).transpose(1, 2))
    return x, gate, up, dh.to(rows.dtype).to(acc)


def fused_mlp_dgrad_ref(rows, w_gate, w_up, w_down, dy, activation,
                        acc=torch.float32):
    """dX of the fused expert MLP, written out: dup . w_up^T +
    dgate . w_gate^T with dup/dgate rounded to the input dtype; products
    and the activation's VJP in ``acc`` (fp32 as in the kernels; fp64
    gives a second plain route with the same rounding points). w_down/dy
    may be the same column slice. -> (E, R, d)."""
    x, gate, up, dh = _bwd_preacts(rows, w_gate, w_up, w_down, dy, acc)
    dgate, dup = activate_vjp(activation, gate, up, dh)
    dt = rows.dtype
    dx = torch.bmm(dup.to(dt).to(acc), w_up.to(acc).transpose(1, 2))
    if w_gate is not None:
        dx = dx + torch.bmm(dgate.to(dt).to(acc),
                            w_gate.to(acc).transpose(1, 2))
    return dx.to(dt)


def fused_mlp_wgrad_ref(rows, w_gate, w_up, w_down, dy, activation,
                        acc=torch.float32):
    """(dw_gate | None, dw_up, dw_down) of the fused expert MLP, written
    out: h^T . dy with h = act(gate, up) rounded to the input dtype, and
    x^T . dup / x^T . dgate with dup/dgate rounded to it; products in
    ``acc`` (see fused_mlp_dgrad_ref). With a column-sliced w_down/dy,
    dw_down is that block and dw_up/dw_gate the block's partials."""
    x, gate, up, dh = _bwd_preacts(rows, w_gate, w_up, w_down, dy, acc)
    dgate, dup = activate_vjp(activation, gate, up, dh)
    dt = rows.dtype
    h = activate(activation, gate, up).to(dt).to(acc)
    xt = x.transpose(1, 2)
    dwd = torch.bmm(h.transpose(1, 2), dy.to(acc)).to(w_down.dtype)
    dwu = torch.bmm(xt, dup.to(dt).to(acc)).to(w_up.dtype)
    dwg = (torch.bmm(xt, dgate.to(dt).to(acc)).to(w_gate.dtype)
           if w_gate is not None else None)
    return dwg, dwu, dwd


def topk_combine_ref(rows, weights):
    """rows: (T, k, d); weights: (T, k) -> (T, d), fp32 sum cast to the
    rows' dtype."""
    out = torch.einsum("tkd,tk->td", rows.float(), weights.float())
    return out.to(rows.dtype)
