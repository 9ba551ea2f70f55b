"""MoE transports at one rank: how the shared tensor reaches the experts.

The transports take the dispatch buffer ``send`` of shape (ep, E_loc, C, d)
and the local expert weights and return the experts' outputs in the same
layout. At one rank every ring and all-to-all degenerates to its local arm:

  naive   - the grouped expert MLP over all chunks (``transport_naive``).
  comet   - the decomposed ring's local arm: the naive forward, its output
            cut into ``n_col_blocks`` column blocks (the layer-1
            N-decomposition) that a streaming combine consumes one by one.
  comet_hier - the two-level ring's local arm: the comet arm after the
            wire format's quantization of the dispatch buffer, applied
            straight through (``transport_comet_hier``).
  bcast   - the decode path: the expert MLP over the whole (E, C, d) buffer.

The comet arm is an ``autograd.Function`` whose backward consumes the
cotangents column block by column block (``_mlp_bwd``), the counterpart of
the JAX package's custom VJP: under "pallas_fused" it runs the dgrad and
wgrad kernels per block. The ranked transports (all-to-all, the comet ring
and its backward ring over torch.distributed) come in a later slice.

The GroupGEMM backend is explicit (``gemm_impl=``) through every entry
point, with the same names as the JAX package:
  "xla"          - torch.bmm, the hidden through device memory.
  "pallas"       - the hand-written grouped GEMM kernel, with the comet
                   traversal orders (layer 1 takes n_major); forward
                   only, as in the JAX package: the comet arms call it
                   with grad mode off and differentiate by hand, the
                   other arms raise under autograd.
  "pallas_fused" - the hand-written fused expert-MLP kernel: GEMM1 ->
                   activation -> GEMM2 in one kernel, the hidden never in
                   device memory.
On CPU tensors the two kernel backends run their plain versions.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import activate, activate_vjp, is_glu

GEMM_BACKENDS = ("xla", "pallas", "pallas_fused")
DEFAULT_GEMM_IMPL = "xla"
MAX_COL_BLOCKS = 8
# comet_hier's wire formats (a copy of ``repro.core.adaptive.WIRE_DTYPES``)
WIRE_DTYPES = ("fp32", "bf16", "fp8_e4m3")
_FP8_WIRE_MAX = 448.0                  # |max finite| of float8_e4m3fn


def legalize_n_col(d_model: int, n_col: int,
                   max_blocks: int = MAX_COL_BLOCKS) -> int:
    """Largest legal layer-1 column split <= the requested one: clamped to
    [1, max_blocks] and decremented until it divides d_model (a copy of
    ``repro.core.adaptive.legalize_n_col``)."""
    n = max(1, min(int(n_col), max_blocks))
    while d_model % n:
        n -= 1
    return n


def _impl(gemm_impl: Optional[str]) -> str:
    """None/"" is the static "xla" default."""
    if gemm_impl is None or gemm_impl == "":
        return DEFAULT_GEMM_IMPL
    if gemm_impl not in GEMM_BACKENDS:
        raise ValueError(f"unknown gemm_impl {gemm_impl!r}")
    return gemm_impl


def _gg(rows, w, order="expert_major", gemm_impl: Optional[str] = None):
    if _impl(gemm_impl) == "pallas":
        return ops.grouped_gemm(rows, w, order=order)
    return torch.bmm(rows, w)


def expert_gemm1(rows, w, activation: str, gemm_impl: Optional[str] = None):
    """rows: (E_loc, R, d) -> h: (E_loc, R, f_loc)."""
    up = _gg(rows, w["w_up"], gemm_impl=gemm_impl)
    gate = (_gg(rows, w["w_gate"], gemm_impl=gemm_impl)
            if is_glu(activation) else None)
    return activate(activation, gate, up)


def expert_gemm2(h, w, col_slice: Optional[Tuple[int, int]] = None,
                 gemm_impl: Optional[str] = None):
    """h: (E_loc, R, f_loc) -> (E_loc, R, d_block)."""
    wd = w["w_down"]
    if col_slice is not None:
        wd = wd[:, :, col_slice[0]:col_slice[0] + col_slice[1]]
    return _gg(h, wd, order="n_major", gemm_impl=gemm_impl)


def _mlp_out(rows, w, activation: str, gemm_impl: Optional[str] = None):
    """Full-width expert MLP under the chosen backend: one fused kernel call
    or the two-GEMM pipeline."""
    if _impl(gemm_impl) == "pallas_fused":
        return ops.fused_mlp(rows, w, activation)
    return expert_gemm2(expert_gemm1(rows, w, activation, gemm_impl), w,
                        gemm_impl=gemm_impl)


def mlp_col_blocks(rows, w, activation: str, n_col: int, blk: int,
                   gemm_impl: Optional[str] = None) -> List[torch.Tensor]:
    """Per-column-block expert MLP outputs, the layer-1 producer interface
    of the comet ring: ``n_col`` tensors (E_loc, R, blk). Unfused backends
    share one hidden across the blocks; the fused backend issues one
    column-sliced kernel per block and recomputes the hidden."""
    if _impl(gemm_impl) == "pallas_fused":
        return [ops.fused_mlp(rows, w, activation, col_slice=(b * blk, blk),
                              order="n_major")
                for b in range(n_col)]
    h = expert_gemm1(rows, w, activation, gemm_impl)
    return [expert_gemm2(h, w, (b * blk, blk), gemm_impl)
            for b in range(n_col)]


def _mlp_preacts(rows, w, activation: str, gemm_impl: Optional[str] = None):
    """Layer-0 pre-activations (gate | None, up) under the backend."""
    up = _gg(rows, w["w_up"], gemm_impl=gemm_impl)
    gate = (_gg(rows, w["w_gate"], gemm_impl=gemm_impl)
            if is_glu(activation) else None)
    return gate, up


def _mlp_bwd(rows, w, activation: str, dys, blk: int,
             gemm_impl: Optional[str] = None):
    """The expert MLP's backward with per-column-block dY consumption.

    rows: (E_loc, R, d); dys: the ``n_col`` column-block cotangents
    (E_loc, R, blk) that partition the output width. Returns (d_rows
    (E_loc, R, d), dw dict with w's keys).

    "pallas_fused": each block runs the column-sliced dgrad and wgrad
    kernels (the hidden recomputed, never stored); the blocks' dX, dw_up and
    dw_gate partials add up in the rows' dtype and the dw_down blocks
    concatenate. "xla" and "pallas": the pre-activations recomputed, dh
    accumulated over the blocks, one activation VJP, and the
    transposed products in torch (the grouped-GEMM kernel is a forward-layout
    kernel; the JAX package leaves these products to XLA too)."""
    impl = _impl(gemm_impl)
    n_col = len(dys)
    glu = is_glu(activation)
    if impl == "pallas_fused":
        d_rows = dwg = dwu = None
        dwd_blocks = []
        for b, dy in enumerate(dys):
            cs = (b * blk, blk) if n_col > 1 else None
            dx = ops.fused_mlp_dgrad(rows, w, dy, activation, col_slice=cs)
            g_, u_, d_ = ops.fused_mlp_wgrad(rows, w, dy, activation,
                                             col_slice=cs)
            d_rows = dx if d_rows is None else d_rows + dx
            dwu = u_ if dwu is None else dwu + u_
            if glu:
                dwg = g_ if dwg is None else dwg + g_
            dwd_blocks.append(d_)
        dw = {"w_up": dwu, "w_down": torch.cat(dwd_blocks, dim=2)
              if n_col > 1 else dwd_blocks[0]}
        if glu:
            dw["w_gate"] = dwg
        return d_rows, dw

    gate, up = _mlp_preacts(rows, w, activation, impl)
    h_cast = activate(activation, gate, up).to(rows.dtype)
    dh = None
    dwd_blocks = []
    for b, dy in enumerate(dys):
        wd_b = w["w_down"][:, :, b * blk:(b + 1) * blk]
        dh_b = torch.bmm(dy, wd_b.transpose(1, 2))
        dh = dh_b if dh is None else dh + dh_b
        dwd_blocks.append(torch.bmm(h_cast.transpose(1, 2), dy))
    dgate, dup = activate_vjp(activation, gate, up, dh.to(up.dtype))
    rt = rows.transpose(1, 2)
    d_rows = torch.bmm(dup, w["w_up"].transpose(1, 2))
    dw = {"w_up": torch.bmm(rt, dup),
          "w_down": torch.cat(dwd_blocks, dim=2)
          if n_col > 1 else dwd_blocks[0]}
    if glu:
        d_rows = d_rows + torch.bmm(dgate, w["w_gate"].transpose(1, 2))
        dw["w_gate"] = torch.bmm(rt, dgate)
    return d_rows.to(rows.dtype), dw


def _cast_like(dw: Dict, w: Dict) -> Dict:
    return {k: dw[k].to(w[k].dtype) for k in w}


def expert_mlp(rows, w, activation: str, gemm_impl: Optional[str] = None):
    return _mlp_out(rows, w, activation, gemm_impl)


def transport_naive(send, w, activation: str,
                    gemm_impl: Optional[str] = None):
    """One rank: (ep, E_loc, C, d) -> the expert outputs, same layout."""
    ep, E_loc, C, d = send.shape
    rows = send.transpose(0, 1).reshape(E_loc, ep * C, d)
    out = expert_mlp(rows, w, activation, gemm_impl)
    out = out.reshape(E_loc, ep, C, -1).transpose(0, 1)
    return out, None


class _CometLocalArm(torch.autograd.Function):
    """The one-rank comet arm (transport.py:536-570 of the JAX package):
    the forward is the naive path cut into column blocks; the backward
    reshapes the per-block cotangents into expert rows and runs
    ``_mlp_bwd``; autograd hands a block that got no gradient in as zeros.
    Saves (send, w) only: the fused backend recomputes the hidden in its
    kernels, the others recompute the pre-activations."""

    @staticmethod
    def forward(ctx, send, keys, activation, n_col, gemm_impl, *ws):
        w = dict(zip(keys, ws))
        out, _ = transport_naive(send, w, activation, gemm_impl)
        ctx.save_for_backward(send, *ws)
        ctx.args = (keys, activation, n_col, gemm_impl)
        if n_col == 1:
            return out
        blk = out.shape[-1] // n_col
        return tuple(out[..., b * blk:(b + 1) * blk].contiguous()
                     for b in range(n_col))

    @staticmethod
    def backward(ctx, *cts):
        send, *ws = ctx.saved_tensors
        keys, activation, n_col, gemm_impl = ctx.args
        w = dict(zip(keys, ws))
        ep, E_loc, C, d = send.shape
        blk = d // n_col
        rows = send.transpose(0, 1).reshape(E_loc, ep * C, d)
        dys = [ct.to(send.dtype).transpose(0, 1).reshape(E_loc, ep * C, blk)
               for ct in cts]
        d_rows, dw = _mlp_bwd(rows, w, activation, dys, blk, gemm_impl)
        d_send = d_rows.reshape(E_loc, ep, C, d).transpose(0, 1)
        dw = _cast_like(dw, w)
        return (d_send.to(send.dtype), None, None, None, None,
                *(dw[k] for k in keys))


def transport_comet_blocks(send, w, activation: str, n_col_blocks: int = 1,
                           ring_group: int = 1,
                           gemm_impl: Optional[str] = None):
    """The comet ring's local arm: returns (blocks, rot) with ``blocks`` the
    ``n_col`` column blocks (ep, E_loc, C, blk) of the expert outputs.
    At one rank the forward is exactly the naive path (``ring_group`` only
    matters across ranks); the backward is ``_CometLocalArm``'s."""
    d = send.shape[-1]
    n_col = legalize_n_col(d, n_col_blocks)
    keys = tuple(sorted(w))
    out = _CometLocalArm.apply(send, keys, activation, n_col, gemm_impl,
                               *(w[k] for k in keys))
    return ([out] if n_col == 1 else list(out)), None


def wire_dtype_supported(wire_dtype: str) -> bool:
    return wire_dtype in WIRE_DTYPES and (
        wire_dtype != "fp8_e4m3" or hasattr(torch, "float8_e4m3fn"))


def _wire_encode(x, wire_dtype: str, per_chunk: bool = False):
    """Quantize a payload for the wire: (payload, scale), scale None for
    the scale-free formats. ``per_chunk`` keeps one symmetric amax scale
    per leading-axis chunk, else one for the tensor (a copy of the JAX
    package's ``_wire_encode``)."""
    if wire_dtype == "fp32":
        return x, None
    if wire_dtype == "bf16":
        return x.to(torch.bfloat16), None
    assert wire_dtype == "fp8_e4m3", wire_dtype
    xf = x.float()
    dims = tuple(range(1, x.dim())) if per_chunk else tuple(range(x.dim()))
    amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp_min(1e-12) / _FP8_WIRE_MAX
    q = (xf / scale).clamp(-_FP8_WIRE_MAX, _FP8_WIRE_MAX)
    return q.to(torch.float8_e4m3fn), scale


def _wire_decode(payload, scale, out_dtype):
    """Dequantize a payload: the scale multiplies in fp32, then the cast."""
    if scale is None:
        return payload.to(out_dtype)
    return (payload.float() * scale).to(out_dtype)


def transport_comet_hier(send, w, activation: str, n_col_blocks: int = 1,
                         ring_group: int = 1, intra_group: int = 1,
                         wire_dtype: str = "fp32",
                         gemm_impl: Optional[str] = None):
    """The two-level ring's local arm: (blocks, rot) as
    ``transport_comet_blocks`` returns them. At one rank no hop crosses a
    wire, but the wire format still quantizes the dispatch buffer, one
    scale per chunk, straight through (the gradient is the unquantized
    one), as the JAX package's single-rank path does. ``intra_group``
    only matters across ranks."""
    if not wire_dtype_supported(wire_dtype):
        raise ValueError(f"wire_dtype {wire_dtype!r} not supported here "
                         f"(known: {WIRE_DTYPES})")
    if wire_dtype != "fp32":
        pay, sc = _wire_encode(send, wire_dtype, per_chunk=True)
        deq = _wire_decode(pay, sc, send.dtype)
        send = send + (deq - send).detach()
    return transport_comet_blocks(send, w, activation,
                                  n_col_blocks=n_col_blocks,
                                  ring_group=ring_group, gemm_impl=gemm_impl)


def transport_bcast(buf_full, w, activation: str,
                    gemm_impl: Optional[str] = None):
    """Decode path. buf_full: (E, C, d) -> (E, C, d): at one rank, the
    expert MLP over the whole buffer."""
    return expert_mlp(buf_full, w, activation, gemm_impl)
