"""MoE transports at one rank: how the shared tensor reaches the experts.

The transports take the dispatch buffer ``send`` of shape (ep, E_loc, C, d)
and the local expert weights and return the experts' outputs in the same
layout. At one rank every ring and all-to-all degenerates to its local arm:

  naive   - the grouped expert MLP over all chunks (``transport_naive``).
  comet   - the decomposed ring's local arm: the naive forward, its output
            cut into ``n_col_blocks`` column blocks (the layer-1
            N-decomposition) that a streaming combine consumes one by one.
  bcast   - the decode path: the expert MLP over the whole (E, C, d) buffer.

The ranked transports (all-to-all, the comet ring over torch.distributed)
come in a later slice.

The GroupGEMM backend is explicit (``gemm_impl=``) through every entry
point, with the same names as the JAX package:
  "xla"          - torch.bmm, the hidden through device memory.
  "pallas"       - the hand-written grouped GEMM kernel, with the comet
                   traversal orders (layer 1 takes n_major).
  "pallas_fused" - the hand-written fused expert-MLP kernel: GEMM1 ->
                   activation -> GEMM2 in one kernel, the hidden never in
                   device memory.
On CPU tensors the two kernel backends run their plain versions.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import activate, is_glu

GEMM_BACKENDS = ("xla", "pallas", "pallas_fused")
DEFAULT_GEMM_IMPL = "xla"
MAX_COL_BLOCKS = 8


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


def transport_comet_blocks(send, w, activation: str, n_col_blocks: int = 1,
                           ring_group: int = 1,
                           gemm_impl: Optional[str] = None):
    """The comet ring's local arm: returns (blocks, rot) with ``blocks`` the
    ``n_col`` column blocks (ep, E_loc, C, blk) of the expert outputs.
    At one rank the forward is exactly the naive path (``ring_group`` only
    matters across ranks)."""
    d = send.shape[-1]
    n_col = legalize_n_col(d, n_col_blocks)
    blk = d // n_col
    out, _ = transport_naive(send, w, activation, gemm_impl)
    return [out[..., b * blk:(b + 1) * blk] for b in range(n_col)], None


def transport_comet(send, w, activation: str, n_col_blocks: int = 1,
                    ring_group: int = 1, gemm_impl: Optional[str] = None):
    """Full-width comet transport: (recv_out (ep, E_loc, C, d), rot)."""
    blocks, rot = transport_comet_blocks(send, w, activation,
                                         n_col_blocks=n_col_blocks,
                                         ring_group=ring_group,
                                         gemm_impl=gemm_impl)
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=-1)
    return out, rot


def transport_bcast(buf_full, w, activation: str,
                    gemm_impl: Optional[str] = None):
    """Decode path. buf_full: (E, C, d) -> (E, C, d): at one rank, the
    expert MLP over the whole buffer."""
    return expert_mlp(buf_full, w, activation, gemm_impl)
