"""Routing and the shared dispatch tensor (the paper's section 3.1).

The shared tensor between dispatch (producer) and the expert GEMMs
(consumer) is the ``(E, C, d)`` dispatch buffer. Every transport uses the
same routing, capacity and slot assignment, so their outputs agree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.parallel import collectives as CL


@dataclass
class DispatchInfo:
    flat_e: torch.Tensor     # (T*k,) expert id per (token, choice)
    pos: torch.Tensor        # (T*k,) slot within the expert's queue
    keep: torch.Tensor       # (T*k,) bool, False = dropped by capacity
    T: int
    k: int


def capacity(T: int, k: int, E: int, factor: float, multiple: int = 4) -> int:
    c = math.ceil(T * k / E * factor)
    c = max(multiple, multiple * math.ceil(c / multiple))
    return c


def router_logits(x, w_router, seq_len: int = 0):
    """The router's fp32 logits of x (T, d): one product per sequence of
    ``seq_len`` rows (0: one product for all of x).

    On the card the fp32 product (TF32 off) takes other bits at 256 rows
    than at 512 and more: cuBLAS picks its algorithm by the row count
    (``chip_smoke.py --only build,stack_bits``: the first op of a 256-token
    prefill whose bits change when the request shares the chunk call with
    others). A product per sequence keeps each sequence's routing, and so
    its stream, independent of how many sequences share the call; a
    serving engine's prefill stacks admissions as the sequences of one
    call."""
    w = w_router.float()
    xf = x.float()
    if seq_len <= 0 or seq_len >= xf.shape[0]:
        return xf @ w
    return torch.cat([xf[i:i + seq_len] @ w
                      for i in range(0, xf.shape[0], seq_len)])


def router(x, w_router, mcfg, token_group=None, seq_len: int = 0):
    """x: (T, d). Returns (idx (T, k), weights (T, k) fp32, aux loss fp32).
    The logits are an fp32 product whatever the compute dtype, one per
    sequence of ``seq_len`` rows (``router_logits``).

    token_group: the process group (``parallel.mesh.Group``) over which the
    tokens are sharded; the load-balance statistics (me, ce) are pmean'd
    over it before their product, so the aux loss is the same under any
    sharding."""
    logits = router_logits(x, w_router, seq_len)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, mcfg.top_k, dim=-1)
    if mcfg.router_norm_topk:
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    E = logits.shape[-1]
    # Switch-style load-balance loss
    me = probs.mean(dim=0)                                          # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device)
    ce.index_add_(0, idx.reshape(-1),
                  torch.ones(idx.numel(), dtype=torch.float32,
                             device=x.device))
    ce = ce / max(idx.numel(), 1)
    if token_group is not None:
        me = CL.pmean(me, token_group)
        ce = CL.pmean(ce, token_group)
    aux = E * torch.sum(me * ce) * mcfg.aux_loss_coef
    return idx, w, aux


def build_dispatch(x, idx, E: int, C: int
                   ) -> Tuple[torch.Tensor, DispatchInfo]:
    """x: (T, d); idx: (T, k). Builds the shared tensor (E, C, d) with tokens
    sorted by (expert, arrival order): slot = position in the expert's
    queue, from a stable argsort of the expert ids. (token, choice) pairs
    past capacity are dropped: they scatter to an extra row E*C that is cut
    off, the counterpart of the JAX scatter's mode="drop"."""
    T, k = idx.shape
    TK = T * k
    dev = x.device
    flat_e = idx.reshape(-1).long()                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    # a scatter-add, not bincount: bincount reads its max on the host and
    # would stall the host on every MoE layer
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                        # (E,)
    arange = torch.arange(TK, device=dev)
    rank_sorted = arange - starts[flat_e[order]]
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted                                         # (T*k,)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + torch.clamp(pos, max=C - 1),
                       torch.full_like(pos, E * C))
    tok = arange // k
    src = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    src[slot] = tok
    filled = torch.zeros(E * C + 1, dtype=torch.bool, device=dev)
    filled[slot] = True
    src, filled = src[:E * C], filled[:E * C]
    buf = torch.where(filled[:, None], x[src], torch.zeros((), dtype=x.dtype,
                                                           device=dev))
    return buf.reshape(E, C, x.shape[-1]), DispatchInfo(flat_e, pos, keep,
                                                        T, k)


def combine(recv_flat, info: DispatchInfo, weights, E_loc: int, C: int,
            rot: Optional[int], ep: int):
    """recv_flat: (ep*E_loc*C, d) expert outputs; slot layout (s, l, c) where
    chunk index s is the destination group g (rot None) or (rot - g) % ep.
    Returns (T, d), the top-k weighted sum; dropped slots contribute zero.
    The gather (slot -> token rows) is plain tensor code; the weighted fp32
    reduction runs in the ``topk_combine`` kernel on the card, with its
    analytic backward (``ops.topk_combine_diff``). ``d`` may be one column
    block: the reduction is columnwise."""
    g = info.flat_e // E_loc
    l = info.flat_e % E_loc
    s_idx = g if rot is None else (rot - g) % ep
    idx = (s_idx * E_loc + l) * C + torch.clamp(info.pos, max=C - 1)
    rows = recv_flat[idx]                                            # (T*k, d)
    rows = torch.where(info.keep[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    rows = rows.reshape(info.T, info.k, -1)
    return ops.topk_combine_diff(rows, weights)


def moe_flops(T: int, k: int, d: int, f: int, glu: bool) -> int:
    """Active FLOPs of one MoE FFN on T tokens (for roofline / adaptive)."""
    n_mat = 3 if glu else 2
    return 2 * T * k * n_mat * d * f
