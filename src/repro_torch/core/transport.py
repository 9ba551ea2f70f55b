"""MoE transports: how the shared tensor reaches the experts.

The transports take the dispatch buffer ``send`` of shape (ep, E_loc, C, d)
(chunked by destination expert group, the paper's M-dimension
decomposition) and the local expert weights and return the experts' outputs
for this rank's tokens in the same layout, plus the ring rotation that
``combine`` needs. Each takes an ``AxisCtx`` (``ctx=``); with none, or at
world 1, every ring and all-to-all degenerates to its local arm:

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
wgrad kernels per block.

Across ranks (``parallel/collectives.py`` over torch.distributed):
  naive   - one tiled all-to-all in, the grouped MLP, one all-to-all back;
            under ETP the chunks are all-gathered over the etp subgroup,
            exchanged within same-tp groups, the partial outputs psum'd,
            and each rank returns its own tp's rows.
  comet   - the decomposed ring (``_comet_ring_fwd``): ep - 1 dispatch
            permutes, the local chunk first, ``ring_group`` source chunks
            per GroupGEMM macro-step, and each output column block sent
            back as soon as it is done. The next macro-step's dispatch is
            posted before this one computes, and every return is posted at
            once, so transfers overlap the GEMMs. Its backward
            (``_comet_ring_bwd``) is scheduled by hand inside one
            ``autograd.Function``: dY over the reverse return permutes, dX
            over the transposed dispatch permutes, dW summed in fp32.
  bcast   - each rank runs its own experts over the whole buffer and one
            psum over the model axis merges them.
  comet_hier - not ported across ranks: it raises.

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

from repro_torch.core.adaptive import (WIRE_DTYPES, legalize_n_col,
                                       legalize_ring_group,
                                       wire_dtype_supported)
from repro_torch.kernels import ops
from repro_torch.models.common import activate, activate_vjp, is_glu
from repro_torch.parallel import collectives as CL

GEMM_BACKENDS = ("xla", "pallas", "pallas_fused")
DEFAULT_GEMM_IMPL = "xla"
_FP8_WIRE_MAX = 448.0                  # |max finite| of float8_e4m3fn


def _ranked(ctx) -> bool:
    """True when ``ctx`` spreads the layer over more than one rank."""
    return ctx is not None and ctx.active and ctx.world > 1


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
             gemm_impl: Optional[str] = None, preacts=None):
    """The expert MLP's backward with per-column-block dY consumption.

    rows: (E_loc, R, d); dys: the ``n_col`` column-block cotangents
    (E_loc, R, blk) that partition the output width. Returns (d_rows
    (E_loc, R, d), dw dict with w's keys).

    "pallas_fused": each block runs the column-sliced dgrad and wgrad
    kernels (the hidden recomputed, never stored); the blocks' dX, dw_up and
    dw_gate partials add up in the rows' dtype and the dw_down blocks
    concatenate. "xla" and "pallas": the pre-activations ``preacts``
    (gate | None, up) that the forward saved, or recomputed when it saved
    none, dh accumulated over the blocks, one activation VJP, and the
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

    gate, up = preacts if preacts is not None else _mlp_preacts(
        rows, w, activation, impl)
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


def _etp_psum(ctx, x):
    if ctx is None or ctx.etp == 1:
        return x
    return CL.psum(x, ctx.etp_group)


def expert_mlp(rows, w, activation: str, gemm_impl: Optional[str] = None,
               ctx=None):
    return _etp_psum(ctx, _mlp_out(rows, w, activation, gemm_impl))


def transport_naive(send, w, activation: str,
                    gemm_impl: Optional[str] = None, ctx=None):
    """(ep, E_loc, C, d) -> the expert outputs of this rank's tokens, same
    layout, and rot None."""
    ep, E_loc, C, d = send.shape
    if not _ranked(ctx):
        rows = send.transpose(0, 1).reshape(E_loc, ep * C, d)
        out = expert_mlp(rows, w, activation, gemm_impl)
        out = out.reshape(E_loc, ep, C, -1).transpose(0, 1)
        return out, None

    if ctx.etp == 1:
        recv = CL.all_to_all(send, ctx.model_group)          # (ep,E_loc,C,d)
        rows = recv.transpose(0, 1).reshape(E_loc, ep * C, d)
        out = expert_mlp(rows, w, activation, gemm_impl, ctx)
        out = out.reshape(E_loc, ep, C, -1).transpose(0, 1)
        return CL.all_to_all(out, ctx.model_group), None

    # ETP > 1: replicate chunks across the etp subgroup, exchange within
    # same-tp groups, psum partials, return from the tp-matching rank
    etp = ctx.etp
    gathered = CL.all_gather(send, ctx.etp_group)      # (etp,ep,E_loc,C,d)
    recv = CL.all_to_all(gathered, ctx.tp_group, dim=1)
    rows = recv.permute(2, 0, 1, 3, 4).reshape(E_loc, etp * ep * C, d)
    out = expert_mlp(rows, w, activation, gemm_impl, ctx)          # psum'd
    out = out.reshape(E_loc, etp, ep, C, -1)
    mine = out[:, ctx.model_rank % etp].transpose(0, 1)     # (ep,E_loc,C,d)
    return CL.all_to_all(mine, ctx.tp_group), None


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


# ---------------------------------------------------------------------------
# comet across ranks: the decomposed ring and its hand-scheduled backward
# ---------------------------------------------------------------------------


def _perm(ctx, group_shift: int, tp_shift: int):
    """Permutation over the model axis: (g, t) -> ((g + group_shift) % ep,
    (t + tp_shift) % etp)."""
    W, etp, ep = ctx.world, ctx.etp, ctx.ep
    pairs = []
    for r in range(W):
        g, t = r // etp, r % etp
        pairs.append((r, ((g + group_shift) % ep) * etp
                      + (t + tp_shift) % etp))
    return pairs


def comet_ring_segments(ep: int, ring_group: int, n_col_blocks: int) -> dict:
    """Segment counts of one forward ring as ``_comet_ring_fwd`` executes
    it (etp = 1 view): ep // ring_group GroupGEMM macro-steps, each
    consuming ring_group source chunks; chunk slot 0 is local, so ep - 1
    dispatch permutes cross the link; every non-local chunk returns
    n_col_blocks combine permutes."""
    g = legalize_ring_group(ep, ring_group)
    return {
        "n_steps": max(1, ep // g),
        "dispatch_hops": max(0, ep - 1),
        "expert_gemms": max(1, ep // g),
        "combine_hops": max(1, n_col_blocks) * max(0, ep - 1),
    }


def _census_note(census, op: str, x, pairs):
    """Record one executed permute (payload bytes and pairs) in the
    caller's ``census`` list; None records nothing."""
    if census is not None:
        census.append({"op": op, "bytes": x.numel() * x.element_size(),
                       "pairs": [list(p) for p in pairs]})


def _dyn_chunk(send, g: int):
    """send: (ep, E_loc, C, d) -> chunk g (E_loc, C, d)."""
    return send[g]


def _comet_ring_fwd(ctx, send, w, activation: str, n_col: int, blk: int,
                    g: int, gemm_impl: Optional[str], census=None):
    """The forward ring. Returns (blocks, rows_steps, preacts_steps):
    ``blocks`` the n_col column blocks (ep, E_loc, C, blk), chunk slot s
    holding the outputs for destination group (g_r - s) % ep;
    ``rows_steps`` each macro-step's dispatched rows and ``preacts_steps``
    its (gate | None, up), the backward's saved residuals. The fused
    backend saves rows only (its dgrad/wgrad kernels recompute the hidden),
    so ``preacts_steps`` is None there."""
    ep, E_loc, C, d = send.shape
    etp = ctx.etp
    n_steps = ep // g
    g_r, t_r = divmod(ctx.model_rank, etp)
    fused = _impl(gemm_impl) == "pallas_fused"

    def dispatch(step):
        """Posts the macro-step's dispatch permutes: per source chunk j,
        the etp receives (slot 0, tp shift 0 is the local chunk)."""
        posted = []
        for j in range(g):
            s = step * g + j
            to_send = _dyn_chunk(send, (g_r - s) % ep).contiguous()
            recvs = []
            for o in range(etp):
                if s == 0 and o == 0:
                    recvs.append(to_send)                    # local first
                else:
                    pairs = _perm(ctx, -s, o)
                    _census_note(census, "disp", to_send, pairs)
                    recvs.append(CL.ppermute(to_send, ctx, pairs))
            posted.append(recvs)
        return posted

    # col_blocks[b][s]: (E_loc, C, blk), a tensor or a return in flight
    col_blocks: List[List] = [[None] * ep for _ in range(n_col)]
    rows_steps: List[torch.Tensor] = []
    preacts_steps = None if fused else []
    Rc = etp * C                                    # rows per source chunk
    nxt = dispatch(0)
    for step in range(n_steps):
        posted = nxt
        if step + 1 < n_steps:      # the next chunks travel while we compute
            nxt = dispatch(step + 1)
        chunk_rows = []
        for recvs in posted:
            got = [CL.wait(p) for p in recvs]
            if etp == 1:
                chunk_rows.append(got[0])                    # (E_loc, C, d)
            else:
                # reorder by true source tp: the chunk from source tp u
                # arrived at position o = (t_r - u) % etp
                by_u = torch.stack([got[(t_r - u) % etp]
                                    for u in range(etp)])
                chunk_rows.append(
                    by_u.transpose(0, 1).reshape(E_loc, Rc, d))
        rows = chunk_rows[0] if g == 1 else torch.cat(chunk_rows, dim=1)
        rows_steps.append(rows)                     # (E_loc, g*etp*C, d)

        # macro-step expert MLP, N-decomposed: the fused backend one kernel
        # per column block; unfused GEMM1 once, GEMM2 per block, with the
        # pre-activations kept for the backward
        if fused:
            obs = mlp_col_blocks(rows, w, activation, n_col, blk, gemm_impl)
        else:
            gate, up = _mlp_preacts(rows, w, activation, gemm_impl)
            h = activate(activation, gate, up)
            obs = [expert_gemm2(h, w, (b * blk, blk), gemm_impl)
                   for b in range(n_col)]
            preacts_steps.append((gate, up))
        for b, ob in enumerate(obs):
            ob = _etp_psum(ctx, ob)                 # (E_loc, g*Rc, blk)
            for j in range(g):
                s = step * g + j
                obj = ob[:, j * Rc:(j + 1) * Rc]
                if etp > 1:                         # my tp's rows
                    obj = obj.reshape(E_loc, etp, C, -1)[:, t_r]
                obj = obj.contiguous()
                if s == 0:
                    col_blocks[b][s] = obj
                else:
                    pairs = _perm(ctx, s, 0)
                    _census_note(census, "comb", obj, pairs)
                    col_blocks[b][s] = CL.ppermute(obj, ctx, pairs)

    blocks = tuple(torch.stack([CL.wait(p) for p in cb])
                   for cb in col_blocks)            # n_col x (ep,E_loc,C,blk)
    return blocks, rows_steps, preacts_steps


def _comet_ring_bwd(ctx, rows_steps, preacts_steps, w, cts,
                    activation: str, n_col: int, blk: int, g: int,
                    send_shape, send_dtype, gemm_impl: Optional[str]):
    """The backward ring: the forward's schedule in reverse roles. Per
    macro-step the dY column blocks of its chunk slots travel the reverse
    return permutes (slot 0 is local; the next step's are posted before
    this one computes) and, under ETP, are scattered at this rank's tp and
    psum'd over the subgroup (the transpose of the forward's psum and
    take); the per-chunk dgrad/wgrad consumes them block by block while the
    dX chunks ride the transposed dispatch permutes back to their source
    rank. The arrivals for a chunk are summed (which also merges the etp
    partials), and dW accumulates over macro-steps in fp32."""
    ep, E_loc, C, d = send_shape
    etp = ctx.etp
    n_steps = ep // g
    Rc = etp * C
    g_r, t_r = divmod(ctx.model_rank, etp)
    dev = rows_steps[0].device

    def dy_posted(step):
        return [[cts[b][s].to(send_dtype).contiguous() if s == 0 else
                 CL.ppermute(cts[b][s].to(send_dtype), ctx, _perm(ctx, -s, 0))
                 for s in range(step * g, (step + 1) * g)]
                for b in range(n_col)]

    d_send = torch.zeros(send_shape, dtype=send_dtype, device=dev)
    dw_acc: Dict[str, torch.Tensor] = {
        k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
        for k, v in w.items()}
    dx_flight = []                 # (chunk slot, its arrivals in flight)
    nxt = dy_posted(0)
    for step in range(n_steps):
        posted = nxt
        if step + 1 < n_steps:
            nxt = dy_posted(step + 1)
        dys = []
        for b in range(n_col):
            parts = []
            for p in posted[b]:
                dy_j = CL.wait(p)                           # (E_loc, C, blk)
                if etp > 1:
                    full = torch.zeros((E_loc, etp, C, blk),
                                       dtype=dy_j.dtype, device=dev)
                    full[:, t_r] = dy_j
                    dy_j = full.reshape(E_loc, Rc, blk)
                parts.append(dy_j)
            dy_b = parts[0] if g == 1 else torch.cat(parts, dim=1)
            if etp > 1:
                # the transpose of (psum over the subgroup, take my tp)
                dy_b = CL.psum(dy_b, ctx.etp_group)
            dys.append(dy_b)                            # (E_loc, g*Rc, blk)

        preacts = None if preacts_steps is None else preacts_steps[step]
        d_rows, dw = _mlp_bwd(rows_steps[step], w, activation, dys, blk,
                              gemm_impl, preacts)
        for k in dw_acc:
            dw_acc[k] += dw[k].float()

        # dX: transposed dispatch permutes back to the source
        for j in range(g):
            s = step * g + j
            dcr = d_rows[:, j * Rc:(j + 1) * Rc]
            if etp > 1:
                by_u = dcr.reshape(E_loc, etp, C, d)
            arrivals = []
            for o in range(etp):
                piece = (by_u[:, (t_r - o) % etp] if etp > 1
                         else dcr).contiguous()
                arrivals.append(piece if s == 0 and o == 0 else
                                CL.ppermute(piece, ctx, _perm(ctx, s, -o)))
            dx_flight.append(((g_r - s) % ep, arrivals))
    # the summed arrivals are the gradient of the chunk this rank
    # dispatched at slot s
    for slot, arrivals in dx_flight:
        tot = None
        for p in arrivals:
            got = CL.wait(p)
            tot = got if tot is None else tot + got
        d_send[slot] = tot.to(send_dtype)
    return d_send, _cast_like(dw_acc, w)


class _CometRing(torch.autograd.Function):
    """The ranked comet ring (the JAX package's ``custom_vjp`` around
    ``_comet_ring_fwd``/``_comet_ring_bwd``): the forward returns the
    ``n_col`` streamed column blocks and keeps the per-step rows (and, for
    the unfused backends, the pre-activations); the backward is the
    hand-scheduled ring."""

    @staticmethod
    def forward(fctx, send, axis_ctx, keys, activation, n_col, g, gemm_impl,
                census, *ws):
        w = dict(zip(keys, ws))
        blk = send.shape[-1] // n_col
        blocks, rows_steps, preacts_steps = _comet_ring_fwd(
            axis_ctx, send, w, activation, n_col, blk, g, gemm_impl, census)
        fctx.save_for_backward(*ws)
        fctx.steps = (rows_steps, preacts_steps)
        fctx.args = (axis_ctx, keys, activation, n_col, blk, g, gemm_impl,
                     tuple(send.shape), send.dtype)
        return blocks

    @staticmethod
    def backward(fctx, *cts):
        (axis_ctx, keys, activation, n_col, blk, g, gemm_impl, send_shape,
         send_dtype) = fctx.args
        w = dict(zip(keys, fctx.saved_tensors))
        rows_steps, preacts_steps = fctx.steps
        # cts[b]: (ep, E_loc, C, blk), indexed by chunk slot
        d_send, dw = _comet_ring_bwd(axis_ctx, rows_steps, preacts_steps, w,
                                     cts, activation, n_col, blk, g,
                                     send_shape, send_dtype, gemm_impl)
        fctx.steps = None
        return (d_send, None, None, None, None, None, None, None,
                *(dw[k] for k in keys))


def transport_comet_blocks(send, w, activation: str, n_col_blocks: int = 1,
                           ring_group: int = 1,
                           gemm_impl: Optional[str] = None, ctx=None,
                           census=None):
    """The comet ring with the layer-1 N-decomposition exposed: returns
    (blocks, rot) with ``blocks`` the ``n_col`` column blocks
    (ep, E_loc, C, blk) of the expert outputs, chunk slot s holding the
    outputs for destination group (rot - s) % ep. A per-block combine can
    start as soon as its block arrives.

    ring_group g: source chunks fused into one GroupGEMM macro-step (ep / g
    steps); larger g reads the expert weights fewer times and overlaps
    less. At one rank the forward is exactly the naive path and rot is
    None; the backward is ``_CometLocalArm``'s. Across ranks the ring and
    its backward ring are ``_CometRing``; ``census``, a list, records
    every forward permute."""
    ep, E_loc, C, d = send.shape
    n_col = legalize_n_col(d, n_col_blocks)
    keys = tuple(sorted(w))
    if not _ranked(ctx):
        out = _CometLocalArm.apply(send, keys, activation, n_col, gemm_impl,
                                   *(w[k] for k in keys))
        return ([out] if n_col == 1 else list(out)), None
    g = legalize_ring_group(ep, ring_group)
    blocks = _CometRing.apply(send, ctx, keys, activation, n_col, g,
                              gemm_impl, census, *(w[k] for k in keys))
    return list(blocks), ctx.model_rank // ctx.etp


def transport_comet(send, w, activation: str, n_col_blocks: int = 1,
                    ring_group: int = 1, gemm_impl: Optional[str] = None,
                    ctx=None):
    """Full-width comet transport: (recv_out (ep, E_loc, C, d), rot), the
    streamed column blocks concatenated (``transport_comet_blocks`` for the
    per-block combine)."""
    blocks, rot = transport_comet_blocks(send, w, activation,
                                         n_col_blocks=n_col_blocks,
                                         ring_group=ring_group,
                                         gemm_impl=gemm_impl, ctx=ctx)
    return (blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=-1)), rot


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
                         gemm_impl: Optional[str] = None, ctx=None):
    """The two-level ring's local arm: (blocks, rot) as
    ``transport_comet_blocks`` returns them. At one rank no hop crosses a
    wire, but the wire format still quantizes the dispatch buffer, one
    scale per chunk, straight through (the gradient is the unquantized
    one), as the JAX package's single-rank path does. ``intra_group``
    only matters across ranks, where the two-level ring is not ported: a
    ranked context raises instead of running the flat ring."""
    if _ranked(ctx):
        raise NotImplementedError(
            "transport_comet_hier: the two-level ring across ranks "
            "(_comet_hier_fwd/_bwd, _hier_perm) is not ported yet; "
            "impl='comet' runs the flat ring")
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
                    gemm_impl: Optional[str] = None, ctx=None):
    """Decode path. buf_full: (E, C, d), the same on every model rank ->
    (E, C, d) fully combined. At one rank the expert MLP over the whole
    buffer; across ranks each rank runs its own experts' slice and one psum
    over the model axis sums the ETP partials and merges the groups."""
    if not _ranked(ctx):
        return expert_mlp(buf_full, w, activation, gemm_impl)
    E, C, d = buf_full.shape
    E_loc = E // ctx.ep
    g_r = ctx.model_rank // ctx.etp
    mine = buf_full[g_r * E_loc:(g_r + 1) * E_loc]
    out = _mlp_out(mine, w, activation, gemm_impl)                 # partial
    full = torch.cat([out.new_zeros((g_r * E_loc, C, out.shape[-1])), out,
                      out.new_zeros(((ctx.ep - g_r - 1) * E_loc, C,
                                     out.shape[-1]))])
    return CL.psum(full, ctx.model_group)
