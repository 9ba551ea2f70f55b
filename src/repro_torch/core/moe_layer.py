"""The MoE block at one rank: router -> shared-tensor dispatch -> transport
-> combine.

Expert weights keep the JAX package's pre-sharded storage (W, E_loc, d, f)
with W the model-axis size, here 1, so a parameter tree bridged from the
JAX package is used as it is.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import routing as R
from repro_torch.core import transport as T
from repro_torch.models.common import ParamDecl, ffn_schema, is_glu

IMPLS = ("naive", "coarse", "comet", "comet_hier", "bcast", "dense")


def moe_schema(cfg, mcfg, W: int = 1, etp: int = 1) -> Dict:
    d = cfg.d_model
    E_loc = mcfg.num_experts // max(1, W // etp)
    f_loc = mcfg.d_expert // etp
    s: Dict = {
        "router": ParamDecl((d, mcfg.num_experts), ("embed_v", "experts_v")),
    }
    # BigMac descend-ascend: shared projections d -> wire before dispatch
    # and wire -> d after combine; the experts live at wire width
    wire = mcfg.wire_dim
    d_in = wire or d
    if wire:
        s["w_desc"] = ParamDecl((d, wire), ("embed_v", None))
        s["w_asc"] = ParamDecl((wire, d), (None, "embed_v"))
    ew: Dict[str, ParamDecl] = {}
    if is_glu(cfg.activation):
        ew["w_gate"] = ParamDecl((W, E_loc, d_in, f_loc),
                                 ("expert_shard", None, "embed", None))
    ew["w_up"] = ParamDecl((W, E_loc, d_in, f_loc),
                           ("expert_shard", None, "embed", None))
    ew["w_down"] = ParamDecl((W, E_loc, f_loc, d_in),
                             ("expert_shard", None, None, "embed"))
    s["experts"] = ew
    if mcfg.num_shared_experts:
        s["shared"] = ffn_schema(cfg, d,
                                 mcfg.d_expert * mcfg.num_shared_experts)
    return s


def pack_expert_weights(full: Dict[str, torch.Tensor], ep: int,
                        etp: int) -> Dict[str, torch.Tensor]:
    """Logical (E, d, f)/(E, f, d) weights -> the pre-sharded
    (W, E_loc, ...) storage layout."""
    out = {}
    for name, w in full.items():
        E_loc = w.shape[0] // ep
        packed = []
        for g in range(ep):
            for t in range(etp):
                sl = w[g * E_loc:(g + 1) * E_loc]
                if name == "w_down":
                    f_loc = w.shape[1] // etp
                    packed.append(sl[:, t * f_loc:(t + 1) * f_loc, :])
                else:
                    f_loc = w.shape[2] // etp
                    packed.append(sl[:, :, t * f_loc:(t + 1) * f_loc])
        out[name] = torch.stack(packed)
    return out


def _moe_body(cfg, mcfg, n_col: int, gemm_impl: str, x, router_w, experts,
              w_desc=None, w_asc=None):
    """x: (B, S, d) tokens. Returns (y, aux). ``w_desc``/``w_asc`` are the
    BigMac projections: the router sees full-width tokens, dispatch to
    combine runs at wire width, and the ascend restores d_model."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    E = mcfg.num_experts
    idx, wts, aux = R.router(xt, router_w, mcfg)
    C = R.capacity(B * S, mcfg.top_k, E, mcfg.capacity_factor)
    ep, E_loc = 1, E
    w_local = {k: v[0] for k, v in experts.items()}           # strip W = 1

    xe = xt if w_desc is None else (xt @ w_desc).to(xt.dtype)
    dw = xe.shape[-1]                                   # wire (or full) width

    impl = mcfg.impl
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}")
    buf, info = R.build_dispatch(xe, idx, E, C)                      # (E,C,dw)
    if impl == "bcast" or (impl != "dense" and S == 1):
        out = T.transport_bcast(buf, w_local, cfg.activation, gemm_impl)
        y = R.combine(out.reshape(E * C, dw), info, wts, E_loc=E, C=C,
                      rot=None, ep=1)
    else:
        send = buf.reshape(ep, E_loc, C, dw)
        # at one rank coarse is the naive schedule on the one token slice
        # that matters
        if impl in ("comet", "comet_hier"):
            if impl == "comet_hier":
                blocks, rot = T.transport_comet_hier(
                    send, w_local, cfg.activation, n_col_blocks=n_col,
                    ring_group=mcfg.ring_group,
                    intra_group=mcfg.intra_group,
                    wire_dtype=mcfg.wire_dtype, gemm_impl=gemm_impl)
            else:
                blocks, rot = T.transport_comet_blocks(
                    send, w_local, cfg.activation, n_col_blocks=n_col,
                    ring_group=mcfg.ring_group, gemm_impl=gemm_impl)
            if mcfg.fused_combine:
                # streaming layer-1 consumer: one combine per column block
                parts = [R.combine(b.reshape(ep * E_loc * C, b.shape[-1]),
                                   info, wts, E_loc, C, rot, ep)
                         for b in blocks]
                y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            else:
                out = blocks[0] if len(blocks) == 1 else \
                    torch.cat(blocks, dim=-1)
                y = R.combine(out.reshape(ep * E_loc * C, dw), info, wts,
                              E_loc, C, rot, ep)
        else:                                           # naive/coarse/dense
            out, rot = T.transport_naive(send, w_local, cfg.activation,
                                         gemm_impl)
            y = R.combine(out.reshape(ep * E_loc * C, dw), info, wts, E_loc,
                          C, rot, ep)
    if w_asc is not None:
        y = (y @ w_asc).to(y.dtype)
    return y.reshape(B, S, d), aux


def moe_ffn(cfg, mcfg, params, x, n_col: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y, aux). At one rank the layer-1 column split
    only slices output columns of the same product, so ``n_col`` comes from
    the caller or the config (default 1), legalized as the JAX package
    legalizes it; the cost-model resolution of the JAX package's plan cache
    is not ported yet."""
    n_col = T.legalize_n_col(cfg.d_model, n_col or mcfg.n_col_blocks or 1)
    y, aux = _moe_body(cfg, mcfg, n_col, T._impl(mcfg.gemm_impl), x,
                       params["router"], params["experts"],
                       w_desc=params.get("w_desc"), w_asc=params.get("w_asc"))
    return y, aux

