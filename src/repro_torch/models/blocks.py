"""Layer blocks: (attention | Mamba-2 SSM) + (dense FFN | MoE), schema,
the lowering of a layer to executed segments (``block_segments``: named
values and declared dataflow, which ``core/schedule.py`` orders), the
training forward and the monolithic prefill (``apply_layer``, the
sequential interpretation of that lowering; ``return_cache`` gives the
layer's cache entry) and the two cached serving modes, single-token
decode and chunked prefill, of both layer kinds. An encoder-decoder's
decoder layer (``cross``) adds a cross-attention over the encoder's
output after its self-attention; its chunked prefill is not ported, as
the JAX package has none.

The training forward also runs on a mesh (a ranked ``AxisCtx``): each
rank holds its rows of the batch, the same on every model rank, and its
slice of the parameters as ``parallel.sharding.param_specs`` cuts them
(the data-axis cuts already gathered, ``lm.forward``). Attention shards
over the model axis as the JAX package's explicit ``shard_map`` does
(``attn_case``), the MoE block calls the ranked ``moe_ffn``, and the
dense FFN is column- then row-parallel where its width divides. Around
them the collectives are Megatron's conjugate pairs
(``parallel.collectives``): every model rank computes the same loss.
The monolithic prefill (``return_cache``) runs the same forward and
keeps each rank's cache entry (``sharding.prefill_cache_specs``).

So do the serving modes (``decode_layer``, ``chunk_layer``): each rank
holds its slots' slice of the decode cache, cut over the model axis by
kv heads, by positions (split-KV decode, ``sharded_decode_attention``) or
not at all (``parallel.sharding.kv_cut``), and the projections follow
the cache's cut. With the paged cache the K/V entries are page pools
shared by every slot, read and written through block tables
(``PagedKV``); a pool is cut by kv heads or not at all.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.moe_layer import moe_ffn, moe_schema
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models.common import (apply_norm, apply_rope, ffn_apply,
                                       ffn_schema, model_sharded,
                                       norm_schema)
from repro_torch.parallel import collectives as CL


def _ranked(ctx) -> bool:
    return ctx is not None and ctx.active


def layer_schema(cfg, pos: int, ctx=None, cross: bool = False) -> Dict:
    """One layer position's schema. On a mesh the experts are stored
    packed for the model axis: (W, E_loc, ...) with W its size
    (``repro/models/blocks.py:35-53``). ``cross``: an encoder-decoder's
    decoder layer, whose attention position adds the cross-attention's
    norm ``ln_x`` and projections ``xattn``."""
    s: Dict[str, Any] = {"ln1": norm_schema(cfg, cfg.d_model)}
    if cfg.layer_kind(pos) == "a":
        s["attn"] = A.attn_schema(cfg, cfg.attn)
        if cross:
            s["ln_x"] = norm_schema(cfg, cfg.d_model)
            s["xattn"] = A.attn_schema(cfg, cfg.attn, cross=True)
    else:
        s["ssm"] = SSM.ssm_schema(cfg, cfg.ssm)
    if cfg.d_ff > 0 or cfg.is_moe_layer(pos):
        s["ln2"] = norm_schema(cfg, cfg.d_model)
        if cfg.is_moe_layer(pos):
            W = ctx.model_size if _ranked(ctx) else 1
            etp = ctx.etp if ctx is not None else 1
            s["moe"] = moe_schema(cfg, cfg.moe, W, etp)
        else:
            s["ffn"] = ffn_schema(cfg, cfg.d_model, cfg.d_ff)
    return s


def _proj(a, p_attn, h, name):
    """One of the q/k/v projections with its bias, heads split: h (B, S,
    d) -> (B, S, H*, hd); the head count is what the weight holds."""
    B, S, _ = h.shape
    t = h @ p_attn["w" + name]
    if "b" + name in p_attn:
        t = t + p_attn["b" + name].to(t.dtype)
    return t.reshape(B, S, -1, a.head_dim)


def _qkv_proj(a, p_attn, h):
    """QKV projection + bias + head reshape. h: (B, S, d) -> q/k/v
    (B, S, H*, hd)."""
    return tuple(_proj(a, p_attn, h, n) for n in "qkv")


def sp_norm(cfg, pn, x, ctx, sp: bool):
    """``apply_norm``. Under the sequence-parallel residual (``sp``) x is
    this rank's slice of the sequence, so the norm's parameters enter
    through ``copy_to``: each rank's share of their gradient is summed
    over the model group into the whole gradient."""
    if sp:
        pn = {k: CL.copy_to(v, ctx.model_group) for k, v in pn.items()}
    return apply_norm(cfg, pn, x)


def _seq_whole(fn, h, ctx, sp: bool):
    """``fn`` over the whole sequence. Under the sequence-parallel residual
    (``sp``) h is this rank's slice of the sequence: it is gathered for
    ``fn`` (``gather_from``) and ``fn``'s result, the same on every model
    rank, cut back to the slice (``scatter_to``)."""
    if not sp:
        return fn(h)
    G = ctx.model_group
    return CL.scatter_to(fn(CL.gather_from(h, G, 1)), G, 1)


def _moe_ranked(cfg, pm, h, ctx, sliced: bool = False):
    """The ranked MoE block inside a model whose ranks all compute the
    same loss. h: this rank's rows (B, S, d), the same on every model
    rank. Under sequence sharding each model rank takes its slice of the
    sequence (``scatter_to``) and y is gathered back (``gather_from``);
    otherwise every model rank routes the same tokens, whose y each holds
    alike. ``moe_ffn``'s collectives keep the JAX transposes, under which
    the ranks' losses sum to the loss: ``grad_share`` hands it shares of
    the cotangents of what several ranks hold alike (y over the model
    ranks, aux over every rank), and ``copy_to`` sums the shares of the
    router's and the tokens' gradients back over the model group.

    ``sliced``: h is already this rank's slice of the sequence (the
    sequence-parallel residual), and so is the y returned; under sequence
    sharding the slice is routed as it is, with no gather."""
    G = ctx.model_group
    m = ctx.model_size
    S = h.shape[1] * (m if sliced else 1)
    seq = ctx.seq_shard and S > 1 and S % m == 0
    if sliced and not seq:
        y, aux = _moe_ranked(cfg, pm, CL.gather_from(h, G, 1), ctx)
        return CL.scatter_to(y, G, 1), aux
    # the context moe_ffn's body runs under: what sharding.shard_tokens
    # returns for the global batch (B * dp rows, which dp divides)
    body_ctx = dataclasses.replace(
        ctx, seq_shard=seq, dp_axes=ctx.dp_axes if ctx.dp_size > 1 else ())
    params = {k: (CL.copy_to(v, G) if k in ("router", "w_desc", "w_asc")
                  else v) for k, v in pm.items() if k != "shared"}
    if sliced:
        x = h
    else:
        x = CL.scatter_to(h, G, 1) if seq else CL.copy_to(h, G)
    y, aux = moe_ffn(cfg, cfg.moe, params, x, body_ctx,
                     n_col=cfg.moe.n_col_blocks)
    if not sliced:
        y = CL.gather_from(y, G, 1) if seq else CL.grad_share(y, m)
    return y, CL.grad_share(aux, ctx.mesh.size)


def _moe_out(cfg, p, x, ctx=None, sp: bool = False):
    """ln2 -> the MoE block of a layer, on the mid residual x: (y, aux
    loss fp32). ``sp``: x is this rank's slice of the sequence."""
    h = sp_norm(cfg, p["ln2"], x, ctx, sp)
    if _ranked(ctx):
        return _moe_ranked(cfg, p["moe"], h, ctx, sp)
    return moe_ffn(cfg, cfg.moe, p["moe"], h, n_col=cfg.moe.n_col_blocks)


def _shared_out(cfg, p, x, ctx=None, sp: bool = False):
    """ln2 -> the MoE block's shared expert, on the mid residual x (as the
    JAX package's ``f_shared``: it reads nothing of the routed experts)."""
    return _seq_whole(lambda t: ffn_apply(
        cfg, p["moe"]["shared"], t, ctx,
        cfg.moe.d_expert * cfg.moe.num_shared_experts),
        sp_norm(cfg, p["ln2"], x, ctx, sp), ctx, sp)


def _ffn_out(cfg, p, x, ctx=None, sp: bool = False):
    """ln2 -> the dense FFN of a layer, on the mid residual x."""
    return _seq_whole(lambda t: ffn_apply(cfg, p["ffn"], t, ctx, cfg.d_ff),
                      sp_norm(cfg, p["ln2"], x, ctx, sp), ctx, sp)


def _mlp_tail(cfg, p, x, ctx=None, sp: bool = False):
    """ln2 -> (MoE | FFN) -> residual, in the order of ``block_segments``'
    tail. Returns (x, aux loss fp32). ``sp``: x is this rank's slice of
    the sequence."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ln2" not in p:
        return x, aux
    if "moe" in p:
        with tracing.span("model.moe"):
            h, aux = _moe_out(cfg, p, x, ctx, sp)
            if "shared" in p["moe"]:
                h = h + _shared_out(cfg, p, x, ctx, sp)
    else:
        with tracing.span("model.ffn"):
            h = _ffn_out(cfg, p, x, ctx, sp)
    return x + h.to(x.dtype), aux


def attn_case(ctx, a, Sq: int) -> str:
    """How attention shards over the model axis (``repro/models/
    blocks.py:61-84``):

      heads  - Hq and Hkv both divide the axis: head sharding;
      qheads - only Hq divides: q sharded over heads, K/V whole on every
               rank;
      seq    - heads don't divide: each rank takes a slice of the queries,
               K/V whole;
      none   - nothing divides: every rank computes it whole.
    """
    m = ctx.model_size if _ranked(ctx) else 1
    if m == 1:
        return "none"
    if a.n_heads % m == 0 and a.n_kv_heads % m == 0:
        return "heads"
    if a.n_heads % m == 0:
        return "qheads"
    if Sq % m == 0 and Sq > 1:
        return "seq"
    return "none"


def _local_kv(k, v, kv_map, rep: int):
    """K/V for local q heads whose global-to-local kv map is ``kv_map``:
    the contiguous slice of kv heads when every kv head serves ``rep``
    consecutive local q heads (GQA as it stands), else the kv heads taken
    per q head (rep 1)."""
    H_l = len(kv_map)
    base = kv_map[0]
    if H_l % rep == 0 and kv_map == [base + i // rep for i in range(H_l)]:
        return (k[:, :, base:base + H_l // rep],
                v[:, :, base:base + H_l // rep])
    idx = torch.tensor(kv_map, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _attn_core(a, causal, use_rope, q, k, v, qp, kp, kv_mask,
               head_base: int = 0, kv_base: int = 0, flash: bool = False,
               return_kv: bool = False):
    """The per-rank attention body (``repro/models/blocks.py:87-113``).
    q: (B, Sq_l, H_l, hd); k/v: (B, Sk, Hkv_l, hd); qp/kp: absolute
    positions (B, Sq_l)/(B, Sk). ``head_base``/``kv_base``: the global
    index of the first local q/kv head, from which each local q head
    finds its kv head (every sharding case). ``flash``: the region is the
    kernel's case (unmasked, and non-causal or causal with positions
    arange(S) on both sides), sent to ``ops.flash_attention`` with its
    ``causal``. ``return_kv``: returns (o, {"k", "v"}),
    the K/V after RoPE and before the heads' expansion (the prefill's
    cache entry)."""
    if use_rope:
        q = apply_rope(q, qp, a.rope_theta)
        k = apply_rope(k, kp, a.rope_theta)
    kv = {"k": k, "v": v}
    rep = a.n_heads // a.n_kv_heads
    kv_map = [(head_base + i) // rep - kv_base for i in range(q.shape[2])]
    k, v = _local_kv(k, v, kv_map, rep)
    if flash:
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal).transpose(
                                    1, 2)
    else:
        o = A.attention(q, k, v, qp, kp, q_block=a.q_block,
                        kv_block=a.kv_block, causal=causal, kv_mask=kv_mask)
    return (o, kv) if return_kv else o


def attn_apply(cfg, p, x, positions, causal: bool, use_rope: bool = True,
               kv_mask=None, arange_positions: bool = False, ctx=None,
               return_kv: bool = False, kv_x=None):
    """Full-sequence attention (blocks.py:116 of the JAX package). x:
    (B, S, d); positions: (B, S) or (1, S) absolute positions of the
    queries (RoPE and the causal mask); kv_mask: optional (B, Sk) key
    validity; ``arange_positions``: the caller built positions as
    arange(S) (the training forward without a mask). ``kv_x``: (B, Sk, d)
    the keys' and values' source (the encoder's output: a
    cross-attention, its key positions arange(Sk)); None: x itself.
    Returns the o-projection (B, S, d).

    Unmasked, and non-causal or causal with positions arange(S): there
    the JAX package's ``__fusable__flash`` region computes exactly what
    its flash kernel computes (``causal`` passed through), and the port
    sends it to ``ops.flash_attention`` (the hand-written kernel on a
    CUDA tensor): an encoder's self-attention, a cross-attention and an
    unmasked decoder's causal self-attention. Every other case keeps the
    plain attention, as the JAX package does. With a ranked ``ctx`` the
    heads shard as ``attn_case`` says of the queries' length, a
    cross-attention's as a self-attention's (``_attn_ranked``); the
    ``seq`` case's query positions are a slice, so it takes the plain
    attention. ``return_kv`` (the monolithic prefill, ``block_segments``):
    returns (the o-projection, {"k", "v"} (B, Sk, Hkv, hd) after RoPE,
    before the heads' expansion), the layer's cache entry; on a mesh this
    rank's, as ``sharding.prefill_cache_specs`` cuts it."""
    a = cfg.attn
    B, S, _ = x.shape
    positions = positions.expand(B, S)
    Sk = S if kv_x is None else kv_x.shape[1]
    if kv_mask is not None:
        kv_mask = kv_mask.expand(B, Sk)
    flash = kv_mask is None and (not causal or arange_positions)
    if _ranked(ctx) and ctx.model_size > 1:
        return _attn_ranked(cfg, p, x, ctx, positions, causal, use_rope,
                            kv_mask, flash, kv_x, return_kv)
    if kv_x is None:
        q, k, v = _qkv_proj(a, p, x)
        kv_pos = positions
    else:
        q = _proj(a, p, x, "q")
        k, v = _proj(a, p, kv_x, "k"), _proj(a, p, kv_x, "v")
        kv_pos = torch.arange(Sk, device=x.device)[None, :].expand(B, Sk)
    o = _attn_core(a, causal, use_rope, q, k, v, positions, kv_pos,
                   kv_mask, flash=flash, return_kv=return_kv)
    if return_kv:
        o, kv = o
        return o.reshape(B, S, a.n_heads * a.head_dim) @ p["wo"], kv
    return o.reshape(B, S, a.n_heads * a.head_dim) @ p["wo"]


def _whole(p, ctx, keys, full: int):
    """The leaves ``keys`` of an attention tree whole on every model rank:
    gathered where a head width of ``full`` columns is stored cut (rows
    of wo), as they are otherwise."""
    G = ctx.model_group
    out = {}
    for k in keys:
        if k in p:
            cut = model_sharded(ctx, full)
            out[k] = CL.gather_from(p[k], G, 0 if k == "wo"
                                    else p[k].dim() - 1) if cut else p[k]
    return out


def _attn_ranked(cfg, p, x, ctx, positions, causal, use_rope, kv_mask,
                 flash, kv_x=None, return_kv: bool = False):
    """attn_apply on a model axis of m > 1 ranks. x, ``kv_x`` (a
    cross-attention's keys' and values' source, whose key positions are
    arange(Sk)) and positions are the same on every model rank; so is the
    result. ``return_kv``: also this rank's K/V after RoPE and before the
    heads' expansion, as ``sharding.prefill_cache_specs`` cuts them: its
    own kv heads in the ``heads`` case, every real kv head otherwise
    (``padded`` drops the dummy heads, ``repro/models/blocks.py:
    189-193``)."""
    a = cfg.attn
    B, S, _ = x.shape
    hd = a.head_dim
    G, m, r = ctx.model_group, ctx.model_size, ctx.model_rank
    Hq, Hkv = a.n_heads, a.n_kv_heads
    src = x if kv_x is None else kv_x
    kv_pos = positions if kv_x is None else torch.arange(
        src.shape[1], device=x.device)[None, :].expand(B, src.shape[1])
    kv_keys = ("wk", "bk", "wv", "bv")
    case = ("padded" if a.pad_heads and (Hq % m or Hkv % m)
            else attn_case(ctx, a, S))
    if case in ("heads", "qheads"):
        # q over heads with this rank's columns of wq (rows of wo), the
        # partial o-projections summed over the model group
        xq = CL.copy_to(x, G)
        q = _proj(a, p, xq, "q")
        if case == "heads":
            xs = xq if kv_x is None else CL.copy_to(kv_x, G)
            k, v = _proj(a, p, xs, "k"), _proj(a, p, xs, "v")
        else:
            # K/V whole on every rank, each rank's q heads reading some
            # of them: the cotangents summed over the group
            w = _whole(p, ctx, kv_keys, Hkv * hd)
            k = CL.copy_to(_proj(a, w, src, "k"), G)
            v = CL.copy_to(_proj(a, w, src, "v"), G)
        o, kv = _attn_core(a, causal, use_rope, q, k, v, positions, kv_pos,
                           kv_mask, r * q.shape[2],
                           r * k.shape[2] if case == "heads" else 0, flash,
                           return_kv=True)
        out = CL.reduce_from(o.reshape(B, S, -1) @ p["wo"], G)
        return (out, kv) if return_kv else out
    # padded / seq / none: every rank projects with the whole weights
    w = {**_whole(p, ctx, ("wq", "bq", "wo"), Hq * hd),
         **_whole(p, ctx, kv_keys, Hkv * hd)}
    q = _proj(a, w, x, "q")
    k, v = _proj(a, w, src, "k"), _proj(a, w, src, "v")
    if case == "padded":
        # the cache's entry: the real heads, whole
        kv = None if not return_kv else {
            "k": apply_rope(k, kv_pos, a.rope_theta) if use_rope else k,
            "v": v}
        # pad the kv heads up to the axis, keep the group ratio for q:
        # zero K/V give dummy heads a zero output, and real q head h keeps
        # kv head h // rep; then heads as above, gathered back whole
        Hkv_p = -(-Hkv // m) * m
        ap = dataclasses.replace(a, n_heads=Hkv_p * (Hq // Hkv),
                                 n_kv_heads=Hkv_p)
        q, k, v = (CL.scatter_to(torch.nn.functional.pad(
            t, (0, 0, 0, n - t.shape[2])), G, 2)
            for t, n in ((q, ap.n_heads), (k, Hkv_p), (v, Hkv_p)))
        o = _attn_core(ap, causal, use_rope, q, k, v, positions, kv_pos,
                       kv_mask, r * q.shape[2], r * k.shape[2], flash)
        o = CL.gather_from(o, G, 2)[:, :, :Hq]
    elif case == "seq":
        # this rank's slice of the queries (their gradient gathered back),
        # all of K/V (their cotangents summed)
        Sl = S // m
        o, kv = _attn_core(a, causal, use_rope, CL.scatter_to(q, G, 1),
                           CL.copy_to(k, G), CL.copy_to(v, G),
                           positions[:, r * Sl:(r + 1) * Sl], kv_pos,
                           kv_mask, return_kv=True)
        o = CL.gather_from(o, G, 1)
    else:
        o, kv = _attn_core(a, causal, use_rope, q, k, v, positions, kv_pos,
                           kv_mask, flash=flash, return_kv=True)
    out = o.reshape(B, S, Hq * hd) @ w["wo"]
    return (out, kv) if return_kv else out


@dataclasses.dataclass(frozen=True)
class ExecSeg:
    """One executed segment of a layer (``repro/models/blocks.py:
    205-218``): a closure over an env dict of named values, with its
    dataflow declared (``reads`` / ``writes``) so ``core/schedule.py`` can
    derive dependencies and reorder emission legally. A legal order only
    permutes which segment runs first over the same expressions."""
    name: str
    kind: str
    block: int
    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    fn: Any                     # Callable[[Dict[str, Any]], None]


def block_segments(cfg, pos: int, p, positions, mask=None,
                   return_cache: bool = False, block: int = 0,
                   x_in: str = "x", x_out: str = "x_out", ctx=None,
                   sp: bool = False, arange_positions: bool = False,
                   enc_out=None):
    """Lower one layer to its executed segment list (``repro/models/
    blocks.py:221-351``). The residual stream enters as env[``x_in``] and
    leaves as env[``x_out``]; the values inside are named ``L{block}.*``:
    ``h0`` the mixer's output, ``xm`` the mid residual, ``h1`` the MoE's
    or the dense FFN's output, ``hsh`` the shared expert's, ``aux`` the
    MoE's aux loss, ``cache`` the layer's cache entry (``return_cache``:
    {"k", "v"} (B, S, Hkv, hd) after RoPE for attention, the SSM's
    {"conv", "state"}). The bodies are ``apply_layer``'s expressions; the
    lowering only names the values between them, so the scheduler sees,
    e.g., that a shared expert reads the mid residual only.

    ``enc_out``: (B, Sk, d) the encoder's output, at an encoder-decoder's
    attention position (``repro/models/blocks.py:235-300``): the mixer's
    residual writes ``xm0``, the ``xattn`` segment (ln_x -> attention of
    the queries over ``enc_out``, non-causal, no RoPE) reads it and writes
    ``hx``, and ``resx`` adds them into ``xm``; under ``return_cache`` the
    cache entry gains {"xk", "xv"} (B, Sk, Hkv, hd), K/V of ``enc_out``
    before the heads' expansion.

    positions, mask, ``arange_positions``, ``ctx`` and ``sp``: as
    ``apply_layer``. On a mesh the cache entry is this rank's, as
    ``sharding.prefill_cache_specs`` cuts it; under ``sp`` the mixer and
    the cross-attention run on the gathered sequence (``_seq_whole``), so
    the entry covers the whole sequence."""
    kind = "attn" if cfg.layer_kind(pos) == "a" else "ssm"
    mix_span = "model.attn" if kind == "attn" else "model.ssm"
    cross = kind == "attn" and enc_out is not None
    pr = f"L{block}."
    xm = pr + "xm"
    xm0 = pr + ("xm0" if cross else "xm")
    cache_w = (pr + "cache",) if return_cache else ()

    def mixer(h):
        """(the mixer's output, its cache entry or None)."""
        if kind == "attn":
            a = cfg.attn
            out = attn_apply(cfg, p["attn"], h, positions, a.causal,
                             a.rope_theta > 0, kv_mask=mask,
                             arange_positions=arange_positions, ctx=ctx,
                             return_kv=return_cache)
            return out if return_cache else (out, None)
        return SSM.ssm_forward(cfg, cfg.ssm, p["ssm"], h,
                               return_cache=return_cache, mask=mask,
                               ctx=ctx)

    def f_mix(env):
        entry = []

        def run(t):
            out, ce = mixer(t)
            entry.append(ce)
            return out

        with tracing.span(mix_span):
            h = sp_norm(cfg, p["ln1"], env[x_in], ctx, sp)
            env[pr + "h0"] = _seq_whole(run, h, ctx, sp)
        if return_cache:
            env[pr + "cache"] = entry[0]

    def f_res1(env):
        x = env[x_in]
        env[xm0] = x + env[pr + "h0"].to(x.dtype)

    segs = [ExecSeg(pr + kind, kind, block, (x_in,), (pr + "h0",) + cache_w,
                    f_mix),
            ExecSeg(pr + "res1", "residual", block, (x_in, pr + "h0"),
                    (xm0,), f_res1)]
    if cross:
        def f_xattn(env):
            xkv = []

            def run(t):
                out = attn_apply(cfg, p["xattn"], t, positions, False,
                                 False, ctx=ctx, return_kv=return_cache,
                                 kv_x=enc_out)
                if return_cache:
                    out, kv = out
                    xkv.append(kv)
                return out

            with tracing.span("model.attn"):
                hx = sp_norm(cfg, p["ln_x"], env[xm0], ctx, sp)
                env[pr + "hx"] = _seq_whole(run, hx, ctx, sp)
            if return_cache:
                env[pr + "cache"]["xk"] = xkv[0]["k"]
                env[pr + "cache"]["xv"] = xkv[0]["v"]

        def f_resx(env):
            x = env[xm0]
            env[xm] = x + env[pr + "hx"].to(x.dtype)

        segs += [ExecSeg(pr + "xattn", "attn", block, (xm0,) + cache_w,
                         (pr + "hx",) + cache_w, f_xattn),
                 ExecSeg(pr + "resx", "residual", block, (xm0, pr + "hx"),
                         (xm,), f_resx)]
    tail = []
    if "ln2" in p and "moe" in p:
        def f_moe(env):
            with tracing.span("model.moe"):
                env[pr + "h1"], env[pr + "aux"] = _moe_out(cfg, p, env[xm],
                                                           ctx, sp)

        segs.append(ExecSeg(pr + "moe", "moe", block, (xm,),
                            (pr + "h1", pr + "aux"), f_moe))
        tail.append(pr + "h1")
        if "shared" in p["moe"]:
            # reads the mid residual only: independent of the ring, the
            # one executed segment the scheduler can move past it
            def f_shared(env):
                with tracing.span("model.moe"):
                    env[pr + "hsh"] = _shared_out(cfg, p, env[xm], ctx, sp)

            segs.append(ExecSeg(pr + "shared", "shared_ffn", block, (xm,),
                                (pr + "hsh",), f_shared))
            tail.append(pr + "hsh")
    elif "ln2" in p:
        def f_ffn(env):
            with tracing.span("model.ffn"):
                env[pr + "h1"] = _ffn_out(cfg, p, env[xm], ctx, sp)

        segs.append(ExecSeg(pr + "ffn", "ffn", block, (xm,), (pr + "h1",),
                            f_ffn))
        tail.append(pr + "h1")

    def f_tail(env):
        x = env[xm]
        if tail:
            h = env[tail[0]]
            if len(tail) > 1:
                h = h + env[tail[1]]
            x = x + h.to(x.dtype)
        env[x_out] = x

    segs.append(ExecSeg(pr + "res2", "residual", block, (xm,) + tuple(tail),
                        (x_out,), f_tail))
    return segs


def run_segments(segs, env):
    """Execute segments in the given emission order against ``env``."""
    for s in segs:
        s.fn(env)
    return env


def apply_layer(cfg, pos: int, p, x, positions, mask=None,
                arange_positions: bool = False, ctx=None, sp: bool = False,
                return_cache: bool = False, enc_out=None):
    """One layer of the training forward and the monolithic prefill
    (``repro/models/blocks.py:361-378``): the sequential interpretation of
    ``block_segments``, ln1 -> (attention | SSM) -> residual -> ln2 ->
    (MoE | FFN) -> residual, with ln_x -> cross-attention over ``enc_out``
    (B, Sk, d) -> residual after the attention of an encoder-decoder's
    decoder layer. mask: optional (B, S) validity; pad keys are
    excluded from attention and pad steps are identities of the SSM scan.
    ``arange_positions``: see attn_apply. ``ctx``: a ranked context (the
    module docstring), or None at one rank. Returns (x, aux loss fp32,
    the layer's cache entry with ``return_cache``, else None).

    ``sp``: the sequence-parallel residual (``lm.sp_split``). x, and the x
    returned, are this rank's slice of the sequence; the norms and
    residual adds run on the slice, attention, the SSM and the dense FFN
    on the gathered sequence (``_seq_whole``), and a sequence-sharded MoE
    routes the slice as it is. positions and mask stay whole."""
    segs = block_segments(cfg, pos, p, positions, mask, return_cache,
                          block=pos, ctx=ctx, sp=sp,
                          arange_positions=arange_positions, enc_out=enc_out)
    env = run_segments(segs, {"x": x})
    aux = env.get(f"L{pos}.aux")
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return env["x_out"], aux, env.get(f"L{pos}.cache")


# ---------------------------------------------------------------------------
# the cached serving modes, at one rank or on a mesh
# ---------------------------------------------------------------------------


def _serve_attn(cfg, p_attn, ctx, cut: str):
    """(the weights a serving step projects with, whether its
    o-projection is a partial sum over the model group). Under
    ``kv_group`` this rank's slice of the cache holds its kv heads: q, k
    and v are column-parallel (this rank's heads, as stored) and wo is
    row-parallel, the ``heads`` case of ``_attn_ranked``. Under
    ``split_kv`` and ``replicated`` every model rank projects with the
    whole weights (``_whole``)."""
    if not _ranked(ctx) or ctx.model_size == 1:
        return p_attn, False
    if cut == "kv_group":
        return p_attn, True
    a = cfg.attn
    return {**_whole(p_attn, ctx, ("wq", "bq", "wo"),
                     a.n_heads * a.head_dim),
            **_whole(p_attn, ctx, ("wk", "bk", "wv", "bv"),
                     a.n_kv_heads * a.head_dim)}, False


class PagedKV(NamedTuple):
    """How a serving call's attention layers read and write the paged K/V
    pools, worked out once per call (``lm.decode_step``,
    ``lm.prefill_chunk``):

      table - (rows run here, nb) the block-table rows this rank's rows
              read through;
      rows  - the flat pool row (``A.decode_rows``, ``A.chunk_rows``) of
              every token of every row of the call, which every rank
              writes;
      mine  - where the slots are cut over dp: the indices, among the
              call's ``n_all`` rows, of the rows this rank runs and
              writes (each dp rank computes K/V for its rows only; they
              are summed over ``group``, the dp group, into every row's,
              so every dp rank's pool takes every write, as the JAX
              package's one pool over dp does); None otherwise.
    """
    table: torch.Tensor
    rows: torch.Tensor
    mine: Optional[torch.Tensor] = None
    n_all: int = 0
    group: Any = None


def _write_paged(kc, vc, k, v, paged: PagedKV):
    """Write this call's new K/V (R, C, Hkv, hd) into the pools through
    ``paged.rows``, in place; where the slots are cut over dp, first the
    whole call's K/V from every dp rank's rows (one all-reduce of (2,
    n_all, C, Hkv, hd), zeros but for each rank's rows: exact)."""
    if paged.mine is not None:
        n = paged.mine.numel()
        whole = k.new_zeros((2, paged.n_all) + tuple(k.shape[1:]))
        whole[0, paged.mine] = k[:n]
        whole[1, paged.mine] = v[:n].to(k.dtype)
        CL.all_reduce_(whole, paged.group)
        k, v = whole[0], whole[1]
    A.paged_write(kc, vc, k, v, paged.rows)


def _write_decode_row(kc, vc, k, v, t_pos, ctx, cut: str):
    """Write each row's new K/V (B, 1, Hkv, hd) at its position ``t_pos``
    (clamped to the cache, as ``A.update_cache`` does), in place. Under
    ``split_kv`` a row lands only on the rank whose slice of the positions
    holds it; the other ranks write the row's old value back at a clamped
    index of their own slice (one index per row: no two writes meet, and
    no host sync)."""
    if cut != "split_kv":
        A.update_cache(kc, vc, k, v, t_pos)
        return
    B, S_loc = kc.shape[:2]
    lo = ctx.model_rank * S_loc
    p = torch.clamp(t_pos.long(), 0, S_loc * ctx.model_size - 1) - lo
    mine = ((p >= 0) & (p < S_loc)).reshape(B, 1, 1)
    rows = torch.arange(B, device=kc.device)
    p = torch.clamp(p, 0, S_loc - 1)
    for c, n in ((kc, k), (vc, v)):
        c[rows, p] = torch.where(mine, n[:, 0].to(c.dtype), c[rows, p])


def sharded_decode_attention(ctx, q, k_cache, v_cache, t_pos, cut: str,
                             block_table=None, kv_start=None):
    """Decode attention against this rank's slice of the cache, with no
    gather of the cache (``repro/models/blocks.py:417-500``). q: this
    rank's rows and q heads (B_l, 1, H_l, hd); t_pos: (B_l,). The arms
    (``parallel.sharding.kv_cut``):

      kv_group   - the cache holds this rank's kv heads, q its q heads
                   (the projections are column-parallel): local decode,
                   no collective;
      split_kv   - the cache holds this rank's S/m positions from
                   rank * S/m: flash-decode partials over them, merged
                   over the model group (one all-reduce MAX, one SUM of
                   (B, H, 1, hd + 1));
      replicated - the whole cache on every model rank: plain decode.

    The rows are this rank's slots, cut over dp where the cache's slots
    are (``sharding.slots_cut``). With ``block_table`` (B_l, nb) the caches
    are page pools, read through the table (``repro/models/blocks.py:
    447-487``): cut on their kv heads (``kv_group``, the table whole on
    every model rank: local decode) or whole (``replicated``); never
    split-KV, since pages interleave positions. ``kv_start``: optional
    (B_l,) first valid cache index per row (a left-padded prefill's
    pads excluded)."""
    if block_table is not None:
        if cut == "split_kv":
            raise ValueError("a paged pool is never cut over positions "
                             "(sharding.kv_cut(..., paged=True))")
        return A.decode_attention(q, k_cache, v_cache, t_pos, block_table,
                                  kv_start)
    if cut == "split_kv" and _ranked(ctx) and ctx.model_size > 1:
        off = ctx.model_rank * k_cache.shape[1]
        m, l, acc = A.decode_attention_partial(q, k_cache, v_cache, t_pos,
                                               off, kv_start)
        out = A.merge_decode_partials(m, l, acc, ctx.model_group)
        return out.transpose(1, 2).to(q.dtype)
    return A.decode_attention(q, k_cache, v_cache, t_pos,
                              kv_start=kv_start)


def decode_layer(cfg, pos: int, p, x, cache, t_pos, ctx=None,
                 cut: str = "replicated", paged: Optional[PagedKV] = None,
                 rope_pos=None, kv_start=None, has_cross: bool = False,
                 xcut: str = "replicated"):
    """x: (B, 1, d); cache: this layer's {"k", "v"} (B, S, Hkv, hd) or SSM
    {"conv", "state"} (B, ...), updated in place; t_pos: (B,) per-row cache
    write index (= RoPE position unless ``rope_pos`` (B,) gives it: a
    left-padded row's real position is its index less its pads);
    ``kv_start``: optional (B,) first valid cache index per row. Returns
    x. ``paged``: the K/V entries are page pools (n_pages, page, Hkv, hd),
    written and read through it.

    ``ctx``: a ranked context of the serving steps (``seq_shard`` off), or
    None at one rank. x and t_pos are then this rank's slots, the cache
    this rank's slice of them, cut over the model axis as ``cut``
    (``parallel.sharding.kv_cut``) says: see ``sharded_decode_attention``
    and ``_serve_attn``. The SSM block runs whole on every model rank, the
    MoE through the ranked ``moe_ffn``, the dense FFN column- then
    row-parallel (``_mlp_tail``).

    ``has_cross``: an encoder-decoder's decoder layer: after the
    self-attention, ln_x -> q of ``xattn.wq`` (no bias, as the JAX package
    takes it) -> plain non-causal attention over every row of the cache's
    {"xk", "xv"} (B, enc_len, Hkv, hd), unwritten rows included
    (``repro/models/blocks.py:541-546``) -> ``xattn.wo`` -> residual. On a
    mesh it follows the "xk"/"xv" cut ``xcut``, which may differ from the
    self-attention's (``sharding.kv_cut`` of enc_len rows): ``kv_group``
    this rank's q heads (columns of ``xattn.wq``) over its kv heads, its
    rows of ``xattn.wo``, the partial sums reduced; ``split_kv``
    flash-decode partials over this rank's rows, every row valid (no
    position mask), merged by the MAX and SUM all-reduces; ``replicated``
    whole."""
    if cfg.layer_kind(pos) != "a":
        with tracing.span("model.ssm"):
            h, new = SSM.ssm_forward(cfg, cfg.ssm, p["ssm"],
                                     apply_norm(cfg, p["ln1"], x),
                                     cache=cache, ctx=ctx)
            cache["conv"].copy_(new["conv"])
            cache["state"].copy_(new["state"])
        return _mlp_tail(cfg, p, x + h, ctx)[0]
    with tracing.span("model.attn"):
        x = _decode_attn(cfg, p, x, cache, t_pos, ctx, cut, paged, rope_pos,
                         kv_start, has_cross, xcut)
    return _mlp_tail(cfg, p, x, ctx)[0]


def _decode_attn(cfg, p, x, cache, t_pos, ctx, cut, paged, rope_pos,
                 kv_start, has_cross, xcut):
    """``decode_layer``'s attention and its residual (and an
    encoder-decoder's cross-attention): x after them."""
    h = apply_norm(cfg, p["ln1"], x)
    a = cfg.attn
    B = x.shape[0]
    w, partial = _serve_attn(cfg, p["attn"], ctx, cut)
    q, k, v = _qkv_proj(a, w, h)
    if a.rope_theta > 0:
        pos_arr = (t_pos if rope_pos is None else rope_pos).reshape(B, 1)
        q = apply_rope(q, pos_arr, a.rope_theta)
        k = apply_rope(k, pos_arr, a.rope_theta)
    if paged is None:
        _write_decode_row(cache["k"], cache["v"], k, v, t_pos, ctx, cut)
    else:
        _write_paged(cache["k"], cache["v"], k, v, paged)
    o = sharded_decode_attention(ctx, q, cache["k"], cache["v"], t_pos, cut,
                                 None if paged is None else paged.table,
                                 kv_start)
    o = o.reshape(B, 1, -1) @ w["wo"]
    if partial:
        o = CL.reduce_from(o, ctx.model_group)
    x = x + o
    if has_cross:
        x = x + _decode_cross(cfg, p, x, cache, ctx, xcut)
    return x


def _decode_cross(cfg, p, x, cache, ctx, xcut: str):
    """A decode step's cross-attention output (B, 1, d) over the cache's
    "xk"/"xv", cut over the model axis as ``xcut`` says
    (``decode_layer``)."""
    a = cfg.attn
    B = x.shape[0]
    hx = apply_norm(cfg, p["ln_x"], x)
    w, partial = p["xattn"], False
    ranked = _ranked(ctx) and ctx.model_size > 1
    if ranked and xcut == "kv_group":
        partial = True
    elif ranked:
        w = _whole(w, ctx, ("wq", "wo"), a.n_heads * a.head_dim)
    q = (hx @ w["wq"]).reshape(B, 1, -1, a.head_dim)
    xk, xv = cache["xk"], cache["xv"]
    if ranked and xcut == "split_kv":
        n = xk.shape[1]
        every = torch.full((B,), n * ctx.model_size - 1, device=x.device)
        m, l, acc = A.decode_attention_partial(q, xk, xv, every,
                                               ctx.model_rank * n)
        o = A.merge_decode_partials(m, l, acc, ctx.model_group).transpose(
            1, 2).to(q.dtype)
    else:
        o = A.dense_attention(q, xk, xv, None, None, causal=False)
    o = o.reshape(B, 1, -1) @ w["wo"]
    return CL.reduce_from(o, ctx.model_group) if partial else o


def chunk_layer(cfg, pos: int, p, x, cache, slots, pos_off, q_pos, mask,
                valid_len, ctx=None, cut: str = "replicated",
                n_write: int = -1, paged: Optional[PagedKV] = None):
    """One prompt chunk per admission row: x (A, C, d) rows enter slot
    ``slots[a]`` of the full cache at indices [pos_off[a], pos_off[a] + C),
    written in place; each row attends over its own slot up to its own
    index (earlier chunks included). Tail-pad K/V land past every valid
    query's index: causal-masked now, overwritten by the first decode
    steps before any query can reach them. An SSM layer takes its slots'
    conv window and state out (zeroed where pos_off == 0: a request's first
    chunk starts from a zero carry), scans on from them with the pads
    (mask (A, C) false) as identity steps, and writes them back in place
    with the window after each row's valid_len tokens. Returns x.

    ``ctx``: a ranked context (``decode_layer``); ``slots`` are then
    indices into this rank's slots, and only the first ``n_write`` rows
    (-1: all) write the cache (``lm.prefill_chunk`` runs one stand-in
    row, whose output it drops, when this rank holds none of the stack's
    slots). Under ``split_kv`` a row's earlier chunks lie on every model
    rank: the rows' slots are gathered whole over the model group, the
    chunk's K/V written into the gathered rows, the attention taken over
    them (``A.attention``, as at one rank), and each rank's slice of the
    positions copied back into its cache.

    ``paged``: the K/V entries are page pools; the chunk's K/V go in
    through ``paged.rows`` (tail pads and identity rows to the null page,
    as ``A.paged_chunk_update`` steers them) and each row attends over
    its logical view gathered through ``paged.table``. ``slots`` then
    index the SSM entries only."""
    n = x.shape[0] if n_write < 0 else n_write
    if cfg.layer_kind(pos) != "a":
        with tracing.span("model.ssm"):
            carry = {}
            for k in ("conv", "state"):
                c = cache[k][slots]
                first = (pos_off == 0).reshape((-1,) + (1,) * (c.dim() - 1))
                carry[k] = torch.where(first, torch.zeros_like(c), c)
            h, new = SSM.ssm_forward(cfg, cfg.ssm, p["ssm"],
                                     apply_norm(cfg, p["ln1"], x),
                                     cache=carry, mask=mask,
                                     valid_len=valid_len, ctx=ctx)
            for k in ("conv", "state"):
                cache[k].index_copy_(0, slots[:n],
                                     new[k][:n].to(cache[k].dtype))
        return _mlp_tail(cfg, p, x + h.to(x.dtype), ctx)[0]
    with tracing.span("model.attn"):
        x = _chunk_attn(cfg, p, x, cache, slots, q_pos, ctx, cut, n, paged)
    return _mlp_tail(cfg, p, x, ctx)[0]


def _chunk_attn(cfg, p, x, cache, slots, q_pos, ctx, cut, n, paged):
    """``chunk_layer``'s attention and its residual: x after them."""
    h = apply_norm(cfg, p["ln1"], x)
    a = cfg.attn
    Ac, C, _ = x.shape
    w, partial = _serve_attn(cfg, p["attn"], ctx, cut)
    q, k, v = _qkv_proj(a, w, h)
    if a.rope_theta > 0:
        q = apply_rope(q, q_pos, a.rope_theta)
        k = apply_rope(k, q_pos, a.rope_theta)
    ck, cv = cache["k"], cache["v"]
    if paged is not None:
        _write_paged(ck, cv, k, v, paged)
        kc, vc = A.paged_gather(ck, paged.table), A.paged_gather(
            cv, paged.table)                   # (A, nb * page, Hkv, hd)
    elif cut == "split_kv" and _ranked(ctx) and ctx.model_size > 1:
        G = ctx.model_group
        S_loc = ck.shape[1]
        lo = ctx.model_rank * S_loc
        kc = CL.gather_from(ck[slots], G, 1)           # (A, S, Hkv, hd)
        vc = CL.gather_from(cv[slots], G, 1)
        rows = torch.arange(Ac, device=x.device)[:, None]
        kc[rows, q_pos] = k.to(kc.dtype)
        vc[rows, q_pos] = v.to(vc.dtype)
        ck[slots[:n]] = kc[:n, lo:lo + S_loc]
        cv[slots[:n]] = vc[:n, lo:lo + S_loc]
    else:
        ck[slots[:n, None], q_pos[:n]] = k[:n].to(ck.dtype)
        cv[slots[:n, None], q_pos[:n]] = v[:n].to(cv.dtype)
        kc, vc = ck[slots], cv[slots]                  # (A, S, Hkv, hd)
    S_tot = kc.shape[1]
    kv_pos = torch.arange(S_tot, device=x.device)[None, :].expand(Ac, S_tot)
    o = A.attention(q, kc, vc, q_pos, kv_pos, q_block=a.q_block,
                    kv_block=a.kv_block)
    h = o.reshape(Ac, C, -1) @ w["wo"]
    if partial:
        h = CL.reduce_from(h, ctx.model_group)
    return x + h.to(x.dtype)
