"""Layer blocks: (attention | Mamba-2 SSM) + (dense FFN | MoE), schema,
the training forward (``apply_layer``, the sequential form of the JAX
package's ``block_segments``) and the two cached serving modes,
single-token decode and chunked prefill, of both layer kinds. No
cross-attention yet."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.moe_layer import moe_ffn, moe_schema
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models.common import (ParamDecl, apply_norm, apply_rope,
                                       ffn_apply, ffn_schema, norm_schema)


def attn_schema(cfg, a) -> Dict[str, ParamDecl]:
    d = cfg.d_model
    s = {
        "wq": ParamDecl((d, a.n_heads * a.head_dim), ("embed", "qheads")),
        "wk": ParamDecl((d, a.n_kv_heads * a.head_dim), ("embed", "kvheads")),
        "wv": ParamDecl((d, a.n_kv_heads * a.head_dim), ("embed", "kvheads")),
        "wo": ParamDecl((a.n_heads * a.head_dim, d), ("qheads", "embed")),
    }
    if a.qkv_bias:
        s["bq"] = ParamDecl((a.n_heads * a.head_dim,), ("qheads",), "zeros")
        s["bk"] = ParamDecl((a.n_kv_heads * a.head_dim,), ("kvheads",),
                            "zeros")
        s["bv"] = ParamDecl((a.n_kv_heads * a.head_dim,), ("kvheads",),
                            "zeros")
    return s


def layer_schema(cfg, pos: int) -> Dict:
    if cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet")
    s: Dict[str, Any] = {"ln1": norm_schema(cfg, cfg.d_model)}
    if cfg.layer_kind(pos) == "a":
        s["attn"] = attn_schema(cfg, cfg.attn)
    else:
        s["ssm"] = SSM.ssm_schema(cfg, cfg.ssm)
    if cfg.d_ff > 0 or cfg.is_moe_layer(pos):
        s["ln2"] = norm_schema(cfg, cfg.d_model)
        if cfg.is_moe_layer(pos):
            s["moe"] = moe_schema(cfg, cfg.moe, W=1, etp=1)
        else:
            s["ffn"] = ffn_schema(cfg, cfg.d_model, cfg.d_ff)
    return s


def _qkv_proj(a, p_attn, h):
    """QKV projection + bias + head reshape. h: (B, S, d) -> q/k/v
    (B, S, H*, hd)."""
    B, S, _ = h.shape
    q = h @ p_attn["wq"]
    k = h @ p_attn["wk"]
    v = h @ p_attn["wv"]
    if "bq" in p_attn:
        q = q + p_attn["bq"].to(q.dtype)
        k = k + p_attn["bk"].to(k.dtype)
        v = v + p_attn["bv"].to(v.dtype)
    return (q.reshape(B, S, a.n_heads, a.head_dim),
            k.reshape(B, S, a.n_kv_heads, a.head_dim),
            v.reshape(B, S, a.n_kv_heads, a.head_dim))


def _mlp_tail(cfg, p, x):
    """ln2 -> (MoE | FFN) -> residual. Returns (x, aux loss fp32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ln2" not in p:
        return x, aux
    h = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        h, aux = moe_ffn(cfg, cfg.moe, p["moe"], h,
                         n_col=cfg.moe.n_col_blocks)
        if "shared" in p["moe"]:
            h = h + ffn_apply(cfg, p["moe"]["shared"],
                              apply_norm(cfg, p["ln2"], x))
    else:
        h = ffn_apply(cfg, p["ffn"], h)
    return x + h.to(x.dtype), aux


def attn_apply(cfg, p, x, positions, causal: bool, use_rope: bool = True,
               kv_mask=None, arange_positions: bool = False):
    """Full-sequence self-attention at one rank (blocks.py:116 of the JAX
    package). x: (B, S, d); positions: (B, S) or (1, S) absolute positions
    (RoPE and the causal mask); kv_mask: optional (B, S) key validity;
    ``arange_positions``: the caller built positions as arange(S) (the
    training forward without a mask). Returns the o-projection (B, S, d).

    Causal, unmasked, with positions arange(S): there the JAX package's
    ``__fusable__flash`` region computes exactly what its flash kernel
    computes, and the port sends it to ``ops.flash_attention`` (the
    hand-written kernel on a CUDA tensor). Every other case keeps the
    plain attention, as the JAX package does."""
    a = cfg.attn
    B, S, _ = x.shape
    q, k, v = _qkv_proj(a, p, x)
    positions = positions.expand(B, S)
    if use_rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    if causal and kv_mask is None and arange_positions:
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True)
        o = o.transpose(1, 2)
    else:
        if kv_mask is not None:
            kv_mask = kv_mask.expand(B, S)
        o = A.attention(q, k, v, positions, positions, q_block=a.q_block,
                        kv_block=a.kv_block, causal=causal, kv_mask=kv_mask)
    return o.reshape(B, S, a.n_heads * a.head_dim) @ p["wo"]


def apply_layer(cfg, pos: int, p, x, positions, mask=None,
                arange_positions: bool = False):
    """The training forward of one layer (blocks.py:361 of the JAX package,
    written sequentially): ln1 -> (attention | SSM) -> residual -> ln2 ->
    (MoE | FFN) -> residual. mask: optional (B, S) validity; pad keys are
    excluded from attention and pad steps are identities of the SSM scan.
    ``arange_positions``: see attn_apply. Returns (x, aux loss fp32)."""
    h = apply_norm(cfg, p["ln1"], x)
    if cfg.layer_kind(pos) == "a":
        a = cfg.attn
        h = attn_apply(cfg, p["attn"], h, positions, a.causal,
                       a.rope_theta > 0, kv_mask=mask,
                       arange_positions=arange_positions)
    else:
        h, _ = SSM.ssm_forward(cfg, cfg.ssm, p["ssm"], h, mask=mask)
    x = x + h.to(x.dtype)
    return _mlp_tail(cfg, p, x)


def decode_layer(cfg, pos: int, p, x, cache, t_pos):
    """x: (B, 1, d); cache: this layer's {"k", "v"} (B, S, Hkv, hd) or SSM
    {"conv", "state"} (B, ...), updated in place; t_pos: (B,) per-row cache
    write index (= RoPE position). Returns x."""
    h = apply_norm(cfg, p["ln1"], x)
    if cfg.layer_kind(pos) != "a":
        h, new = SSM.ssm_forward(cfg, cfg.ssm, p["ssm"], h, cache=cache)
        cache["conv"].copy_(new["conv"])
        cache["state"].copy_(new["state"])
        return _mlp_tail(cfg, p, x + h)[0]
    a = cfg.attn
    B = x.shape[0]
    q, k, v = _qkv_proj(a, p["attn"], h)
    if a.rope_theta > 0:
        pos_arr = t_pos.reshape(B, 1)
        q = apply_rope(q, pos_arr, a.rope_theta)
        k = apply_rope(k, pos_arr, a.rope_theta)
    kc, vc = A.update_cache(cache["k"], cache["v"], k, v, t_pos)
    o = A.decode_attention(q, kc, vc, t_pos)
    x = x + o.reshape(B, 1, a.n_heads * a.head_dim) @ p["attn"]["wo"]
    return _mlp_tail(cfg, p, x)[0]


def chunk_layer(cfg, pos: int, p, x, cache, slots, pos_off, q_pos, mask,
                valid_len):
    """One prompt chunk per admission row: x (A, C, d) rows enter slot
    ``slots[a]`` of the full cache at indices [pos_off[a], pos_off[a] + C),
    written in place; each row attends over its own slot up to its own
    index (earlier chunks included). Tail-pad K/V land past every valid
    query's index: causal-masked now, overwritten by the first decode
    steps before any query can reach them. An SSM layer takes its slots'
    conv window and state out (zeroed where pos_off == 0: a request's first
    chunk starts from a zero carry), scans on from them with the pads
    (mask (A, C) false) as identity steps, and writes them back in place
    with the window after each row's valid_len tokens. Returns x."""
    h = apply_norm(cfg, p["ln1"], x)
    if cfg.layer_kind(pos) != "a":
        carry = {}
        for k in ("conv", "state"):
            c = cache[k][slots]
            first = (pos_off == 0).reshape((-1,) + (1,) * (c.dim() - 1))
            carry[k] = torch.where(first, torch.zeros_like(c), c)
        h, new = SSM.ssm_forward(cfg, cfg.ssm, p["ssm"], h, cache=carry,
                                 mask=mask, valid_len=valid_len)
        for k in ("conv", "state"):
            cache[k].index_copy_(0, slots, new[k].to(cache[k].dtype))
        return _mlp_tail(cfg, p, x + h.to(x.dtype))[0]
    a = cfg.attn
    Ac, C, _ = x.shape
    q, k, v = _qkv_proj(a, p["attn"], h)
    if a.rope_theta > 0:
        q = apply_rope(q, q_pos, a.rope_theta)
        k = apply_rope(k, q_pos, a.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[slots[:, None], q_pos] = k.to(ck.dtype)
    cv[slots[:, None], q_pos] = v.to(cv.dtype)
    kc, vc = ck[slots], cv[slots]                      # (A, S, Hkv, hd)
    S_tot = kc.shape[1]
    kv_pos = torch.arange(S_tot, device=x.device)[None, :].expand(Ac, S_tot)
    o = A.attention(q, kc, vc, q_pos, kv_pos, q_block=a.q_block,
                    kv_block=a.kv_block)
    h = o.reshape(Ac, C, a.n_heads * a.head_dim) @ p["attn"]["wo"]
    x = x + h.to(x.dtype)
    return _mlp_tail(cfg, p, x)[0]
