"""GQA attention in plain PyTorch: the projections' schema
(``attn_schema``, self- and cross-attention), dense and chunked
online-softmax prefill attention, and decode against a contiguous KV
cache.

These mirror the JAX package's jnp einsums (``repro.models.attention``),
scores and softmax in fp32. They are not ``scaled_dot_product_attention``;
the training forward's full-sequence attention goes to the flash-attention
kernel instead (``models/blocks.attn_apply``). Masks are by
absolute positions (``q_pos``/``kv_pos``, causal or not) and an optional
(B, Sk) key validity ``kv_mask``, and ``decode_attention``'s
``kv_start`` (a left-padded row's first valid index); the JAX functions'
``q_offset`` is not ported (no caller passes one). The split-KV decode of a cache cut over positions reduces each
shard to flash-decode partials (``decode_attention_partial``) and merges
them across the shards' ranks (``merge_decode_partials``). The paged
cache's pools are read through block tables (``paged_gather``) and
written through them in place (``paged_update_cache``,
``paged_chunk_update``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import ParamDecl
from repro_torch.parallel import collectives as CL

NEG_INF = -1e30
DENSE_THRESHOLD = 1024          # the JAX package's attention() default


def attn_schema(cfg, a, cross: bool = False):
    """The q/k/v/o projections (and their biases where ``a.qkv_bias``) of
    an attention block (``repro/models/attention.py:23-35``). A
    cross-attention (``cross``) has the same leaves: its k and v project
    the encoder's output."""
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


def _expand_kv(k, n_heads):
    """(B, S, Hkv, hd) -> (B, S, Hq, hd) by repeat."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _scale(hd: int) -> float:
    return 1.0 / math.sqrt(hd)


def _causal(q_pos, kv_pos):
    """(B, Sq), (B, Sk) absolute positions -> (B, 1, Sq, Sk) keep-mask."""
    return kv_pos[:, None, None, :] <= q_pos[:, None, :, None]


def _mask(s, q_pos, kv_pos, causal, kv_mask):
    """Scores (B, H, Sq, Sk) with the causal mask and the (B, Sk) key
    validity applied."""
    if causal:
        s = torch.where(_causal(q_pos, kv_pos), s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
    return s


def dense_attention(q, k, v, q_pos, kv_pos, causal: bool = True,
                    kv_mask=None):
    """O(S^2) path. q: (B, Sq, H, hd), k/v: (B, Sk, Hkv, hd); q_pos/
    kv_pos: (B, Sq)/(B, Sk) absolute positions for the causal mask;
    kv_mask: optional (B, Sk) bool, False keys are excluded."""
    H, hd = q.shape[2], q.shape[3]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * _scale(hd)
    scores = _mask(scores, q_pos, kv_pos, causal, kv_mask)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, q_block: int, kv_block: int, q_pos, kv_pos,
                      causal: bool = True, kv_mask=None):
    """Flash-style two-level loop: outer over q blocks, inner over kv
    blocks with a running (max, sum, acc). Memory O(q_block * kv_block).
    Shapes the blocks do not tile take the dense path."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    if Sq % q_block or Sk % kv_block:
        return dense_attention(q, k, v, q_pos, kv_pos, causal, kv_mask)
    dev = q.device
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    outs = []
    for qs in range(0, Sq, q_block):
        qblk = q[:, qs:qs + q_block].float().transpose(1, 2) * _scale(hd)
        qpos = q_pos[:, qs:qs + q_block]
        m = torch.full((B, H, q_block), NEG_INF, device=dev)
        l = torch.zeros((B, H, q_block), device=dev)
        acc = torch.zeros((B, H, q_block, hd), device=dev)
        for ks in range(0, Sk, kv_block):
            kblk = k[:, ks:ks + kv_block].float().transpose(1, 2)
            vblk = v[:, ks:ks + kv_block].float().transpose(1, 2)
            s = torch.einsum("bhqd,bhkd->bhqk", qblk, kblk)
            s = _mask(s, qpos, kv_pos[:, ks:ks + kv_block], causal,
                      None if kv_mask is None
                      else kv_mask[:, ks:ks + kv_block])
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                       vblk)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=2).transpose(1, 2)                # (B,Sq,H,hd)
    return out.to(q.dtype)


def attention(q, k, v, q_pos, kv_pos, q_block: int = 512,
              kv_block: int = 1024, causal: bool = True, kv_mask=None):
    """Full-sequence attention: the dense path up to DENSE_THRESHOLD**2
    score elements per row and head, the chunked path beyond (the JAX
    package's switch, attention.py:170-178)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq * Sk <= DENSE_THRESHOLD * DENSE_THRESHOLD:
        return dense_attention(q, k, v, q_pos, kv_pos, causal, kv_mask)
    return chunked_attention(q, k, v, q_block, kv_block, q_pos, kv_pos,
                             causal, kv_mask)


# -- the paged (block-table) cache layout ------------------------------------
# A pool holds fixed-size pages shared by every slot: (n_pages, page, Hkv,
# hd). A block table (B, max_blocks) maps row b's logical block i
# (positions [i * page, (i + 1) * page)) to a physical page; entry 0 is the
# NULL page, never allocated: unmapped blocks gather it (masked by position
# validity) and writes of dead rows and masked tokens are steered into it
# (``repro/models/attention.py:186-247``). Writes scatter into the pool's
# flat (n_pages * page, Hkv, hd) view, in place.

NULL_PAGE = 0


def paged_gather(pool, block_table):
    """The logical per-row view of a pool. pool: (P, page, Hkv, hd);
    block_table: (B, nb) page ids. Returns (B, nb * page, Hkv, hd), row
    b's logical positions in order."""
    P, page, Hkv, hd = pool.shape
    B, nb = block_table.shape
    flat = pool.index_select(0, block_table.reshape(-1).long())
    return flat.view(B, nb * page, Hkv, hd)


def decode_rows(pos, block_table, page: int):
    """The flat pool row (page id * page + offset) each decode row writes
    at its logical position ``pos`` (B,): the block is clipped to the
    table, so a position past it lands in the last block's page, and a
    dead row's all-zero table row steers it into the null page."""
    B, nb = block_table.shape
    pos = pos.long().reshape(-1).expand(B)
    blk = torch.clamp(pos // page, 0, nb - 1)
    pid = block_table.long().gather(1, blk[:, None])[:, 0]
    return pid * page + pos % page


def chunk_rows(pos_off, block_table, tok_mask, page: int):
    """The flat pool row of each token of a prompt chunk, (A * C,): row a's
    token c at logical position pos_off[a] + c; tokens masked out
    (``tok_mask`` (A, C) false: tail pads, identity rows) or past the
    table go to the null page."""
    A, C = tok_mask.shape
    nb = block_table.shape[1]
    pos_off = pos_off.long().reshape(-1).expand(A)
    positions = pos_off[:, None] + torch.arange(C, device=pos_off.device)
    blk = positions // page
    pid = block_table.long().gather(1, torch.clamp(blk, 0, nb - 1))
    pid = torch.where(tok_mask & (blk < nb), pid, NULL_PAGE)
    return (pid * page + positions % page).reshape(A * C)


def paged_write(k_pool, v_pool, k, v, rows):
    """Write new K/V (R, C, Hkv, hd) at the flat pool rows ``rows`` (R *
    C,), in place. Rows that meet (the null page) keep one of their
    writes, which one undefined, as in the JAX scatter."""
    P, page, Hkv, hd = k_pool.shape
    for pool, new in ((k_pool, k), (v_pool, v)):
        pool.view(P * page, Hkv, hd).index_copy_(
            0, rows, new.reshape(-1, Hkv, hd).to(pool.dtype))
    return k_pool, v_pool


def paged_update_cache(k_pool, v_pool, k_new, v_new, pos, block_table):
    """Decode write through block tables: (B, 1, Hkv, hd) at each row's
    logical position ``pos`` (B,), in place; rows whose mapped page is the
    null page (free slots: all-zero table rows) write into it. Returns
    the pools."""
    return paged_write(k_pool, v_pool, k_new, v_new,
                       decode_rows(pos, block_table, k_pool.shape[1]))


def paged_chunk_update(k_pool, v_pool, k, v, pos_off, block_table,
                       tok_mask):
    """Prefill-chunk write through block tables: k/v (A, C, Hkv, hd) at
    logical positions pos_off[a] + [0, C), in place; tokens with
    ``tok_mask`` (A, C) false go to the null page. Returns the pools."""
    return paged_write(k_pool, v_pool, k, v,
                       chunk_rows(pos_off, block_table, tok_mask,
                                  k_pool.shape[1]))


def decode_attention(q, k_cache, v_cache, pos, block_table=None,
                     kv_start=None):
    """q: (B, 1, H, hd); caches: (B, S, Hkv, hd); pos: (B,) per-row current
    index. Attends over cache[kv_start : pos + 1] by masking (a ``where``
    on the scores); kv_start: optional (B,) first valid index per row (a
    left-padded row excludes its pads). block_table: optional (B, nb);
    the caches are then shared (n_pages, page, Hkv, hd) pools and each
    row's logical view is gathered through its table (``paged_gather``;
    unmapped blocks read the null page, masked like stale contiguous
    rows)."""
    if block_table is not None:
        k_cache = paged_gather(k_cache, block_table)
        v_cache = paged_gather(v_cache, block_table)
    S = k_cache.shape[1]
    H, hd = q.shape[2], q.shape[3]
    k = _expand_kv(k_cache, H)
    v = _expand_kv(v_cache, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(hd)
    ar = torch.arange(S, device=q.device)[None, None, None, :]
    valid = ar <= pos.reshape(-1, 1, 1, 1)
    if kv_start is not None:
        valid = valid & (ar >= kv_start.reshape(-1, 1, 1, 1))
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def decode_attention_partial(q, k_shard, v_shard, pos, kv_offset: int,
                             kv_start=None):
    """Flash-decode partial over a local shard of the cache's positions
    (``repro/models/attention.py:282-306``). q: (B, 1, H, hd); shards:
    (B, S_loc, Hkv, hd) holding absolute positions [kv_offset, kv_offset +
    S_loc); pos: (B,) per-row current index; kv_start: optional (B,)
    first valid index. Returns fp32 (m, l, acc): the running max (B, H,
    1), the sum (B, H, 1) and the accumulator (B, H, 1, hd). A shard
    wholly past ``pos`` gives l = acc = 0 and a finite m (NEG_INF)."""
    S_loc = k_shard.shape[1]
    H, hd = q.shape[2], q.shape[3]
    k = _expand_kv(k_shard, H)
    v = _expand_kv(v_shard, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(hd)
    ar = (kv_offset + torch.arange(S_loc, device=q.device))[
        None, None, None, :]
    valid = ar <= pos.reshape(-1, 1, 1, 1)
    if kv_start is not None:
        valid = valid & (ar >= kv_start.reshape(-1, 1, 1, 1))
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)                                       # (B, H, 1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bhqk,bkhd->bhqd", p, v.float())


def merge_decode_partials(m, l, acc, group=None):
    """Merge split-KV partials into the attention output (B, H, 1, hd)
    fp32 (``repro/models/attention.py:309-316``): the global max, each
    partial rescaled by exp(m - max), sums divided by max(l, 1e-30).
    ``group``: the process group whose members hold the shards, each
    passing its own partials (one all-reduce MAX of m, one SUM of l and
    acc together: a few kB per layer instead of gathering the cache);
    None: the shards' partials stacked here on a leading axis."""
    if group is None:
        m_g = m.amax(dim=0)
        corr = torch.exp(m - m_g)
        l_g = (l * corr).sum(dim=0)
        acc_g = (acc * corr[..., None]).sum(dim=0)
    else:
        m_g = CL.all_reduce_(m.clone(), group, op="max")
        corr = torch.exp(m - m_g)
        both = CL.all_reduce_(torch.cat([acc * corr[..., None],
                                         (l * corr)[..., None]], dim=-1),
                              group)
        acc_g, l_g = both[..., :-1], both[..., -1]
    return acc_g / torch.clamp(l_g[..., None], min=1e-30)


def update_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write (B, 1, Hkv, hd) at per-row positions ``pos`` (B,), in place.
    Positions past the end clamp to the last index, as the JAX package's
    dynamic_update_slice does."""
    B, S = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    p = torch.clamp(pos.long(), 0, S - 1)
    k_cache[rows, p] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, p] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
