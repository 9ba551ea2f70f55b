"""Logical-axis rules (MaxText-style), context construction, and one
rank's share of the global arrays.

Parameters: the JAX package's rules map each schema leaf's logical axes
to mesh axes (``make_rules``, ``decl_spec``, ``param_specs``), and
``jax.jit`` places every leaf by its spec. Here each rank keeps only its
slice: ``shard_params`` cuts a global tree by the specs and
``gather_params`` assembles it back (a collective). The global tree of a
mesh differs from the one-rank tree only in the packed expert storage
(W, E_loc, ...), W the model-axis size: ``to_mesh`` and ``from_mesh`` go
between the one-rank tree and this rank's shard of the mesh tree, the
layout-free form that checkpoints and the tests use.

Tokens: the JAX package hands ``shard_map`` the global arrays with
partition specs (``moe_layer.moe_ffn``'s ``in_specs``): tokens split over
dp (when B divides) and over the model axis (under sequence sharding), the
packed expert storage split over the model axis, the router replicated.
``shard_tokens`` and ``shard_experts`` cut a rank's share,
``gather_tokens`` and ``gather_experts`` assemble the global arrays back
(for tests and the self-test).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.moe_layer import (pack_expert_weights,
                                        resolve_token_sharding,
                                        unpack_expert_weights)
from repro_torch.models.common import ParamDecl, tree_map, tree_map_path
from repro_torch.parallel import collectives as CL
from repro_torch.parallel.mesh import AxisCtx, Mesh, choose_ep

Tree = Any
# a spec entry: no mesh axis, one, or several (row-major over them)
Entry = Union[None, str, Tuple[str, ...]]


class PartitionSpec:
    """One mesh-axis entry per dimension (``jax.sharding.PartitionSpec``).
    Not a tuple, so the tree helpers take it as a leaf; compares equal to
    the tuple of its entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Entry):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec shards over."""
        out = []
        for e in self.entries:
            if e is not None:
                out += [e] if isinstance(e, str) else list(e)
        return tuple(out)


P = PartitionSpec


# logical axes used by the schemas:
#   vocab, embed, embed_v (norm vectors), qheads, kvheads, ffn,
#   expert_shard, experts_v, ssm_in, ssm_conv, ssm_inner, ssm_heads, layers
def make_rules(fsdp: bool) -> Dict[str, Optional[str]]:
    return {
        "vocab": "model",
        "embed": "data" if fsdp else None,
        "embed_v": None,
        "qheads": "model",
        "kvheads": "model",
        "ffn": "model",
        "expert_shard": "model",
        "experts_v": None,
        "ssm_in": "model",
        "ssm_conv": "model",
        "ssm_inner": "model",
        "ssm_heads": None,
        "layers": None,
    }


def decl_spec(decl: ParamDecl, rules: Dict[str, Optional[str]],
              axis_sizes: Dict[str, int]) -> PartitionSpec:
    axes = []
    used = set()
    for dim, logical in zip(decl.shape, decl.logical):
        ax = rules.get(logical) if logical is not None else None
        if ax is not None and (dim % axis_sizes.get(ax, 1) != 0
                               or ax in used):
            ax = None                  # non-divisible or repeated: replicate
        if ax is not None:
            used.add(ax)
        axes.append(ax)
    return P(*axes)


def _sizes(mesh) -> Dict[str, int]:
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def param_specs(schema: Tree, mesh, fsdp: bool) -> Tree:
    """The spec of every leaf of ``schema``; ``mesh`` is a ``Mesh`` or its
    axis sizes (a dict)."""
    rules, sizes = make_rules(fsdp), _sizes(mesh)
    return tree_map(lambda d: decl_spec(d, rules, sizes), schema)


def state_specs(cfg, ctx: AxisCtx, fsdp: bool = True) -> Dict:
    """The train state's specs (``repro.launch.train_step.state_specs``):
    AdamW's moments are cut as the parameters are."""
    from repro_torch.models import lm
    pspecs = param_specs(lm.model_schema(cfg, ctx), ctx.mesh, fsdp)
    return {"params": pspecs,
            "opt": {"m": pspecs, "v": pspecs, "count": P()},
            "step": P()}


# ---------------------------------------------------------------------------
# one rank's slice of a global array, and back
# ---------------------------------------------------------------------------


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _cut(mesh: Mesh, entry: Entry, coords=None) -> Tuple[int, int]:
    """(pieces, this rank's piece) of a dimension with spec ``entry``."""
    co = mesh.coords if coords is None else coords
    n, i = 1, 0
    for a in _entry_axes(entry):
        n, i = n * mesh.shape[a], i * mesh.shape[a] + co[a]
    return n, i


def shard_leaf(full: torch.Tensor, spec: PartitionSpec,
               mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``full``; a leaf no dimension of which is cut
    is returned as it is."""
    t = full
    for dim, entry in enumerate(spec):
        n, i = _cut(mesh, entry)
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(full.shape)} does "
                                 f"not split {n} ways (spec {spec})")
            size = t.shape[dim] // n
            t = t.narrow(dim, i * size, size)
    return t if t is full else t.clone(memory_format=torch.contiguous_format)


def gather_leaf(local: torch.Tensor, spec: PartitionSpec,
                mesh: Mesh) -> torch.Tensor:
    """The global array from every rank's slice: collective over the ranks
    that hold the pieces (every rank calls it)."""
    axes = spec.axes()
    if not axes or all(mesh.shape[a] == 1 for a in axes):
        return local
    group = mesh.group(axes)
    CL.check_device("gather_leaf", group, local)
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(group.size)]
    dist.all_gather(parts, local, group=group.pg)
    shape = [s * _cut(mesh, e)[0] for s, e in zip(local.shape, spec)]
    out = local.new_empty(shape)
    for rank, part in zip(group.ranks, parts):
        co = mesh.coords_of(rank)
        idx = []
        for s, e in zip(local.shape, spec):
            i = _cut(mesh, e, co)[1]
            idx.append(slice(i * s, (i + 1) * s))
        out[tuple(idx)] = part
    return out


def _spec_at(specs: Tree, path) -> PartitionSpec:
    for k in path:
        specs = specs[k]
    return specs


def shard_params(full: Tree, specs: Tree, mesh: Mesh) -> Tree:
    return tree_map_path(lambda path, t: shard_leaf(
        t, _spec_at(specs, path), mesh), full)


def gather_params(local: Tree, specs: Tree, mesh: Mesh) -> Tree:
    """Collective: every rank calls it and gets the whole tree."""
    return tree_map_path(lambda path, t: gather_leaf(
        t, _spec_at(specs, path), mesh), local)


def _expert_trees(params: Tree):
    """The expert dicts of every MoE layer position."""
    return [lp["moe"]["experts"] for lp in params["layers"]
            if "moe" in lp]


def pack_params(params: Tree, ctx: AxisCtx) -> Tree:
    """The one-rank tree (stacked experts (n_periods, 1, E, ...)) as the
    mesh's global tree (n_periods, W, E_loc, ...), the other leaves as
    they are (``pack_expert_weights`` on every MoE layer position). On a
    model axis of one rank the two layouts are one: the tree is returned
    as it is, with no copy of the experts."""
    if ctx.ep * ctx.etp == 1:
        return params
    out = tree_map(lambda t: t, params)
    for ew in _expert_trees(out):
        packed = pack_expert_weights({k: v[:, 0] for k, v in ew.items()},
                                     ctx.ep, ctx.etp)
        ew.update(packed)
    return out


def unpack_params(params: Tree, ctx: AxisCtx) -> Tree:
    """The inverse of ``pack_params``."""
    if ctx.ep * ctx.etp == 1:
        return params
    out = tree_map(lambda t: t, params)
    for ew in _expert_trees(out):
        full = unpack_expert_weights(ew, ctx.ep, ctx.etp)
        ew.update({k: v[:, None] for k, v in full.items()})
    return out


def to_mesh(params: Tree, cfg, ctx: AxisCtx, fsdp: bool = True) -> Tree:
    """This rank's shard of the mesh tree, from the one-rank tree (or an
    optimizer moment tree of the same layout)."""
    specs = state_specs(cfg, ctx, fsdp)["params"]
    return shard_params(pack_params(params, ctx), specs, ctx.mesh)


def from_mesh(local: Tree, cfg, ctx: AxisCtx, fsdp: bool = True) -> Tree:
    """The one-rank tree from every rank's shard (collective)."""
    specs = state_specs(cfg, ctx, fsdp)["params"]
    return unpack_params(gather_params(local, specs, ctx.mesh), ctx)


def gather_state(state: Dict, cfg, ctx: AxisCtx, fsdp: bool = True) -> Dict:
    """The train state in the one-rank layout, from every rank's shard
    (collective): parameters and AdamW moments gathered whole."""
    opt = state["opt"]
    return {"params": from_mesh(state["params"], cfg, ctx, fsdp),
            "opt": {"m": from_mesh(opt["m"], cfg, ctx, fsdp),
                    "v": from_mesh(opt["v"], cfg, ctx, fsdp),
                    "count": opt["count"]},
            "step": state["step"]}


def shard_state(state: Dict, cfg, ctx: AxisCtx, fsdp: bool = True) -> Dict:
    """This rank's shard of a train state in the one-rank layout."""
    opt = state["opt"]
    return {"params": to_mesh(state["params"], cfg, ctx, fsdp),
            "opt": {"m": to_mesh(opt["m"], cfg, ctx, fsdp),
                    "v": to_mesh(opt["v"], cfg, ctx, fsdp),
                    "count": opt["count"]},
            "step": state["step"]}


def fsdp_gather_tree(tree: Tree, specs: Tree, ctx: AxisCtx,
                     drop: int = 0) -> Tree:
    """Every leaf stored sharded over a data axis, gathered whole on that
    dimension (``collectives.fsdp_gather``: its gradient is reduce-
    scattered). ``drop`` leading spec entries are skipped (1 for one
    period's slice of the stacked layer leaves)."""
    def one(path, t):
        for dim, entry in enumerate(_spec_at(specs, path)[drop:]):
            axes = tuple(a for a in _entry_axes(entry)
                         if a != ctx.model_axis)
            if axes:
                t = CL.fsdp_gather(t, ctx.mesh.group(axes), dim)
        return t
    return tree_map_path(one, tree)


def replicas(spec: PartitionSpec, mesh: Mesh) -> int:
    """How many ranks hold each slice of a leaf with ``spec``."""
    return math.prod(mesh.shape.values()) // math.prod(
        mesh.shape[a] for a in spec.axes())


def make_ctx(cfg, mesh: Optional[Mesh], seq_shard: bool = True) -> AxisCtx:
    if mesh is None:
        return AxisCtx()
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    msize = mesh.shape.get("model", 1)
    ep = etp = 1
    if cfg.moe is not None:
        ep, etp = choose_ep(cfg.moe.num_experts, msize, cfg.moe.ep)
        # d_expert must divide over etp too
        while etp > 1 and cfg.moe.d_expert % etp:
            etp //= 2
            ep = msize // etp
        if cfg.moe.num_experts % ep:
            raise ValueError(f"no valid (ep, etp) for "
                             f"E={cfg.moe.num_experts} on model axis {msize}")
    else:
        ep, etp = msize, 1
    return AxisCtx(mesh=mesh, dp_axes=dp_axes, model_axis="model",
                   ep=ep, etp=etp, seq_shard=seq_shard)


# ---------------------------------------------------------------------------
# the decode cache on a mesh
# ---------------------------------------------------------------------------


def slots_cut(ctx: AxisCtx, batch: int) -> bool:
    """Whether ``batch`` decode slots split over the data axes: more than
    one slot, and dp divides them (``repro/parallel/sharding.py:85``)."""
    return (ctx is not None and ctx.active and ctx.dp_size > 1
            and batch > 1 and batch % ctx.dp_size == 0)


def kv_cut(ctx: AxisCtx, n_kv_heads: int, seq_len: int,
           paged: bool = False) -> str:
    """How a K/V cache entry is cut over the model axis, the one place the
    choice is made (``kv_spec``, ``repro/parallel/sharding.py:88-93``, and
    the arms of ``sharded_decode_attention``): "kv_group" when the model
    axis divides the kv heads, else "split_kv" when it divides the
    positions, else "replicated" (also on a model axis of one rank). An
    encoder-decoder's "xk"/"xv" take it of their ``enc_len`` rows (the
    decode's cross-attention arms, ``blocks.decode_layer``). A
    ``paged`` pool is never "split_kv": its pages interleave positions
    (``paged_cache_specs``, ``repro/parallel/sharding.py:119-146``)."""
    m = ctx.model_size if ctx is not None and ctx.active else 1
    if m == 1:
        return "replicated"
    if n_kv_heads % m == 0:
        return "kv_group"
    if seq_len % m == 0 and not paged:
        return "split_kv"
    return "replicated"


def cache_specs(cfg, ctx: AxisCtx, batch: int, seq_len: int,
                enc_len: int = 0) -> Tuple:
    """The spec of every entry of ``lm.init_cache``'s tree, a tuple over
    period positions (``repro/parallel/sharding.py:79-116``): the leading
    (n_periods,) axis whole, the slots over the dp axes (``slots_cut``),
    K/V (.., B, S, Hkv, hd) over the model axis as ``kv_cut`` says; an
    encoder-decoder's encoder K/V "xk"/"xv" (.., B, enc_len, Hkv, hd) as
    ``kv_cut`` says of ``enc_len`` rows, a cut of their own.

    The SSM entries, conv (.., B, W-1, C) and state (.., B, nh, ds, hd),
    are cut over the dp slots only. The JAX package also cuts the conv
    channels and the state heads over the model axis; the port's Mamba
    block runs whole on every model rank (``ssm.whole_params``), so each
    model rank keeps its slots' whole carry, and no collective enters the
    SSM's serving steps."""
    from repro_torch.models.lm import period_of
    dp = ctx.dp_axes if len(ctx.dp_axes) != 1 else ctx.dp_axes[0]
    b = dp if slots_cut(ctx, batch) else None

    def kv_spec(n: int) -> PartitionSpec:
        cut = kv_cut(ctx, cfg.attn.n_kv_heads, n)
        return P(None, b, "model" if cut == "split_kv" else None,
                 "model" if cut == "kv_group" else None, None)

    specs = []
    for pos in range(period_of(cfg)):
        if cfg.layer_kind(pos) == "a":
            kv = kv_spec(seq_len)
            e = {"k": kv, "v": kv}
            if cfg.n_enc_layers:
                x = kv_spec(enc_len)
                e.update(xk=x, xv=x)
            specs.append(e)
        else:
            specs.append({"conv": P(None, b, None, None),
                          "state": P(None, b, None, None, None)})
    return tuple(specs)


def prefill_cache_specs(cfg, ctx: AxisCtx, batch: int) -> Tuple:
    """The spec of every entry of the monolithic prefill's cache on a mesh
    (``lm.prefill(ctx=)``: (n_periods, B, S, ...) per period position),
    the layout ``serving.stitch_prefill_cache`` reads: ``cache_specs``'
    cut on every axis but the sequence. K/V and "xk"/"xv" are cut on
    their kv heads where the model axis divides them (the attention's
    ``heads`` case, whose ranks each project their own kv heads) and are
    whole on every model rank otherwise, where the decode cache may cut
    the positions (``split_kv``): a prompt of S positions cut S/m ways
    would not line up with a decode cache's cut of its own length, so
    each rank keeps every position and the stitch takes the rows its
    decode slice holds. The rows are cut over dp as the decode cache's
    slots of the same count; the SSM entries as ``cache_specs`` cuts
    them."""
    # at a length of 1 no model axis of more than one rank divides the
    # positions: every K/V entry is cut on its heads or whole
    return cache_specs(cfg, ctx, batch, 1, 1)


def paged_cache_specs(cfg, ctx: AxisCtx, n_slots: int) -> Tuple:
    """The spec of every entry of ``lm.init_paged_cache``'s tree
    (``repro/parallel/sharding.py:119-146``): a K/V page pool (..,
    n_pages, page, Hkv, hd) cut on its kv heads where ``kv_cut`` says so,
    its pages whole (one pool over the dp axes, as in the JAX package);
    the SSM entries as ``cache_specs`` cuts them (the dp slots only)."""
    from repro_torch.models.lm import period_of
    dense = cache_specs(cfg, ctx, n_slots, 1)
    specs = []
    for pos in range(period_of(cfg)):
        if cfg.layer_kind(pos) == "a":
            cut = kv_cut(ctx, cfg.attn.n_kv_heads, 0, paged=True)
            kv = P(None, None, None, "model" if cut == "kv_group" else None,
                   None)
            specs.append({"k": kv, "v": kv})
        else:
            specs.append(dense[pos])
    return tuple(specs)


def local_shape(shape, spec: PartitionSpec, mesh: Mesh) -> Tuple[int, ...]:
    """This rank's shape of a global ``shape`` cut as ``spec`` says."""
    return tuple(n // _cut(mesh, e)[0] for n, e in zip(shape, spec))


def _dp_index(ctx: AxisCtx, dp_axes, coords=None) -> int:
    """Row-major index over ``dp_axes`` of this rank (or of ``coords``)."""
    co = ctx.mesh.coords if coords is None else coords
    i = 0
    for a in dp_axes:
        i = i * ctx.mesh.shape[a] + co[a]
    return i


def shard_tokens(ctx: AxisCtx, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, AxisCtx]:
    """(this rank's tokens of the global (B, S, ...) batch x, the context
    that says how they were cut). B splits over the dp axes when it
    divides, S over the model axis under sequence sharding when it
    divides (``moe_layer.resolve_token_sharding``)."""
    B, S = x.shape[0], x.shape[1]
    seq_sharded, dp_axes = resolve_token_sharding(ctx, B, S)
    if dp_axes:
        b = B // ctx.dp_size
        x = x[_dp_index(ctx, dp_axes) * b:][:b]
    if seq_sharded:
        s = S // ctx.model_size
        x = x[:, ctx.model_rank * s:][:, :s]
    return x.contiguous(), dataclasses.replace(
        ctx, seq_shard=seq_sharded, dp_axes=dp_axes)


def shard_experts(ctx: AxisCtx, packed: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """This rank's entry (leading dim 1) of the packed (W, E_loc, ...)
    expert storage."""
    m = ctx.model_rank
    return {k: v[m:m + 1].clone() for k, v in packed.items()}


def gather_tokens(ctx: AxisCtx, y: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's share ``y``, cut as ``ctx`` (the
    context ``shard_tokens`` returned) says. Of the ranks that hold the
    same tokens, the one at coordinate 0 on the replicated axes gives
    them. Collective over every rank."""
    world = ctx.mesh.group(ctx.mesh.axis_names)
    parts = CL.all_gather(y, world)
    b, s = y.shape[0], y.shape[1]
    nb = ctx.dp_size if ctx.dp_axes else 1
    ns = ctx.model_size if ctx.seq_shard else 1
    out = y.new_empty((b * nb, s * ns) + tuple(y.shape[2:]))
    replicated = [a for a in ctx.mesh.axis_names if a not in ctx.dp_axes
                  and not (a == ctx.model_axis and ctx.seq_shard)]
    for rank, part in zip(world.ranks, parts):
        co = ctx.mesh.coords_of(rank)
        if any(co[a] for a in replicated):
            continue
        bi = _dp_index(ctx, ctx.dp_axes, co)
        si = co[ctx.model_axis] if ctx.seq_shard else 0
        out[bi * b:(bi + 1) * b, si * s:(si + 1) * s] = part
    return out


def gather_experts(ctx: AxisCtx, shard: torch.Tensor) -> torch.Tensor:
    """The packed (W, E_loc, ...) storage from every model rank's entry
    (leading dim 1). Collective over the model axis."""
    return CL.all_gather(shard[0], ctx.model_group)
