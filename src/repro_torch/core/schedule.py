"""Block-schedule IR: whole-graph overlap beyond one MoE layer (the port's
copy of ``repro.core.schedule``; pure Python, so both packages give the
same segments, orders and times).

Comet overlaps communication with computation inside one MoE layer; the
dispatch/combine rings still leave link-idle compute bubbles (and
compute-idle link bubbles) that only non-MoE work from adjacent blocks can
fill. This module is the IR that makes those moves legal and rankable:

* a model forward (and, in training, backward) is lowered to typed
  ``Segment``s (attn / norm / router / dispatch_hop / expert_gemm /
  combine_hop / wgrad_flush / ...), each pinned to a device resource
  ("compute", or one of the full-duplex link directions "link_in" /
  "link_out") with explicit dependencies;
* ``overlap_order`` is the scheduler: a greedy earliest-start list
  schedule over the dependency DAG that legally hoists the next block's
  attention/norm into the current block's ring bubbles and floats the
  previous layer's wgrad flush (the comet ring's hand-scheduled
  backward) into the backward ring's link windows;
* ``schedule_time`` evaluates any legal order on the three-resource
  machine model. ``layer_barriers=True`` models layer-at-a-time execution
  (overlap within a block, a barrier at every block boundary): the
  baseline the whole-graph figures difference against;
* ``exec_order`` applies the same scheduler to the executed segment list
  (``models/blocks.block_segments`` lowers each layer to ``ExecSeg``s):
  the reordering only permutes segment emission over identical dataflow,
  so scheduled execution computes what the sequential order computes.

Micro-slicing: ``attn_{i+1}`` truly depends on ``combine_i``, so with one
slice the forward has no legal cross-layer motion. Slicing the token dim
into ``n_slices`` independent strips creates it. Slicing is a cost-model
degree of freedom (the tuner's whole-graph candidates); the executed path
keeps full-width segments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Segment taxonomy
# ---------------------------------------------------------------------------

# forward segment kinds
SEGMENT_KINDS = (
    "norm",          # pre-attn / pre-mlp RMSNorm
    "attn",          # attention (qkvo + sdpa), incl. cross-attn
    "ssm",           # mamba mixer (hybrid blocks)
    "ffn",           # dense FFN (non-MoE blocks)
    "shared_ffn",    # MoE shared expert (reads the mid residual only)
    "residual",      # residual add + sharding constraint
    "router",        # top-k gate + dispatch-buffer build
    "dispatch_hop",  # one comet-ring dispatch ppermute      -> link_in
    "expert_gemm",   # one macro-step's fused expert MLP
    "combine_hop",   # one column-block's combine ppermute   -> link_out
    "moe",           # whole MoE layer as ONE segment (executed path)
    # backward-only kinds (training lowering)
    "attn_bwd",      # attention dgrad/wgrad
    "ring_bwd_gemm",  # one backward macro-step's dgrad/wgrad GEMMs
    "ring_bwd_hop",  # dY-in / dX-out reverse ppermute
    "wgrad_flush",   # fp32 dW accumulator flush (floats freely)
)

# which device resource each kind occupies; dispatch and combine ride
# opposite link DIRECTIONS (ICI is full duplex), which is exactly why the
# combine tail of block i can overlap the dispatch head of block i+1
RESOURCE_OF = {
    "norm": "compute", "attn": "compute", "ssm": "compute",
    "ffn": "compute", "shared_ffn": "compute", "residual": "compute",
    "router": "compute", "expert_gemm": "compute",
    "dispatch_hop": "link_in", "combine_hop": "link_out",
    "moe": "link",           # executed path: opaque, serializes on a link
    "attn_bwd": "compute", "ring_bwd_gemm": "compute",
    "ring_bwd_hop": "link_in",   # refined per-direction by the lowering
    "wgrad_flush": "compute",
}

# nominal costs used when ordering EXECUTED segments (no hardware model
# when the forward is built — only the relative shape matters: rings dominate, norms are
# cheap, so attention hoists into the MoE window)
NOMINAL_COST = {
    "norm": 0.1, "attn": 1.0, "ssm": 1.0, "ffn": 1.0, "shared_ffn": 1.0,
    "residual": 0.05, "router": 0.2, "moe": 4.0,
    "dispatch_hop": 0.5, "expert_gemm": 1.0, "combine_hop": 0.5,
    "attn_bwd": 2.0, "ring_bwd_gemm": 2.0, "ring_bwd_hop": 1.0,
    "wgrad_flush": 0.5,
}


@dataclasses.dataclass(frozen=True)
class Segment:
    """One schedulable unit. ``deps`` are sids of segments that must FINISH
    before this one starts; by construction deps < sid, so every
    ScheduleGraph is a DAG."""
    sid: int
    name: str
    kind: str
    block: int                   # owning block index (layer), -1 = global
    deps: Tuple[int, ...]
    cost_s: float
    resource: str
    slice_id: int = 0


class ScheduleGraph:
    """Append-only segment DAG over the block sequence."""

    def __init__(self):
        self.segments: List[Segment] = []

    def add(self, name: str, kind: str, block: int,
            deps: Iterable[int] = (), cost_s: float = 0.0,
            resource: Optional[str] = None, slice_id: int = 0) -> int:
        if kind not in SEGMENT_KINDS:
            raise ValueError(f"unknown segment kind {kind!r}")
        sid = len(self.segments)
        deps = tuple(sorted(set(int(d) for d in deps)))
        for d in deps:
            if not 0 <= d < sid:
                raise ValueError(
                    f"segment {name!r}: dep {d} must reference an earlier "
                    f"segment (sid {sid})")
        self.segments.append(Segment(
            sid=sid, name=name, kind=kind, block=block, deps=deps,
            cost_s=float(cost_s),
            resource=resource or RESOURCE_OF[kind], slice_id=slice_id))
        return sid

    def __len__(self):
        return len(self.segments)


# ---------------------------------------------------------------------------
# Orders
# ---------------------------------------------------------------------------


def sequential_order(g: ScheduleGraph) -> List[int]:
    """Program order — the layer-at-a-time baseline emission."""
    return list(range(len(g)))


def validate_order(g: ScheduleGraph, order: Sequence[int]) -> List[str]:
    """Legality check: ``order`` must be a permutation of all sids in which
    every segment appears after all of its dependencies. Returns a list of
    violation strings (empty = legal)."""
    errs: List[str] = []
    n = len(g)
    if sorted(order) != list(range(n)):
        errs.append(f"order is not a permutation of 0..{n - 1}")
        return errs
    pos = {sid: i for i, sid in enumerate(order)}
    for seg in g.segments:
        for d in seg.deps:
            if pos[d] >= pos[seg.sid]:
                errs.append(
                    f"{g.segments[d].name} (sid {d}) must precede "
                    f"{seg.name} (sid {seg.sid})")
    return errs


def overlap_order(g: ScheduleGraph) -> List[int]:
    """Greedy earliest-start list schedule.

    Repeatedly picks, among dependency-ready segments, the one that can
    START earliest on its resource given current resource-free times and
    dep finish times (ties broken by (block, sid) so the order is
    deterministic and biased toward program order). This is what hoists
    next-block attention into a ring's compute bubble: while the ring
    occupies link_in/link_out, the compute resource frees early and the
    only ready compute segment is the hoisted one."""
    n = len(g)
    finish: Dict[int, float] = {}
    free: Dict[str, float] = {}
    n_deps = [len(s.deps) for s in g.segments]
    dependents: List[List[int]] = [[] for _ in range(n)]
    for s in g.segments:
        for d in s.deps:
            dependents[d].append(s.sid)
    ready = [s.sid for s in g.segments if not s.deps]
    order: List[int] = []
    while ready:
        best = None
        for sid in ready:
            s = g.segments[sid]
            start = max([free.get(s.resource, 0.0)]
                        + [finish[d] for d in s.deps])
            key = (start, s.block, sid)
            if best is None or key < best[0]:
                best = (key, sid)
        (start, _, _), sid = best
        s = g.segments[sid]
        finish[sid] = start + s.cost_s
        free[s.resource] = finish[sid]
        order.append(sid)
        ready.remove(sid)
        for t in dependents[sid]:
            n_deps[t] -= 1
            if n_deps[t] == 0:
                ready.append(t)
    if len(order) != n:                      # unreachable for a valid DAG
        raise RuntimeError("overlap_order: dependency cycle")
    # greedy list scheduling admits anomalies (an early greedy pick can
    # delay the critical path); program order is always a legal schedule
    # too, so fall back to it when greedy evaluates worse — making
    # "scheduled never slower than sequential emission" an invariant, not
    # a hope
    seq = list(range(n))
    if (schedule_time(g, order)["total"]
            > schedule_time(g, seq)["total"]):
        return seq
    return order


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def schedule_time(g: ScheduleGraph, order: Sequence[int],
                  layer_barriers: bool = False) -> Dict[str, float]:
    """Evaluate an emission order on the three-resource machine.

    Segments issue IN ORDER per resource (an in-order queue per engine —
    a stream's in-order execution: reordering must happen at emission,
    the device won't do it for you); a segment starts at
    max(resource free, deps finish).

    ``layer_barriers=True`` models today's layer-at-a-time execution: when
    the emitted block id changes, all resources sync to the max finish so
    far — overlap lives within one block only. This is the honest
    per-layer-overlap baseline: without it, evaluating the sequential
    order would grant it the same cross-layer overlap the scheduler
    creates, and there would be nothing to difference."""
    errs = validate_order(g, order)
    if errs:
        raise ValueError("illegal order: " + "; ".join(errs[:3]))
    free: Dict[str, float] = {}
    finish: Dict[int, float] = {}
    busy: Dict[str, float] = {}
    cur_block = None
    total = 0.0
    for sid in order:
        s = g.segments[sid]
        if layer_barriers and s.block != cur_block and s.block >= 0:
            if cur_block is not None:
                for r in list(free):
                    free[r] = total
            cur_block = s.block
        start = max([free.get(s.resource, 0.0)]
                    + [finish[d] for d in s.deps])
        finish[sid] = start + s.cost_s
        free[s.resource] = finish[sid]
        busy[s.resource] = busy.get(s.resource, 0.0) + s.cost_s
        total = max(total, finish[sid])
    out = {"total": total}
    for r, b in busy.items():
        out[f"busy_{r}"] = b
        out[f"idle_{r}"] = total - b
    return out


# ---------------------------------------------------------------------------
# Executed path: order ExecSeg-like objects (models/blocks.py)
# ---------------------------------------------------------------------------


def exec_order(segs, mode: str = "overlap"):
    """Order executed segments. ``segs`` are duck-typed objects with
    ``.name`` (unique), ``.kind``, ``.block``, ``.reads`` / ``.writes``
    (value names). Dependencies are derived from dataflow: a segment
    depends on the LAST writer of each value it reads (and on the previous
    writer of any value it overwrites, so no reorder can clobber a live
    value). Returns the segments in the chosen emission order — a pure
    permutation over identical dataflow, hence numerically identical.

    mode: "sequential" keeps program order; "overlap" runs the greedy
    scheduler with nominal costs."""
    if mode not in ("sequential", "overlap"):
        raise ValueError(f"unknown schedule mode {mode!r}")
    if mode == "sequential":
        return list(segs)
    g = ScheduleGraph()
    writer: Dict[str, int] = {}
    readers: Dict[str, List[int]] = {}
    for e in segs:
        deps = set()
        for v in e.reads:
            if v in writer:
                deps.add(writer[v])
        for v in e.writes:
            # WAR + WAW: can't overwrite a value someone still needs
            if v in writer:
                deps.add(writer[v])
            deps.update(readers.get(v, ()))
        sid = g.add(e.name, e.kind, e.block, deps=deps,
                    cost_s=NOMINAL_COST.get(e.kind, 1.0))
        for v in e.reads:
            readers.setdefault(v, []).append(sid)
        for v in e.writes:
            writer[v] = sid
            readers[v] = []
    order = overlap_order(g)
    errs = validate_order(g, order)
    if errs:                                 # defensive: scheduler bug
        raise RuntimeError("exec_order produced an illegal order: "
                           + errs[0])
    segs = list(segs)
    return [segs[i] for i in order]


# ---------------------------------------------------------------------------
# Cost lowering: whole-graph model for the tuner / benchmarks
# ---------------------------------------------------------------------------


def comet_ring_counts(ep: int, ring_group: int, n_col_blocks: int) -> Dict:
    """Segment counts of one comet forward ring (must agree with
    core/transport.py's loop structure): ep//g macro-steps, each consuming
    g source chunks; dispatch moves ep-1 remote chunks; combine returns
    n_col column blocks per source chunk, ep-1 of them remote."""
    g = max(1, ring_group)
    n_steps = max(1, ep // g)
    return {
        "n_steps": n_steps,
        "dispatch_hops": max(0, ep - 1),
        "expert_gemms": n_steps,
        "combine_hops": max(1, n_col_blocks) * max(0, ep - 1),
    }


def lower_model_graph(hw, s, plan, *, d_model: int, n_blocks: int = 2,
                      n_slices: int = 1,
                      training: bool = False) -> ScheduleGraph:
    """Lower ``n_blocks`` identical transformer-MoE blocks under ``plan``
    to a ScheduleGraph with roofline segment costs (core/adaptive.py
    terms). Each block: norm+attn -> router -> comet ring (ring_group-
    aggregated macro-steps on compute, dispatch hops on link_in, combine
    hops on link_out) -> next block. ``n_slices`` micro-slices the token
    dim (Lancet): slices are independent strips, so slice j of block i+1
    can start once slice j of block i combines. ``training=True`` appends
    the reversed-block backward chain with FLOATING wgrad_flush segments
    (no dependents — the scheduler sinks them into link windows).

    Lump terms shared by every order (expert-weight reads, hidden-tensor
    HBM traffic, combine staging) are NOT segments — ``graph_step_time``
    adds them identically to baseline and scheduled totals."""
    from repro_torch.core import adaptive as A       # lazy: avoid import cycles
    from repro_torch.analysis import simulator as SIM

    lt = A.layer_times(hw, s)
    grp = max(1, plan.ring_group)
    n_col = max(1, plan.n_col_blocks)
    cnt = comet_ring_counts(s.ep, grp, n_col)
    n_steps = cnt["n_steps"]
    ns = max(1, n_slices)
    W = s.ep * s.etp
    t_attn = (SIM.attn_time(hw, d_model, max(1, s.M // W), 1) / ns
              + 2e-6)                         # + norm epsilon
    t_router = A.gemm_time(hw, max(1, s.M // ns), s.E, d_model)
    # per-slice ring costs: rows scale 1/ns, hop latency does not
    ss = dataclasses.replace(s, M=max(1, s.M // ns))
    lts = A.layer_times(hw, ss)
    # one macro-step consumes g source chunks; backend differences (fused
    # recompute vs hidden round trip) live in the lump terms, not here
    t_gemm = grp * lts["t_chunk_compute"]
    if plan.impl == "comet_hier":
        # topology-aware ring: macro-step m's dispatch wave sums its g
        # sub-step hops from the per-class profile (inter-node sub-steps
        # first, intra-node tail — core/adaptive.hier_step_order), so the
        # race detector and whole-graph scheduler see the SAME per-step
        # asymmetry the transport executes. The backward ring moves
        # native-width gradients: price its hops with the wire format off.
        hops = A.hop_time_profile(hw, ss, plan)
        hops_n = A.hop_time_profile(
            hw, ss, dataclasses.replace(plan, wire_dtype="fp32"))
        dhop = [sum(hops[m * grp + j] for j in range(grp))
                for m in range(n_steps)]
        bhop = [sum(hops_n[m * grp + j] for j in range(grp))
                for m in range(n_steps)]
    else:
        dhop = [grp * lts["t_hop"]] * n_steps  # g chunks per dispatch wave
        bhop = dhop

    g = ScheduleGraph()
    last_combine: Dict[int, int] = {}         # slice -> sid of final combine
    for i in range(n_blocks):
        for j in range(ns):
            dep = [last_combine[j]] if j in last_combine else []
            a = g.add(f"L{i}.s{j}.attn", "attn", i, deps=dep,
                      cost_s=t_attn, slice_id=j)
            r = g.add(f"L{i}.s{j}.router", "router", i, deps=[a],
                      cost_s=t_router, slice_id=j)
            prev_recv = r
            combine_done = r
            for m in range(n_steps):
                deps = [prev_recv]
                if m > 0:
                    d = g.add(f"L{i}.s{j}.disp{m}", "dispatch_hop", i,
                              deps=[r], cost_s=dhop[m], slice_id=j)
                    deps.append(d)
                e = g.add(f"L{i}.s{j}.gemm{m}", "expert_gemm", i,
                          deps=deps, cost_s=t_gemm, slice_id=j)
                prev_recv = e
                for b in range(n_col):
                    combine_done = g.add(
                        f"L{i}.s{j}.comb{m}.{b}", "combine_hop", i,
                        deps=[e], cost_s=dhop[m] / n_col, slice_id=j)
            last_combine[j] = combine_done
    if training:
        # backward of block i runs MoE-ring-bwd THEN attn_bwd (reverse of
        # the forward's attn -> moe); dY macro-chunks stream on link_in
        # while the dgrad/wgrad GEMMs run, dX returns on link_out — the
        # hand-scheduled comet ring's two comm streams
        t_abwd = 2.0 * t_attn
        t_bgemm = grp * (lts["t_bwd_gemm"]
                         + (lts["t_gemm1"]     # on-chip hidden recompute
                            if plan.gemm_impl == "pallas_fused" else 0.0))
        # (the bwd recompute is NOT in the lump terms — modeled_plan_time_bwd
        # charges it per chunk the same way, so keep it as segment cost)
        t_flush = A._dw_accum_time(hw, s, n_steps) / (n_steps * ns)
        prev_dx: Dict[int, int] = {}          # slice -> upstream grad sid
        for i in reversed(range(n_blocks)):
            for j in range(ns):
                up = [prev_dx[j]] if j in prev_dx else [last_combine[j]]
                prev_g = None
                dx = up[0]
                for m in range(n_steps):
                    h = g.add(f"L{i}.s{j}.dyhop{m}", "ring_bwd_hop", i,
                              deps=up, cost_s=bhop[m], resource="link_in",
                              slice_id=j)
                    deps = [h] if prev_g is None else [h, prev_g]
                    prev_g = g.add(f"L{i}.s{j}.bgemm{m}", "ring_bwd_gemm",
                                   i, deps=deps, cost_s=t_bgemm, slice_id=j)
                    dx = g.add(f"L{i}.s{j}.dxhop{m}", "ring_bwd_hop", i,
                               deps=[prev_g], cost_s=bhop[m],
                               resource="link_out", slice_id=j)
                    # the flush has NO dependents: it floats into whatever
                    # bubble the scheduler finds (the deferred dW)
                    g.add(f"L{i}.s{j}.flush{m}", "wgrad_flush", i,
                          deps=[prev_g], cost_s=t_flush, slice_id=j)
                prev_dx[j] = g.add(f"L{i}.s{j}.attn_bwd", "attn_bwd", i,
                                   deps=[dx, prev_g], cost_s=t_abwd,
                                   slice_id=j)
    return g


def graph_step_time(hw, s, plan, *, d_model: int, n_blocks: int = 2,
                    n_slices: int = 1, training: bool = False,
                    scheduled: bool = True) -> Dict[str, float]:
    """Whole-graph modeled time for ``n_blocks`` blocks under ``plan``.

    scheduled=False: sequential emission + per-block barriers (today's
    layer-at-a-time execution; overlap only within one block) and no
    micro-slicing. scheduled=True: the greedy whole-graph order with
    ``n_slices``. Lump HBM terms (expert-weight reads per macro-step,
    hidden-tensor traffic, combine staging; + bwd hidden and nothing else
    — dW flushes are already graph segments) are added identically to
    both, so the difference isolates the scheduling win. Slice
    co-scheduling keeps a macro-step's expert weights resident across
    slices, so weight reads are charged once per macro-step, not per
    slice."""
    from repro_torch.core import adaptive as A

    ns = max(1, n_slices) if scheduled else 1
    g = lower_model_graph(hw, s, plan, d_model=d_model, n_blocks=n_blocks,
                          n_slices=ns, training=training)
    if scheduled:
        order = overlap_order(g)
        t = schedule_time(g, order)
    else:
        t = schedule_time(g, sequential_order(g), layer_barriers=True)
    n_steps = max(1, s.ep // max(1, plan.ring_group))
    lump = n_blocks * (A._weight_read_time(hw, s, n_steps)
                       + A._hidden_traffic_time(hw, s, plan)
                       + A._combine_stage_time(hw, s, plan))
    if training:
        lump += n_blocks * (A._weight_read_time(hw, s, n_steps)
                            + A._bwd_hidden_time(hw, s, plan))
    out = dict(t)
    out["total"] = t["total"] + lump
    out["lump_s"] = lump
    out["n_slices"] = ns
    return out
