"""The schedule-IR race detector (the port's copy of
``repro.analysis.verify.schedule_check``).

The block-schedule IR (core/schedule.py) is only safe because every legal
emission order is a pure permutation over identical dataflow. This pass
re-establishes that claim INDEPENDENTLY: it never trusts the deps the
scheduler was handed (a lowering bug would poison both the order and the
check), but re-derives the hazard relation from first principles and then
checks any proposed order against it.

Two IR flavours, two derivations:

* **Executed segments** (``ExecSeg``, models/blocks.py) declare their
  dataflow as ``reads`` / ``writes`` value-name sets. The hazard relation
  (RAW / WAR / WAW) is recomputed here from those sets alone — a bug in
  ``exec_order``'s last-writer/reader bookkeeping cannot hide, because
  this module keeps its own.
* **Cost-IR segments** (``Segment``, ``lower_model_graph``) carry no
  read/write sets, but their names encode the comet-ring structure
  (``L{i}.s{j}.disp{m}`` / ``gemm{m}`` / ``comb{m}.{b}`` / ...). The
  checker re-derives the ring's precedence rules from that structure:
  recv-before-dependent-compute (every ``link_in`` hop lands before the
  GEMM that consumes it), send-after-produce, per-ring FIFO on each link
  direction (a ring's messages cannot overtake each other on one wire —
  the deadlock-freedom condition), completeness of every ring step, and
  floating ``wgrad_flush`` legality (after its producing GEMM, nothing
  ever depends on it).

``check_model_archs`` runs the standalone check over ``lower_model_graph``
outputs for every registered MoE arch (on ``h100_nvlink`` unless given a
preset; the port's default key); ``models/lm.forward_scheduled`` calls
``assert_exec_order_safe`` before every scheduled forward runs
(``REPRO_VERIFY_SCHEDULE=0`` opts out).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.verify.diagnostics import Diagnostic

_PASS = "schedule"


def _d(rule: str, loc: str, msg: str, hint: str = "",
       severity: str = "error") -> Diagnostic:
    return Diagnostic(_PASS, rule, severity, loc, msg, hint)


# ---------------------------------------------------------------------------
# Executed path: hazards from reads/writes
# ---------------------------------------------------------------------------


def derive_exec_hazards(segs: Sequence) -> List[Tuple[int, int, str, str]]:
    """Re-derive every RAW/WAR/WAW hazard edge from the segments' declared
    ``reads``/``writes`` (program order = list order). Returns
    ``(before, after, kind, value)`` index pairs: ``before`` must be
    emitted before ``after`` in ANY legal order."""
    edges: List[Tuple[int, int, str, str]] = []
    last_writer: Dict[str, int] = {}
    readers_since: Dict[str, List[int]] = {}
    for i, s in enumerate(segs):
        for v in s.reads:
            if v in last_writer:
                edges.append((last_writer[v], i, "RAW", v))
        for v in s.writes:
            if v in last_writer:
                edges.append((last_writer[v], i, "WAW", v))
            for r in readers_since.get(v, ()):
                if r != i:
                    edges.append((r, i, "WAR", v))
        for v in s.reads:
            readers_since.setdefault(v, []).append(i)
        for v in s.writes:
            last_writer[v] = i
            readers_since[v] = []
    return edges


def check_exec_order(program: Sequence, ordered: Sequence) -> List[Diagnostic]:
    """Check a proposed emission order of executed segments against the
    independently re-derived hazard relation. ``program`` is the segment
    list in program order, ``ordered`` the order to be emitted; segments
    are matched by their unique ``.name``."""
    diags: List[Diagnostic] = []
    names = [s.name for s in program]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        return [_d("duplicate-name", "exec:program",
                   f"segment names not unique: {dup[:3]}",
                   hint="namespace executed values/segments per block")]
    pos = {s.name: i for i, s in enumerate(ordered)}
    missing = [n for n in names if n not in pos]
    extra = [getattr(s, "name", "?") for s in ordered
             if getattr(s, "name", None) not in set(names)]
    if missing or extra or len(ordered) != len(program):
        diags.append(_d(
            "not-a-permutation", "exec:order",
            f"order is not a permutation of the program "
            f"(missing {missing[:3]}, extra {extra[:3]}, "
            f"{len(ordered)} vs {len(program)} segments)",
            hint="every program segment must be emitted exactly once"))
        return diags
    idx = {i: s.name for i, s in enumerate(program)}
    for before, after, kind, value in derive_exec_hazards(program):
        if pos[idx[before]] >= pos[idx[after]]:
            diags.append(_d(
                f"{kind.lower()}-hazard", f"exec:{idx[after]}",
                f"{kind} hazard on {value!r}: {idx[before]!r} must be "
                f"emitted before {idx[after]!r}, order has it after",
                hint="the scheduler may only permute within the hazard "
                     "partial order"))
    return diags


def assert_exec_order_safe(program: Sequence, ordered: Sequence):
    """Debug assertion used by models/lm.forward_scheduled: raise if the
    scheduler emitted a hazard-violating order."""
    diags = check_exec_order(program, ordered)
    if diags:
        raise RuntimeError(
            "scheduled emission violates re-derived dataflow hazards:\n"
            + "\n".join(str(d) for d in diags[:5]))


# ---------------------------------------------------------------------------
# Cost IR: structural re-derivation of the comet-ring rules
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(
    r"^L(?P<block>\d+)\.s(?P<slice>\d+)\."
    r"(?P<op>attn_bwd|attn|router|disp|gemm|comb|dyhop|bgemm|dxhop|flush)"
    r"(?P<m>\d+)?(?:\.(?P<b>\d+))?$")

# resource each structural op must occupy (deadlock-freedom starts with
# hops being on the link direction their peer expects)
_OP_RESOURCE = {
    "attn": "compute", "router": "compute", "gemm": "compute",
    "bgemm": "compute", "attn_bwd": "compute", "flush": "compute",
    "disp": "link_in", "dyhop": "link_in",
    "comb": "link_out", "dxhop": "link_out",
}


def _parse(name: str) -> Optional[Dict]:
    m = _NAME_RE.match(name)
    if not m:
        return None
    g = m.groupdict()
    return {"block": int(g["block"]), "slice": int(g["slice"]),
            "op": g["op"],
            "m": int(g["m"]) if g["m"] is not None else None,
            "b": int(g["b"]) if g["b"] is not None else None}


def check_graph_order(g, order: Sequence[int],
                      expect: Optional[Dict] = None) -> List[Diagnostic]:
    """Check a proposed order of a ``lower_model_graph`` ScheduleGraph.

    Everything is re-derived from segment NAMES and kinds — the declared
    ``deps`` are never consulted, so a lowering that dropped an edge and a
    scheduler that exploited the hole are both caught. ``expect`` may pin
    the ring geometry: ``{"n_steps": int, "n_col": int}`` (otherwise both
    are inferred from the observed indices, which still catches interior
    holes and ordering bugs, just not a uniformly truncated ring).
    """
    diags: List[Diagnostic] = []
    n = len(g.segments)
    if sorted(order) != list(range(n)):
        return [_d("not-a-permutation", "graph:order",
                   f"order is not a permutation of 0..{n - 1}")]
    pos = {sid: i for i, sid in enumerate(order)}

    # group parsed segments by (block, slice)
    rings: Dict[Tuple[int, int], Dict] = {}
    for s in g.segments:
        p = _parse(s.name)
        if p is None:
            diags.append(_d("unknown-segment", f"graph:{s.name}",
                            "segment name does not match the lowering's "
                            "naming scheme; structural checks skipped",
                            severity="warning"))
            continue
        want = _OP_RESOURCE[p["op"]]
        if s.resource != want:
            diags.append(_d(
                "wrong-resource", f"graph:{s.name}",
                f"{p['op']} segment on resource {s.resource!r}, expected "
                f"{want!r}",
                hint="dispatch/dY ride link_in, combine/dX ride link_out; "
                     "a hop on the wrong direction deadlocks its peer"))
        ring = rings.setdefault((p["block"], p["slice"]), {})
        ring.setdefault(p["op"], {})[(p["m"], p["b"])] = s.sid

    def before(a: int, b: int, rule: str, why: str, hint: str = ""):
        if pos[a] >= pos[b]:
            diags.append(_d(rule,
                            f"graph:{g.segments[b].name}",
                            f"{g.segments[a].name} must precede "
                            f"{g.segments[b].name}: {why}", hint))

    for (blk, sl), ring in sorted(rings.items()):
        loc = f"graph:L{blk}.s{sl}"
        gemms = ring.get("gemm", {})
        disps = ring.get("disp", {})
        combs = ring.get("comb", {})
        if not gemms:
            continue
        n_steps = (expect["n_steps"] if expect
                   else max(m for m, _ in gemms) + 1)
        n_col = (expect["n_col"] if expect
                 else (max(b for _, b in combs) + 1 if combs else 1))
        # ring completeness: every step's recv / compute / sends exist
        for m in range(n_steps):
            if (m, None) not in gemms:
                diags.append(_d("missing-segment", loc,
                                f"ring step {m} has no expert_gemm",
                                hint="lowering dropped a macro-step"))
            if m > 0 and (m, None) not in disps:
                diags.append(_d(
                    "missing-segment", loc,
                    f"ring step {m} has no dispatch hop: its GEMM would "
                    f"consume a chunk that never arrives",
                    hint="every remote macro-step needs its link_in recv"))
            for b in range(n_col):
                if (m, b) not in combs:
                    diags.append(_d(
                        "missing-segment", loc,
                        f"ring step {m} column block {b} has no combine "
                        f"hop: that output tile is never returned"))
        if "attn" in ring and "router" in ring and (0, None) in gemms:
            a = ring["attn"][(None, None)]
            r = ring["router"][(None, None)]
            before(a, r, "raw-hazard", "router reads attention output")
            before(r, gemms[(0, None)], "raw-hazard",
                   "the first macro-step consumes the local dispatch "
                   "buffer the router built")
        for m in range(n_steps):
            if (m, None) not in gemms:
                continue
            e = gemms[(m, None)]
            if m > 0 and (m, None) in disps:
                before(disps[(m, None)], e, "recv-before-compute",
                       f"GEMM {m} consumes the chunk dispatch hop {m} "
                       f"delivers",
                       hint="a compute issued before its recv deadlocks "
                            "the in-order queues")
            if m > 0 and (m - 1, None) in gemms:
                before(gemms[(m - 1, None)], e, "ring-order",
                       "macro-steps share the compute resource in ring "
                       "order")
            for b in range(n_col):
                if (m, b) in combs:
                    before(e, combs[(m, b)], "send-after-produce",
                           f"combine {m}.{b} returns a column block GEMM "
                           f"{m} produces")
        # the TRUE cross-layer dependency: attn of block i+1 (slice j)
        # waits for the LAST combine of block i in the same slice
        prev_ring = rings.get((blk - 1, sl))
        if prev_ring and "attn" in ring:
            a = ring["attn"][(None, None)]
            for (m, b), sid in prev_ring.get("comb", {}).items():
                before(sid, a, "raw-hazard",
                       f"block {blk} attention reads block {blk - 1}'s "
                       f"combined output (slice {sl})")
        # per-link FIFO: one ring's messages cannot overtake on one wire
        for opname, hops in (("disp", disps), ("comb", combs)):
            def step_span(mm):
                ps = [pos[sid] for (m, b), sid in hops.items() if m == mm]
                return (min(ps), max(ps)) if ps else None
            spans = [(mm, step_span(mm)) for mm in range(n_steps)]
            prev = None
            for mm, span in spans:
                if span is None:
                    continue
                if prev is not None and span[0] <= prev[1][1]:
                    diags.append(_d(
                        "link-fifo", loc,
                        f"{opname} hops of step {mm} emitted before step "
                        f"{prev[0]} finished its sends: ring messages "
                        f"would overtake on one wire",
                        hint="FIFO per (ring, direction) is the deadlock-"
                             "freedom condition"))
                prev = (mm, span)
        # backward chain (training lowerings)
        dyh = ring.get("dyhop", {})
        bgs = ring.get("bgemm", {})
        dxh = ring.get("dxhop", {})
        fls = ring.get("flush", {})
        for m in range(max((m for m, _ in bgs), default=-1) + 1):
            if (m, None) not in bgs:
                diags.append(_d("missing-segment", loc,
                                f"backward step {m} has no ring_bwd_gemm"))
                continue
            bg = bgs[(m, None)]
            if (m, None) in dyh:
                before(dyh[(m, None)], bg, "recv-before-compute",
                       f"bgemm {m} consumes the dY chunk dyhop {m} "
                       f"delivers")
            else:
                diags.append(_d("missing-segment", loc,
                                f"backward step {m} has no dY hop"))
            if (m, None) in dxh:
                before(bg, dxh[(m, None)], "send-after-produce",
                       f"dxhop {m} returns the dX chunk bgemm {m} "
                       f"produces")
            else:
                diags.append(_d("missing-segment", loc,
                                f"backward step {m} has no dX hop"))
            if (m, None) in fls:
                before(bg, fls[(m, None)], "flush-before-producer",
                       f"wgrad flush {m} drains the fp32 accumulator "
                       f"bgemm {m} fills")
            if m > 0 and (m - 1, None) in bgs:
                before(bgs[(m - 1, None)], bg, "ring-order",
                       "backward macro-steps run in ring order")

    # floating wgrad_flush legality: NOTHING may depend on a flush — the
    # whole point is that the scheduler can sink it into any later bubble
    flush_sids = {s.sid for s in g.segments if s.kind == "wgrad_flush"}
    if flush_sids:
        for s in g.segments:
            bad = flush_sids.intersection(s.deps)
            if bad:
                diags.append(_d(
                    "flush-has-dependent", f"graph:{s.name}",
                    f"{s.name} depends on wgrad_flush sid(s) "
                    f"{sorted(bad)}: flushes must float freely",
                    hint="read the dW accumulator via the optimizer "
                         "step, not a graph edge"))
    return diags


def check_lowered(hw, s, plan, *, d_model: int, n_blocks: int = 2,
                  n_slices: int = 1, training: bool = False
                  ) -> List[Diagnostic]:
    """Lower one model graph, schedule it, and run the structural check
    with the ring geometry pinned from (s, plan)."""
    from repro_torch.core.schedule import (comet_ring_counts, lower_model_graph,
                                     overlap_order)
    g = lower_model_graph(hw, s, plan, d_model=d_model, n_blocks=n_blocks,
                          n_slices=n_slices, training=training)
    cnt = comet_ring_counts(s.ep, max(1, plan.ring_group),
                            max(1, plan.n_col_blocks))
    expect = {"n_steps": cnt["n_steps"],
              "n_col": max(1, plan.n_col_blocks)}
    return check_graph_order(g, overlap_order(g), expect=expect)


def check_model_archs(hw=None, tokens: int = 4096) -> List[Diagnostic]:
    """Standalone pass: lower + schedule + check every registered MoE arch
    (fwd and fwd+bwd, sliced and unsliced). Dense/SSM archs have no comet
    ring to lower and are skipped."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.core import adaptive as A

    hw = hw or A.H100_NVL
    diags: List[Diagnostic] = []
    for name in list_archs():
        cfg = get_config(name)
        if cfg.moe is None:
            continue
        ep = min(8, cfg.moe.num_experts)
        s = A.plan_shape(cfg.moe, cfg.d_model, tokens, ep, 1)
        plans = [A.legalize_plan(
            A.Plan("comet", ring_group=2, n_col_blocks=4,
                   gemm_impl="pallas_fused", fused_combine=True),
            s.N, s.ep)]
        # the hierarchical ring lowers to the same segment graph with
        # per-class hop costs — sweep it on the asymmetric preset so the
        # race detector covers comet_hier's schedules too
        plans.append(A.legalize_plan(
            A.Plan("comet_hier", ring_group=2, n_col_blocks=4,
                   gemm_impl="pallas_fused", fused_combine=True,
                   intra_group=4, wire_dtype="bf16"),
            s.N, s.ep))
        hw_for = {"comet_hier": A.H100_CROSSNODE}
        for plan in plans:
            for training in (False, True):
                for ns in (1, 2):
                    for d in check_lowered(hw_for.get(plan.impl, hw), s,
                                           plan, d_model=cfg.d_model,
                                           n_blocks=2, n_slices=ns,
                                           training=training):
                        diags.append(Diagnostic(
                            d.passname, d.rule, d.severity,
                            f"{name}[{plan.impl},ns={ns},"
                            f"bwd={int(training)}]:{d.location}",
                            d.message, d.hint))
    return diags
