"""Adaptive workload assignment (paper §3.2.2): the cost model, the plan
cache and the tuner (``repro.core.adaptive``).

The paper balances communication against computation by moving SMs
between thread-block roles. The knob both packages keep is the pipeline
geometry of one MoE layer, a ``Plan``: the transport (naive, coarse,
comet, comet_hier, bcast), ``ring_group`` (source chunks fused per
GroupGEMM macro-step), ``n_col_blocks`` (the layer-1 N-decomposition), the
GroupGEMM backend (``xla`` = torch.bmm, ``pallas`` = the grouped-GEMM
kernel, ``pallas_fused`` = the fused expert-MLP kernels) and the streaming
combine.

Two layers, as in the paper:
1. an analytical model (roofline arithmetic from the ``Hardware`` presets
   and the discrete-event simulator, ``analysis/simulator.py``) ranks the
   candidates where nothing is timed;
2. a plan cache (JSON, the same format and keys as the JAX package's, so a
   file written by either package resolves the same plans in the other)
   holds the winners, keyed by (hw, M, N, K, E, topk, ep, etp[, phase]);
   ``make_timing_measure`` times the port's ``moe_ffn`` on the card (CUDA
   events) to fill it with measured winners.

The presets keep the JAX package's names and values. The port's default
hardware key is ``h100_nvlink`` (the JAX package's is ``tpu_v5e``): it is
the card the port runs on. The whole-graph terms (``ring_bubble_time``,
``cross_layer_fill_time``, ``modeled_graph_step_time``) price the
block-schedule IR of ``core/schedule.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Hardware models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    flops: float                 # peak dense bf16 FLOP/s per chip
    hbm_bw: float                # bytes/s
    link_bw: float               # bytes/s per interconnect link/direction
    links: int = 1               # usable links per chip for the ring
    gemm_eff: float = 0.7        # sustained fraction of peak for big GEMMs
    small_tile_penalty: float = 0.55   # efficiency when M-tile < 128 rows
    # per-core VMEM budget for a Pallas kernel's working set: the TPU
    # gate of candidate_plans (analysis/kernel_check.plan_vmem_ok); a GPU
    # preset is gated on the port's kernel instead, and 0 turns either off
    vmem_bytes: int = 32 * 2**20
    # --- topology descriptor (two link classes) -----------------------
    # A flat fabric leaves these at their defaults: intra_bw/inter_bw of
    # 0.0 mean "same as link_bw", intra_group=1 means every hop is
    # inter-class. An asymmetric preset sets link_bw = inter_bw so every
    # FLAT transport (whose ppermutes always span node boundaries)
    # automatically prices at the slow class with no code changes.
    intra_bw: float = 0.0        # bytes/s within a node (NVLink/ICI pod)
    inter_bw: float = 0.0        # bytes/s across nodes (RDMA/DCN)
    intra_group: int = 1         # devices per node on the EP axis
    # fixed software/DMA-setup latency per fine-grained transfer: this is
    # what makes the optimal decomposition COARSER at small M and FINER at
    # large M (the paper's Fig. 8 shift of the optimal division point)
    hop_latency_s: float = 5e-6


TPU_V5E = Hardware("tpu_v5e", flops=197e12, hbm_bw=819e9, link_bw=50e9,
                   links=2)
H100_NVL = Hardware("h100_nvlink", flops=990e12, hbm_bw=3.35e12,
                    link_bw=377e9, links=1, gemm_eff=0.65)
L20_PCIE = Hardware("l20_pcie", flops=119e12, hbm_bw=864e9, link_bw=25e9,
                    links=1, gemm_eff=0.6)
# asymmetric topology: 4-GPU NVLink nodes joined by RDMA — the regime
# MoNTA/MegaScale-MoE target. link_bw == inter_bw so every flat transport
# prices at the slow class (its ppermutes always have a cross-node pair).
H100_CROSSNODE = Hardware("h100_crossnode", flops=990e12, hbm_bw=3.35e12,
                          link_bw=50e9, links=1, gemm_eff=0.65,
                          intra_bw=377e9, inter_bw=50e9, intra_group=4)

HW = {h.name: h for h in (TPU_V5E, H100_NVL, L20_PCIE, H100_CROSSNODE)}


# ---------------------------------------------------------------------------
# Analytical cost terms for one MoE layer (per device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEShape:
    M: int          # tokens on this device's group before dispatch
    N: int          # d_model
    K: int          # d_expert (per-device after ETP split)
    E: int          # global experts
    topk: int
    ep: int
    etp: int
    glu: bool = True
    bytes_per_elt: int = 2


# wire formats for the hierarchical transport's dispatch payloads and
# per-column-block combine partials. "fp32" is the identity format (native
# payload dtype on the wire; the name records the dequant/accum width);
# "bf16" is a plain cast; "fp8_e4m3" is per-chunk symmetric-scale
# quantization (optim/compression.py's scale machinery at fp8 range).
WIRE_DTYPES = ("fp32", "bf16", "fp8_e4m3")

# bytes/element on the wire; None = the payload's native width
_WIRE_BYTES = {"fp32": None, "bf16": 2, "fp8_e4m3": 1}


def wire_bytes_per_elt(s: "MoEShape", wire_dtype: str) -> float:
    b = _WIRE_BYTES.get(wire_dtype)
    return float(s.bytes_per_elt if b is None else b)


def wire_dtype_supported(wire_dtype: str) -> bool:
    """Whether this torch can carry ``wire_dtype`` (fp8 needs
    ``torch.float8_e4m3fn``); the transports and the candidate stream
    both ask it."""
    return wire_dtype in WIRE_DTYPES and (
        wire_dtype != "fp8_e4m3" or hasattr(torch, "float8_e4m3fn"))


def gemm_time(hw: Hardware, rows: int, n: int, k: int, n_mats: int = 1) -> float:
    """Time for rows×k @ k×n (n_mats of them), with small-tile derating."""
    eff = hw.gemm_eff if rows >= 128 else hw.gemm_eff * hw.small_tile_penalty
    return n_mats * 2.0 * rows * n * k / (hw.flops * eff)


def layer_times(hw: Hardware, s: MoEShape) -> Dict[str, float]:
    """Per-chunk / per-hop costs for the comet schedule (fwd and bwd)."""
    rows_per_chunk = s.M * s.topk / s.ep          # expert rows from one source group
    n_l0 = 2 if s.glu else 1                       # gate+up vs up
    t_gemm1 = gemm_time(hw, rows_per_chunk, s.K, s.N, n_l0)
    t_gemm2 = gemm_time(hw, rows_per_chunk, s.N, s.K)
    chunk_bytes = rows_per_chunk * s.N * s.bytes_per_elt
    t_hop = hw.hop_latency_s + chunk_bytes / (hw.link_bw * hw.links)
    # backward per-chunk GEMM work: dgrad (dh = dY·w_downᵀ, dX = dh·w_l0ᵀ)
    # + wgrad (dw_down = hᵀ·dY, dw_l0 = xᵀ·dh) ≈ 2× forward. The fused
    # backend's in-VMEM hidden recompute is an extra t_gemm1 charged where
    # the backend is known (unfused backends save the pre-activations).
    t_bwd_gemm = 2.0 * (t_gemm1 + t_gemm2)
    return {
        "t_gemm1": t_gemm1, "t_gemm2": t_gemm2,
        "t_chunk_compute": t_gemm1 + t_gemm2,
        "t_hop": t_hop,
        "dispatch_balance": t_hop / max(t_gemm1 + t_gemm2, 1e-12),
        "t_bwd_gemm": t_bwd_gemm,
        # reverse-hop balance: each backward chunk moves dY in AND dX out
        "bwd_balance": 2.0 * t_hop / max(t_bwd_gemm, 1e-12),
    }


# ---------------------------------------------------------------------------
# Knob legalization — the ONE place transport geometry is made legal. Both
# the tuner (before ranking/persisting) and the transports (at trace time)
# use these, so the cost model, hot_path_hbm_bytes and execution can never
# disagree about the knobs that actually run.
# ---------------------------------------------------------------------------

MAX_COL_BLOCKS = 8


def legalize_n_col(d_model: int, n_col: int,
                   max_blocks: int = MAX_COL_BLOCKS) -> int:
    """Largest legal layer-1 column split ≤ the requested one: clamped to
    [1, max_blocks] and decremented until it divides d_model."""
    n = max(1, min(int(n_col), max_blocks))
    while d_model % n:
        n -= 1
    return n


def legalize_ring_group(ep: int, ring_group: int) -> int:
    """Largest legal macro-step fusion ≤ the requested one: clamped to
    [1, ep] and decremented until it divides ep."""
    ep = max(1, ep)
    g = max(1, min(int(ring_group), ep))
    while ep % g:
        g -= 1
    return g


def legalize_intra_group(ep: int, intra_group: int) -> int:
    """Largest legal node size ≤ the requested one: clamped to [1, ep] and
    decremented until it divides ep. Shared by the tuner, the cost model
    and transport_comet_hier (same convention as legalize_ring_group)."""
    ep = max(1, ep)
    ig = max(1, min(int(intra_group), ep))
    while ep % ig:
        ig -= 1
    return ig


def legalize_plan(plan: "Plan", d_model: int, ep: int) -> "Plan":
    """Return ``plan`` with executable knobs — what transport_comet_blocks
    / transport_comet_hier will actually run for this (d_model, ep).
    ``intra_group`` is a hier-only knob: hier plans get it legalized
    against ep, every other transport normalizes it to 1."""
    n = legalize_n_col(d_model, plan.n_col_blocks)
    g = legalize_ring_group(ep, plan.ring_group)
    ig = (legalize_intra_group(ep, plan.intra_group)
          if plan.impl == "comet_hier" else 1)
    if (n, g, ig) == (plan.n_col_blocks, plan.ring_group, plan.intra_group):
        return plan
    return dataclasses.replace(plan, n_col_blocks=n, ring_group=g,
                               intra_group=ig)


def choose_n_col(hw: Hardware, s: MoEShape, max_blocks: int = 8,
                 align: int = 128) -> int:
    """Pick the layer-1 N-decomposition: the finest column split whose
    per-block GEMM still runs at full tile efficiency (block ≥ align cols)
    and whose per-block return-hop stays ≤ per-block compute (no comm-bound
    tail). Mirrors the paper's observation that the optimal n_c grows with M
    and with communication burden (lower TP / higher bandwidth need)."""
    best = 1
    for n_col in range(1, max_blocks + 1):
        blk = s.N // n_col
        if blk < align or s.N % n_col:
            continue
        rows = s.M * s.topk / s.ep
        t_blk_gemm = gemm_time(hw, rows, blk, s.K)
        t_blk_hop = (hw.hop_latency_s
                     + rows * blk * s.bytes_per_elt / (hw.link_bw * hw.links))
        if t_blk_hop <= t_blk_gemm * 1.05:
            best = n_col
    return best


# ---------------------------------------------------------------------------
# Profile cache (the paper's pre-compiled kernel metadata analogue)
# ---------------------------------------------------------------------------


class AdaptiveCache:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.table: Dict[str, Dict] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self.table = json.load(f)

    @staticmethod
    def key(s: MoEShape, hw: Hardware, phase: str = "train") -> str:
        base = (f"{hw.name}:M{s.M}:N{s.N}:K{s.K}:E{s.E}:k{s.topk}"
                f":ep{s.ep}:etp{s.etp}")
        # the train phase keeps the historical unqualified key so every
        # pre-v4 cache entry keeps resolving; serving phases qualify it
        return base if phase in ("", "train") else f"{base}:ph{phase}"

    def get(self, s: MoEShape, hw: Hardware) -> Optional[Dict]:
        return self.table.get(self.key(s, hw))

    def put(self, s: MoEShape, hw: Hardware, cfg: Dict):
        self.table[self.key(s, hw)] = cfg
        if self.path:
            with open(self.path, "w") as f:
                json.dump(self.table, f, indent=1)

    def tune(self, s: MoEShape, hw: Hardware,
             candidates: Iterable[Dict],
             measure: Callable[[Dict], float]) -> Dict:
        """Profile-guided: measure each candidate once, cache the argmin."""
        hit = self.get(s, hw)
        if hit is not None:
            return hit
        best_cfg, best_t = None, math.inf
        for cfg in candidates:
            t = measure(cfg)
            if t < best_t:
                best_cfg, best_t = dict(cfg), t
        best_cfg["measured_s"] = best_t
        self.put(s, hw, best_cfg)
        return best_cfg


def default_candidates(s: MoEShape, max_blocks: int = 8):
    for n_col in range(1, max_blocks + 1):
        if s.N % n_col == 0 and s.N // n_col >= 128:
            yield {"n_col_blocks": n_col}


def resolve_n_col(mcfg, cfg_d_model: int, tokens_local: int,
                  ep: int, etp: int, hw: Hardware = H100_NVL) -> int:
    """Entry used by moe_layer when mcfg.n_col_blocks == 0 (adaptive)."""
    if mcfg.n_col_blocks:
        return mcfg.n_col_blocks
    s = plan_shape(mcfg, cfg_d_model, tokens_local, ep, etp)
    return choose_n_col(hw, s)


# ---------------------------------------------------------------------------
# Adaptive transport plans: a full schedule — transport impl × ring_group ×
# n_col_blocks × gemm backend — tuned per shape and persisted. ``tune_plan``
# times real executions of the port's moe_ffn when a timing callback is
# supplied and ranks with the discrete-event simulator / roofline model
# otherwise, so the same cache format serves offline (launch/tune.py) and
# measured tuning on the card.
# ---------------------------------------------------------------------------


# Schema history:
#   v2 — plans gained ``gemm_impl="pallas_fused"`` and the
#     ``fused_combine`` flag.
#   v3 — plans are ranked on FORWARD + BACKWARD step time (the
#     custom-VJP comet backward ring); ``measured_s`` is the fwd+bwd total,
#     ``t_bwd_s`` its backward component (0 when only the total was timed),
#     and ``objective`` records what the ranking covered. Knobs are stored
#     LEGALIZED (see ``legalize_plan``). v1/v2 caches load unchanged —
#     ``Plan.from_json`` defaults the missing fields (objective="fwd").
#   v4 — keys gained a LATENCY PHASE: ``train`` plans keep the
#     unqualified v3 key (ranked fwd+bwd as before, so every pre-v4 cache
#     still loads and resolves), while ``:phprefill`` / ``:phdecode``
#     entries rank on forward-only objectives — decode on per-step latency
#     (tiny-M shapes where the constant terms legalize toward bcast /
#     small ring groups; no backward exists at inference), prefill on
#     chunk throughput. ``Plan.phase`` records which ranking produced it.
#   v5 — WHOLE-GRAPH schedules rank beside per-layer plans: plans
#     gained ``schedule`` ("" = per-layer execution; "overlap" = the
#     block-schedule IR's cross-layer order, core/schedule.py) and
#     ``n_slices`` (Lancet-style token micro-slicing that creates the
#     legal cross-layer motion). Graph candidates are ranked on the
#     two-block whole-graph model (``modeled_graph_step_time``), per-layer
#     candidates exactly as in v4. v4 and older caches load unchanged —
#     ``Plan.from_json`` defaults schedule=""/n_slices=1 (per-layer).
#   v6 — TOPOLOGY-AWARE plans: the ``comet_hier`` transport (two-
#     level intra/inter-node ring) joins TRANSPORTS, and plans gained
#     ``intra_group`` (devices per node on the EP axis; hier-only knob,
#     stored legalized via the shared ``legalize_intra_group``) and
#     ``wire_dtype`` (dispatch/combine wire format: fp32 | bf16 |
#     fp8_e4m3 — non-fp32 only legal on comet_hier). v5 and older caches
#     load unchanged — ``Plan.from_json`` defaults intra_group=1 /
#     wire_dtype="fp32" (the flat, full-precision schedule).
PLAN_CACHE_VERSION = 6

TRANSPORTS = ("naive", "coarse", "comet", "comet_hier", "bcast")
PLAN_PHASES = ("train", "prefill", "decode")

# what each phase's ranking objective covers (persisted in Plan.objective)
PHASE_OBJECTIVES = {"train": "fwd_bwd", "prefill": "prefill_tput",
                    "decode": "decode_latency"}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One concrete MoE-layer schedule. ``measured_s`` is the winning latency
    under the measure that selected it; ``source`` records whether that was a
    real timed execution ("measured") or the analytical model ("model")."""
    impl: str = "comet"
    ring_group: int = 1
    n_col_blocks: int = 1
    gemm_impl: str = "xla"
    fused_combine: bool = False
    measured_s: float = 0.0
    source: str = "model"
    t_bwd_s: float = 0.0               # backward component of measured_s
    objective: str = "fwd_bwd"         # what measured_s ranked: fwd |
                                       # fwd_bwd | prefill_tput | decode_latency
    phase: str = "train"               # latency phase the plan was ranked for
    schedule: str = ""                 # "" = per-layer execution; "overlap"
                                       # = whole-graph block-schedule order
                                       # (core/schedule.py)
    n_slices: int = 1                  # token micro-slices creating the
                                       # cross-layer overlap freedom
    intra_group: int = 1               # devices per node on the EP axis
                                       # (comet_hier two-level ring; 1 on
                                       # every other transport)
    wire_dtype: str = "fp32"           # dispatch/combine wire format
                                       # (comet_hier; fp32 = native bytes)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "Plan":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        # pre-v3 entries were ranked on forward time only; say so rather
        # than defaulting to the v3 objective
        kw.setdefault("objective", "fwd")
        plan = cls(**kw)
        # dataclasses don't type-check: a hand-edited / bit-rotted entry
        # with a string where a knob belongs must raise HERE (the cache
        # loader skips it) rather than explode deep inside plan resolution
        for f, ty in (("impl", str), ("ring_group", int),
                      ("n_col_blocks", int), ("n_slices", int),
                      ("intra_group", int), ("wire_dtype", str),
                      ("measured_s", (int, float)),
                      ("t_bwd_s", (int, float))):
            if not isinstance(getattr(plan, f), ty):
                raise ValueError(f"plan field {f}={getattr(plan, f)!r} "
                                 f"is not {ty}")
        return plan

    def validate(self, d_model: Optional[int] = None,
                 ep: Optional[int] = None) -> list:
        """Static legality of the knob settings — everything checkable
        without hardware. Returns a list of problem strings (empty =
        legal). With ``d_model``/``ep`` supplied, also requires the knobs
        to be PRE-legalized (v3+ caches store legalized knobs; an entry
        that re-legalizes differently would execute different geometry
        than the tuner ranked)."""
        bad = []
        if self.impl not in TRANSPORTS:
            bad.append(f"impl {self.impl!r} not in {TRANSPORTS}")
        if not 1 <= self.n_col_blocks <= MAX_COL_BLOCKS:
            bad.append(f"n_col_blocks {self.n_col_blocks} outside "
                       f"[1, {MAX_COL_BLOCKS}]")
        if self.ring_group < 1:
            bad.append(f"ring_group {self.ring_group} < 1")
        if self.intra_group < 1:
            bad.append(f"intra_group {self.intra_group} < 1")
        if self.wire_dtype not in WIRE_DTYPES:
            bad.append(f"wire_dtype {self.wire_dtype!r} not in {WIRE_DTYPES}")
        elif self.wire_dtype != "fp32" and self.impl != "comet_hier":
            bad.append(f"wire_dtype {self.wire_dtype!r} requires the "
                       "comet_hier transport")
        if self.gemm_impl not in ("", "xla", "pallas", "pallas_fused"):
            bad.append(f"unknown gemm_impl {self.gemm_impl!r}")
        if self.phase not in PLAN_PHASES:
            bad.append(f"phase {self.phase!r} not in {PLAN_PHASES}")
        if self.schedule not in ("", "overlap"):
            bad.append(f"unknown schedule {self.schedule!r}")
        if self.n_slices < 1:
            bad.append(f"n_slices {self.n_slices} < 1")
        if self.schedule == "" and self.n_slices != 1:
            bad.append("per-layer schedule with n_slices != 1")
        if self.schedule == "overlap" and (self.n_slices < 2
                                           or self.impl != "comet"):
            bad.append("overlap schedule requires comet with >= 2 slices")
        if not bad and d_model is not None and ep is not None:
            lg = legalize_plan(self, d_model, ep)
            if ((lg.n_col_blocks, lg.ring_group, lg.intra_group)
                    != (self.n_col_blocks, self.ring_group,
                        self.intra_group)):
                bad.append(
                    f"knobs ({self.n_col_blocks}, {self.ring_group}, "
                    f"{self.intra_group}) not legal for d_model={d_model}, "
                    f"ep={ep} (legalize to ({lg.n_col_blocks}, "
                    f"{lg.ring_group}, {lg.intra_group}))")
        return bad

    def apply(self, mcfg):
        """Return ``mcfg`` running this plan's schedule. Sets
        ``plan_override`` so nested calls do not re-resolve the plan."""
        return dataclasses.replace(
            mcfg, impl=self.impl, ring_group=self.ring_group,
            n_col_blocks=max(1, self.n_col_blocks),
            fused_combine=self.fused_combine, gemm_impl=self.gemm_impl,
            intra_group=max(1, self.intra_group),
            wire_dtype=self.wire_dtype, plan_override=True)


def plan_shape(mcfg, d_model: int, tokens_local: int, ep: int,
               etp: int) -> MoEShape:
    """The (M, d, f, E, topk, ep, etp) key shape for plan lookup — must be
    built identically by the tuner and by moe_layer's resolution. With
    BigMac descend-ascend experts (``mcfg.wire_dim``) the ring moves
    wire-width rows, so N IS the wire width: the cost model, the plan key,
    and knob legalization (n_col divides the combine width) all follow."""
    wire = getattr(mcfg, "wire_dim", 0)
    return MoEShape(M=tokens_local, N=wire or d_model,
                    K=mcfg.d_expert // max(1, etp), E=mcfg.num_experts,
                    topk=mcfg.top_k, ep=ep, etp=etp)


_KEY_GEOM_RE = re.compile(r":N(\d+):.*:ep(\d+):")


def _key_geometry(key: str) -> Tuple[Optional[int], Optional[int]]:
    """(d_model, ep) parsed from a cache key, (None, None) if the key is
    not in the canonical format — validation then skips the legality-vs-
    geometry part and checks only the static ranges."""
    m = _KEY_GEOM_RE.search(key)
    return (int(m.group(1)), max(1, int(m.group(2)))) if m else (None, None)


class PlanCache:
    """JSON-backed map  shape-key -> Plan  (Comet's pre-compiled kernel
    metadata analogue, but holding full transport schedules)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.plans: Dict[str, Plan] = {}
        if path and os.path.exists(path):
            self.load(path)

    @staticmethod
    def key(s: MoEShape, hw: Hardware, phase: str = "train") -> str:
        return AdaptiveCache.key(s, hw, phase)

    def load(self, path: str):
        import warnings
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError) as e:
            # a corrupt/unreadable cache must not take the run down — behave
            # like a missing file (analytical fallback) and say so
            warnings.warn(f"plan cache {path!r} unreadable ({e}); starting "
                          "empty — plans fall back to the analytical model",
                          stacklevel=2)
            self.plans = {}
            return
        version = raw.get("version", 0) if isinstance(raw, dict) else 0
        if isinstance(version, (int, float)) and version > PLAN_CACHE_VERSION:
            # a future format may mean anything; retuning is cheap, silently
            # misreading a newer schema is not
            warnings.warn(f"plan cache {path!r} has version {version} > "
                          f"supported {PLAN_CACHE_VERSION}; starting empty",
                          stacklevel=2)
            self.plans = {}
            return
        table = raw.get("plans", raw) if isinstance(raw, dict) else {}
        self.plans = {}
        bad = 0
        for k, v in table.items():
            if not (isinstance(v, dict) and "impl" in v):
                bad += 1
                continue
            try:
                plan = Plan.from_json(v)
            except (TypeError, ValueError, KeyError):
                bad += 1        # one mangled entry must not drop the rest
                continue
            geom = _key_geometry(k)
            problems = plan.validate(*geom)
            if problems and not plan.validate():
                # knobs are statically fine but not pre-legalized (a
                # hand-written or pre-v3 entry): resolve to the executable
                # schedule the transport would run, same as resolve-time
                # legalization always has
                plan = legalize_plan(plan, *geom)
                problems = plan.validate(*geom)
            if problems:
                # an illegal entry (hand-edited, or written by a broken
                # tuner) would execute geometry nobody ranked — skip it
                warnings.warn(f"plan cache {path!r}: entry {k!r} illegal "
                              f"({'; '.join(problems)}); skipped",
                              stacklevel=2)
                bad += 1
                continue
            self.plans[k] = plan
        if bad:
            warnings.warn(f"plan cache {path!r}: skipped {bad} malformed "
                          f"entr{'y' if bad == 1 else 'ies'}", stacklevel=2)

    def save(self, path: Optional[str] = None):
        path = path or self.path
        if not path:
            raise ValueError("PlanCache has no path to save to")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # atomic: a concurrent load_plan_cache must never see a torn file
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": PLAN_CACHE_VERSION,
                       "plans": {k: p.to_json()
                                 for k, p in sorted(self.plans.items())}},
                      f, indent=1)
        os.replace(tmp, path)

    def get(self, s: MoEShape, hw: Hardware,
            phase: str = "train") -> Optional[Plan]:
        return self.plans.get(self.key(s, hw, phase))

    def put(self, s: MoEShape, hw: Hardware, plan: Plan, save: bool = True,
            phase: str = "train"):
        problems = plan.validate(s.N, max(1, s.ep))
        if problems:
            raise ValueError(f"refusing to cache illegal plan for "
                             f"{self.key(s, hw, phase)}: "
                             f"{'; '.join(problems)}")
        self.plans[self.key(s, hw, phase)] = plan
        if save and self.path:
            self.save()


def candidate_plans(s: MoEShape, max_col_blocks: int = 8,
                    max_ring_group: int = 4,
                    gemm_impls: Tuple[str, ...] = ("xla", "pallas_fused"),
                    include_bcast: bool = True,
                    include_graph: bool = False,
                    hw: Optional[Hardware] = None) -> Iterable[Plan]:
    """The search space: every transport with its legal knob settings.

    The default backend set omits ``"pallas"`` — the analytical model rates
    it identically to ``"xla"`` (same GEMMs, same HBM traffic), so including
    it only duplicates candidates; measured tuning (launch/tune.py --gemm)
    can add it. ``"pallas_fused"`` IS modeled (the saved hidden HBM round
    trip vs. the per-column-block GEMM1 recompute), as is the comet
    ``fused_combine`` streaming-consumer flag.

    ``include_graph=True`` adds whole-graph variants of every comet
    candidate that passes the gate: ``schedule="overlap"`` with 2 or 4
    token micro-slices (one slice has no cross-layer freedom:
    attn_{i+1} truly depends on combine_i). They rank on the two-block
    graph model (``core/schedule.py``) against the per-layer candidates.

    ``hw`` (default H100_NVL) gates the fused backend's candidates
    (``analysis.kernel_check.plan_vmem_ok``): a TPU preset on its VMEM
    budget, as the JAX package gates every preset, a GPU preset on the
    port's fused kernel fitting one block's shared memory. A Hardware
    with ``vmem_bytes=0`` disables the gate."""
    hw = H100_NVL if hw is None else hw
    from repro_torch.analysis.kernel_check import plan_vmem_ok
    n_cols = [n for n in range(1, max_col_blocks + 1)
              if s.N % n == 0 and s.N // n >= 128] or [1]
    rings = [g for g in range(1, min(max_ring_group, s.ep) + 1)
             if s.ep % g == 0] or [1]
    for gi in gemm_impls:
        for p in (Plan("naive", 1, 1, gi), Plan("coarse", 1, 1, gi)):
            if plan_vmem_ok(s, p, hw):
                yield p
        for rg in rings:
            for n_col in n_cols:
                for fc in (False, True):
                    p = Plan("comet", rg, n_col, gi, fc)
                    if not plan_vmem_ok(s, p, hw):
                        continue
                    yield p
                    if include_graph:
                        for ns in (2, 4):
                            yield Plan("comet", rg, n_col, gi, fc,
                                       schedule="overlap", n_slices=ns)
        # hierarchical variants only where the topology declares real node
        # structure (1 < intra_group < ep after legalization): a flat
        # fabric gains nothing and the flat presets stay byte-identical in
        # the candidate stream. Wire formats are a hier-only knob; fp8 is
        # enumerated only when this torch can represent it.
        ig = legalize_intra_group(s.ep, hw.intra_group)
        if 1 < ig < s.ep:
            wires = ["fp32", "bf16"]
            if wire_dtype_supported("fp8_e4m3"):
                wires.append("fp8_e4m3")
            for rg in rings:
                for n_col in n_cols:
                    for fc in (False, True):
                        for wd in wires:
                            p = Plan("comet_hier", rg, n_col, gi, fc,
                                     intra_group=ig, wire_dtype=wd)
                            if plan_vmem_ok(s, p, hw):
                                yield p
        if include_bcast:
            p = Plan("bcast", 1, 1, gi)
            if plan_vmem_ok(s, p, hw):
                yield p


# ---------------------------------------------------------------------------
# Topology-aware hop pricing (the comet_hier two-level ring). One shared
# overlap formula — ``exposed_comm_from_hops`` — consumes per-sub-step hop
# times from EITHER the analytical profile below (modeled) or from a census
# of executed ppermutes (the JAX package's benchmarks/run.py), so the
# two exposed-comm figures differ only in where the traffic came from.
# ---------------------------------------------------------------------------


def hier_step_order(ep: int, intra_group: int) -> list:
    """Sub-step (node_shift, local_shift) sequence of the two-level ring.

    Step 0 is the local chunk. The inter-node steps come FIRST (the slow
    hops overlap the most remaining compute), the intra-node steps land in
    the tail where little compute is left to hide them — which is also why
    the hierarchical ring's unavoidable last-return-hop exposure is priced
    at the fast class while flat comet pays the slow one."""
    ep = max(1, ep)
    ig = legalize_intra_group(ep, intra_group)
    nn = ep // ig
    order = [(0, 0)]
    for sn in range(1, nn):
        for sl in range(ig):
            order.append((sn, sl))
    for sl in range(1, ig):
        order.append((0, sl))
    return order


def hier_step_classes(ep: int, intra_group: int) -> list:
    """Per-sub-step link class: "local" | "intra" | "inter"."""
    out = []
    for sn, sl in hier_step_order(ep, intra_group):
        if sn == 0 and sl == 0:
            out.append("local")
        elif sn == 0:
            out.append("intra")
        else:
            out.append("inter")
    return out


def link_class_bw(hw: Hardware, cls: str) -> float:
    """Raw bytes/s of one link class (falls back to the flat link_bw when
    the topology descriptor leaves a class unset)."""
    if cls == "intra":
        return (hw.intra_bw or hw.link_bw) * hw.links
    return (hw.inter_bw or hw.link_bw) * hw.links


def hop_time_profile(hw: Hardware, s: MoEShape, plan: "Plan") -> list:
    """Per-sub-step one-way hop times (len ep; index 0 = the local chunk,
    cost 0) for a ring transport. Flat comet pays link_bw on every remote
    hop; comet_hier prices each hop by its class and shrinks the payload
    by the wire format (dispatch and combine both ride the wire dtype)."""
    ep = max(1, s.ep)
    rows = s.M * s.topk / ep
    if plan.impl != "comet_hier":
        t = layer_times(hw, s)["t_hop"]
        return [0.0] + [t] * (ep - 1)
    chunk_bytes = rows * s.N * wire_bytes_per_elt(s, plan.wire_dtype)
    out = []
    for cls in hier_step_classes(ep, plan.intra_group):
        if cls == "local":
            out.append(0.0)
        else:
            out.append(hw.hop_latency_s + chunk_bytes / link_class_bw(hw, cls))
    return out


def exposed_comm_from_hops(hop_in: list, hop_out: list, t_comp: float,
                           ring_group: int) -> float:
    """Exposed comm of one decomposed ring: pipeline end time minus pure
    compute, on a three-resource machine (link_in, compute, link_out;
    in-order FIFO per link — the schedule IR's resource model in
    miniature). ``hop_in``/``hop_out`` are per-sub-step one-way hop times
    (index 0 = local, 0.0); ``t_comp`` is one macro-step's GEMM time."""
    ep = len(hop_in)
    g = max(1, ring_group)
    n_steps = max(1, ep // g)
    t_in = 0.0
    core = 0.0
    t_out = 0.0
    for m in range(n_steps):
        for j in range(g):
            t_in += hop_in[m * g + j]
        core = max(core, t_in) + t_comp
        for j in range(g):
            t_out = max(t_out, core) + hop_out[m * g + j]
    return max(0.0, max(core, t_out) - n_steps * t_comp)


def fwd_exposed_comm_time(hw: Hardware, s: MoEShape, plan: "Plan") -> float:
    """Forward communication NOT hidden behind compute for the ring
    transports, priced per link class (the hier figure's modeled side)."""
    hops = hop_time_profile(hw, s, plan)
    g = max(1, plan.ring_group)
    t_comp = g * layer_times(hw, s)["t_chunk_compute"]
    return exposed_comm_from_hops(hops, hops, t_comp, g)


def _weight_read_time(hw: Hardware, s: MoEShape, reads: float) -> float:
    """HBM time to stream the local expert weights ``reads`` times — the
    ring_group trade-off (transport_comet docstring): g source chunks fused
    per GroupGEMM macro-step means ep/g weight reads instead of ep."""
    n_mats = (2 if s.glu else 1) + 1
    w_bytes = (s.E / max(1, s.ep)) * n_mats * s.N * s.K * s.bytes_per_elt
    return reads * w_bytes / hw.hbm_bw


def _layer0_weight_bytes(s: MoEShape) -> float:
    """Local layer-0 expert weights (w_gate + w_up), one full read."""
    n_l0 = 2 if s.glu else 1
    return (s.E / max(1, s.ep)) * n_l0 * s.N * s.K * s.bytes_per_elt


def _hidden_traffic_time(hw: Hardware, s: MoEShape, plan: Plan) -> float:
    """Time attributable to the inter-GEMM hidden tensor h (rows_total, K).

    Unfused backends (xla / pallas) write h to HBM once and re-read it per
    GEMM2 call — the comet schedule's N-decomposition re-reads ALL of h for
    every column block. The fused backend never gives h an HBM address, but
    each extra column block is a separate col-sliced kernel call that
    recomputes GEMM1: it re-spends the FLOPs AND re-streams the layer-0
    weights (whichever bounds) — this term is what lets the tuner rank the
    backends, and what pushes the fused schedule toward n_col == 1 (where
    the kernel's n_major traversal supplies the early tile completion)."""
    rows = s.M * s.topk                     # expert rows per device (a2a paths)
    if plan.impl == "bcast":
        rows /= max(1, s.ep)                # each rank only its expert slice
    n_col = (max(1, plan.n_col_blocks)
             if plan.impl in ("comet", "comet_hier") else 1)
    if plan.gemm_impl == "pallas_fused":
        n_l0 = 2 if s.glu else 1
        n_steps = max(1, s.ep // max(1, plan.ring_group)) \
            if plan.impl in ("comet", "comet_hier") else 1
        recompute = gemm_time(hw, rows, s.K, s.N, n_l0)
        reread = n_steps * _layer0_weight_bytes(s) / hw.hbm_bw
        return (n_col - 1) * max(recompute, reread)
    h_bytes = rows * s.K * s.bytes_per_elt
    return h_bytes * (1 + n_col) / hw.hbm_bw


def _combine_stage_time(hw: Hardware, s: MoEShape, plan: Plan) -> float:
    """Extra HBM staging for the comet combine: without ``fused_combine``
    the n_col column blocks are concatenated into a full-width
    (M·topk, N) buffer (write + read) before one combine; the streaming
    per-block combine consumes each block in place."""
    if plan.impl not in ("comet", "comet_hier") or plan.fused_combine \
            or max(1, plan.n_col_blocks) == 1:
        return 0.0
    return 2.0 * s.M * s.topk * s.N * s.bytes_per_elt / hw.hbm_bw


def hot_path_hbm_bytes(s: MoEShape, plan: Plan) -> int:
    """Modeled HBM bytes moved by one MoE layer's hot path under ``plan`` —
    the figure the JAX package's benchmarks/run.py --json reports so the fused pipeline's
    traffic saving is visible next to the latency model. Terms: dispatch
    buffer (write + read), inter-GEMM hidden (0 when fused), expert output
    (write + combine read), comet combine staging (0 when streaming), and
    expert-weight reads — ×ep/ring_group macro-steps for comet, with the
    layer-0 weights re-streamed (n_col - 1) extra times under the fused
    backend (each col-sliced kernel call recomputes GEMM1). The fused
    schedule therefore minimizes its bytes at n_col == 1, where the
    kernel's n_major traversal supplies the early tile completion."""
    rows = s.M * s.topk
    if plan.impl == "bcast":
        rows /= max(1, s.ep)                # matches _hidden_traffic_time
    bpe = s.bytes_per_elt
    ring = plan.impl in ("comet", "comet_hier")
    n_col = max(1, plan.n_col_blocks) if ring else 1
    dispatch = 2 * rows * s.N * bpe
    hidden = (0 if plan.gemm_impl == "pallas_fused"
              else rows * s.K * bpe * (1 + n_col))
    out = 2 * rows * s.N * bpe
    stage = (0 if not ring or plan.fused_combine or n_col == 1
             else 2 * rows * s.N * bpe)
    n_steps = (max(1, s.ep // max(1, plan.ring_group)) if ring else 1)
    n_mats = (2 if s.glu else 1) + 1
    weights = n_steps * (s.E / max(1, s.ep)) * n_mats * s.N * s.K * bpe
    if plan.gemm_impl == "pallas_fused":
        weights += n_steps * (n_col - 1) * _layer0_weight_bytes(s)
    return int(dispatch + hidden + out + stage + weights)


def modeled_plan_time(hw: Hardware, s: MoEShape, plan: Plan) -> float:
    """Analytical latency for one MoE layer under ``plan`` — the fallback
    measure when no device mesh is attached. Built on the discrete-event
    simulator (analysis/simulator.py) plus HBM-traffic terms the simulator
    does not model: expert-weight reads (differentiates ring_group), the
    inter-GEMM hidden round trip (differentiates the fused backend), and
    the comet combine staging (differentiates ``fused_combine``)."""
    from repro_torch.analysis import simulator as SIM  # lazy: it imports us
    tpu = hw.name.startswith("tpu")
    extra = _hidden_traffic_time(hw, s, plan) + _combine_stage_time(hw, s, plan)
    if plan.impl == "naive":
        return (SIM.sim_megatron(hw, s)["total"]
                + _weight_read_time(hw, s, 1) + extra)
    if plan.impl == "coarse":
        n = 2
        return (SIM.sim_pipeline(hw, s, n_chunks=n)["total"]
                + _weight_read_time(hw, s, n) + extra)
    if plan.impl == "bcast":
        # tokens replicated over the model axis: no dispatch, every rank runs
        # its expert slice over the full token set, one psum combines.
        rows = s.M * s.topk / max(1, s.ep)
        n_l0 = 2 if s.glu else 1
        t_g = (gemm_time(hw, rows, s.K, s.N, n_l0)
               + gemm_time(hw, rows, s.N, s.K))
        W = s.ep * s.etp
        ar = (2.0 * (W - 1) / W * s.M * s.topk * s.N * s.bytes_per_elt
              / SIM.link_rate(hw)) if W > 1 else 0.0
        return t_g + ar + _weight_read_time(hw, s, 1) + extra
    g = max(1, plan.ring_group)
    n_steps = max(1, s.ep // g)
    if plan.impl == "comet_hier":
        t = SIM.sim_comet_hier(hw, s, plan,
                               n_col=max(1, plan.n_col_blocks),
                               tpu=tpu)["total"]
        # pipeline fill under macro-step fusion: the first macro-step's
        # remote sub-steps, priced at their own link classes
        fill = sum(hop_time_profile(hw, s, plan)[1:g])
    else:
        t = SIM.sim_comet(hw, s, n_col=max(1, plan.n_col_blocks),
                          tpu=tpu)["total"]
        # ring_group g: ep/g weight reads (macro-step fusion) but a g-hop
        # pipeline-fill before the first macro-step can start.
        fill = (g - 1) * layer_times(hw, s)["t_hop"]
    return t + _weight_read_time(hw, s, n_steps) + fill + extra


# ---------------------------------------------------------------------------
# Backward-pass cost model (the custom-VJP comet ring vs the XLA-autodiff
# transposed baseline). Plans are ranked on fwd + bwd: the training step is
# the north-star workload and ~2/3 of it is backward.
# ---------------------------------------------------------------------------


def _dw_accum_time(hw: Hardware, s: MoEShape, n_flushes: int) -> float:
    """HBM time for the fp32 dW accumulators: each flush reads + writes the
    local expert-weight footprint. The comet custom VJP flushes once per
    macro-step (×ep/ring_group); the autodiff baseline flushes per chunk
    (×ep) because every reverse step is a separate transposed GroupGEMM."""
    n_mats = (2 if s.glu else 1) + 1
    dw_bytes = (s.E / max(1, s.ep)) * n_mats * s.N * s.K * 4       # fp32
    return n_flushes * 2.0 * dw_bytes / hw.hbm_bw


def _bwd_hidden_time(hw: Hardware, s: MoEShape, plan: Plan) -> float:
    """Hidden-tensor HBM traffic during the custom-VJP backward. The fused
    backend recomputes h inside the dgrad/wgrad kernels (VMEM-resident —
    charged as FLOPs where the backend is known); unfused backends re-read
    the SAVED layer-0 pre-activations and stream the dh accumulator."""
    if plan.gemm_impl == "pallas_fused":
        return 0.0
    rows = s.M * s.topk
    n_l0 = 2 if s.glu else 1
    return (1 + n_l0) * rows * s.K * s.bytes_per_elt / hw.hbm_bw


def modeled_plan_time_bwd(hw: Hardware, s: MoEShape, plan: Plan) -> float:
    """Analytical backward latency of one MoE layer under ``plan``.

    comet runs the custom-VJP ring: dY chunks travel the reverse permutes
    while the per-chunk dgrad/wgrad GEMMs (with VMEM/HBM hidden remat) and
    the next hop overlap — the forward's pipeline geometry with two comm
    streams (dY in, dX out) — and dW flushes once per macro-step.

    naive/coarse keep XLA autodiff: the transposed all_to_all schedule,
    fully serialized, hidden SAVED by the forward and re-read (plus the dh
    round trip) instead of recomputed — except under the fused backend,
    whose dgrad/wgrad kernels recompute in VMEM everywhere.

    bcast's backward is modeled at TRAINING semantics (backward only exists
    in training): every token must be resident on every model rank, so each
    rank back-propagates its expert slice of ALL ep groups' tokens (×ep the
    a2a paths' per-chunk rows) and the dX psum moves the full replicated
    buffer. This is what keeps the tuner from "winning" a training shape
    with the decode path; at decode-sized M the constant terms dominate and
    bcast stays competitive."""
    lt = layer_times(hw, s)
    # the fused dgrad/wgrad kernels recompute the hidden in VMEM (extra
    # GEMM1 FLOPs); unfused custom-VJP paths re-read saved pre-activations
    recomp = lt["t_gemm1"] if plan.gemm_impl == "pallas_fused" else 0.0
    t_chunk_bwd = lt["t_bwd_gemm"] + recomp
    if plan.impl == "bcast":
        W = s.ep * s.etp
        full_bytes = s.ep * s.M * s.topk * s.N * s.bytes_per_elt
        ar = (2.0 * (W - 1) / W * full_bytes / _a2a_rate(hw)) if W > 1 else 0.0
        return (s.ep * t_chunk_bwd + ar + _dw_accum_time(hw, s, 1)
                + _weight_read_time(hw, s, 1) + _bwd_hidden_time(hw, s, plan))
    if plan.impl in ("naive", "coarse", "dense"):
        rows = s.M * s.topk
        W = s.ep * s.etp
        t_comm = (2.0 * rows * s.N * s.bytes_per_elt / _a2a_rate(hw)
                  if W > 1 else 0.0)
        if plan.gemm_impl == "pallas_fused":
            t_h = 0.0
        else:
            # autodiff: saved h re-read + the dh round trip
            t_h = 2.0 * s.M * s.topk * s.K * s.bytes_per_elt / hw.hbm_bw
        n = 2 if plan.impl == "coarse" else 1
        return (t_comm + s.ep * t_chunk_bwd + t_h + _dw_accum_time(hw, s, n)
                + _weight_read_time(hw, s, n))
    g = max(1, plan.ring_group)
    n_steps = max(1, s.ep // g)
    t_macro_comp = g * t_chunk_bwd
    if plan.impl == "comet_hier":
        # the backward rides the hierarchical permutes at NATIVE width
        # (gradients are never wire-quantized), dY in + dX out
        hops = hop_time_profile(
            hw, s, dataclasses.replace(plan, wire_dtype="fp32"))
        exposed = exposed_comm_from_hops(hops, hops, t_macro_comp, g)
        return (n_steps * t_macro_comp + exposed
                + _dw_accum_time(hw, s, n_steps)
                + _weight_read_time(hw, s, n_steps)
                + _bwd_hidden_time(hw, s, plan))
    t_macro_comm = g * 2.0 * lt["t_hop"]               # dY in + dX out
    steady = n_steps * max(t_macro_comp, t_macro_comm)
    fill = min(t_macro_comp, t_macro_comm) + (g - 1) * lt["t_hop"]
    return (steady + fill + _dw_accum_time(hw, s, n_steps)
            + _weight_read_time(hw, s, n_steps)
            + _bwd_hidden_time(hw, s, plan))


def bwd_exposed_comm_time(hw: Hardware, s: MoEShape, plan: Plan) -> float:
    """Backward communication NOT hidden behind compute. comet: the pipeline
    fill plus any steady-state comm residual; naive (and the autodiff
    baseline) expose the full reverse collectives."""
    lt = layer_times(hw, s)
    if plan.impl == "bcast":
        return 0.0
    if plan.impl == "comet_hier":
        g = max(1, plan.ring_group)
        recomp = lt["t_gemm1"] if plan.gemm_impl == "pallas_fused" else 0.0
        hops = hop_time_profile(
            hw, s, dataclasses.replace(plan, wire_dtype="fp32"))
        return exposed_comm_from_hops(hops, hops,
                                      g * (lt["t_bwd_gemm"] + recomp), g)
    if plan.impl != "comet":
        return 2.0 * s.M * s.topk * s.N * s.bytes_per_elt / _a2a_rate(hw)
    g = max(1, plan.ring_group)
    n_steps = max(1, s.ep // g)
    recomp = lt["t_gemm1"] if plan.gemm_impl == "pallas_fused" else 0.0
    t_macro_comp = g * (lt["t_bwd_gemm"] + recomp)
    t_macro_comm = g * 2.0 * lt["t_hop"]
    return (g * lt["t_hop"]
            + n_steps * max(0.0, t_macro_comm - t_macro_comp))


def autodiff_bwd_time(hw: Hardware, s: MoEShape) -> float:
    """The XLA-autodiff baseline the custom VJP replaces: the transposed
    ring serializes ALL reverse ppermutes after the forward completes
    (nothing overlaps them), re-reads the saved hidden from HBM, and
    round-trips the fp32 dW accumulator per chunk."""
    lt = layer_times(hw, s)
    t_comm = 2.0 * s.ep * lt["t_hop"]                  # dY + dX, exposed
    t_comp = s.ep * 2.0 * (lt["t_gemm1"] + lt["t_gemm2"])
    h_read = s.M * s.topk * s.K * s.bytes_per_elt / hw.hbm_bw
    return (t_comm + t_comp + h_read + _dw_accum_time(hw, s, s.ep)
            + _weight_read_time(hw, s, s.ep))


def hot_path_hbm_bytes_bwd(s: MoEShape, plan: Plan) -> int:
    """Modeled HBM bytes of one MoE layer's backward under the custom-VJP
    schedule: dY read + dX write, the saved dispatch rows re-read for the
    recompute/wgrad, hidden remat traffic (0 when fused — dgrad/wgrad
    recompute it in VMEM), per-macro-step weight reads, and the fp32 dW
    accumulator round trips ×(ep/ring_group)."""
    rows = s.M * s.topk
    bpe = s.bytes_per_elt
    n_l0 = 2 if s.glu else 1
    n_mats = n_l0 + 1
    dy_dx = 2 * rows * s.N * bpe
    saved = rows * s.N * bpe
    hidden = (0 if plan.gemm_impl == "pallas_fused"
              else (1 + n_l0) * rows * s.K * bpe)
    if plan.impl in ("comet", "comet_hier"):
        n_steps = max(1, s.ep // max(1, plan.ring_group))
    else:
        n_steps = 2 if plan.impl == "coarse" else 1
    w_bytes = (s.E / max(1, s.ep)) * n_mats * s.N * s.K
    weights = n_steps * w_bytes * bpe
    dw = n_steps * 2 * w_bytes * 4
    return int(dy_dx + saved + hidden + weights + dw)


def autodiff_bwd_hbm_bytes(s: MoEShape) -> int:
    """HBM bytes of the autodiff baseline backward: hidden saved by the
    forward is re-read, every reverse chunk re-reads the weights and
    round-trips the dW accumulator."""
    rows = s.M * s.topk
    bpe = s.bytes_per_elt
    n_l0 = 2 if s.glu else 1
    n_mats = n_l0 + 1
    w_bytes = (s.E / max(1, s.ep)) * n_mats * s.N * s.K
    return int(2 * rows * s.N * bpe + rows * s.N * bpe
               + (1 + n_l0) * rows * s.K * bpe
               + s.ep * w_bytes * bpe + s.ep * 2 * w_bytes * 4)


def _a2a_rate(hw: Hardware) -> float:
    from repro_torch.analysis import simulator as SIM  # lazy: it imports us
    return SIM.link_rate(hw)


def modeled_step_time(hw: Hardware, s: MoEShape, plan: Plan) -> float:
    """The train-phase ranking metric: one MoE layer's forward + backward."""
    return modeled_plan_time(hw, s, plan) + modeled_plan_time_bwd(hw, s, plan)


# ---------------------------------------------------------------------------
# Cross-layer (whole-graph) cost terms: the block-schedule IR's view.
# core/schedule.py lowers blocks to segments; these wrappers expose its
# bubble/fill accounting to the tuner so whole-graph schedules rank in the
# same candidate stream as per-layer plans.
# ---------------------------------------------------------------------------


def modeled_graph_step_time(hw: Hardware, s: MoEShape, plan: Plan,
                            d_model: int = 0, n_blocks: int = 2,
                            training: bool = True,
                            scheduled: Optional[bool] = None) -> float:
    """PER-BLOCK modeled time of an ``n_blocks`` whole-graph window under
    ``plan`` (attention + ring segments + lump HBM terms; fwd+bwd when
    ``training``). ``scheduled=None`` follows ``plan.schedule``; False
    forces the layer-at-a-time barrier baseline: the difference of the
    two isolates the cross-layer fill. ``d_model`` defaults to s.N (equal
    except under BigMac wire-width shapes, where callers that know the
    real width should pass it)."""
    from repro_torch.core import schedule as SCH   # lazy: it imports us
    if scheduled is None:
        scheduled = plan.schedule == "overlap"
    t = SCH.graph_step_time(hw, s, plan, d_model=d_model or s.N,
                            n_blocks=n_blocks, n_slices=plan.n_slices,
                            training=training, scheduled=scheduled)
    return t["total"] / max(1, n_blocks)


def ring_bubble_time(hw: Hardware, s: MoEShape, plan: Plan,
                     training: bool = False) -> float:
    """Compute-idle time of ONE block's comet ring under per-layer
    execution: the bubble budget cross-layer scheduling can feed with
    neighbouring-layer compute (next block's attn/norm forward; previous
    layer's wgrad flush backward)."""
    from repro_torch.core import schedule as SCH
    g = SCH.lower_model_graph(hw, s, plan, d_model=s.N, n_blocks=1,
                              n_slices=1, training=training)
    t = SCH.schedule_time(g, SCH.sequential_order(g), layer_barriers=True)
    return t.get("idle_compute", 0.0)


def cross_layer_fill_time(hw: Hardware, s: MoEShape, plan: Plan,
                          n_blocks: int = 2, n_slices: int = 2,
                          training: bool = False) -> float:
    """What whole-graph scheduling reclaims per block: barrier baseline
    minus scheduled time for the same window (>= 0 by construction: the
    scheduler never legalizes a slower order than the baseline)."""
    p = dataclasses.replace(plan, schedule="overlap",
                            n_slices=max(1, n_slices))
    base = modeled_graph_step_time(hw, s, p, n_blocks=n_blocks,
                                   training=training, scheduled=False)
    sched = modeled_graph_step_time(hw, s, p, n_blocks=n_blocks,
                                    training=training, scheduled=True)
    return max(0.0, base - sched)


def phase_measure(hw: Hardware, s: MoEShape,
                  phase: str) -> Callable[[Plan], float]:
    """The analytical ranking objective for a latency phase: training ranks
    fwd+bwd (~2/3 of a step is backward); serving phases rank FORWARD ONLY —
    decode on per-step latency (no backward exists at inference; at tiny M
    the constant terms push toward bcast / small ring groups), prefill on
    chunk walltime (throughput = chunk tokens / this). Whole-graph
    candidates (``plan.schedule``) score as their per-layer base time minus
    the graph model's cross-layer fill — the graph total also carries
    attention + lump terms the per-layer objective never sees, so ranking
    raw graph time against per-layer time would bury every scheduled
    candidate under a constant it cannot influence; differencing the two
    graph runs (barrier vs scheduled, identical lumps) cancels it."""
    def measure(p: Plan) -> float:
        training = phase == "train"
        if p.schedule:
            base_p = dataclasses.replace(p, schedule="", n_slices=1)
            base = (modeled_step_time(hw, s, base_p) if training
                    else modeled_plan_time(hw, s, base_p))
            fill = cross_layer_fill_time(hw, s, p, n_slices=p.n_slices,
                                         training=training)
            return base - fill
        if phase == "train":
            return modeled_step_time(hw, s, p)
        return modeled_plan_time(hw, s, p)
    return measure


def tune_plan(s: MoEShape, hw: Hardware, cache: Optional[PlanCache] = None,
              measure: Optional[Callable[[Plan], float]] = None,
              candidates: Optional[Iterable[Plan]] = None,
              force: bool = False, objective: Optional[str] = None,
              phase: str = "train") -> Plan:
    """Pick the fastest plan for ``s`` on ``hw`` for a latency ``phase``.

    ``measure`` is a callable Plan -> seconds timing a REAL execution (see
    ``make_timing_measure``, which can time a full fwd+bwd); when None the
    analytical model ranks the candidates on the phase objective
    (``phase_measure``: train = fwd+bwd, prefill/decode = fwd-only).
    ``objective`` records what the supplied measure covered — pass "fwd"
    with a forward-only measure so the persisted provenance is truthful;
    None defaults to the phase's objective name. Candidates are legalized
    (``legalize_plan``) before ranking and the winner is stored LEGALIZED
    in ``cache`` (if given) under the phase-qualified
    (M, d, f, E, topk, ep, etp, hw[, phase]) key and returned."""
    assert phase in PLAN_PHASES, phase
    if objective is None:
        objective = PHASE_OBJECTIVES[phase]
    if cache is not None and not force:
        hit = cache.get(s, hw, phase)
        if hit is not None:
            return hit
    cands = list(candidates) if candidates is not None \
        else list(candidate_plans(s, hw=hw))
    # legalize BEFORE ranking so the knobs measured are the knobs that run,
    # then dedupe (legalization can collapse distinct candidates)
    seen = set()
    uniq = []
    for p in cands:
        p = legalize_plan(p, s.N, s.ep)
        k = (p.impl, p.ring_group, p.n_col_blocks, p.gemm_impl,
             p.fused_combine, p.schedule, p.n_slices, p.intra_group,
             p.wire_dtype)
        if k not in seen:
            seen.add(k)
            uniq.append(p)
    cands = uniq
    source = "measured" if measure is not None else "model"
    meas = measure if measure is not None else phase_measure(hw, s, phase)
    best: Optional[Plan] = None
    best_t = math.inf
    failed = []
    for p in cands:
        try:
            t = float(meas(p))
        except Exception as e:            # illegal candidate for this shape
            failed.append((p, e))
            continue
        if t < best_t:
            best, best_t = p, t
    if failed:
        import warnings
        p0, e0 = failed[0]
        warnings.warn(
            f"tune_plan: {len(failed)}/{len(cands)} candidates failed for "
            f"{PlanCache.key(s, hw, phase)} (first: {p0.impl} "
            f"rg{p0.ring_group} nc{p0.n_col_blocks} {p0.gemm_impl}: {e0!r}); "
            "the tuned result only ranks the surviving candidates",
            stacklevel=2)
    if best is None:
        raise RuntimeError(f"no candidate plan measurable for {s}")
    t_bwd = (modeled_plan_time_bwd(hw, s, best)
             if measure is None and phase == "train" else 0.0)
    best = dataclasses.replace(best, measured_s=best_t, source=source,
                               t_bwd_s=t_bwd, objective=objective,
                               phase=phase)
    if cache is not None:
        cache.put(s, hw, best, phase=phase)
    return best


def analytic_plan(s: MoEShape, hw: Hardware, phase: str = "train") -> Plan:
    """Model-ranked plan — what moe_layer falls back to when the configured
    cache file is missing or has no entry for this shape."""
    return tune_plan(s, hw, cache=None, measure=None, phase=phase)


def make_timing_measure(cfg, mcfg, params, x, ctx=None, iters: int = 3,
                        warmup: int = 1,
                        grad: bool = False) -> Callable[[Plan], float]:
    """Timing callback over real executions of the port's ``moe_ffn``.

    Returns measure(plan) -> mean seconds per call of the layer under the
    plan's schedule (impl/ring_group/n_col/gemm backend, carried entirely
    by ``plan.apply``), on the device ``x`` lies on: ``warmup`` calls, then
    ``iters`` calls timed by CUDA events and one synchronize on the card,
    by ``perf_counter`` on the CPU. ``grad=True`` times forward plus
    backward of ``sum(y.float() ** 2) + aux`` with respect to the expert
    weights (the train-phase objective); otherwise the forward runs under
    ``torch.no_grad``. On a ranked ``ctx`` every rank times its own calls
    and the time of each plan is the largest over the world
    (``all_reduce(MAX)``), so every rank ranks the same numbers and picks
    the same plan: ranks running different transports would deadlock in
    their first collective."""
    import time as _time

    from repro_torch.core.moe_layer import moe_ffn  # lazy: it imports us

    experts = {k: v.detach() for k, v in params["experts"].items()}

    def call(m2):
        if not grad:
            with torch.no_grad():
                return moe_ffn(cfg, m2, params, x, ctx)[0]
        ew = {k: v.clone().requires_grad_(True) for k, v in experts.items()}
        y, aux = moe_ffn(cfg, m2, {**params, "experts": ew}, x, ctx)
        loss = (y.float() ** 2).sum() + aux
        torch.autograd.grad(loss, list(ew.values()))
        return loss

    def measure(plan: Plan) -> float:
        m2 = plan.apply(mcfg)
        for _ in range(max(1, warmup)):
            call(m2)
        n = max(1, iters)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                call(m2)
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3 / n
        else:
            t0 = _time.perf_counter()
            for _ in range(n):
                call(m2)
            t = (_time.perf_counter() - t0) / n
        if ctx is not None and ctx.active and ctx.world > 1:
            import torch.distributed as dist
            tt = torch.tensor([t], dtype=torch.float64, device=x.device)
            dist.all_reduce(tt, op=dist.ReduceOp.MAX)
            t = float(tt[0])
        return t

    return measure


# ---------------------------------------------------------------------------
# Plan resolution (moe_layer entry)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _plan_cache_at(path: str, mtime: float) -> PlanCache:
    pc = PlanCache(path if mtime >= 0 else None)
    pc.path = path
    return pc


def load_plan_cache(path: str) -> PlanCache:
    """mtime-memoized cache load; a missing file yields an empty cache (the
    analytical model then supplies plans), and an external rewrite of the
    file is picked up on the next lookup (the mtime is part of the memo
    key, so a stale entry is simply never hit again)."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = -1.0
    return _plan_cache_at(path, mtime)


def plan_lookup_enabled(mcfg) -> bool:
    if getattr(mcfg, "plan_override", False):
        return False
    return bool(getattr(mcfg, "plan_cache", "")
                or os.environ.get("REPRO_PLAN_CACHE", ""))


def resolve_plan(mcfg, d_model: int, tokens_local: int, ep: int, etp: int,
                 hw: Optional[Hardware] = None,
                 phase: Optional[str] = None) -> Optional[Plan]:
    """Schedule lookup for moe_layer. Returns None when plan resolution is
    disabled (no cache configured, or the explicit-override escape hatch is
    set); otherwise the cached plan for this shape and latency phase,
    falling back to the analytical model (phase objective) when the cache
    file or entry is absent. The phase comes from ``phase`` >
    ``mcfg.plan_phase`` > "train" (pre-v4 caches hold only unqualified
    train keys, which keep resolving); the hardware key from ``hw`` >
    ``mcfg.plan_hw`` > $REPRO_PLAN_HW > h100_nvlink (the JAX package's
    last default is tpu_v5e)."""
    if not plan_lookup_enabled(mcfg):
        return None
    if phase is None:
        phase = getattr(mcfg, "plan_phase", "") or "train"
    if hw is None:
        name = getattr(mcfg, "plan_hw", "") \
            or os.environ.get("REPRO_PLAN_HW", "")
        if name and name not in HW:
            import warnings
            warnings.warn(f"unknown plan hardware {name!r} (have "
                          f"{sorted(HW)}); using h100_nvlink — tuned plans "
                          f"for {name!r} will never match", stacklevel=2)
        hw = HW.get(name, H100_NVL)
    path = getattr(mcfg, "plan_cache", "") \
        or os.environ.get("REPRO_PLAN_CACHE", "")
    s = plan_shape(mcfg, d_model, tokens_local, ep, etp)
    cache = load_plan_cache(path)
    plan = cache.get(s, hw, phase)
    if plan is None:
        plan = analytic_plan(s, hw, phase)
        # memoize in the loaded (in-memory) cache only — repeated traces of
        # the same shape must not repeat the candidate search, and a later
        # rewrite of the file invalidates this via the mtime check
        cache.plans[cache.key(s, hw, phase)] = plan
    # pre-v3 (or hand-written) cache entries may carry knobs the transport
    # would silently re-legalize; resolve to the executable schedule HERE so
    # the applied plan and the cost model agree with what runs. Legalized
    # against s.N — the COMBINE width n_col must divide, which is the wire
    # width under BigMac descend-ascend experts, not d_model.
    return legalize_plan(plan, s.N, max(1, ep))
