"""Device-trace arithmetic: which device kernels belong to which group,
and busy and idle time as the union of the kernels' intervals.

The groups are a frozen copy of ``KERNEL_GROUPS`` in the port's
``analysis/roofline.py``. The idle share departs from that module's
``1 - sum of kernel time / wall`` on purpose: a sum counts twice what runs
at once on two streams (NCCL beside compute), a union does not.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]

# device-kernel name fragments -> group; the first match wins, a name that
# matches none is "other"
KERNEL_GROUPS = (
    ("flash_kernel", "flash_attention"),
    ("flash_hopper_kernel", "flash_attention"),
    ("ssd_kernel", "ssd_forward"),
    ("ssd_hopper_kernel", "ssd_forward"),
    ("rmsnorm_kernel", "rmsnorm"),
    ("fused_mlp_wgrad", "fused_mlp_wgrad"),
    ("wgrad_product", "fused_mlp_wgrad"),
    ("fused_mlp_dgrad", "fused_mlp_dgrad"),
    ("dgrad_product", "fused_mlp_dgrad"),
    ("recompute_kernel", "fused_mlp_recompute"),
    ("fused_mlp", "fused_mlp"),
    ("sum_partials", "fused_mlp_reduce"),
    ("sum_splits", "fused_mlp_reduce"),
    ("grouped_gemm", "grouped_gemm"),
    ("topk_combine", "topk_combine"),
    ("nccl", "nccl"),
    ("gemm", "library_gemm"), ("nvjet", "library_gemm"),
    ("xmma", "library_gemm"), ("cutlass", "library_gemm"),
    ("softmax", "softmax"), ("reduce_kernel", "reductions"),
    ("index", "indexing"), ("scatter", "indexing"), ("gather", "indexing"),
    ("copy", "copies"), ("Cat", "copies"), ("elementwise", "elementwise"),
    ("Memset", "copies"), ("Memcpy", "copies"))

# the port's MoE kernels: the expert MLP forward and backward (with its
# recompute and reduce passes), the GroupGEMM and the top-k combine
MOE_GROUPS = frozenset({"fused_mlp", "fused_mlp_dgrad", "fused_mlp_wgrad",
                        "fused_mlp_recompute", "fused_mlp_reduce",
                        "grouped_gemm", "topk_combine"})


def group_of(name: str) -> str:
    for frag, g in KERNEL_GROUPS:
        if frag in name:
            return g
    return "other"


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged, sorted, disjoint intervals covering the same time."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def clip(intervals: Iterable[Interval], lo: float,
         hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle intervals of [lo, hi] between the merged busy ones."""
    out, t = [], lo
    for s, e in union(clip(busy, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_gaps(idle: Sequence[Interval],
               spans: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each idle interval's time
    goes to the innermost (latest starting) host span that covers each
    part of it, else to "outside any span"."""
    out: Dict[str, float] = {}
    spans = sorted(spans, key=lambda s: s[1])
    for gs, ge in idle:
        cuts = sorted({gs, ge} | {t for _, s, e in spans for t in (s, e)
                                  if gs < t < ge})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            name = "outside any span"
            for n, s, e in spans:
                if s <= mid < e:
                    name = n
            out[name] = out.get(name, 0.0) + (b - a)
    return out


# ---------------------------------------------------------------------------
# Readings of a traced window (the per-layer readers call these)
# ---------------------------------------------------------------------------


def share_of_busy(rec, groups) -> float:
    """The device time of the kernels in ``groups`` (their union) over
    the device's busy time, in %; None where nothing ran."""
    mine = [(s, e) for n, s, e in rec["kernels"] if group_of(n) in groups]
    if not mine or rec["busy_s"] <= 0:
        return None
    return 100.0 * covered(clip(mine, 0.0, rec["window_s"])) / rec["busy_s"]


def idle_percent(rec) -> float:
    if rec["window_s"] <= 0 or not rec["kernels"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def moe_bounds(rec) -> Dict[str, Dict[str, float]]:
    """By MoE kernel: its calls in the window, the mean routed rows an
    expert of its calls, and the sum of their bounds in seconds. Each
    expert-MLP call is priced on its routed rows and the experts they hit
    (``costs.moe_call_bound``); the top-k combine and the GroupGEMM on
    their shapes."""
    from portbench.yardstick import costs
    out: Dict[str, Dict[str, float]] = {}
    for c in rec["calls"]:
        k, sh = c["kernel"], c["shapes"]
        if k in ("fused_mlp", "fused_mlp_dgrad", "fused_mlp_wgrad"):
            d, f, n_out = sh[0][2], sh[2][2], sh[3][2]
            b = costs.moe_call_bound(k, c["rows"], d, f, n_out, c["glu"],
                                     c["itemsize"])
            rows = sum(c["rows"]) / max(1, len(c["rows"]))
        elif k == "topk_combine":
            T, kk, d = sh[0]
            b, rows = costs.topk_combine_cost(T, kk, d, c["itemsize"]
                                              ).bound_s(), 0.0
        elif k == "grouped_gemm":
            E, M, Kd = sh[0]
            b, rows = costs.grouped_gemm_cost(E, M, Kd, sh[1][2],
                                              c["itemsize"]).bound_s(), M
        else:
            continue
        e = out.setdefault(k, {"calls": 0, "rows": 0.0, "bound_s": 0.0})
        e["calls"] += 1
        e["rows"] += rows
        e["bound_s"] += b
    for e in out.values():
        e["rows"] /= e["calls"]
    return out


def moe_device_s(rec) -> Dict[str, float]:
    """Device seconds of each MoE kernel group in the window."""
    out: Dict[str, float] = {}
    for n, s, e in rec["kernels"]:
        g = group_of(n)
        if g in MOE_GROUPS:
            out[g] = out.get(g, 0.0) + (e - s)
    return out


def moe_roofline(rec) -> float:
    """Sum of the MoE calls' bounds (``moe_bounds``) over the device time
    of their kernels, in %."""
    bound = sum(e["bound_s"] for e in moe_bounds(rec).values())
    dev = sum(moe_device_s(rec).values())
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
