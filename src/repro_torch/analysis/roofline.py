"""Roofline terms of one step on an H100 (the port's counterpart of
``repro.analysis.roofline``).

Three terms per (arch x shape x mesh), all in seconds a step a device:

  compute    = product FLOPs / peak FLOP/s     (bf16 products at the
               tensor-core rate, fp32 products at the fp32 rate: TF32 is
               off, ``device.resolve_device``)
  memory     = bytes / HBM bandwidth
  collective = ring-model link bytes / link bandwidth

The JAX module reads them from XLA's ``cost_analysis()`` and the compiled
HLO text. The port has no HLO: its counts come from
``analysis/op_cost.count_cost``, a dispatch mode that prices each aten op,
each ``c10d`` collective and each kernel region of ``kernels/ops.py`` as
the step runs (on the card, on the CPU, or on ``meta`` tensors in the dry
run). A kernel region is priced by its cost function below: the bytes a
call must move (each operand read once, each output written once) and the
operations it does. ``chip_smoke.py`` takes each kernel's bound from the
same functions, so the bound column and the counter cannot drift apart.

``analyze`` turns a count into the report; given a ``torch.profiler``
trace of the same step (``device_time_by_name``) it adds the wall and
device time, the idle share, the device time by kernel group and the
model FLOPs utilisation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.adaptive import H100_NVL

# NVIDIA H100 SXM data-sheet peaks: dense bf16 tensor-core and fp32 rates,
# HBM3 bandwidth and size (at the full 700 W power limit)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BW = 3.35e12                 # bytes/s
HBM_BYTES = 80e9                 # one card's device memory
LINK_BW = H100_NVL.link_bw       # bytes/s per NVLink link and direction

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute",
                    "collective-broadcast")


def collective_traffic(op: str, operand_bytes: float,
                       group_size: int) -> float:
    """Ring-model bytes one rank sends for a collective over ``group_size``
    ranks on ``operand_bytes`` (``repro/analysis/roofline.py:93-102``):
    all-reduce 2(n-1)/n B, all-gather (n-1) B (the operand is the local
    shard), reduce-scatter and all-to-all (n-1)/n B, a permute or a
    broadcast B."""
    n = max(1, int(group_size))
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * operand_bytes
    if op == "all-gather":
        return float((n - 1) * operand_bytes)
    if op in ("reduce-scatter", "all-to-all"):
        return (n - 1) / n * operand_bytes
    if op in ("collective-permute", "collective-broadcast"):
        return float(operand_bytes)
    raise ValueError(f"unknown collective {op!r}; have {COLLECTIVE_KINDS}")


# ---------------------------------------------------------------------------
# Arch-level terms (exact ports of the JAX module's)
# ---------------------------------------------------------------------------


def flash_kernel_bytes(cfg, shape) -> float:
    """Analytic GLOBAL HBM boundary traffic of the attention regions tagged
    ``__fusable__flash`` (whose internals the HLO byte count skips — on the
    TPU target they run as the Pallas flash kernel with scores in VMEM).

    Per attention layer, fwd = read q + read k,v + write o; train adds the
    remat re-forward (×1) and the backward (reads q,k,v,o,do; writes
    dq,dk,dv ≈ ×2 fwd), total ×4. Decode reads the full KV cache per token.
    """
    if cfg.attn is None:
        return 0.0
    a = cfg.attn
    dt = 2 if "16" in cfg.compute_dtype else 4
    Bsz, S = shape.global_batch, shape.seq_len

    def layer_io(Tq, Tk):
        return dt * (2 * Tq * a.n_heads * a.head_dim
                     + 2 * Tk * a.n_kv_heads * a.head_dim)

    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "a")
    factor = 4.0 if shape.kind == "train" else 1.0
    if shape.kind == "decode":
        # q/o negligible; read whole cache per token per layer
        per_layer = dt * 2 * Bsz * S * a.n_kv_heads * a.head_dim
        total = n_attn * per_layer
        if cfg.n_enc_layers:
            total += cfg.n_layers * dt * 2 * Bsz * 4096 * a.n_kv_heads * a.head_dim
        return total
    total = n_attn * layer_io(Bsz * S, Bsz * S) * factor
    if cfg.n_enc_layers:                      # whisper: encoder + cross attn
        Sd = max(64, S // 4)
        total = cfg.n_layers * layer_io(Bsz * Sd, Bsz * Sd) * factor     # dec self
        total += cfg.n_layers * layer_io(Bsz * Sd, Bsz * S) * factor    # cross
        total += cfg.n_enc_layers * layer_io(Bsz * S, Bsz * S) * factor  # enc
    return total


def ssd_kernel_bytes(cfg, shape) -> float:
    """Analytic GLOBAL boundary traffic of ``__fusable__ssd`` regions (the
    Pallas SSD kernel: read x, dt, B, C; write y; chunk internals in VMEM).
    Same train ×4 factor (fwd + remat + bwd≈2) as the flash model."""
    if cfg.ssm is None:
        return 0.0
    s = cfg.ssm
    dt = 2 if "16" in cfg.compute_dtype else 4
    Bsz, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return 0.0                      # decode path is the O(1) recurrence
    d_in = s.expand * cfg.d_model
    n_ssm = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "m")
    per_layer = dt * Bsz * S * (2 * d_in + 2 * s.d_state + d_in // s.head_dim)
    factor = 4.0 if shape.kind == "train" else 1.0
    return n_ssm * per_layer * factor


def model_flops(cfg, shape) -> float:
    """6·N_active·D for train; 2·N_active·D for inference."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# Per-kernel cost: the bytes a call must move and the operations it does
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One kernel call: ``bytes`` (each operand read once, each output
    written once), ``flops`` and the rate they run at (``peak``: "bf16" the
    tensor cores, "fp32" the fp32 units); ``products``: the FLOPs are matrix
    products (the compute term counts them), else elementwise work."""
    bytes: float
    flops: float
    peak: str
    products: bool = True

    def bound_s(self) -> Tuple[float, str]:
        """The least time the card takes for the call, and what bounds it:
        max(bytes / HBM bandwidth, FLOPs / the peak of their type)."""
        t_bytes = self.bytes / HBM_BW
        t_ops = self.flops / PEAK_FLOPS[self.peak]
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


def _peak(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "fp32"


def fused_mlp_cost(E: int, R: int, d: int, f: int, n_out: int,
                   glu: bool = True, itemsize: int = 2) -> KernelCost:
    """The fused expert MLP, per expert act(x Wg, x Wu) Wd over R rows:
    x, the weights and y once; 2 R d f per up product, 2 R f n_out down."""
    n_w1 = 2 if glu else 1
    nbytes = (E * R * d + n_w1 * E * d * f + E * f * n_out
              + E * R * n_out) * itemsize
    flops = 2 * E * R * d * f * n_w1 + 2 * E * R * f * n_out
    return KernelCost(nbytes, flops, _peak(itemsize))


def fused_mlp_bwd_cost(kernel: str, E: int, R: int, d: int, f: int,
                       n_out: int, glu: bool = True,
                       itemsize: int = 2) -> KernelCost:
    """``fused_mlp_dgrad`` (dX) or ``fused_mlp_wgrad`` (dWg, dWu, dWd) for
    the cotangent dy of ``n_out`` output columns: operands read once and
    outputs written once; the FLOPs count the recompute of the hidden that
    the interface forces."""
    if kernel not in ("fused_mlp_dgrad", "fused_mlp_wgrad"):
        raise ValueError(f"not a backward kernel: {kernel!r}")
    n_w1 = 2 if glu else 1
    dgrad = kernel == "fused_mlp_dgrad"
    ins = E * R * d + n_w1 * E * d * f + E * f * n_out + E * R * n_out
    outs = E * R * d if dgrad else n_w1 * E * d * f + E * f * n_out
    flops = (2 * E * R * f * (2 * n_w1 * d + n_out) if dgrad
             else 2 * E * R * f * (2 * n_w1 * d + 2 * n_out))
    return KernelCost((ins + outs) * itemsize, flops, _peak(itemsize))


def grouped_gemm_cost(E: int, M: int, K: int, N: int,
                      itemsize: int = 2) -> KernelCost:
    """(E, M, K) x (E, K, N): both operands and the product once."""
    return KernelCost((E * M * K + E * K * N + E * M * N) * itemsize,
                      2 * E * M * K * N, _peak(itemsize))


def topk_combine_cost(T: int, k: int, d: int, itemsize: int = 2,
                      w_itemsize: int = 4) -> KernelCost:
    """The weighted sum of each token's k rows: rows, weights and the
    output once; one multiply-add a row element (elementwise, not a
    product: the compute term leaves it out)."""
    return KernelCost(T * k * d * itemsize + T * k * w_itemsize
                      + T * d * itemsize, 2 * T * k * d, _peak(itemsize),
                      products=False)


def flash_cost(B: int, Hq: int, Hkv: int, S: int, Sk: int, hd: int,
               causal: bool = True, itemsize: int = 2) -> KernelCost:
    """Attention of (B, Hq, S, hd) queries over (B, Hkv, Sk, hd) keys and
    values: q, k, v and o once; QK^T and PV over the (causal: S(S+1)/2)
    query-key pairs."""
    pairs = S * (S + 1) // 2 if causal else S * Sk
    nbytes = (2 * B * Hq * S * hd + 2 * B * Hkv * Sk * hd) * itemsize
    return KernelCost(nbytes, 2 * 2 * B * Hq * pairs * hd, _peak(itemsize))


def ssd_cost(B: int, S: int, nh: int, hd: int, ds: int, itemsize: int = 2,
             h0: bool = False, final: bool = False,
             tensor_cores: bool = False) -> KernelCost:
    """The Mamba-2 chunked SSD at the kernels' chunk Q (``ssd.CHUNK``): x,
    B, C, dt, A, D and y once, the fp32 state read (``h0``) and written
    (``final``). FLOPs per (batch, chunk) C B^T (shared by the heads), per
    (batch, head, chunk) the (Q, Q) (Q, hd) product and the two (Q, ds)
    (ds, hd) state products: fp32 on the general path; on the tensor-core
    path (``ssd.hopper_path``) C B^T of exact bf16 products and the other
    three once per bf16 term of their fp32 operand (``ssd.HOPPER_TERMS``)."""
    from repro_torch.kernels import ssd
    nbytes = (2 * B * S * nh * hd + 2 * B * S * ds) * itemsize \
        + B * S * nh * 4 + 2 * nh * 4
    if h0:
        nbytes += B * nh * ds * hd * 4
    if final:
        nbytes += B * nh * ds * hd * 4
    Q = ssd.CHUNK
    nc = -(-S // Q)
    cb = 2 * B * nc * Q * Q * ds
    rest = B * nh * nc * (2 * Q * Q * hd + 2 * 2 * Q * ds * hd)
    if tensor_cores:
        return KernelCost(nbytes, cb + ssd.HOPPER_TERMS * rest, "bf16")
    return KernelCost(nbytes, cb + rest, "fp32")


def rmsnorm_cost(T: int, d: int, itemsize: int = 2) -> KernelCost:
    """RMSNorm of (T, d): x read and y written once, the fp32 scale once;
    square, sum, normalise, scale in fp32 (elementwise)."""
    return KernelCost(2 * T * d * itemsize + d * 4, 4 * T * d, "fp32",
                      products=False)


def split3_cost(n: int) -> KernelCost:
    """The three-piece bf16 split of n fp32 values: each read once (4
    bytes) and its three pieces written once (6 bytes); two fp32
    differences a value (elementwise)."""
    return KernelCost(10 * n, 2 * n, "fp32", products=False)


def region_cost(kernel: str, *operands) -> KernelCost:
    """The cost of one ``kernels/ops.py`` call of ``kernel`` from the
    operands it was given (tensors, or None where absent), as
    ``op_cost.count_cost`` prices the region: the same on CPU, CUDA and
    ``meta`` tensors (the SSD's path from ``ssd.hopper_path``, which reads
    only dtypes, shapes, strides and the base's alignment)."""
    if kernel == "fused_mlp":
        rows, w_gate, w_up, w_down = operands
        E, R, d = rows.shape
        return fused_mlp_cost(E, R, d, w_up.shape[2], w_down.shape[2],
                              w_gate is not None, rows.element_size())
    if kernel in ("fused_mlp_dgrad", "fused_mlp_wgrad"):
        rows, w_gate, w_up, w_down, _ = operands
        E, R, d = rows.shape
        return fused_mlp_bwd_cost(kernel, E, R, d, w_up.shape[2],
                                  w_down.shape[2], w_gate is not None,
                                  rows.element_size())
    if kernel == "grouped_gemm":
        lhs, rhs = operands
        E, M, K = lhs.shape
        return grouped_gemm_cost(E, M, K, rhs.shape[2], lhs.element_size())
    if kernel == "topk_combine":
        rows, w = operands
        T, k, d = rows.shape
        return topk_combine_cost(T, k, d, rows.element_size(),
                                 w.element_size())
    if kernel == "flash_attention":
        q, k, _, causal = operands
        B, Hq, S, hd = q.shape
        return flash_cost(B, Hq, k.shape[1], S, k.shape[2], hd, causal,
                          q.element_size())
    if kernel == "ssd_forward":
        from repro_torch.kernels import ssd
        x, dt, A, Bm, Cm, D, h0, final = operands
        B, S, nh, hd = x.shape
        return ssd_cost(B, S, nh, hd, Bm.shape[-1], x.element_size(),
                        h0 is not None, final,
                        ssd.hopper_path(x, dt, A, Bm, Cm, D, h0))
    if kernel == "rmsnorm":
        x, _ = operands
        return rmsnorm_cost(x.numel() // x.shape[-1], x.shape[-1],
                            x.element_size())
    if kernel == "split3":
        g, = operands
        return split3_cost(g.numel())
    raise ValueError(f"no cost function for kernel {kernel!r}")


# ---------------------------------------------------------------------------
# Device time by kernel group (torch.profiler)
# ---------------------------------------------------------------------------

# device-kernel name fragments -> the group a profile sums them into (the
# first match wins; names matching none are "other")
KERNEL_GROUPS = (
    ("flash_kernel", "flash_attention kernel"),
    ("flash_hopper_kernel", "flash_attention kernel"),
    ("ssd_kernel", "ssd_forward kernel"),
    ("ssd_hopper_kernel", "ssd_forward kernel"),
    ("rmsnorm_kernel", "rmsnorm kernel"),
    ("fused_mlp_wgrad", "fused_mlp_wgrad kernel"),
    ("wgrad_product", "fused_mlp_wgrad kernel"),
    ("fused_mlp_dgrad", "fused_mlp_dgrad kernel"),
    ("dgrad_product", "fused_mlp_dgrad kernel"),
    # the wgmma dgrad's and wgrad's shared first launch
    ("recompute_kernel", "fused_mlp backward recompute"),
    ("fused_mlp", "fused_mlp kernel"),
    ("sum_partials", "fused_mlp reduce pass"),
    ("sum_splits", "fused_mlp reduce pass"),
    ("topk_combine", "topk_combine kernel"),
    ("split3", "head split kernel"),
    ("gemm", "library GEMMs"), ("nvjet", "library GEMMs"),
    ("xmma", "library GEMMs"), ("cutlass", "library GEMMs"),
    ("softmax", "softmax"), ("reduce_kernel", "reductions"),
    ("index", "indexing"), ("scatter", "indexing"), ("gather", "indexing"),
    ("copy", "copies and casts"), ("Cat", "copies and casts"),
    ("elementwise", "elementwise"), ("Memset", "copies and casts"),
    ("Memcpy", "copies and casts"))


def device_time_by_name(prof, wall: float) -> Dict:
    """Sum the device kernels and copies of a ``torch.profiler`` profile by
    name: wall and device ms (``wall`` in seconds), idle share, the top 20
    names and the sums by group (``KERNEL_GROUPS``)."""
    import torch
    by_name: Dict[str, Tuple[float, int]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    dev_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    groups: Dict[str, Tuple[float, int]] = {}
    for name, (ms, n) in by_name.items():
        g = next((g for frag, g in KERNEL_GROUPS if frag in name), "other")
        gms, gn = groups.get(g, (0.0, 0))
        groups[g] = (gms + ms, gn + n)
    return {"wall_ms": wall * 1e3, "device_ms": dev_ms,
            "idle_share": max(0.0, 1 - dev_ms / (wall * 1e3)),
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, (ms, n) in top],
            "groups": {g: {"ms": ms, "calls": n} for g, (ms, n) in
                       sorted(groups.items(), key=lambda kv: -kv[1][0])}}


# ---------------------------------------------------------------------------
# The report of one counted step
# ---------------------------------------------------------------------------


def analyze(cost, n_chips: int, cfg=None, shape=None,
            profile: Optional[Dict] = None) -> Dict:
    """Roofline terms of one step from its ``op_cost.Cost`` (per device:
    the count of one rank). The keys of the JAX report, ``hlo_`` read as
    ``op_``. With ``cfg`` and ``shape``, the model FLOPs and the share of
    the roofline they reach; with a ``profile`` (``device_time_by_name``
    of the same step), the measured wall and device ms, the idle share,
    device ms by kernel group and ``mfu``: model FLOPs a device a second
    of wall time over the bf16 peak."""
    t_compute = sum(f / PEAK_FLOPS[dt] for dt, f in cost.mxu_by_dtype.items())
    t_memory = cost.bytes / HBM_BW
    t_coll = cost.ici_bytes / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    report = {
        "n_chips": n_chips,
        "op_flops_per_device": cost.flops,
        "op_mxu_flops_per_device": cost.mxu_flops,
        "op_mxu_flops_by_dtype": dict(cost.mxu_by_dtype),
        "op_bytes_per_device": cost.bytes,
        "collective_bytes_per_device": cost.ici_bytes,
        "collective_per_op": dict(cost.coll_per_op),
        "collective_counts": {k: int(v) for k, v in cost.coll_counts.items()},
        "regions": {k: dict(v) for k, v in cost.regions.items()},
        "peak_temp_bytes": cost.peak_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_time_s": max(terms.values()),
    }
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        report["model_flops_global"] = mf
        report["model_flops_per_device"] = mf / n_chips
        report["useful_flops_ratio"] = (mf / n_chips) / max(cost.flops, 1.0)
        # useful model FLOPs per device over the bf16 peak, relative to the
        # step's bound time: how close to its roofline the step could run
        report["roofline_fraction"] = (
            (mf / n_chips / PEAK_FLOPS["bf16"])
            / max(max(terms.values()), 1e-30))
    if profile is not None:
        wall_s = profile["wall_ms"] / 1e3
        report.update(wall_ms=profile["wall_ms"],
                      device_ms=profile["device_ms"],
                      idle_share=profile["idle_share"],
                      device_ms_by_group={g: r["ms"] for g, r in
                                          profile["groups"].items()})
        if "model_flops_per_device" in report:
            report["mfu"] = (report["model_flops_per_device"] / wall_s
                             / PEAK_FLOPS["bf16"])
    return report


def fmt_report(name: str, r: Dict) -> str:
    lines = [f"== {name} ==",
             f"  chips={r['n_chips']} "
             f"FLOPs/dev={r['op_flops_per_device']:.3e} "
             f"bytes/dev={r['op_bytes_per_device']:.3e} "
             f"ici/dev={r['collective_bytes_per_device']:.3e}",
             f"  t_compute={r['t_compute_s']*1e3:.2f}ms "
             f"t_memory={r['t_memory_s']*1e3:.2f}ms "
             f"t_collective={r['t_collective_s']*1e3:.2f}ms "
             f"-> dominant: {r['dominant']}"]
    if "useful_flops_ratio" in r:
        lines.append(f"  model/op flops={r['useful_flops_ratio']:.3f} "
                     f"roofline_fraction={r['roofline_fraction']:.3f}")
    if r.get("collective_per_op"):
        per = ", ".join(f"{k}:{v/1e6:.1f}MB×{r['collective_counts'][k]}"
                        for k, v in sorted(r["collective_per_op"].items()))
        lines.append(f"  collectives: {per}")
    if r.get("regions"):
        per = ", ".join(f"{k}×{int(v['calls'])}"
                        for k, v in sorted(r["regions"].items()))
        lines.append(f"  kernel regions: {per}")
    if "wall_ms" in r:
        lines.append(f"  wall={r['wall_ms']:.1f}ms device={r['device_ms']:.1f}ms "
                     f"idle={r['idle_share']:.3f} "
                     f"bound/wall={r['bound_time_s']*1e3/r['wall_ms']:.3f}"
                     + (f" mfu={r['mfu']:.4f}" if "mfu" in r else ""))
    mem = r.get("memory")
    if mem:
        lines.append("  mem/dev: args={:.2f}GB temp={:.2f}GB fits={}".format(
            mem["argument_bytes"] / 1e9, mem["peak_temp_bytes"] / 1e9,
            mem["fits"]))
    return "\n".join(lines)
