"""Discrete-event overlap simulator for one MoE layer (and the e2e model),
a copy of ``repro.analysis.simulator``: pure arithmetic on the
``core/adaptive`` presets, which the cost model of ``modeled_plan_time``
builds on.

Reproduces the paper's evaluation (Figures 1a, 8–14) without GPUs: each
mechanism is a task graph over two device resources (compute engine, link)
plus a host launch thread; the event loop resolves start times from resource
availability and data dependencies. Chunk granularity matches each
mechanism's real schedule:

  megatron_cutlass / megatron_te — serial: a2a → GroupGEMM → a2a; no overlap.
  fastermoe   — pipeline degree 2 (the paper's description of [8]); EP only.
  tutel       — n-chunk 2D-hierarchical a2a pipeline; per-chunk kernels mean
                host scheduling overhead scales with chunks AND experts.
  comet       — the paper: EP source-rank chunks (chunk 0 = local, zero recv
                latency), fused per-chunk MLP, layer-1 N-decomposed into
                n_col blocks whose return traffic starts after the first
                block completes; single fused kernel ⇒ one host launch.
                On GPU hardware, thread-block specialization donates nc/n_sm
                of compute throughput to communication (adaptive); on TPU the
                ICI DMA engines are disjoint so compute is NOT derated — the
                hardware-adaptation note in DESIGN.md.

Host-overhead and efficiency constants are calibrated once against the
paper's Fig. 10/11 operating point (Mixtral 8×7B shapes, EP=8, H100) and then
validated — not re-fit — against the paper's other claims (e2e 1.71×, layer
1.28–2.37×, hiding 86.5%/68.6%/29.2%, L20 1.19–1.46×); see
benchmarks/ + tests/test_simulator.py for the asserted bands.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

# the presets are re-exported, as the JAX simulator's callers import them
from repro_torch.core.adaptive import (H100_CROSSNODE, H100_NVL,  # noqa: F401
                                       L20_PCIE, TPU_V5E, Hardware, MoEShape)

# host-side launch overhead per kernel (CUDA launch + python dispatch); the
# paper attributes FasterMoE/Tutel's small-M losses to this
HOST_LAUNCH_S = 22e-6

# effective fraction of peak link bandwidth achieved by bulk all-to-all with
# per-peer messages in the 1-8 MB range (NCCL on NVLink is far from peak at
# MoE dispatch sizes — this is what makes comm 47% of Fig. 1a despite
# 377 GB/s links). Calibrated once at the Fig. 10/11 operating point.
A2A_EFF = {"h100_nvlink": 0.12, "l20_pcie": 0.45, "tpu_v5e": 0.55,
           "h100_crossnode": 0.3}


def link_rate(hw: Hardware) -> float:
    return hw.link_bw * hw.links * A2A_EFF.get(hw.name, 0.5)


def link_rate_class(hw: Hardware, cls: str) -> float:
    """Effective rate of one link class of an asymmetric topology (same
    per-preset a2a efficiency; the class picks the raw bandwidth). Falls
    back to the flat link_bw where the descriptor leaves a class unset."""
    if cls == "intra":
        bw = hw.intra_bw or hw.link_bw
    else:
        bw = hw.inter_bw or hw.link_bw
    return bw * hw.links * A2A_EFF.get(hw.name, 0.5)


@dataclasses.dataclass
class Timeline:
    """Three-resource event timeline (compute, link, host)."""
    core: float = 0.0
    link: float = 0.0
    host: float = 0.0
    launches: int = 0

    def launch(self, n: int = 1) -> float:
        """Host issues n kernels; returns the time the last is issued."""
        self.host += n * HOST_LAUNCH_S
        self.launches += n
        return self.host

    def compute(self, dur: float, ready: float = 0.0) -> float:
        start = max(self.core, ready)
        self.core = start + dur
        return self.core

    def comm(self, dur: float, ready: float = 0.0) -> float:
        start = max(self.link, ready)
        self.link = start + dur
        return self.link


# ---------------------------------------------------------------------------
# Per-device work for one MoE layer (uniform routing unless imbalance > 0)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerWork:
    rows: float          # expert rows this device computes (M*topk/EP)
    flops_l0: float      # layer-0 GEMM flops (gate+up)
    flops_l1: float      # layer-1 GEMM flops (down)
    disp_bytes: float    # dispatch bytes crossing this device's link
    comb_bytes: float    # combine bytes
    small_rows: float    # rows per expert (tile-efficiency check)


def layer_work(s: MoEShape, imbalance_std: float = 0.0) -> LayerWork:
    W = s.ep * s.etp
    n_mats = 2 if s.glu else 1
    rows = s.M * s.topk / s.ep
    hot = 1.0 + min(2.0, imbalance_std * s.E)      # hottest-rank scaling
    rows *= hot
    k_loc = s.K / s.etp
    flops_l0 = 2.0 * rows * s.N * k_loc * n_mats
    flops_l1 = 2.0 * rows * k_loc * s.N
    remote = (s.ep - 1) / s.ep if s.ep > 1 else 0.0
    disp = s.M / W * s.topk * s.N * s.bytes_per_elt * remote * s.etp * hot
    comb = disp
    if s.etp > 1:
        # ETP adds the partial-output all-reduce over the TP group
        comb += 2.0 * (s.etp - 1) / s.etp * rows * s.N * s.bytes_per_elt \
            / s.etp
    return LayerWork(rows, flops_l0, flops_l1, disp, comb,
                     rows / max(1, s.E / s.ep))


def _eff(hw: Hardware, rows_per_expert: float, k_loc: float = 1e9,
         fragmented: bool = True) -> float:
    """GEMM efficiency: small M-tiles derate everyone; a TP-fragmented K
    (baselines switch weights per small GEMM — paper Fig. 12) derates the
    baselines, while comet's rescheduled GroupGEMM keeps the MXU/tensor-core
    utilization (fragmented=False)."""
    eff = hw.gemm_eff if rows_per_expert >= 128 else \
        hw.gemm_eff * hw.small_tile_penalty
    if fragmented and k_loc < 4096:
        eff *= 0.75
    return eff


def _chunk_rate(hw: Hardware, n_chunks: int) -> float:
    """Chunked a2a sends k× smaller per-peer messages; effective bandwidth
    degrades with chunk count (NCCL latency-bound regime)."""
    return link_rate(hw) / (1.0 + 0.15 * (n_chunks - 1))


# ---------------------------------------------------------------------------
# Mechanisms
# ---------------------------------------------------------------------------


def sim_megatron(hw: Hardware, s: MoEShape, imb: float = 0.0,
                 te: bool = False) -> Dict:
    """Serial, no overlap. TE variant has extra framework call overhead."""
    w = layer_work(s, imb)
    tl = Timeline()
    eff = _eff(hw, w.small_rows, s.K / s.etp)
    # router + permute/indexing kernels
    r = tl.launch(8 + (6 if te else 0))
    t = tl.comm(w.disp_bytes / link_rate(hw), ready=r)
    r = tl.launch(3)
    t = tl.compute(w.flops_l0 / (hw.flops * eff), ready=max(t, r))
    r = tl.launch(2)
    t = tl.compute(w.flops_l1 / (hw.flops * eff), ready=max(t, r))
    r = tl.launch(2)
    t = tl.comm(w.comb_bytes / link_rate(hw), ready=max(t, r))
    r = tl.launch(3)                               # un-permute + topk reduce
    end = max(t, r)
    return {"total": end, "comm": (w.disp_bytes + w.comb_bytes) /
            link_rate(hw), "overlapped": 0.0, "tl": tl}


def sim_pipeline(hw: Hardware, s: MoEShape, n_chunks: int, imb: float = 0.0,
                 launches_per_chunk: int = 8,
                 extra_local_compute: float = 0.0) -> Dict:
    """Coarse-grained k-chunk pipeline (FasterMoE k=2, Tutel k=n): chunked
    a2a and expert compute overlap across chunks; partitioned experts run at
    reduced tile efficiency; each chunk re-launches its kernel set."""
    w = layer_work(s, imb)
    tl = Timeline()
    eff = _eff(hw, w.small_rows / n_chunks, s.K / s.etp)
    # comm kernels on a second stream contend for SMs with the GEMMs
    eff *= 0.9
    rate = _chunk_rate(hw, n_chunks)
    comm_total = 0.0
    recv_done: List[float] = []
    for i in range(n_chunks):
        r = tl.launch(launches_per_chunk // 2)
        d = w.disp_bytes / n_chunks / rate
        recv_done.append(tl.comm(d, ready=r))
        comm_total += d
    mlp_done: List[float] = []
    for i in range(n_chunks):
        r = tl.launch(launches_per_chunk // 2)
        f = (w.flops_l0 + w.flops_l1) / n_chunks / (hw.flops * eff)
        f += extra_local_compute / n_chunks
        mlp_done.append(tl.compute(f, ready=max(recv_done[i], r)))
    end = 0.0
    for i in range(n_chunks):
        d = w.comb_bytes / n_chunks / rate
        end = tl.comm(d, ready=mlp_done[i])
        comm_total += d
    serial_comm = comm_total
    comp_time = (w.flops_l0 + w.flops_l1) / (hw.flops * eff) \
        + extra_local_compute
    # comm hidden = what a fully-serial schedule would add vs what we see
    overlapped = max(0.0, comp_time + serial_comm - end)
    return {"total": end, "comm": serial_comm,
            "overlapped": min(serial_comm, overlapped), "tl": tl}


def sim_fastermoe(hw: Hardware, s: MoEShape, imb: float = 0.0) -> Dict:
    if s.etp > 1:
        raise ValueError("FasterMoE supports expert parallelism only")
    # local indexing extends computation (paper Fig. 11 note)
    w = layer_work(s, imb)
    extra = 0.15 * (w.flops_l0 + w.flops_l1) / (hw.flops * hw.gemm_eff)
    return sim_pipeline(hw, s, n_chunks=2, imb=imb,
                        launches_per_chunk=10 + s.E // 4,
                        extra_local_compute=extra)


def sim_tutel(hw: Hardware, s: MoEShape, imb: float = 0.0) -> Dict:
    # optimized 2D a2a burdens local compute (paper Fig. 11 note)
    w = layer_work(s, imb)
    extra = 0.08 * (w.flops_l0 + w.flops_l1) / (hw.flops * hw.gemm_eff)
    return sim_pipeline(hw, s, n_chunks=4, imb=imb,
                        launches_per_chunk=8 + s.E // 8,
                        extra_local_compute=extra)


def sim_comet(hw: Hardware, s: MoEShape, imb: float = 0.0,
              n_col: int = 0, tpu: bool = False,
              nc_frac: Optional[float] = None) -> Dict:
    """Fine-grained: EP source-rank chunks, local chunk first, fused per-chunk
    MLP, N-decomposed layer-1 with early block return; one fused kernel."""
    w = layer_work(s, imb)
    tl = Timeline()
    ep = max(1, s.ep)
    if n_col <= 0:
        from repro_torch.core.adaptive import choose_n_col
        n_col = choose_n_col(hw, s)
    # GPU: thread-block specialization splits SMs between comm and compute;
    # the adaptive division point balances per-chunk comm and compute.
    if tpu:
        comp_scale, link_scale = 1.0, 1.0
    else:
        if nc_frac is None:
            t_comm = (w.disp_bytes + w.comb_bytes) / link_rate(hw)
            t_comp = (w.flops_l0 + w.flops_l1) / (hw.flops * hw.gemm_eff)
            # donate enough SMs that comm keeps pace, floor/cap for sanity
            nc_frac = min(0.5, max(0.05, t_comm / max(t_comm + t_comp, 1e-12)))
        # GEMM throughput is sublinear in SM count (memory-bound tails), so
        # donating nc_frac of SMs costs ~half of it in GEMM time (Fig. 8's
        # flat region around the optimum)
        comp_scale = 1.0 - 0.5 * nc_frac
        link_scale = 1.0
    # unpartitioned experts + rescheduled GroupGEMM: no fragmentation derate
    eff = _eff(hw, w.small_rows, fragmented=False) * comp_scale
    r = tl.launch(1)                                    # ONE fused kernel
    comm_total = 0.0

    # dispatch: chunk 0 is local; chunks 1..ep-1 stream over the link
    recv_done = [r]
    for i in range(1, ep):
        d = w.disp_bytes / max(1, ep - 1) / (link_rate(hw) * link_scale)
        recv_done.append(tl.comm(d, ready=r))
        comm_total += d
    end = r
    for i in range(ep):
        f0 = w.flops_l0 / ep / (hw.flops * eff)
        t0 = tl.compute(f0, ready=recv_done[i])
        # layer-1 in n_col column blocks; each block returns as produced
        for b in range(n_col):
            f1 = w.flops_l1 / ep / n_col / (hw.flops * eff)
            tb = tl.compute(f1)
            d = w.comb_bytes / ep / n_col / (link_rate(hw) * link_scale)
            end = tl.comm(d, ready=tb)
            comm_total += d
    end = max(end, tl.core)
    comp_time = (w.flops_l0 + w.flops_l1) / (hw.flops * eff)
    overlapped = max(0.0, comp_time + comm_total - end)
    return {"total": end, "comm": comm_total,
            "overlapped": min(comm_total, overlapped), "tl": tl,
            "n_col": n_col}


def sim_comet_hier(hw: Hardware, s: MoEShape, plan, imb: float = 0.0,
                   n_col: int = 0, tpu: bool = False) -> Dict:
    """comet's fine-grained schedule on the two-level ring: each sub-step's
    dispatch/combine hop is priced at its link class (intra vs inter, the
    inter steps front-loaded — core/adaptive.hier_step_order), and the
    wire format shrinks the bytes of both directions. Compute is identical
    to sim_comet: the hierarchy only re-routes traffic."""
    from repro_torch.core import adaptive as A
    w = layer_work(s, imb)
    tl = Timeline()
    ep = max(1, s.ep)
    if n_col <= 0:
        from repro_torch.core.adaptive import choose_n_col
        n_col = choose_n_col(hw, s)
    if tpu:
        comp_scale = 1.0
    else:
        t_comm = (w.disp_bytes + w.comb_bytes) / link_rate(hw)
        t_comp = (w.flops_l0 + w.flops_l1) / (hw.flops * hw.gemm_eff)
        nc_frac = min(0.5, max(0.05, t_comm / max(t_comm + t_comp, 1e-12)))
        comp_scale = 1.0 - 0.5 * nc_frac
    eff = _eff(hw, w.small_rows, fragmented=False) * comp_scale
    classes = A.hier_step_classes(ep, plan.intra_group)
    wire_scale = (A.wire_bytes_per_elt(s, plan.wire_dtype)
                  / s.bytes_per_elt)
    r = tl.launch(1)
    comm_total = 0.0
    recv_done = [r]
    for i in range(1, ep):
        d = (w.disp_bytes * wire_scale / max(1, ep - 1)
             / link_rate_class(hw, classes[i]))
        recv_done.append(tl.comm(d, ready=r))
        comm_total += d
    end = r
    for i in range(ep):
        f0 = w.flops_l0 / ep / (hw.flops * eff)
        tl.compute(f0, ready=recv_done[i])
        for b in range(n_col):
            f1 = w.flops_l1 / ep / n_col / (hw.flops * eff)
            tb = tl.compute(f1)
            if classes[i] == "local":
                continue                      # local chunk: no return hop
            d = (w.comb_bytes * wire_scale / ep / n_col
                 / link_rate_class(hw, classes[i]))
            end = tl.comm(d, ready=tb)
            comm_total += d
    end = max(end, tl.core)
    comp_time = (w.flops_l0 + w.flops_l1) / (hw.flops * eff)
    overlapped = max(0.0, comp_time + comm_total - end)
    return {"total": end, "comm": comm_total,
            "overlapped": min(comm_total, overlapped), "tl": tl,
            "n_col": n_col}


MECHANISMS = {
    "megatron_cutlass": lambda hw, s, imb=0.0: sim_megatron(hw, s, imb),
    "megatron_te": lambda hw, s, imb=0.0: sim_megatron(hw, s, imb, te=True),
    "fastermoe": sim_fastermoe,
    "tutel": sim_tutel,
    "comet": sim_comet,
}


# ---------------------------------------------------------------------------
# e2e model: attention part identical across mechanisms (paper Fig. 9 hatch)
# ---------------------------------------------------------------------------


def attn_time(hw: Hardware, d_model: int, tokens_per_dev: int, tp: int,
              bytes_per_elt: int = 2) -> float:
    """Per-layer non-MoE time: qkvo projections + sdpa + 2 TP all-reduces."""
    f_proj = 2.0 * tokens_per_dev * d_model * d_model * 4 / tp
    f_sdpa = 2.0 * 2.0 * tokens_per_dev * tokens_per_dev * d_model / tp
    t_comp = (f_proj + f_sdpa * 0.25) / (hw.flops * hw.gemm_eff)
    ar = 2 * 2.0 * tokens_per_dev * d_model * bytes_per_elt / \
        link_rate(hw) * (tp - 1) / max(tp, 1)
    return t_comp + (ar if tp > 1 else 0.0)


def sim_e2e(hw: Hardware, mech: str, s: MoEShape, d_model: int,
            n_layers: int, tp_nonmoe: int, imb: float = 0.0,
            tpu: bool = False) -> float:
    W = s.ep * s.etp
    tokens_dev = s.M // W
    ta = attn_time(hw, d_model, tokens_dev * (W // tp_nonmoe), tp_nonmoe)
    fn = MECHANISMS[mech]
    tm = (fn(hw, s, imb, tpu=tpu) if mech == "comet" else fn(hw, s, imb))
    return n_layers * (ta + tm["total"])


def sim_e2e_graph(hw: Hardware, s: MoEShape, plan, d_model: int,
                  n_layers: int, n_slices: int = 2, training: bool = False,
                  scheduled: bool = True) -> float:
    """Whole-graph e2e: ``n_layers`` blocks through the block-schedule IR
    (core/schedule.py) under a comet ``plan``. ``scheduled=False`` is the
    layer-at-a-time per-layer-overlap baseline (same segments, per-block
    barriers, no micro-slicing). Modeled on a two-block window and scaled:
    the schedule is periodic, so per-block steady-state time is what an
    L-layer stack repeats."""
    from repro_torch.core import schedule as SCH   # lazy: an import cycle
    t = SCH.graph_step_time(hw, s, plan, d_model=d_model, n_blocks=2,
                            n_slices=n_slices, training=training,
                            scheduled=scheduled)
    return n_layers * t["total"] / 2.0
