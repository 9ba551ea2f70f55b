"""Adaptive-plan tuner of the port (the JAX package's ``tools/tune.py``):
fills the JSON plan cache that ``moe_ffn``, the train step and the serving
engine resolve their MoE schedules from. The file format and keys are the
JAX package's, so a cache written here loads there and back.

Two modes:

* model-backed (default) - ranks every candidate plan with the analytical
  cost model (``analysis/simulator.py`` and the HBM terms of
  ``core/adaptive.py``); needs no device. Tunes the paper's three model
  shapes over an M grid, plus the smoke shape.
* ``--measured`` - times the port's ``moe_ffn`` under each candidate and
  caches the fastest: on the card at world 1 (CUDA events), or on
  ``--ranks`` gloo CPU ranks (``--device cpu``; a check of function, not
  of speed: every rank times its own calls, each candidate takes the
  slowest rank's time, and rank 0 alone writes the file).

Usage:
  python -m repro_torch.launch.tune --hw h100_nvlink
  python -m repro_torch.launch.tune --models qwen2-moe-2.7b --phase decode \\
      --decode-M 8 --ep 1 --out plans.json
  python -m repro_torch.launch.tune --measured --arch qwen2-moe-2.7b \\
      --batch 4 --seq 1024 --ep 1 --capacity-factor 1.25 --phase train
  python -m repro_torch.launch.tune --measured --device cpu --ranks 4 \\
      --ep 2 --etp 2

Prints one CSV row per tuned shape (the JAX tuner's columns).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

# the paper's Table 2 models (a copy of the JAX package's
# benchmarks/figures.PAPER_MODELS)
PAPER_MODELS = {
    "mixtral-8x7b": dict(L=32, E=8, topk=2, N=4096, K=14336),
    "qwen2-moe-2.7b": dict(L=24, E=64, topk=4, N=2048, K=1408),
    "phi3.5-moe": dict(L=32, E=16, topk=2, N=4096, K=6400),
}
# the (arch, B, S) of the JAX package's single-device smoke run; its
# plan-shape key is tuned beside the paper's shapes
SMOKE_ARCH = "granite-moe-3b-a800m-smoke"
SMOKE_BATCH_SEQ = (2, 16)
HEADER = ("tag,M,N,K,E,topk,ep,etp,phase,impl,ring_group,n_col,intra_group,"
          "wire,gemm,fused_combine,latency,source")


def plan_row(tag, s, plan) -> str:
    """One CSV row, as the JAX tuner's ``_print_plan`` prints it."""
    sched = f",{plan.schedule}/ns{plan.n_slices}" if plan.schedule else ""
    return (f"{tag},M{s.M},N{s.N},K{s.K},E{s.E},k{s.topk},ep{s.ep},"
            f"etp{s.etp},{plan.phase},{plan.impl},rg{plan.ring_group},"
            f"nc{plan.n_col_blocks},ig{plan.intra_group},{plan.wire_dtype},"
            f"{plan.gemm_impl},fc{int(plan.fused_combine)},"
            f"{plan.measured_s * 1e3:.4f}ms,{plan.source}{sched}")


def _hw_lines() -> str:
    """One line per Hardware preset, topology descriptor included."""
    from repro_torch.core.adaptive import HW
    lines = []
    for name in sorted(HW):
        h = HW[name]
        topo = (f"intra_bw={h.intra_bw / 1e9:.0f}GB/s "
                f"inter_bw={h.inter_bw / 1e9:.0f}GB/s "
                f"intra_group={h.intra_group}"
                if h.intra_group > 1 else "flat")
        lines.append(f"  {name:<16} link_bw={h.link_bw / 1e9:.0f}GB/s "
                     f"hop_latency={h.hop_latency_s * 1e6:.0f}us  {topo}")
    return "\n".join(lines)


def smoke_plan_shapes():
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import plan_shape
    cfg = get_config(SMOKE_ARCH)
    toks = SMOKE_BATCH_SEQ[0] * SMOKE_BATCH_SEQ[1]
    return [("granite-smoke", plan_shape(cfg.moe, cfg.d_model, toks, 1, 1))]


def tune_model_backed(args, hw, cache):
    """Returns the rows printed: (tag, shape, plan) per tuned shape."""
    from repro_torch.core.adaptive import (MoEShape, candidate_plans,
                                           tune_plan)

    # --graph widens the candidate set with whole-graph scheduled variants
    # (schedule="overlap", n_slices 2 and 4) so they rank in the same
    # cache rows as the per-layer plans
    def cands(s):
        return (candidate_plans(s, include_graph=True, hw=hw)
                if args.graph else None)

    models = args.models or list(PAPER_MODELS)
    rows = []
    for phase in args.phase:
        Ms = args.decode_M if phase == "decode" else args.M
        for name in models:
            m = PAPER_MODELS[name]
            for M in Ms:
                s = MoEShape(M=M, N=m["N"], K=m["K"] // max(1, args.etp),
                             E=m["E"], topk=m["topk"], ep=args.ep,
                             etp=args.etp)
                rows.append((name, s, tune_plan(s, hw, cache,
                                                force=args.force,
                                                phase=phase,
                                                candidates=cands(s))))
        if not args.models:
            for tag, s in smoke_plan_shapes():
                rows.append((tag, s, tune_plan(s, hw, cache,
                                               force=args.force,
                                               phase=phase,
                                               candidates=cands(s))))
    return rows


def _layer(args, device):
    """The timed layer: (cfg, mcfg at the tuner's capacity, the router,
    the logical (E, ...) experts, x), seeded, in bf16 on the card and in
    fp32 on the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.common import is_glu
    cfg = get_config(args.arch)
    mcfg = cfg.moe
    if mcfg is None:
        raise SystemExit(f"--measured requires a MoE arch, got {args.arch}")
    E, d, f = mcfg.num_experts, cfg.d_model, mcfg.d_expert
    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def nrm(*shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(dt)

    full = {"w_up": nrm(E, d, f, scale=d ** -0.5),
            "w_down": nrm(E, f, d, scale=f ** -0.5)}
    if is_glu(cfg.activation):
        full["w_gate"] = nrm(E, d, f, scale=d ** -0.5)
    router = nrm(d, E, scale=d ** -0.5)
    x = nrm(args.batch, args.seq, d, scale=1.0)
    # capacity 0 = the expert count, no token dropped: every candidate
    # computes the same work (the JAX tuner's choice)
    cf = args.capacity_factor or float(E)
    return cfg, dataclasses.replace(mcfg, capacity_factor=cf), router, \
        full, x


def tune_measured(args, hw, cache, device, ctx=None):
    """Times the candidates on this process's device (every rank of a
    ranked ``ctx`` calls it alike). Returns ([(tag, shape, plan)], the
    candidates timed: [(plan, seconds or None, the error of a candidate
    that failed)], empty on a cache hit)."""
    from repro_torch.core.adaptive import (candidate_plans,
                                           make_timing_measure, plan_shape,
                                           tune_plan)
    from repro_torch.core.moe_layer import pack_expert_weights
    cfg, mcfg, router, full, x = _layer(args, device)
    ep, etp = (ctx.ep, ctx.etp) if ctx is not None else (1, 1)
    if ctx is not None:
        from repro_torch.parallel import sharding as SH
        experts = SH.shard_experts(ctx, pack_expert_weights(full, ep, etp))
        x, ctx = SH.shard_tokens(ctx, x)
    else:
        experts = {k: v[None] for k, v in full.items()}
    params = {"router": router, "experts": experts}
    phase = args.phase[0]
    fwd_only = args.fwd_only or phase != "train"
    measure = make_timing_measure(cfg, mcfg, params, x, ctx,
                                  iters=args.iters, warmup=1,
                                  grad=not fwd_only)
    # the key's M: this rank's tokens, the JAX package's local_token_count
    s = plan_shape(mcfg, cfg.d_model, x.shape[0] * x.shape[1], ep, etp)
    cands = list(candidate_plans(s, gemm_impls=tuple(args.gemm), hw=hw))
    timed = []

    def recording(plan):
        try:
            t = measure(plan)
        except Exception as e:        # tune_plan warns and skips it
            timed.append((plan, None, f"{type(e).__name__}: {e}"))
            raise
        timed.append((plan, t, ""))
        return t

    plan = tune_plan(s, hw, cache, measure=recording, candidates=cands,
                     force=args.force, phase=phase,
                     objective="fwd" if (args.fwd_only and phase == "train")
                     else None)
    return [(args.arch, s, plan)], timed


def _ranked_main(args_dict) -> int:
    """One gloo rank of ``--measured --ranks N``: a (1, N) mesh with the
    requested (ep, etp); rank 0 alone writes the cache."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.adaptive import HW, PlanCache
    from repro_torch.parallel.mesh import AxisCtx, make_mesh
    args = argparse.Namespace(**args_dict)
    n = dist.get_world_size()
    ctx = AxisCtx(mesh=make_mesh((1, n), ("data", "model")),
                  dp_axes=("data",), model_axis="model", ep=args.ep,
                  etp=args.etp, seq_shard=True)
    cache = PlanCache(args.out)
    if dist.get_rank() != 0:
        cache.path = None             # every rank reads, rank 0 writes
    rows, timed = tune_measured(args, HW[args.hw], cache,
                                torch.device("cpu"), ctx)
    if dist.get_rank() == 0:
        for p, t, err in timed:
            print(f"# timed {p.impl} rg{p.ring_group} nc{p.n_col_blocks} "
                  f"{p.gemm_impl} fc{int(p.fused_combine)} ig{p.intra_group}"
                  f" {p.wire_dtype}: "
                  + (f"{t * 1e3:.3f} ms" if err == "" else f"failed: {err}"),
                  flush=True)
        for row in rows:
            print(plan_row(*row), flush=True)
        cache.save()
        print(f"\nwrote {len(cache.plans)} plans -> {args.out}", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", default="h100_nvlink")
    ap.add_argument("--out", default=None,
                    help="plan-cache path (default plans/<hw>.json)")
    ap.add_argument("--models", nargs="*", default=[],
                    choices=sorted(PAPER_MODELS),
                    help="paper shapes to tune (model mode; default all "
                         "three and the smoke shape)")
    ap.add_argument("--M", type=int, nargs="*", default=[1024, 4096, 16384],
                    help="per-group token counts to tune (model mode)")
    ap.add_argument("--phase", nargs="*", default=["train"],
                    choices=["train", "prefill", "decode"],
                    help="latency phases; train ranks fwd+bwd, "
                         "prefill/decode forward only. --measured uses the "
                         "first entry")
    ap.add_argument("--decode-M", type=int, nargs="*",
                    default=[8, 32, 128, 512],
                    help="token counts for the decode phase (model mode)")
    ap.add_argument("--ep", type=int, default=0,
                    help="default 8 in model mode, the ranks / --etp "
                         "measured")
    ap.add_argument("--etp", type=int, default=1)
    ap.add_argument("--force", action="store_true",
                    help="re-tune even on a cache hit")
    ap.add_argument("--graph", action="store_true",
                    help="also rank whole-graph block-schedule candidates "
                         "(schedule=overlap, micro-sliced) against the "
                         "per-layer plans (model mode)")
    ap.add_argument("--measured", action="store_true",
                    help="time real executions instead of the cost model")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="--measured: the card (world 1) or gloo CPU ranks")
    ap.add_argument("--ranks", type=int, default=1,
                    help="--measured --device cpu: gloo ranks (ep x etp)")
    ap.add_argument("--arch", default="granite-moe-3b-a800m-smoke",
                    help="MoE arch to time (--measured)")
    ap.add_argument("--capacity-factor", type=float, default=0.0,
                    help="--measured: 0 = the expert count (no drop)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--fwd-only", action="store_true",
                    help="time only the forward (--measured)")
    ap.add_argument("--gemm", nargs="*", default=["xla", "pallas_fused"],
                    choices=["xla", "pallas", "pallas_fused"],
                    help="GroupGEMM backends to search (--measured)")
    return ap


def main(argv=None):
    """Returns {"rows": [(tag, shape, plan)] printed, "timed": the
    candidates of a measured run (``tune_measured``)}; a ranked run's
    ranks print its rows."""
    args = build_parser().parse_args(argv)
    from repro_torch.core.adaptive import HW, PlanCache
    if args.hw not in HW:
        raise SystemExit(f"unknown --hw {args.hw!r}; available Hardware "
                         f"presets:\n" + _hw_lines())
    hw = HW[args.hw]
    args.out = args.out or os.path.join("plans", f"{args.hw}.json")
    if not args.measured:
        args.ep = args.ep or 8
    else:
        n = args.ranks if args.device == "cpu" else 1
        args.ep = args.ep or max(1, n // args.etp)
        if args.ep * args.etp != n:
            raise SystemExit(f"--ep {args.ep} x --etp {args.etp} must be "
                             f"the {n} rank(s) (the card runs world 1; "
                             f"--ranks N runs gloo CPU ranks)")
    print(HEADER, flush=True)
    if args.measured and n > 1:
        from repro_torch.launch.selftest import spawn
        spawn(n, _ranked_main, (vars(args),), device="cpu", timeout=600.0)
        return {"rows": [], "timed": []}
    timed = []
    cache = PlanCache(args.out)
    if args.measured:
        from repro_torch.device import resolve_device
        rows, timed = tune_measured(args, hw, cache,
                                    resolve_device(args.device))
    else:
        rows = tune_model_backed(args, hw, cache)
    for row in rows:
        print(plan_row(*row))
    cache.save()
    print(f"\nwrote {len(cache.plans)} plans -> {args.out}")
    return {"rows": rows, "timed": timed}


if __name__ == "__main__":
    main()
    sys.exit(0)
