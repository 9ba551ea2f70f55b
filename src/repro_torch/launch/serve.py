"""Serving launcher for the port: the continuous-batching engine on one
GPU, random weights from a seed.

  python -m repro_torch.launch.serve --arch qwen2-moe-2.7b --requests 16 \
      --batch 8 --max-seq 1024 --chunk 256 --max-new 32 \
      --gemm-impl pallas_fused
  python -m repro_torch.launch.serve --arch mamba2-780m --max-seq 2048 \
      --prompt-max 1024
  python -m repro_torch.launch.serve --arch qwen2-moe-2.7b --page-size 64 \
      --batch 16 --pages 129
  python -m repro_torch.launch.serve --arch qwen2-moe-2.7b --page-size 64 \
      --pages 129 --chaos 0.02 --snapshot-dir /path/to/snapshots

The engine's flags are ``serving.EngineConfig``'s groups (engine, paging,
robustness, chaos, disagg), the JAX launcher's flag names, with the
port's card defaults (``--max-seq 1024 --batch 8 --chunk 256``).
``--gemm-impl`` applies to configs with MoE layers only. ``--plan-cache``
resolves every MoE layer's schedule from a tuned plan cache instead
(``launch/tune.py`` writes one): prefill chunks take its ``prefill``
entries, decode steps its ``decode`` ones, keyed by ``--plan-hw``
(default h100_nvlink). ``--page-size`` > 0 serves from the paged KV cache
(``serving/paged_cache.py``) of ``--pages`` pages counting the null page
(0: parity capacity, every slot able to hold ``--max-seq``); ``--admit-k``
caps the admissions per stacked prefill call (0: every free slot).
``--chaos`` > 0 injects a seeded fault plan (crashes, NaN rows, latency
spikes) over ``4 * (--max-new + --prompt-max)`` steps with recovery on;
``--snapshot-dir`` makes recovery restore a snapshot instead of
replaying from the start.

``--disagg`` (with ``--page-size``) serves through the router topology
(``serving/disagg.py``): ``--prefill-workers`` prefill workers of
``--prefill-slots`` slots hand each finished prefill over by page
migration to ``--decode-workers`` decode workers of ``--decode-slots``
slots (0: ``--batch``), and the router's summary is printed (handoffs,
pages moved, re-migrations, duplicates dropped, TTFT, per-worker
counters); ``--chaos`` then draws each crash against one worker:

  python -m repro_torch.launch.serve --arch qwen2-moe-2.7b --disagg \
      --page-size 64 --prefill-workers 1 --decode-workers 1 --prefill-slots 4

Prompt lengths are drawn from [--prompt-min, --prompt-max] by a seeded
numpy RNG; under ``--disagg`` from the JAX launcher's mixed trace, 0.5x-2x
of a mean of ``--prompt-max`` / 2. ``--device cpu`` runs on the CPU (small
configs only).

``--trace`` records the program's spans (``repro_torch/tracing.py``) while
the engine runs, and prints for each span name its count, its total host
time and its self time (the total less its children's), then the p50 and p90 of the
engine's admission wait (``Request.admit_t - submit_t``):

  python -m repro_torch.launch.serve --arch jamba-v0.1-52b-smoke --trace
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from collections import Counter

import numpy as np

from repro_torch import tracing


def make_trace(vocab: int, n_req: int, lo: int, hi: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n_req)
    return [rng.integers(1, vocab, size=int(n)).tolist() for n in lens]


def print_engine_summary(eng, prompts, dt):
    n_prefill = sum(len(p) for p in prompts)
    tput = (n_prefill + eng.decode_tokens) / dt
    print(f"{n_prefill} prefill toks + {eng.decode_steps} decode "
          f"steps ({eng.decode_tokens} toks) across {eng.B} slots / "
          f"{len(prompts)} requests in {dt:.2f}s  ({tput:.0f} tok/s)")
    print(f"phase timings: prefill {eng.prefill_s:.2f}s "
          f"({eng.prefill_tokens / max(eng.prefill_s, 1e-9):.0f} tok/s), "
          f"decode {eng.decode_s:.2f}s "
          f"({eng.decode_s / max(eng.decode_steps, 1) * 1e3:.1f} ms/step)")
    if eng.paged:
        print(f"paged cache: page {eng.page_size} toks, "
              f"{eng.n_pages - 1} usable pages "
              f"({eng.free_pages} free after drain), "
              f"{eng.admissions} admissions")
    if eng.faults is not None or eng.failures or eng.expired or \
            eng.quarantined or eng.shed:
        statuses = Counter(r.status.value for r in eng.finished.values())
        print(f"robustness: statuses {dict(statuses)}, "
              f"{eng.failures} step failures / {eng.recoveries} recoveries, "
              f"{eng.quarantined} quarantined, {eng.expired} expired, "
              f"{eng.shed} shed, "
              f"{len(eng.monitor.flagged)} straggler steps")
        if eng.faults is not None:
            print(f"injected: {eng.faults.counts}")


def print_router_summary(router, prompts, dt):
    s = router.summary()
    ec = router.econfig
    total = s["prefill_tokens"] + s["decode_tokens"]
    print(f"disagg: {ec.prefill_workers} prefill x "
          f"{ec.prefill_slots or ec.batch_size} slots -> "
          f"{ec.decode_workers} decode x "
          f"{ec.decode_slots or ec.batch_size} slots, "
          f"page {router.page_size} toks")
    print(f"{s['prefill_tokens']} prefill toks + {s['decode_tokens']} "
          f"decode toks / {len(prompts)} requests in {dt:.2f}s "
          f"({total / dt:.0f} tok/s)")
    print(f"migration: {s['migrations']} handoffs, {s['pages_moved']} "
          f"pages moved, {s['remigrations']} re-migrations, "
          f"{s['duplicate_handoffs']} duplicates dropped")
    ttfts = [r.ttft_s for r in router.finished.values()
             if r.first_token_t > 0]
    if ttfts:
        print(f"ttft: mean {np.mean(ttfts) * 1e3:.1f} ms, "
              f"p99 {np.percentile(ttfts, 99) * 1e3:.1f} ms")
    statuses = Counter(r.status.value for r in router.finished.values())
    print(f"robustness: statuses {dict(statuses)}, "
          f"{s['failures']} worker failures / {s['recoveries']} "
          f"recoveries, {s['quarantined']} quarantined, "
          f"{s['expired']} expired, {s['shed']} shed")
    for name, w in s["per_worker"].items():
        print(f"  {name}: {w}")


def print_admission_wait(finished):
    """p50 and p90 of the engine's wait from a request's submission to the
    start of the stacked call that admitted it (``admit_t - submit_t``),
    over the finished requests that were admitted."""
    waits = [r.admit_t - r.submit_t for r in finished.values()
             if r.admit_t > 0]
    if waits:
        p50, p90 = np.percentile(waits, [50, 90]) * 1e3
        print(f"admission wait: p50 {p50:.2f} ms, p90 {p90:.2f} ms "
              f"({len(waits)} of {len(finished)} requests admitted)")


def main(argv=None, device=None):
    """``device``: where the engine runs (default ``--device``, else
    cuda)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    wl = ap.add_argument_group("workload")
    wl.add_argument("--requests", type=int, default=16)
    wl.add_argument("--max-new", type=int, default=32)
    wl.add_argument("--prompt-min", type=int, default=64)
    wl.add_argument("--prompt-max", type=int, default=512)
    wl.add_argument("--gemm-impl", default="pallas_fused",
                    choices=("xla", "pallas", "pallas_fused"))
    wl.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    wl.add_argument("--trace", action="store_true",
                    help="record the program's spans and print their "
                         "count, total and self time, and the admission "
                         "wait")
    from repro_torch.serving import EngineConfig
    EngineConfig.add_cli_args(ap)
    # the card's defaults (the JAX launcher's are 128, 4 and 16)
    ap.set_defaults(max_seq=1024, batch=8, chunk=256)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, gemm_impl=args.gemm_impl))
    lo, hi = args.prompt_min, args.prompt_max
    if args.disagg:             # the prefill-heavy mix the topology is for
        mean = args.prompt_max // 2
        lo, hi = max(1, mean // 2), 2 * mean
    ec = EngineConfig.from_cli_args(
        args, chaos_horizon=4 * (args.max_new + args.prompt_max))
    if args.chaos > 0:
        print(f"chaos: {ec.make_faults().plan.summary()} over "
              f"{ec.chaos_horizon} steps (seed {args.chaos_seed})")
    eng = ec.build(cfg, device=device or args.device)
    prompts = make_trace(cfg.vocab_size, args.requests, lo, hi, args.seed)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=args.max_new) for p in prompts]
    with tracing.recording() if args.trace else contextlib.nullcontext():
        eng.run()
    if eng.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i, rid in enumerate(rids):
        r = eng.finished[rid]
        tag = "" if r.status.value == "ok" else f"  [{r.status.value}]"
        print(f"req{i} (len {len(prompts[i])}): {r.tokens}{tag}")
    if ec.disagg:
        print_router_summary(eng, prompts, dt)
    else:
        print_engine_summary(eng, prompts, dt)
    if args.trace:
        tracing.print_summary(tracing.drain())
        print_admission_wait(eng.finished)
    return eng


if __name__ == "__main__":
    main()
