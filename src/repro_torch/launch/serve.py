"""Serving launcher for the port: the continuous-batching engine on one
GPU, random weights from a seed.

  python -m repro_torch.launch.serve --arch qwen2-moe-2.7b --requests 16 \
      --batch 8 --max-seq 1024 --chunk 256 --max-new 32 \
      --gemm-impl pallas_fused
  python -m repro_torch.launch.serve --arch mamba2-780m --max-seq 2048 \
      --prompt-max 1024
  python -m repro_torch.launch.serve --arch qwen2-moe-2.7b --page-size 64 \
      --batch 16 --pages 129

``--gemm-impl`` applies to configs with MoE layers only. ``--plan-cache``
resolves every MoE layer's schedule from a tuned plan cache instead
(``launch/tune.py`` writes one): prefill chunks take its ``prefill``
entries, decode steps its ``decode`` ones, keyed by ``--plan-hw``
(default h100_nvlink). ``--page-size`` > 0 serves from the paged KV cache
(``serving/paged_cache.py``) of ``--pages`` pages counting the null page
(0: parity capacity, every slot able to hold ``--max-seq``); ``--admit-k``
caps the admissions per stacked prefill call (0: every free slot).

Prompt lengths are drawn from [--prompt-min, --prompt-max] by a seeded
numpy RNG. ``--device cpu`` runs on the CPU (small configs only).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-min", type=int, default=64)
    ap.add_argument("--prompt-max", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8, help="decode slots")
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--gemm-impl", default="pallas_fused",
                    choices=("xla", "pallas", "pallas_fused"))
    ap.add_argument("--plan-cache", default=None,
                    help="tuned plan cache (JSON) the MoE layers resolve "
                         "their schedule from")
    ap.add_argument("--plan-hw", default="",
                    help="hardware key for plan lookup (default "
                         "h100_nvlink)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV page length (0 = contiguous cache)")
    ap.add_argument("--pages", type=int, default=0,
                    help="pool size incl. null page (0 = parity)")
    ap.add_argument("--admit-k", type=int, default=0,
                    help="max stacked admissions per step (0 = slots)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.serving import ServeEngine

    cfg = get_config(args.arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, gemm_impl=args.gemm_impl))
    eng = ServeEngine(cfg, max_seq=args.max_seq, batch_size=args.batch,
                      seed=args.seed, chunk=args.chunk, device=args.device,
                      plan_cache=args.plan_cache, plan_hw=args.plan_hw,
                      page_size=args.page_size, n_pages=args.pages,
                      admit_k=args.admit_k)
    prompts = make_trace(cfg.vocab_size, args.requests, args.prompt_min,
                         args.prompt_max, args.seed)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=args.max_new) for p in prompts]
    eng.run()
    if eng.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i, rid in enumerate(rids):
        r = eng.finished[rid]
        tag = "" if r.status.value == "ok" else f"  [{r.status.value}]"
        print(f"req{i} (len {len(prompts[i])}): {r.tokens}{tag}")
    print_engine_summary(eng, prompts, dt)
    return eng


if __name__ == "__main__":
    main()
