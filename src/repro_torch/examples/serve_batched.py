"""Continuous-batching serving example (the port's counterpart of
``examples/serve_batched.py``): requests are SUBMITTED at staggered times
while the engine decodes, late arrivals are admitted into slots freed by
finished requests (chunked prefill into the slot's cache region), and the
decode batch advances every live slot at its own position.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched            # the card
      PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serving import ServeEngine


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m-smoke")
    ap.add_argument("--slots", type=int, default=2,
                    help="decode slots — fewer than requests, so the "
                         "example shows mid-flight slot reuse")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--arrival-every", type=int, default=3,
                    help="submit a new request every N decode steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    print(f"serving {cfg.name} (vocab={cfg.vocab_size}, "
          f"{cfg.param_count()/1e6:.1f}M params) — {args.slots} slots, "
          f"{args.requests} requests, chunked prefill x{args.chunk}")
    eng = ServeEngine(cfg, max_seq=args.max_seq, batch_size=args.slots,
                      chunk=args.chunk, device=args.device)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(4, 17))).tolist()
               for _ in range(args.requests)]

    # staggered arrivals: one new request every --arrival-every decode
    # steps — late requests land in slots freed by earlier ones
    t0 = time.perf_counter()
    submitted = {}
    next_req = 0
    while next_req < len(prompts) or eng.pending:
        # idle gap in the arrival schedule (everything drained before the
        # next threshold): admit the next request now, decode_steps only
        # advances while slots are live
        if next_req < len(prompts) and (
                not eng.pending or eng.decode_steps >=
                next_req * args.arrival_every):
            rid = eng.submit(prompts[next_req], max_new=args.max_new)
            submitted[rid] = next_req
            print(f"  t={eng.decode_steps:3d} steps: submit req{next_req} "
                  f"[{len(prompts[next_req])} toks]")
            next_req += 1
        was = [None if s is None else s.rid for s in eng.slot_req]
        eng.step()
        for slot, req in enumerate(eng.slot_req):
            if req is not None and was[slot] != req.rid:
                reused = " (reused)" if eng.admissions > args.slots else ""
                print(f"  t={eng.decode_steps:3d} steps: "
                      f"req{submitted[req.rid]} -> slot {slot}{reused}")
    dt = time.perf_counter() - t0

    print()
    for rid, req in sorted(eng.finished.items()):
        i = submitted[rid]
        print(f"req{i}: prompt[{len(prompts[i])} toks] -> "
              f"{req.tokens[:8]}...  ttft {req.ttft_s*1e3:.0f}ms")
    tput = (eng.prefill_tokens + eng.decode_tokens) / dt
    print(f"\n{eng.admissions} admissions into {args.slots} slots, "
          f"{eng.prefill_tokens} prefill toks + {eng.decode_steps} decode "
          f"steps in {dt:.2f}s  ({tput:.0f} tok/s on {eng.device}; prefill "
          f"{eng.prefill_s:.2f}s / decode {eng.decode_s:.2f}s)")
    return {"streams": {submitted[rid]: list(req.tokens)
                        for rid, req in eng.finished.items()},
            "admissions": eng.admissions, "prompts": prompts}


if __name__ == "__main__":
    main()
