"""The knee sweep of a rate cell: the highest arrival rate the program
sustains, found once, when the cell is defined.

    python3 portbench/knee.py --workload jamba-serve-poisson \
        --rates 2,3,4,5,6 --seconds 30 --seed 1 [--out file.jsonl]

Runs the cell's open loop (``loops/serve.py``, no correctness check) at
each rate in turn, each from a freshly built engine, and prints one JSON
line a rate: requests due, finished per second, the backlog left queued
at the window's close, the tails. A rate is sustained where at most 2
requests are still waiting for a slot at the close; the knee is the
highest sustained rate.
The cell's traffic file then takes 0.8 of it as a number.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    from portbench import guard, harness
    from portbench.loops import serve
    from portbench.run import _caches
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    guard.install()
    _caches()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    base = harness.load_cell(args.workload)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell.traffic["arrivals"]["rate_per_s"] = rate
        res = serve.run(cell, args.seed, args.seconds, False, "cuda",
                        time.perf_counter(), "rate", check=False)
        d = res["detail"]
        row = {"rate_per_s": rate, **res["end_to_end"], **d,
               "sustained": d["backlog"] <= 2}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        torch.cuda.empty_cache()
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    print(json.dumps({"knee_per_s": max(ok) if ok else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
