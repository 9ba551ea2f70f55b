"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for. Prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit (also the last lines of
standard error). Exits non-zero without a result line where there is no
CUDA device or too few, where the program cannot be imported, or where
JAX or the JAX package was loaded. ``--control 1`` adds the reference in
fp8 (the control of the check's limits) and prints its readings too;
``--fault <name>`` plants one of ``faults.py``'s faults. Both serve the
setting of the limits and no measured run.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import guard  # noqa: E402

CACHE = REPO / ".bench_cache"


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc build lives in ``src/repro_torch/kernels/
    build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1))
    ap.add_argument("--fault", default="",
                    help="plant a fault of faults.py (limit setting only)")
    args = ap.parse_args(argv)
    guard.install()
    guard.check_reference()
    _caches()
    from portbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program must be there)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = harness.loop_module(cell.spec["loop"])
    fault = None
    if args.fault:
        from portbench import faults
        fault = {**faults.TRAIN, **faults.SERVE}[args.fault]
    res = loop.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START, fault=fault, control=bool(args.control))
    return emit(cell, res, bool(args.trace))


def emit(cell, res, trace: bool, device: str = "cuda") -> int:
    from portbench import harness
    bad = guard.loaded()
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 3
    if trace:
        metrics = harness.per_layer_values(cell, res["record"])
    else:
        metrics = {m["name"]: {"value": res["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = harness.device_info(device, cell.chips, res["peak_bytes"])
    if trace:
        dev["busy_s"] = res["record"]["busy_s"]
        dev["window_s"] = res["record"]["window_s"]
    print(json.dumps(harness.finite({"detail": res.get("detail"),
                                     "control": res.get("control"),
                                     "moe": res.get("moe")})),
          file=sys.stderr)
    harness.print_checks(res["checks"])
    print(harness.result_line(
        res["correct"], res["attempted"], res["failed"], metrics, dev,
        res["checks"], res.get("breakdown") if trace else None,
        res.get("control")))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
