"""The dry-run and roofline tables from the dry run's JSON reports (the
port's counterpart of ``tools/make_experiments.py``).

Reads the ``<arch>_<shape>_<chips>_<impl>.json`` reports that
``python -m repro_torch.launch.dryrun --out DIR`` writes, and writes
three markdown tables: the single-pod and the multi-pod dry run (FLOPs,
bytes and collective bytes a device, this rank's arguments and peak
temporaries in GB (1e9), whether they fit one H100's 80 GB, the
collectives by kind) and the single pod's roofline terms with the next
lever for the dominant one. The JAX report's ``hlo_`` keys are the
port's ``op_``, its ``memory_analysis`` the port's ``memory``; the
roofline terms are priced with the H100 constants of
``analysis/roofline.py``. A skipped cell gets a row that says why.

Usage:
  python -m repro_torch.analysis.make_experiments [--dryrun DIR] \\
      [--multipod DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.configs import LM_SHAPES

NEXT_STEP = {
    "compute": "raise per-chip batch or quantize (compute-bound: healthy)",
    "memory": "cut activation/weight re-reads (remat policy, ring_group, "
              "SP residual) or fuse kernels",
    "collective": "coarser grad-sync (accum), head-aligned TP sharding, or "
                  "comet overlap absorbs it at the schedule level",
}


def load(d):
    """{(arch, shape): report} of the reports in directory ``d``."""
    rows = {}
    for fn in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        parts = os.path.basename(fn)[:-5].split("_")
        arch_shape = "_".join(parts[:-2])       # <arch>_<shape>_<chips>_<impl>
        for sh in LM_SHAPES:
            if arch_shape.endswith("_" + sh):
                rows[(arch_shape[: -len(sh) - 1], sh)] = r
                break
    return rows


def fmt_s(x):
    return f"{x*1e3:.1f}"


def _skipped(r) -> str:
    return f"skipped: {r.get('reason', '')[:60]}"


def roofline_table(rows, caption):
    out = [f"\n### {caption}\n",
           "| arch | shape | impl | t_comp ms | t_mem ms | t_coll ms | "
           "dominant | 6ND/op | roofline frac | next lever |",
           "|---|---|---|---:|---:|---:|---|---:|---:|---|"]
    for (arch, sh), r in sorted(rows.items()):
        if r.get("status") == "skipped":
            out.append(f"| {arch} | {sh} | {r.get('impl', '-')} | "
                       f"{_skipped(r)} | | | | | | |")
            continue
        out.append(
            f"| {arch} | {sh} | {r.get('impl','-')} | "
            f"{fmt_s(r['t_compute_s'])} | {fmt_s(r['t_memory_s'])} | "
            f"{fmt_s(r['t_collective_s'])} | {r['dominant']} | "
            f"{r.get('useful_flops_ratio', 0):.2f} | "
            f"{r.get('roofline_fraction', 0):.4f} | "
            f"{NEXT_STEP[r['dominant']][:58]} |")
    return "\n".join(out)


def dryrun_table(rows, caption):
    out = [f"\n### {caption}\n",
           "| arch | shape | chips | FLOPs/dev | HBM bytes/dev | collective "
           "bytes/dev | args GB | temp GB | fits H100 80 GB | collectives |",
           "|---|---|---:|---:|---:|---:|---:|---:|---|---|"]
    for (arch, sh), r in sorted(rows.items()):
        if r.get("status") == "skipped":
            out.append(f"| {arch} | {sh} | {r.get('n_chips', '-')} | "
                       f"{_skipped(r)} | | | | | | |")
            continue
        mem = r.get("memory", {})
        args = mem.get("argument_bytes", 0) / 1e9
        temp = mem.get("peak_temp_bytes", 0) / 1e9
        fits = "yes" if mem.get("fits") else "NO"
        cc = r.get("collective_counts", {})
        cstr = " ".join(f"{k.replace('all-','a')[:7]}:{v}"
                        for k, v in sorted(cc.items()))
        out.append(
            f"| {arch} | {sh} | {r['n_chips']} | "
            f"{r['op_flops_per_device']:.2e} | "
            f"{r['op_bytes_per_device']:.2e} | "
            f"{r['collective_bytes_per_device']:.2e} | "
            f"{args:.2f} | {temp:.2f} | {fits} | {cstr[:60]} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dryrun", default="experiments/dryrun")
    ap.add_argument("--multipod", default="experiments/dryrun_multipod")
    ap.add_argument("--out", default="experiments/tables.md")
    args = ap.parse_args(argv)
    single = load(args.dryrun)
    multi = load(args.multipod)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("<!-- generated by python -m "
                "repro_torch.analysis.make_experiments -->\n")
        f.write(dryrun_table(single,
                "Dry-run, single pod (16×16 = 256 chips)"))
        f.write("\n")
        f.write(dryrun_table(multi,
                "Dry-run, multi-pod (2×16×16 = 512 chips)"))
        f.write("\n")
        f.write(roofline_table(single,
                "Roofline terms, single pod (H100 constants)"))
        f.write("\n")
    print(f"wrote {args.out}",
          f"({len(single)} single-pod, {len(multi)} multi-pod cells)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
