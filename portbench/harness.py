"""Everything a run shares whatever its cell: finding the cell's files by
the names in ``BENCHMARK.json``, the per-layer readers, the device's
readings and the result line.

A cell is ``workloads/<cell>.json`` (its loop kind, the program's settings
and the limits of its checks); its configuration is the file that
``BENCHMARK.json`` names, its traffic ``traffic/<traffic>.json``, its loop
``loops/<kind>.py`` and each per-layer metric ``metrics/<metric>.py``.
Adding a cell, a traffic mix or a metric adds files and a manifest entry.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    spec: Dict                 # workloads/<cell>.json
    conf: Dict                 # the configuration file
    traffic: Dict              # traffic/<traffic>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, bench: Optional[Dict] = None, root: Path = REPO,
              base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``root``'s
    BENCHMARK.json); its own files under ``base``."""
    bench = bench if bench is not None else read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(entry["chips"]),
                read_json(base / "workloads" / f"{name}.json"),
                read_json(root / conf_entry["file"]),
                read_json(base / "traffic" / f"{entry['traffic']}.json"),
                e2e, per_layer)


def loop_module(kind: str):
    return importlib.import_module(f"portbench.loops.{kind}")


def reader(metric: str, base: Path = HERE):
    """``metrics/<metric>.py``'s ``read(record) -> float | None``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_values(cell: Cell, record: Dict,
                     base: Path = HERE) -> Dict[str, Dict]:
    """Each of the cell's per-layer metrics that its reader finds."""
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"], base)(record)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(device, chips: int, peak_bytes: int) -> Dict:
    import torch
    if str(device).startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def finite(x):
    """NaN and infinities as null: the line stays strict JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict, device: Dict, checks: Dict,
                breakdown: Optional[Dict] = None,
                control: Optional[Dict] = None) -> str:
    """The run's last line of standard output, ``checks`` its last key."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control is not None:
        out["control"] = control
    out["checks"] = checks
    return json.dumps(finite(out), allow_nan=False)


def print_checks(checks: Dict) -> None:
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
