"""The port's dry run (``launch/dryrun.py``): smoke cells on a (2, 2) mesh
over 4 fake ranks, and the CLI on the production mesh over 256. The fake
process group is process-global and test workers persist, so each run is
one subprocess; every cell must be ``ok`` (or the documented
``long_500k`` skip, with the JAX package's reason)."""
import json
import os
import subprocess
import sys

import pytest

from repro.configs.base import LM_SHAPES as JSHAPES
from repro.configs.base import shape_applicable as jshape_applicable
from repro.configs import get_config as jax_config

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CELLS = """
import json, sys
from repro_torch.launch import dryrun as D
D.init_fake_group(4, int(sys.argv[1]))
from repro_torch.configs import LM_SHAPES, SMOKE_SHAPE, ShapeConfig, get_config
from repro_torch.parallel.mesh import make_mesh
mesh = make_mesh((2, 2), ("data", "model"))
shapes = {"train": SMOKE_SHAPE, "prefill": ShapeConfig("p", 64, 4, "prefill"),
          "decode": ShapeConfig("d", 64, 4, "decode"),
          "long_500k": LM_SHAPES["long_500k"]}
out = {}
for arch, names in (("qwen2-moe-2.7b-smoke", ("train", "prefill", "decode")),
                    ("llava-next-34b-smoke", ("train",)),
                    ("jamba-v0.1-52b-smoke", ("train",)),
                    ("qwen2-0.5b-smoke", ("long_500k",))):
    for n in names:
        r = D.run_cell(get_config(arch), shapes[n], mesh, 4, "",
                       verbose=False)
        out[f"{arch}/{n}"] = {k: r.get(k) for k in (
            "status", "reason", "dominant", "collective_bytes_per_device",
            "collective_counts", "regions", "memory", "bound_time_s",
            "op_flops_per_device")}
print("CELLS " + json.dumps(out))
"""


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def cells():
    """rank 1's cells (data 0, model 1) and rank 2's (data 1, model 0)."""
    out = {}
    for rank in (1, 2):
        line = next(ln for ln in _run(["-c", CELLS, str(rank)]).splitlines()
                    if ln.startswith("CELLS "))
        out[rank] = json.loads(line[len("CELLS "):])
    return out


def test_smoke_cells_run_on_a_mesh(cells):
    for rank, res in cells.items():
        for name, r in res.items():
            if name.endswith("long_500k"):
                continue
            assert r["status"] == "ok", (rank, name, r)
            assert r["op_flops_per_device"] > 0 and r["bound_time_s"] > 0
            assert r["memory"]["fits"] and r["memory"]["argument_bytes"] > 0
        train = res["qwen2-moe-2.7b-smoke/train"]
        # the data-parallel gradient sums and the model axis's collectives
        assert train["collective_bytes_per_device"] > 0
        assert "all-reduce" in train["collective_counts"]
        assert {"topk_combine", "rmsnorm"} <= set(train["regions"])
        assert res["qwen2-moe-2.7b-smoke/decode"]["memory"]["cache_bytes"] > 0


def test_ranks_of_one_cut_hold_the_same_bytes(cells):
    """Ranks 1 and 2 hold different slices of the same sizes."""
    for name in ("qwen2-moe-2.7b-smoke/train", "jamba-v0.1-52b-smoke/train"):
        assert cells[1][name]["memory"]["argument_bytes"] == \
            cells[2][name]["memory"]["argument_bytes"]


def test_long_500k_skips_as_jax(cells):
    r = cells[1]["qwen2-0.5b-smoke/long_500k"]
    ok, reason = jshape_applicable(jax_config("qwen2-0.5b-smoke"),
                                   JSHAPES["long_500k"])
    assert not ok
    assert r["status"] == "skipped" and r["reason"] == reason


def test_cli_on_the_production_mesh(tmp_path):
    """``python -m repro_torch.launch.dryrun`` over 256 fake ranks: a
    decode cell ok and the long_500k skip, exit 0, the summary file."""
    summary = tmp_path / "cells.json"
    out = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
                "--shape", "decode_32k", "--rank", "17", "--summary",
                str(summary)])
    assert "256 chips, rank 17" in out and "1 cells, 0 failures" in out
    cells = json.loads(summary.read_text())
    assert [c["status"] for c in cells] == ["ok"]
    out = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
                "--shape", "long_500k"])
    assert "SKIPPED: pure full-attention arch" in out
