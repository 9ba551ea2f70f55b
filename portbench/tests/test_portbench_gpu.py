"""The cells' checks on the card at their own size: a sound run of the
program is correct, and the control (the reference in fp8 in the
program's place) reads past a limit. Marked ``gpu``: each test looks for a
card when it runs and skips without one. On the card:
``python -m pytest -m gpu portbench/tests/test_portbench_gpu.py``."""
import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import REPO

CELLS = ["qwen2moe-train-8k", "jamba-serve-batch", "jamba-serve-poisson"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_not(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", str(2 ** 32 + 17), "--seconds", "5",
                        "--trace", "0", "--control", "1"], cwd=REPO,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    limits = harness.load_cell(cell).spec["limits"]
    assert any(line["control"][k] > lim for k, lim in limits.items())
    assert line["control"]["correct"] is False
