"""The benchmark's own tests (not part of the repository's suite): run
``python -m pytest portbench/tests`` from the repository's root. Tests
marked ``gpu`` need a CUDA device and skip elsewhere."""
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="session")
def smoke_bench():
    with open(DATA / "bench.json") as f:
        return json.load(f)


@pytest.fixture(scope="session")
def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)
