"""The import guard: the program passes, JAX and the JAX package do not,
by whole top-level name; the reference imports neither them nor the
program."""
import subprocess
import sys

import pytest

from portbench import guard
from portbench.tests.conftest import REPO

RUN = ("import sys; sys.path[:0] = [{src!r}, {repo!r}]; "
       "from portbench import guard; guard.install(); import {mod}")


def _import(mod):
    code = RUN.format(src=str(REPO / "src"), repo=str(REPO), mod=mod)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)


def test_the_program_passes():
    r = _import("repro_torch.serving")
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mod", ["repro", "repro.models.lm", "jax"])
def test_the_jax_side_is_refused(mod):
    r = _import(mod)
    assert r.returncode != 0
    assert "refuses to import" in r.stderr


def test_loaded_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchx", object())
    monkeypatch.setitem(sys.modules, "jaxline", object())
    assert "repro_torchx" not in guard.loaded()
    assert "jaxline" not in guard.loaded()
    monkeypatch.setitem(sys.modules, "repro.configs", object())
    assert "repro.configs" in guard.loaded()


def test_the_reference_stands_alone():
    got = set(guard.reference_imports())
    assert not got & guard.REFERENCE_FORBIDDEN
    assert got <= {"torch", "math", "typing", "portbench", "statistics",
                   "__future__"}
    guard.check_reference()


def test_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "qwen2moe-train-8k", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_without_the_program_fails(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone
    gives no result."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "jamba-serve-batch", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
