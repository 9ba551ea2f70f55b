"""The port stands alone: no module of ``src/repro_torch`` imports ``jax``
or the JAX package, every module imports with JAX unavailable, and the
entry points refuse to fall back to the CPU without being asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(PORT.rglob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _modules() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_jax():
    names = [".".join(("repro_torch",) + p.relative_to(PORT).with_suffix(
        "").parts).replace(".__init__", "") for p in _modules()]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_default_to_cuda_and_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import ServeEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(get_config("mamba2-780m-smoke"))
    cfg = get_config("qwen2-moe-2.7b-smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(cfg, 2, 16)


@pytest.mark.parametrize("kernel", ["topk_combine", "grouped_gemm",
                                    "fused_mlp", "flash_attention",
                                    "ssd_forward"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """A wrapper launches its CUDA kernel or raises: it never computes a
    CPU tensor itself (the plain version is ops' job)."""
    from repro_torch.kernels import (flash_attention, fused_mlp,
                                     grouped_gemm, ssd, topk_combine)
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "topk_combine":
            topk_combine.topk_combine(x, torch.zeros(2, 3))
        elif kernel == "grouped_gemm":
            grouped_gemm.grouped_gemm(x, torch.zeros(2, 8, 4))
        elif kernel == "fused_mlp":
            fused_mlp.fused_mlp(x, torch.zeros(2, 8, 4), torch.zeros(2, 8, 4),
                                torch.zeros(2, 4, 8), "swiglu")
        elif kernel == "flash_attention":
            q = torch.zeros(1, 2, 4, 8)
            flash_attention.flash_attention(q, q, q)
        else:
            ssd.ssd_forward(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2),
                            torch.zeros(2), torch.zeros(1, 4, 3),
                            torch.zeros(1, 4, 3), torch.zeros(2))
    assert (topk_combine.launches, grouped_gemm.launches,
            fused_mlp.launches, flash_attention.launches,
            ssd.launches) == (0, 0, 0, 0, 0)


def test_ops_sends_cpu_tensors_to_the_plain_versions(monkeypatch):
    from repro_torch.kernels import ops, ref
    calls = []
    real = ref.topk_combine_ref
    monkeypatch.setattr(ref, "topk_combine_ref",
                        lambda r, w: calls.append(r.device) or real(r, w))
    out = ops.topk_combine(torch.ones(2, 3, 4), torch.ones(2, 3))
    assert calls == [torch.device("cpu")]
    assert torch.equal(out, torch.full((2, 4), 3.0))
    with pytest.raises(ValueError, match="devices"):
        ops.topk_combine(torch.ones(2, 3, 4, device="meta"),
                         torch.ones(2, 3))


@pytest.mark.parametrize("op", ["flash_attention", "ssd_forward"])
def test_ops_sends_cpu_tensors_to_the_new_plain_versions(monkeypatch, op):
    """flash_attention and ssd_forward: a CPU tensor reaches the plain
    version (flash_attention_ref, ssd_chunked_ref at the given chunk), a
    tensor on another device raises."""
    from repro_torch.kernels import ops, ref
    calls = []
    name = {"flash_attention": "flash_attention_ref",
            "ssd_forward": "ssd_chunked_ref"}[op]
    real = getattr(ref, name)
    monkeypatch.setattr(ref, name, lambda *a: calls.append(
        (a[0].device, a[6:])) or real(*a))
    if op == "flash_attention":
        q = torch.ones(1, 2, 4, 8)
        ops.flash_attention(q, q, q)
        assert calls == [(torch.device("cpu"), ())]
        with pytest.raises(ValueError, match="devices"):
            ops.flash_attention(q.to("meta"), q, q)
    else:
        args = [torch.ones(1, 4, 2, 8), torch.ones(1, 4, 2),
                -torch.ones(2), torch.ones(1, 4, 3), torch.ones(1, 4, 3),
                torch.ones(2)]
        ops.ssd_forward(*args, 2)
        assert calls == [(torch.device("cpu"), (2,))]
        with pytest.raises(ValueError, match="devices"):
            ops.ssd_forward(args[0].to("meta"), *args[1:], 2)
