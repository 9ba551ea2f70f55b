"""The port's verify passes (``repro_torch.analysis.verify``): clean runs
over the real tree, a seeded mutant per rule, and the ``.cu`` constants
the kernel models carry against their sources.

* CLEAN (``tests/test_verify.py:79-100`` in the port's terms): the
  convention linter over ``src/repro_torch``, the kernel models of all
  eight kernels on both paths, the ``hopper_path`` gates, the tuner's plan
  gate, the legalization fixed point and the schedule pass give no
  diagnostic; ``python -m repro_torch.analysis.verify --all --json``
  exits 0 with an empty report, and the JAX package's kernel and schedule
  passes stay clean beside it.
* MUTANTS: each corrupts a real model, gate or source snippet, and the
  pass must name the rule: shared memory over the limit, an off-by-one
  tile map, a grid one block short, a bf16 accumulator, 1,056 threads, a
  ``hopper_path`` that admits a stride of 4 elements, a ``.cu`` constant
  edited without its model, and a snippet per lint rule.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis.verify import kernel_check as JK
from repro.analysis.verify import schedule_check as JS
from repro_torch.analysis.verify import conventions as C
from repro_torch.analysis.verify import kernel_check as K
from repro_torch.analysis.verify import schedule_check as S
from repro_torch.analysis.verify.diagnostics import (Diagnostic, Report,
                                                     parse_ignores)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels import grouped_gemm as GG
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import split3 as S3
from repro_torch.kernels import ssd as SSD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("fused_mlp", "fused_mlp_dgrad", "fused_mlp_wgrad", "grouped_gemm",
           "topk_combine", "flash_attention", "ssd_forward", "rmsnorm")


def rules_of(diags):
    return {d.rule for d in diags}


def _model(prefix):
    return next(m for m in K.builtin_kernel_models()
                if m.name.startswith(prefix))


# ---------------------------------------------------------------------------
# diagnostics core
# ---------------------------------------------------------------------------


def test_report_rendering_and_json():
    r = Report([Diagnostic("kernel", "smem-overflow", "error", "kernel:x",
                           "too big", "shrink"),
                Diagnostic("conventions", "process-group", "warning",
                           "a.py:3", "meh")])
    assert not r.ok and len(r.errors) == 1
    assert "kernel/smem-overflow" in r.text() and "[fix: shrink]" in r.text()
    j = json.loads(r.to_json())
    assert j["errors"] == 1 and not j["ok"]
    assert Report().ok and "clean" in Report().text()


def test_bad_severity_rejected():
    with pytest.raises(ValueError):
        Diagnostic("kernel", "r", "fatal", "x", "m")


def test_ignore_requires_justification():
    src = ("x = 1  # verify: ignore[process-group] -- the mesh builds it\n"
           "y = 2  # verify: ignore[mutable-global]\n")
    ignores, bad = parse_ignores(src)
    assert 1 in ignores and ignores[1][0] == "process-group"
    assert bad == [(2, "mutable-global")]


# ---------------------------------------------------------------------------
# clean runs
# ---------------------------------------------------------------------------


def test_clean_tree_conventions():
    diags = C.lint_tree(os.path.join(REPO, "src", "repro_torch"))
    assert diags == [], "\n".join(str(d) for d in diags)


def test_launch_counters_are_the_only_suppressions():
    """Every suppression in the port is a launch counter's ``global``,
    justified, in a kernel wrapper (the verify passes' own docstrings show
    the comment's form)."""
    root = os.path.join(REPO, "src", "repro_torch")
    found = []
    for dirpath, _, files in os.walk(root):
        if dirpath.endswith(os.path.join("analysis", "verify")):
            continue
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path, encoding="utf-8") as f:
                    src = f.read()
                ignores, bad = parse_ignores(src)
                assert bad == [], path
                lines = src.splitlines()
                found += [(os.path.relpath(path, root), lines[i - 1].strip(),
                           rule) for i, (rule, _) in ignores.items()]
    assert found and all(
        p.startswith("kernels") and rule == "mutable-global"
        and line.startswith("global ") and "launches" in line
        for p, line, rule in found), found


def test_clean_builtin_kernels():
    diags = K.check_builtin_kernels()
    assert diags == [], "\n".join(str(d) for d in diags)


def test_builtin_models_cover_every_kernel_on_both_paths():
    names = [m.name for m in K.builtin_kernel_models()]
    for kernel in KERNELS:
        mine = [n for n in names if n.split("[")[0] == kernel]
        assert mine, kernel
        if kernel not in ("topk_combine", "rmsnorm"):    # one kernel each
            paths = {n.split("[")[1].split("]")[0] for n in mine}
            assert "general" in paths and len(paths) == 2, (kernel, paths)


def test_clean_gates_plans_and_legalization():
    assert K.check_hopper_gates() == []
    assert K.check_legalize_fixed_point() == []
    assert K.check_cu_constants() == []
    from repro_torch.analysis import kernel_check as plan_gate
    assert plan_gate.check_candidate_plans() == []


def test_clean_model_archs_schedule():
    diags = S.check_model_archs()
    assert diags == [], "\n".join(str(d) for d in diags)


def test_reference_passes_stay_clean():
    assert JK.check_builtin_kernels() == []
    assert JS.check_model_archs() == []


def test_verify_cli_clean():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.verify", "--all",
         "--json"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    j = json.loads(out.stdout)
    assert j["ok"] and j["diagnostics"] == []


def test_verify_cli_exits_1_on_an_error(tmp_path):
    bad = tmp_path / "core"
    bad.mkdir()
    (bad / "x.py").write_text("_CACHE = {}\n")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.verify",
         "--conventions", "--root", str(tmp_path)], capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 1 and "mutable-global" in out.stdout


# ---------------------------------------------------------------------------
# seeded mutants: kernel models
# ---------------------------------------------------------------------------


def test_mutant_smem_over_the_limit():
    # the dgrad product at four ring stages instead of three
    m = _model("fused_mlp_dgrad[wgmma]/product")
    four = m.dyn_smem + 6 * FM.HOPPER_PANEL
    assert "smem-overflow" in rules_of(
        K.check_smem(dataclasses.replace(m, dyn_smem=four)))
    # the grouped GEMM one stage past its plan
    p = GG.hopper_plan(64, 160, 1408)
    g = _model("grouped_gemm[wgmma]/expert_major")
    slot = (p["frags"] + p["bn"] // 64) * GG.HOPPER_PANEL
    assert "smem-overflow" in rules_of(K.check_smem(
        dataclasses.replace(g, dyn_smem=p["smem_bytes"] + slot)))
    # static shared memory counts too
    r = _model("rmsnorm")
    assert "smem-overflow" in rules_of(K.check_smem(dataclasses.replace(
        r, static_smem=K.SMEM_PER_BLOCK - r.dyn_smem + 1)))


def test_mutant_tile_map_off_by_one():
    m = _model("fused_mlp[wgmma]/expert_major")
    o = m.outputs[0]
    shifted = dataclasses.replace(
        o, tiles=lambda ids: o.tiles(ids) + np.array([0, 0, 1, 0]))
    rules = rules_of(K.check_tiles(dataclasses.replace(m,
                                                       outputs=(shifted,))))
    assert {"index-out-of-bounds", "uncovered-output-tile"} <= rules


def test_mutant_grid_one_short():
    for prefix in ("fused_mlp[wgmma]/expert_major",
                   "grouped_gemm[general]/expert_major",
                   "flash_attention[wgmma]", "ssd_forward[mma]"):
        m = _model(prefix)
        short = m.grid[:-1] + (m.grid[-1] - 1,)
        assert "uncovered-output-tile" in rules_of(
            K.check_tiles(dataclasses.replace(m, grid=short))), prefix


def test_mutant_two_blocks_on_one_tile():
    m = _model("grouped_gemm[general]/expert_major")
    o = m.outputs[0]
    twice = dataclasses.replace(o, tiles=lambda ids: o.tiles(ids // 2 * 2))
    diags = K.check_tiles(dataclasses.replace(m, outputs=(twice,)))
    assert any("more than once" in d.message for d in diags)


def test_mutant_bf16_accumulator():
    m = _model("grouped_gemm[wgmma]")
    assert "accum-dtype" in rules_of(
        K.check_accum(dataclasses.replace(m, accum_dtype="bfloat16")))
    # fp32 inputs are not held to the rule
    assert K.check_accum(dataclasses.replace(
        m, in_dtypes=("float32",) * 2, accum_dtype="bfloat16")) == []


def test_mutant_threads():
    m = _model("rmsnorm")
    assert "threads-per-block" in rules_of(
        K.check_threads(dataclasses.replace(m, threads=1056)))
    w = _model("flash_attention[wgmma]")
    assert "threads-per-block" in rules_of(
        K.check_threads(dataclasses.replace(w, threads=320)))
    assert K.check_threads(dataclasses.replace(w, wgmma=False,
                                               threads=320)) == []


def _loose_fused_mlp_gate(rows, w_gate, w_up, w_down, dy=None):
    """fused_mlp.hopper_path with its stride rule loosened to 4 elements."""
    ts = [t for t in (rows, w_gate, w_up, w_down, dy) if t is not None]
    d, f, N = rows.shape[2], w_up.shape[2], w_down.shape[2]
    if min(d, f, N) <= 0 or d % 8 or f % 8 or N % 8:
        return False
    return all(t.dtype == torch.bfloat16 and t.stride(-1) == 1
               and t.data_ptr() % 16 == 0
               and all(s % 4 == 0 for s in t.stride()[:-1]) for t in ts)


def test_mutant_gate_admits_a_stride_of_4_elements():
    diags = K.check_hopper_gates({"fused_mlp": _loose_fused_mlp_gate})
    assert "tma-alignment" in rules_of(diags)
    assert all("fused_mlp" in d.location for d in diags)


def test_mutant_gate_admits_an_unaligned_base():
    def loose_flash(q, k, v):
        return q.shape[-1] in FA.HOPPER_HEAD_DIMS and all(
            t.dtype == torch.bfloat16 and t.stride(-1) == 1
            and t.data_ptr() % 2 == 0
            and all(st % 8 == 0 for st in t.stride()[:-1])
            for t in (q, k, v))
    assert "tma-alignment" in rules_of(
        K.check_hopper_gates({"flash_attention": loose_flash}))


def test_real_gates_refuse_what_tma_refuses():
    """The probes reach both sides of each real gate: some accepted, some
    refused."""
    x_ok = K._meta((2, 16, 64), strides=(16 * 72, 72, 1))
    x_bad = K._meta((2, 16, 64), strides=(16 * 68, 68, 1))
    w = K._meta((2, 64, 128))
    wd = K._meta((2, 128, 64))
    assert FM.hopper_path(x_ok, w, w, wd)
    assert not FM.hopper_path(x_bad, w, w, wd)
    assert not GG.hopper_path(K._meta((2, 16, 64), offset=4), w)


def test_mutant_model_of_a_real_plan_function():
    """The models follow the wrappers' plan functions: an rmsnorm plan
    whose grid covers fewer rows than it is given is caught."""
    p = RN.launch_plan(2048, 1536, 2, True)
    m = _model("rmsnorm")
    o = m.outputs[0]

    def fewer(ids):
        t = o.tiles(ids)
        return t[t[:, 0] < 2047]
    assert "uncovered-output-tile" in rules_of(K.check_tiles(
        dataclasses.replace(m, outputs=(dataclasses.replace(o, tiles=fewer),))))
    assert m.grid == (p["blocks"],) and m.threads == p["threads"]


# ---------------------------------------------------------------------------
# the .cu constants the models carry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(K.CU_CONSTANTS))
def test_cu_constant_matches_its_source(key):
    src, name = key
    with open(os.path.join(K.csrc_dir(), src), encoding="utf-8") as f:
        assert K.cu_constant(f.read(), name) == K.CU_CONSTANTS[key]


def test_wrapper_constants_match_the_sources():
    def c(src, name):
        return K.cu_constant(K.read_source(src), name)
    assert FM.HOPPER_BM == c("fused_mlp_hopper.cu", "BM")
    assert FM.HOPPER_FC == c("fused_mlp_hopper.cu", "FC")
    assert FM.HOPPER_FS_MAX == c("fused_mlp_hopper.cu", "FS_MAX")
    assert FM.HOPPER_PANEL == c("fused_mlp_hopper.cu", "PANEL")
    assert FM.HOPPER_SLOT == c("fused_mlp_hopper.cu", "SLOT")
    assert FM.HOPPER_SMEM_MAX == c("fused_mlp_hopper.cu", "SMEM_MAX")
    assert FM.HOPPER_MAX_STAGES == c("hopper.cuh", "kMaxStages")
    assert FM.HOPPER_BAR_BYTES == c("hopper.cuh", "kBarBytes")
    assert FM.GENERAL_CHUNK == c("fused_mlp.cu", "BFS")
    assert GG.HOPPER_FRAG == c("grouped_gemm_hopper.cu", "FRAG")
    assert GG.HOPPER_MAX_FRAGS == c("grouped_gemm_hopper.cu", "MAX_FRAGS")
    assert GG.HOPPER_SMEM_MAX == c("grouped_gemm_hopper.cu", "SMEM_MAX")
    assert SSD.CHUNK == c("ssd.cu", "kQ") == c("ssd_hopper.cu", "kQ")
    assert SSD.MAX_STATE == c("ssd.cu", "kDS")
    assert SSD.MAX_HEAD_DIM == c("ssd.cu", "kHD")
    assert S3.THREADS == c("split3.cu", "kThreads")
    assert SSD.HOPPER_SLAB == c("ssd_hopper.cu", "kP")
    assert SSD.HOPPER_TERMS == c("ssd_hopper.cu", "kTerms")
    assert RN.MAX_THREADS == c("rmsnorm.cu", "kMaxThreads")


def test_mutant_cu_constant_edited_without_its_model():
    def edited(src):
        text = K.read_source(src)
        if src == "flash_attention_hopper.cu":
            text = text.replace("constexpr int BQ = 128;",
                                "constexpr int BQ = 64;")
        return text
    diags = K.check_cu_constants(edited)
    assert rules_of(diags) == {"cu-constant"}
    assert [d.location for d in diags] == ["csrc/flash_attention_hopper.cu:BQ"]


def test_cu_constant_evaluates_expressions():
    text = ("constexpr int A = 4;\nconstexpr int B = A * 32;\n"
            "constexpr int C = (B + 127) / 128;\nconstexpr int D = f(A);\n")
    assert K.cu_constant(text, "B") == 128 and K.cu_constant(text, "C") == 1
    with pytest.raises(KeyError):
        K.cu_constant(text, "D")


# ---------------------------------------------------------------------------
# seeded mutants: convention linter snippets
# ---------------------------------------------------------------------------


def test_mutant_lint_new_group_outside_the_mesh():
    src = ("import torch.distributed as dist\n\n\ndef f(r):\n"
           "    return dist.new_group(r)\n")
    assert "process-group" in rules_of(C.lint_source("core/x.py", src))
    assert C.lint_source("parallel/mesh.py", src) == []


def test_mutant_lint_init_process_group_outside_launch():
    src = ("import torch.distributed as dist\n\n\ndef f():\n"
           "    dist.init_process_group('gloo')\n")
    assert "process-group" in rules_of(C.lint_source("training/x.py", src))
    assert C.lint_source("launch/x.py", src) == []


def test_mutant_lint_mutable_module_dict():
    src = "_CACHE = {}\n"
    assert "mutable-global" in rules_of(C.lint_source("kernels/x.py", src))
    assert C.lint_source("configs/x.py", src) == []
    assert C.lint_source("kernels/x.py", "TABLE = {'a': 1}\n") == []


def test_mutant_lint_global_stmt():
    src = "_N = 0\n\n\ndef bump():\n    global _N\n    _N += 1\n"
    assert "mutable-global" in rules_of(C.lint_source("serving/x.py", src))


def test_mutant_lint_serving_assert():
    src = "def admit(n):\n    assert n >= 0\n    return n\n"
    assert "serving-assert" in rules_of(C.lint_source("serving/x.py", src))
    assert C.lint_source("kernels/x.py", src) == []


def test_mutant_lint_inline_knob_mod():
    src = "def pick(d, plan):\n    return d % plan.n_col_blocks == 0\n"
    assert "knob-legalize" in rules_of(C.lint_source("core/transport.py",
                                                     src))
    assert C.lint_source("core/adaptive.py", src) == []


@pytest.mark.parametrize("src", ["import jax\n", "import jax.numpy as jnp\n",
                                 "from jax import lax\n",
                                 "from repro.core import routing\n",
                                 "import repro.models.lm\n"])
def test_mutant_lint_reference_import(src):
    assert "no-reference-import" in rules_of(C.lint_source("models/x.py",
                                                           src))


def test_lint_port_imports_are_legal():
    src = ("from repro_torch.core import routing\nimport repro_torch\n"
           "from . import common\nimport jaxlib_free_name\n")
    assert C.lint_source("models/x.py", src) == []


def test_mutant_lint_bad_ignore_reported():
    src = "def admit(n):\n    assert n  # verify: ignore[serving-assert]\n"
    rules = rules_of(C.lint_source("serving/x.py", src))
    assert "bad-ignore" in rules and "serving-assert" in rules


def test_lint_justified_ignore_suppresses():
    src = ("def admit(n):\n"
           "    assert n  # verify: ignore[serving-assert] -- a test shim\n")
    assert C.lint_source("serving/x.py", src) == []
