"""The convention linter (AST) over ``src/repro_torch``: the port's
durable rules (ROADMAP "Port conventions"), the ones that decay silently
because nothing crashes when they break (the JAX package's
``repro.analysis.verify.conventions``, its rules in the port's terms).

* ``process-group``: ``dist.new_group`` only in ``parallel/mesh.py``,
  where every rank builds every group in one order (group creation is
  collective), and ``init_process_group`` only in the ``launch/`` entries
  (the JAX rule ``mesh-entry``).
* ``mutable-global``: no module-level mutable accumulator (``{}``,
  ``[]``, ``dict()``, ...) and no ``global`` statement in ``core/``,
  ``kernels/``, ``models/`` and ``serving/``: state that leaks across
  calls and tests. Non-empty literal tables are constants and pass.
* ``serving-assert``: no ``assert`` in ``serving/`` (``python -O`` drops
  it); raise a real exception.
* ``knob-legalize``: no inline ``% n_col`` / ``% ring_group`` /
  ``% intra_group`` outside ``core/adaptive.py``: plan knobs go through
  ``legalize_n_col``/``legalize_ring_group``/``legalize_intra_group``/
  ``legalize_plan``, so every consumer clamps alike.
* ``no-reference-import``: no import of ``jax`` or of the JAX package
  ``repro`` (the port keeps its own copies; ``tests/test_torch_imports.py``
  also imports every module with both blocked).

Suppression: ``# verify: ignore[rule] -- why`` on the offending line; the
justification is mandatory (``diagnostics.apply_ignores``).
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional

from repro_torch.analysis.verify.diagnostics import Diagnostic, apply_ignores

_PASS = "conventions"

MESH_FILE = "parallel/mesh.py"
ENTRY_DIR = "launch/"
HOT_DIRS = ("core/", "kernels/", "models/", "serving/")
SERVING_DIRS = ("serving/",)
ADAPTIVE_FILE = "core/adaptive.py"
REFERENCE_MODULES = ("jax", "repro")
_KNOB_FRAGMENTS = ("n_col", "ring_group", "intra_group")
_MUTABLE_CALLS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                  "deque", "Counter"}


def _d(rule: str, path: str, line: int, msg: str,
       hint: str = "") -> Diagnostic:
    return Diagnostic(_PASS, rule, "error", f"{path}:{line}", msg, hint)


def _dotted(node: ast.AST) -> Optional[str]:
    """'dist.new_group' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_empty_mutable(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set)) and not getattr(
            node, "keys", getattr(node, "elts", None)):
        return True
    if isinstance(node, ast.Call) and not node.args and not node.keywords:
        name = _dotted(node.func) or ""
        return name.split(".")[-1] in _MUTABLE_CALLS
    return False


def _is_reference(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in REFERENCE_MODULES)


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.diags: List[Diagnostic] = []
        where = f"/{relpath}"
        self.is_mesh = relpath.endswith(MESH_FILE)
        self.is_entry = f"/{ENTRY_DIR}" in where
        self.is_hot = any(f"/{d}" in where for d in HOT_DIRS)
        self.is_serving = any(f"/{d}" in where for d in SERVING_DIRS)
        # core/adaptive.py owns legalization; analysis/verify/ checks it
        self.is_adaptive = (relpath.endswith(ADAPTIVE_FILE)
                            or "analysis/verify/" in relpath)
        self._depth = 0                      # > 0 inside a def/class

    def _add(self, rule, node, msg, hint=""):
        self.diags.append(_d(rule, self.relpath, node.lineno, msg, hint))

    # -- no-reference-import ------------------------------------------

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            if _is_reference(a.name):
                self._add("no-reference-import", node,
                          f"import of '{a.name}'",
                          hint="keep a copy under repro_torch/")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.level == 0 and _is_reference(node.module or ""):
            self._add("no-reference-import", node,
                      f"import from '{node.module}'",
                      hint="keep a copy under repro_torch/")
        self.generic_visit(node)

    # -- process-group ------------------------------------------------

    def visit_Call(self, node: ast.Call):
        last = (_dotted(node.func) or "").split(".")[-1]
        if last == "new_group" and not self.is_mesh:
            self._add("process-group", node,
                      f"process group built outside {MESH_FILE}",
                      hint="take it from a Mesh (mesh.group, "
                           "model_subgroups): every rank must build every "
                           "group in one order")
        if last == "init_process_group" and not self.is_entry:
            self._add("process-group", node,
                      f"init_process_group outside the {ENTRY_DIR} entries",
                      hint="the entry point joins the group; library code "
                           "takes a Mesh")
        self.generic_visit(node)

    # -- mutable-global -----------------------------------------------

    def _check_module_assign(self, node, value):
        if self.is_hot and self._depth == 0 and value is not None \
                and _is_empty_mutable(value):
            self._add("mutable-global", node,
                      "module-level mutable accumulator in a hot-path "
                      "module", hint="functools.lru_cache or explicit state")

    def visit_Assign(self, node: ast.Assign):
        self._check_module_assign(node, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        self._check_module_assign(node, node.value)
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global):
        if self.is_hot:
            self._add("mutable-global", node,
                      f"'global {', '.join(node.names)}' in a hot-path "
                      f"module", hint="explicit state, or a justified "
                                      "suppression")
        self.generic_visit(node)

    # -- serving-assert -----------------------------------------------

    def visit_Assert(self, node: ast.Assert):
        if self.is_serving:
            self._add("serving-assert", node,
                      "bare assert in serving code (stripped under "
                      "python -O)", hint="raise ValueError/RuntimeError")
        self.generic_visit(node)

    # -- knob-legalize ------------------------------------------------

    def visit_BinOp(self, node: ast.BinOp):
        if not self.is_adaptive and isinstance(node.op, ast.Mod):
            for side in (node.left, node.right):
                name = _dotted(side) or ""
                if any(f in name for f in _KNOB_FRAGMENTS):
                    self._add("knob-legalize", node,
                              f"inline divisibility math on '{name}' "
                              f"outside {ADAPTIVE_FILE}",
                              hint="legalize_n_col/legalize_ring_group/"
                                   "legalize_intra_group/legalize_plan")
                    break
        self.generic_visit(node)

    # -- scope tracking -----------------------------------------------

    def _scoped(self, node):
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_ClassDef = _scoped
    visit_Lambda = _scoped


def lint_source(relpath: str, source: str) -> List[Diagnostic]:
    """Lint one module (``relpath`` relative to the package root); the
    diagnostics that survive its ignore comments, plus ``bad-ignore``
    findings."""
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [_d("syntax-error", relpath, e.lineno or 0,
                   f"cannot parse: {e.msg}")]
    linter = _Linter(relpath)
    linter.visit(tree)
    return apply_ignores(linter.diags, relpath, source, _PASS)


def package_root() -> str:
    """``src/repro_torch`` of this checkout."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def lint_tree(root: Optional[str] = None) -> List[Diagnostic]:
    """Lint every ``.py`` under ``root`` (default: the port's package)."""
    root = root or package_root()
    diags: List[Diagnostic] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "build"))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                diags.extend(lint_source(rel, f.read()))
    return diags
