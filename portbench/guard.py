"""The import guard: nothing the benchmark runs may load JAX or the JAX
package.

Names are compared by their top-level module name, whole: ``repro_torch``
(the program) passes, ``repro`` (the JAX package), ``jax``, ``jaxlib`` and
``flax`` do not. ``install`` refuses such an import for the rest of the
process; ``loaded`` reports any that are in ``sys.modules`` all the same
(the harness checks it once the window has closed). The reference is held
to more: ``reference_imports`` lists what its sources import, and it may
import neither the program nor the JAX package.
"""
from __future__ import annotations

import ast
import importlib.abc
import sys
from pathlib import Path
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
REFERENCE_FORBIDDEN = FORBIDDEN | {"repro_torch"}
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".", 1)[0]


class _Refuse(importlib.abc.MetaPathFinder):
    def __init__(self, names):
        self.names = frozenset(names)

    def find_spec(self, fullname, path=None, target=None):
        if top(fullname) in self.names:
            raise ImportError(f"the benchmark refuses to import {fullname!r}"
                              f" (top-level name {top(fullname)!r})")
        return None


def install(names=FORBIDDEN) -> None:
    """Refuse, from now on, every import whose top-level name is in
    ``names``; raise at once if one is loaded already."""
    bad = loaded(names)
    if bad:
        raise ImportError(f"already loaded: {bad}")
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse(names))


def loaded(names=FORBIDDEN) -> List[str]:
    return sorted(m for m in list(sys.modules) if top(m) in names)


def reference_imports() -> List[str]:
    """Top-level names the reference's sources import."""
    out = set()
    for path in sorted(REFERENCE_DIR.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                out.update(top(a.name) for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                out.add(top(node.module))
    return sorted(out)


def check_reference() -> None:
    bad = sorted(set(reference_imports()) & REFERENCE_FORBIDDEN)
    if bad:
        raise ImportError(f"the reference imports {bad}")
