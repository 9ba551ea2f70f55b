"""Production mesh factory (``repro.launch.mesh``): the (data, model) =
(16, 16) layout, or (pod, data, model) = (2, 16, 16), over the ranks of
an initialised process group of that size."""
from __future__ import annotations

from repro_torch.parallel.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
