"""An offline batch: a queue kept full (``loops/serve.py``, mode "batch")."""
from portbench.loops import serve


def run(cell, seed, seconds, trace, device, t0, **kw):
    return serve.run(cell, seed, seconds, trace, device, t0, "batch", **kw)
