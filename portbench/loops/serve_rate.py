"""Open-loop arrivals at a fixed rate (``loops/serve.py``, mode "rate")."""
from portbench.loops import serve


def run(cell, seed, seconds, trace, device, t0, **kw):
    return serve.run(cell, seed, seconds, trace, device, t0, "rate", **kw)
