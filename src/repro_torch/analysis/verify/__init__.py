"""The port's static checks over the schedule IR (the JAX package's
``repro.analysis.verify``, its schedule pass): ``schedule_check`` is the
race detector that re-derives RAW/WAR/WAW hazards, ring send/recv pairing
and wgrad-flush legality from scratch and checks a proposed emission
order against them. The plan gate for the port's kernels is
``analysis/kernel_check.py``.
"""
from repro_torch.analysis.verify.diagnostics import (Diagnostic, Report,
                                                     parse_ignores)

__all__ = ["Diagnostic", "Report", "parse_ignores"]
