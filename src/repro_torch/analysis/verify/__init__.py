"""The port's static checks (the JAX package's ``repro.analysis.verify``
and its driver ``tools/verify.py``; run ``python -m
repro_torch.analysis.verify --all``): ``schedule_check`` is the race
detector that re-derives RAW/WAR/WAW hazards, ring send/recv pairing and
wgrad-flush legality from scratch and checks a proposed emission order
against them; ``kernel_check`` the resource checker of the CUDA launches
under an H100's limits (with the tuner's plan gate,
``analysis/kernel_check.py``); ``conventions`` the AST linter of the
port's rules.
"""
from repro_torch.analysis.verify.diagnostics import (Diagnostic, Report,
                                                     parse_ignores)

__all__ = ["Diagnostic", "Report", "parse_ignores"]
