"""The traced run's records: the device's kernels from ``torch.profiler``,
the harness's own host spans around each call into the program (each a
``bench:<name>`` annotation on the profiler's clock), and the shapes of
every kernel call through the program's ``kernels/ops.py``.

With tracing off, ``span`` costs nothing and no hook is installed.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from portbench.yardstick import kernels as K

PREFIX = "bench:"


class Trace:
    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.kernels: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        self.window: Optional[Tuple[float, float]] = None
        self.calls = KernelCalls()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield

    @contextlib.contextmanager
    def window_ctx(self):
        """Profiles its body: the window (``record`` reads it)."""
        if not self.on:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.calls.install()
        try:
            with torch.profiler.record_function(PREFIX + "window"):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self.calls.uninstall()
            self.prof.__exit__(None, None, None)

    def _events(self):
        """(name, is_device, start_s, end_s) of every profiled event."""
        try:
            evs = self.prof.profiler.kineto_results.events()
            for e in evs:
                dev = e.device_type() == torch.autograd.DeviceType.CUDA
                s = e.start_ns() * 1e-9
                yield e.name(), dev, s, s + e.duration_ns() * 1e-9
        except AttributeError:
            for e in self.prof.events():
                dev = e.device_type == torch.autograd.DeviceType.CUDA
                yield (e.name, dev, e.time_range.start * 1e-6,
                       e.time_range.end * 1e-6)

    def _read(self):
        for name, dev, s, e in self._events():
            if dev:
                if not name.startswith(PREFIX):
                    self.kernels.append((name, s, e))
            elif name.startswith(PREFIX):
                if name == PREFIX + "window":
                    self.window = (s, e)
                else:
                    self.spans.append((name[len(PREFIX):], s, e))
        self.prof = None

    def record(self) -> Dict:
        """What the per-layer readers read, times in seconds from the
        window's start. The profile is read here, not when the window
        closes: reading it takes long, and a loop may have work to finish
        first."""
        if self.prof is not None:
            self._read()
        lo, hi = self.window if self.window else (0.0, 0.0)
        kern = [(n, s - lo, e - lo) for n, s, e in self.kernels
                if e > lo and s < hi]
        spans = [(n, s - lo, e - lo) for n, s, e in self.spans
                 if e > lo and s < hi]
        busy = K.union(K.clip([(s, e) for _, s, e in kern], 0.0, hi - lo))
        return {"window_s": hi - lo, "kernels": kern, "spans": spans,
                "busy": busy, "busy_s": sum(e - s for s, e in busy),
                "calls": self.calls.read()}

    def breakdown(self, rec: Dict) -> Dict:
        by: Dict[str, float] = {}
        for n, s, e in rec["kernels"]:
            by[n] = by.get(n, 0.0) + (e - s)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        idle = K.label_gaps(K.gaps(rec["busy"], 0.0, rec["window_s"]),
                            rec["spans"])
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps]}


class KernelCalls:
    """Wraps the program's ``kernels/ops._kernel``, through which every
    hand-written kernel call passes, and keeps each call's name and the
    shapes of its operands; for the expert MLP's calls also each expert's
    count of rows that hold a token (a dispatch buffer's empty capacity
    rows are zero), as a device tensor read after the window."""

    MLP = ("fused_mlp", "fused_mlp_dgrad", "fused_mlp_wgrad")

    def __init__(self):
        self._orig = None
        self._calls: List[Dict] = []

    def install(self):
        from repro_torch.kernels import ops
        if self._orig is not None:
            return
        self._orig = ops._kernel
        orig = self._orig

        def hooked(name, fn, *operands):
            self._calls.append(self._describe(name, operands))
            return orig(name, fn, *operands)
        ops._kernel = hooked

    def uninstall(self):
        if self._orig is None:
            return
        from repro_torch.kernels import ops
        ops._kernel = self._orig
        self._orig = None

    def _describe(self, name, operands) -> Dict:
        shapes = [None if t is None else tuple(t.shape) for t in operands
                  if t is None or isinstance(t, torch.Tensor)]
        call = {"kernel": name, "shapes": shapes,
                "itemsize": operands[0].element_size()}
        if name in self.MLP:
            rows = operands[0]
            call["rows"] = (rows != 0).any(-1).sum(-1)
            call["glu"] = operands[1] is not None
        return call

    def read(self) -> List[Dict]:
        out = []
        for c in self._calls:
            c = dict(c)
            if "rows" in c:
                c["rows"] = [int(r) for r in c["rows"].tolist()]
            out.append(c)
        self._calls = []
        return out
