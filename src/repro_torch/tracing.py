"""The program's spans: named intervals of host time at the boundaries of
its layers, the one tracing system of the port.

    from repro_torch import tracing
    with tracing.recording():
        eng.run()
    spans = tracing.drain()   # [(name, parent, start_ns, end_ns, attrs)]
    tracing.print_summary(spans)

``launch/serve.py --trace`` and ``launch/train.py --trace`` print that
summary: each span name's count, total and self host time.

Where they sit (names are constants):

* engine (``serving/engine.py``): ``engine.expire`` (deadline passes),
  ``engine.admit`` (the admission phase; attributes ``step`` and the
  admitted ``rids``), per prefill chunk ``engine.prefill.inputs`` /
  ``.forward`` / ``.readback``, ``engine.decode`` (attribute ``step``)
  with ``engine.decode.inputs`` / ``.forward`` / ``.readback`` / ``.emit``,
  and ``engine.snapshot``;
* model step (``models/blocks.py``, ``models/lm.py``): a block's mixer
  ``model.attn`` or ``model.ssm``, its ``model.moe`` or ``model.ffn``, and
  the fp32 head ``model.head``;
* MoE layer (``core/moe_layer.py``): ``moe.route``, ``moe.experts``,
  ``moe.combine``;
* train step (``launch/train_step.py``): ``train.grad`` (each
  microbatch), ``train.guard``, ``train.update``.

Off, the default, ``span`` returns one shared no-op context: no clock
read, no allocation, no ``record_function``. On (inside ``recording()``),
a span reads ``time.perf_counter_ns`` at entry and at exit and appends
``[name, parent index, start, end, attrs]`` to an in-memory list, its
parent the innermost span open at its entry. While a torch profiler
records, it also opens a profiler range named ``"repro:" + name``, so the
span lies on the profiler's clock beside the device's kernels. A span
never syncs the device and never reads a tensor: the host time it covers
is the host's, and the kernels it launches may run after it closes (the
profiler's correlation ids join each kernel to its launch, and so to the
span open at that launch).

The range is ``torch._C._profiler._RecordFunctionFast``, not
``torch.profiler.record_function``: under the profiler on an H100 host a
whole span costs 4.9 us with it, a bare ``record_function`` 13.6 us; and
it is an op-scope range, a host event only, where ``record_function``'s user scope
also makes the profiler draw a device-side annotation over the kernels
launched inside it, which a reader of the device trace would have to tell
from the kernels.

Attributes go on an open span with ``set(key, value)`` (a no-op when
off); values that cost something to build are built under
``enabled()``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, TextIO, Tuple

import torch

PREFIX = "repro:"

Span = Tuple[str, int, int, int, Optional[Dict[str, Any]]]


class _State:
    """The tracer's one state: how many ``recording()`` contexts are open,
    the spans recorded, the indices of the open ones, and the clock (a
    test may stub it)."""

    __slots__ = ("depth", "spans", "stack", "clock")

    def __init__(self):
        self.depth = 0
        self.spans: List[list] = []
        self.stack: List[int] = []
        self.clock = time.perf_counter_ns


_STATE = _State()


class _Off:
    """The shared context of every span while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key: str, value: Any) -> None:
        pass


OFF = _Off()


class _On:
    __slots__ = ("name", "idx", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _STATE
        self.idx = len(st.spans)
        st.spans.append([self.name, st.stack[-1] if st.stack else -1,
                         st.clock(), 0, None])
        st.stack.append(self.idx)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        st = _STATE
        if self.rf is not None:
            self.rf.__exit__(*exc)
        st.spans[self.idx][3] = st.clock()
        st.stack.pop()
        return False

    def set(self, key: str, value: Any) -> None:
        e = _STATE.spans[self.idx]
        if e[4] is None:
            e[4] = {}
        e[4][key] = value


def span(name: str):
    """A context for the span ``name``: ``OFF`` unless recording."""
    return _On(name) if _STATE.depth else OFF


def enabled() -> bool:
    return _STATE.depth > 0


@contextlib.contextmanager
def recording():
    """Records spans inside its body (nested contexts nest)."""
    _STATE.depth += 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def drain() -> List[Span]:
    """The spans recorded since the last drain, in order of entry (a
    parent's index is into this list, -1 for none), and clears them."""
    if _STATE.stack:
        raise RuntimeError(f"drain() inside {len(_STATE.stack)} open "
                           f"span(s)")
    out = [tuple(e) for e in _STATE.spans]
    _STATE.spans = []
    return out


def summarize(spans: List[Span]) -> Dict[str, Tuple[int, int, int]]:
    """By span name: (count, total ns, self ns), self being a span's
    duration less its children's."""
    child = [0] * len(spans)
    for _, parent, s, e, _ in spans:
        if parent >= 0:
            child[parent] += e - s
    out: Dict[str, Tuple[int, int, int]] = {}
    for i, (name, _, s, e, _) in enumerate(spans):
        n, tot, own = out.get(name, (0, 0, 0))
        out[name] = (n + 1, tot + e - s, own + e - s - child[i])
    return out


def print_summary(spans: List[Span], file: Optional[TextIO] = None) -> None:
    """Prints each span name's count, total and self host time, by total."""
    rows = sorted(summarize(spans).items(), key=lambda kv: -kv[1][1])
    print(f"{'span':<26}{'count':>8}{'total ms':>12}{'self ms':>12}",
          file=file)
    for name, (n, tot, own) in rows:
        print(f"{name:<26}{n:>8}{tot / 1e6:>12.2f}{own / 1e6:>12.2f}",
              file=file)
