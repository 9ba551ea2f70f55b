"""Deterministic fault injection for the serving engine (the port's own
copy of ``repro.serving.faults``, numpy only).

* :class:`FaultPlan` — a seeded, step-indexed schedule of fault events
  (crashes, latency spikes, NaN logit rows, page-pool squeezes).
  ``FaultPlan.poisson`` draws a chaos schedule from independent per-step
  Bernoulli trials, so a whole chaos trace is one integer seed; it makes
  the JAX module's draws in the same order, so one seed gives the same
  plan (and the same poisoned rows) in both packages.
* :class:`FaultInjector` — applies a plan through a NARROW hook in
  ``ServeEngine.step()``: ``begin_step`` fires latency/pressure/crash
  events keyed on the engine's monotonic step counter, ``poison_rows``
  marks live decode rows whose logits the engine must treat as
  non-finite. The engine's own quarantine / recovery machinery then
  handles the fault exactly as it would a real one.

The injector is keyed on ``ServeEngine.step_idx``, which is MONOTONIC
across crash recovery (it never rolls back with a snapshot restore), so
an injected crash fires exactly once — replayed steps run fault-free
unless the plan schedules new events for them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """Simulated device loss raised from inside ``ServeEngine.step()``."""

    def __init__(self, step: int, msg: str = ""):
        super().__init__(msg or f"injected device loss at step {step}")
        self.step = step


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Step-indexed fault schedule. All step indices refer to the engine's
    monotonic ``step_idx`` (1-based, never rolled back by recovery).

    * ``crash_steps`` — steps whose ``begin_step`` raises InjectedFault.
    * ``latency_s`` — step -> seconds of injected sleep (straggler spike).
    * ``nan_rows`` — step -> how many live decode rows get their logits
      treated as non-finite (per-row quarantine path).
    * ``page_squeeze`` — step -> (n_pages, hold_steps): temporarily claim
      free pages from the engine's allocator (memory-pressure admission
      stall), released ``hold_steps`` later.
    * ``crash_workers`` — step -> (role, index): crash ONE worker of the
      disaggregated topology (e.g. ``("decode", 0)``) at that step. Only
      role-scoped injectors (``FaultInjector(plan, role=...)``) fire
      these, and only the matching worker's injector raises — the router
      hands the same plan to every worker, so a single seed targets a
      single worker role across the whole fleet. Ignored by role-less
      (single-engine) injectors.
    """
    seed: int = 0
    crash_steps: Tuple[int, ...] = ()
    latency_s: Mapping[int, float] = dataclasses.field(default_factory=dict)
    nan_rows: Mapping[int, int] = dataclasses.field(default_factory=dict)
    page_squeeze: Mapping[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    crash_workers: Mapping[int, Tuple[str, int]] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def poisson(cls, seed: int, horizon: int, crash_rate: float = 0.02,
                nan_rate: float = 0.02, spike_rate: float = 0.05,
                spike_s: float = 0.02, squeeze_rate: float = 0.0,
                squeeze_pages: int = 2, squeeze_hold: int = 4,
                start: int = 2,
                workers: Tuple[Tuple[str, int], ...] = ()) -> "FaultPlan":
        """Chaos schedule: independent per-step Bernoulli draws for each
        fault class over ``[start, horizon)`` — the discrete analogue of a
        Poisson fault process. One seed reproduces the whole trace.

        With ``workers`` (disaggregated topology: a tuple of ``(role,
        index)`` targets), each crash draw hits one uniformly chosen
        worker and lands in ``crash_workers`` instead of ``crash_steps``
        — the whole-engine crash becomes a single-worker loss."""
        rng = np.random.default_rng(seed)
        crash, lat, nan, squeeze, wcrash = [], {}, {}, {}, {}
        for t in range(start, horizon):
            if rng.random() < crash_rate:
                if workers:
                    wcrash[t] = tuple(workers[int(rng.integers(len(workers)))])
                else:
                    crash.append(t)
            if rng.random() < spike_rate:
                lat[t] = spike_s
            if rng.random() < nan_rate:
                nan[t] = 1
            if rng.random() < squeeze_rate:
                squeeze[t] = (squeeze_pages, squeeze_hold)
        return cls(seed=seed, crash_steps=tuple(crash), latency_s=lat,
                   nan_rows=nan, page_squeeze=squeeze, crash_workers=wcrash)

    def summary(self) -> Dict[str, int]:
        return {"crash": len(self.crash_steps),
                "latency": len(self.latency_s),
                "nan": len(self.nan_rows),
                "page_squeeze": len(self.page_squeeze),
                "worker_crash": len(self.crash_workers)}


class FaultInjector:
    """Applies a :class:`FaultPlan` to a live engine through the narrow
    ``begin_step`` / ``poison_rows`` hook pair. Counts everything it
    injects (``counts``) and records an event log for assertions."""

    def __init__(self, plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep,
                 role: Optional[Tuple[str, int]] = None):
        self.plan = plan
        self.sleep = sleep
        # role=(name, index) scopes this injector to ONE worker of a
        # disaggregated topology: only the plan's matching crash_workers
        # entries fire here (the router clones one plan across workers)
        self.role = tuple(role) if role is not None else None
        self.counts: Dict[str, int] = {"crash": 0, "latency": 0, "nan": 0,
                                       "page_squeeze": 0}
        self.events: List[Tuple[int, str]] = []
        self._squeezes: Dict[int, int] = {}      # pseudo-slot -> release step

    def begin_step(self, eng):
        """Fire this step's latency / page-pressure / crash events. Called
        first thing in ``ServeEngine.step()``; a raised InjectedFault is
        the simulated device loss the engine's recovery path handles."""
        t = eng.step_idx
        # release expired squeezes first so pressure is bounded
        for key, rel in list(self._squeezes.items()):
            if t >= rel:
                if eng.alloc is not None and eng.alloc.owns(key):
                    eng.alloc.free_slot(key)
                del self._squeezes[key]
        s = self.plan.latency_s.get(t)
        if s:
            self.counts["latency"] += 1
            self.events.append((t, f"latency {s:.3f}s"))
            self.sleep(s)
        sq = self.plan.page_squeeze.get(t)
        if sq and eng.paged:
            n_pages, hold = sq
            n_pages = min(n_pages, eng.alloc.free_pages,
                          eng.alloc.cfg.max_blocks)
            if n_pages > 0:
                key = -1000 - t          # pseudo-slot, never a real slot id
                eng.alloc.allocate(key, n_pages * eng.page_size)
                self._squeezes[key] = t + hold
                self.counts["page_squeeze"] += 1
                self.events.append((t, f"squeeze {n_pages} pages"))
        if self.role is not None:
            tgt = self.plan.crash_workers.get(t)
            if tgt is not None and tuple(tgt) == self.role:
                self.counts["crash"] += 1
                self.events.append((t, f"crash {self.role[0]}{self.role[1]}"))
                raise InjectedFault(
                    t, f"injected {self.role[0]}-worker {self.role[1]} "
                       f"loss at step {t}")
        if t in self.plan.crash_steps:
            self.counts["crash"] += 1
            self.events.append((t, "crash"))
            raise InjectedFault(t)

    def release_all(self, eng):
        """Drop every outstanding page squeeze (e.g. after the engine
        drains before a squeeze's scheduled release step)."""
        for key in list(self._squeezes):
            if eng.alloc is not None and eng.alloc.owns(key):
                eng.alloc.free_slot(key)
            del self._squeezes[key]

    def poison_rows(self, eng) -> List[int]:
        """Live decode rows whose logits the engine must treat as
        non-finite this step (deterministic per (seed, step))."""
        k = self.plan.nan_rows.get(eng.step_idx, 0)
        if not k:
            return []
        live = np.flatnonzero(eng.live)
        if live.size == 0:
            return []
        rng = np.random.default_rng((self.plan.seed, eng.step_idx))
        rows = rng.choice(live, size=min(k, live.size), replace=False)
        self.counts["nan"] += len(rows)
        self.events.append((eng.step_idx, f"nan rows {sorted(rows.tolist())}"))
        return [int(r) for r in rows]
