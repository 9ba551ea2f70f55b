"""Disaggregated prefill/decode serving: the router and its workers
(``repro.serving.disagg``, behaviour for behaviour).

Prefill is a bursty, compute-bound batch job and decode a steady,
latency-bound stream, so the topology runs them on separate worker pools:

* A :class:`PrefillWorker` (``role="prefill"``) admits queued requests and
  runs their prompt chunks; the moment a prefill finishes (its first token
  is produced there) the worker exports it as a
  :class:`~repro_torch.serving.engine.Handoff` and forgets it, so its slots
  and pages turn over at prefill rate.
* The :class:`Router` migrates each handoff into the decode worker with
  the most free slots (``migrate()``: fresh pages through
  ``import_pages``, the copied content written in, no second prefill), and
  applies backpressure by holding the handoff until a decode pool has a
  slot and the pages.
* A :class:`DecodeWorker` (``role="decode"``) takes requests only through
  ``migrate()`` and decodes them against its own paged pool.

Token streams equal a single engine's: the prefill chunks, the migrated
cache contents and each row's decode are the same computations on the
same values; only the pool they live in changes.

Exactly once across the handoff boundary: every worker shares one
emission-watermark dict (the router's), the router holds each handoff
until its request retires, and each worker keeps its own snapshot and
write-ahead-log recovery under ``snapshot_dir/prefill<i>`` or
``decode<i>``. A recovered prefill worker replays its queue and
re-exports: the router drops the duplicate handoffs by rid. A recovered
decode worker holds only what its snapshot saw: the router re-migrates
every rid it lost from the held handoff (regeneration is bit-identical and
the shared watermark suppresses re-emission). The chaos plan's
``crash_workers`` targets one (role, index) at a time through role-scoped
injectors.

The router reuses ``ServeEngine``'s policy methods unbound (spec coercion,
rejection, shedding, queue expiry, ``run``, ``collect``, ``generate``), on
the same attribute contract, so the two front ends cannot drift apart.

On a mesh (``mesh=``) every worker runs on the same mesh and every rank
makes the same submissions: each worker holds its shard of the one
parameter tree, and each rank's handoffs its slice of the pages. The
router's own clock reads are the engine's shared reading (rank 0's,
all-reduced at fixed points: once a ``submit``, once a step in
``_expire_ready``, once a terminal record), so every rank expires the same
handoffs; each worker's step keeps its scheduler checksum, so a rank whose
router diverged raises by name instead of hanging.
"""
from __future__ import annotations

import os
import time
from collections import deque
from collections.abc import Mapping
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.serving.engine import (EngineConfig, Handoff, RejectReason,
                                        Request, RequestStatus, ServeEngine,
                                        _req_from_json, pages_for)


class PrefillWorker(ServeEngine):
    """Chunked-prefill engine (``role="prefill"``): admits queued
    requests, runs their prompt chunks on the ``prefill`` plans, then
    exports every finished prefill into ``outbox`` as a :class:`Handoff`
    instead of decoding it. A prefill worker never decodes, so after each
    step every live slot is a finished prefill."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, role="prefill", **kw)
        self.outbox: List[Handoff] = []

    def _after_phases(self):
        for slot in range(self.B):
            if self.live[slot] and self.slot_req[slot] is not None:
                self.outbox.append(self.export_handoff(slot))


class DecodeWorker(ServeEngine):
    """Slot-scheduler decode engine (``role="decode"``): requests enter
    only through ``migrate()`` and run the ``decode`` plans against this
    worker's own paged pool; ``submit()`` is refused."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, role="decode", **kw)


class Router:
    """The admission front end and scheduler of the topology. One
    ``step()`` is one tick of the whole fleet: expire, dispatch, prefill
    workers step, drain the outboxes, migrate ready handoffs, decode
    workers step, collect the finished. Workers step once a tick, so their
    monotonic step counters align with the router's and a chaos plan's
    ``crash_workers`` schedule means the same instant on every worker."""

    def __init__(self, cfg, econfig: EngineConfig, params=None, mesh=None,
                 clock: Optional[Callable[[], float]] = None,
                 on_token: Optional[Callable[[int, int, int], None]] = None,
                 faults="auto", device: DeviceLike = None):
        if not econfig.disagg:
            raise ValueError("Router needs an EngineConfig with disagg=True")
        ec = econfig
        self.cfg = cfg
        self.econfig = ec
        self.device = resolve_device(device)
        self.mesh = mesh
        self._world = (mesh.group(mesh.axis_names) if mesh is not None
                       else None)
        self._clock = clock or time.perf_counter
        self.on_token = on_token
        # router-level admission policy (workers get per-request deadlines
        # through the Request records; the bounded queue lives here)
        self.max_queue = ec.max_queue
        self.shed_policy = ec.shed_policy
        self.ttft_deadline_s = ec.ttft_deadline_s
        self.deadline_s = ec.deadline_s

        if faults == "auto":
            def injector(role):
                return ec.make_faults(role=role)
        elif faults is None or isinstance(faults, Mapping):
            def injector(role):
                return None if faults is None else faults.get(role)
        else:
            raise ValueError("faults must be 'auto', None, or a mapping "
                             "{(role, idx): FaultInjector}")
        recover = ec.recover
        if recover is None and ec.chaos_rate > 0:
            recover = True

        def subdir(role: str, i: int) -> Optional[str]:
            if ec.snapshot_dir is None:
                return None
            return os.path.join(ec.snapshot_dir, f"{role}{i}")

        # one parameter set for the fleet: at one rank the first worker's
        # tensors are handed to the next; on a mesh every worker keeps its
        # shard of the same full tree
        if params is None and mesh is not None:
            params = lm.init_params(cfg, ec.seed, self.device)
        common = dict(mesh=mesh, max_seq=ec.max_seq, chunk=ec.chunk,
                      seed=ec.seed, plan_cache=ec.plan_cache,
                      plan_hw=ec.plan_hw, page_size=ec.page_size,
                      admit_k=ec.admit_k, snapshot_every=ec.snapshot_every,
                      max_restarts=ec.max_restarts, recover=recover,
                      clock=clock, on_token=on_token, device=self.device)
        self.prefills: List[PrefillWorker] = []
        for i in range(ec.prefill_workers):
            w = PrefillWorker(cfg, params=params,
                              batch_size=ec.prefill_slots or ec.batch_size,
                              snapshot_dir=subdir("prefill", i),
                              faults=injector(("prefill", i)), **common)
            if mesh is None:
                params = w.params        # init once, share across the fleet
            self.prefills.append(w)
        self.decodes: List[DecodeWorker] = []
        for i in range(ec.decode_workers):
            w = DecodeWorker(cfg, params=params,
                             batch_size=ec.decode_slots or ec.batch_size,
                             n_pages=ec.n_pages,
                             snapshot_dir=subdir("decode", i),
                             faults=injector(("decode", i)), **common)
            if mesh is None:
                params = w.params
            self.decodes.append(w)
        self.params = params
        self.workers: List[ServeEngine] = [*self.prefills, *self.decodes]
        # the legalized geometry comes from the workers (they snap chunk
        # and page to divisors); admission checks must see what they see
        self.max_seq = self.workers[0].max_seq
        self.page_size = self.workers[0].page_size
        self._pool_cap = min(min(w.n_pages - 1, w.max_blocks)
                             for w in self.workers)
        # one emission watermark across the fleet: exactly-once delivery
        # must survive a request moving between workers; so must its
        # admission stamp (both popped by ``collect``)
        self.emitted: Dict[int, int] = {}
        self.admitted_t: Dict[int, float] = {}
        for w in self.workers:
            w.emitted = self.emitted
            w.admitted_t = self.admitted_t
        # router scheduler state
        self.queue: deque = deque()
        self.ready: deque = deque()               # rids awaiting migration
        self.handoffs: Dict[int, Handoff] = {}    # held until retire
        self.assigned: Dict[int, Tuple[str, int]] = {}  # rid -> (state, idx)
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        self.step_idx = 0
        # accounting
        self.migrations = 0
        self.remigrations = 0          # decode-crash re-migrations
        self.duplicate_handoffs = 0    # prefill-crash replays deduped
        self.pages_moved = 0
        self.shed = 0
        self.expired = 0

    # the router is the engine's admission front end: its policy methods
    # reused unbound (the same attribute contract: queue, clocks,
    # counters), so both submission surfaces validate and batch alike
    _world_rank = ServeEngine._world_rank
    _ranked = ServeEngine._ranked
    _shared_now = ServeEngine._shared_now
    _coerce_spec = ServeEngine._coerce_spec
    _reject = ServeEngine._reject
    _shed_victim = ServeEngine._shed_victim
    _expire_queued = ServeEngine._expire_queued
    run = ServeEngine.run
    collect = ServeEngine.collect
    generate = ServeEngine.generate

    # -- admission ----------------------------------------------------------

    def submit(self, request, max_new: int = 32,
               eos_id: Optional[int] = None,
               ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request with the fleet; returns its id. Validation
        matches ``ServeEngine.submit`` reason for reason (the same spec
        coercion, the same typed rejection); the capacity check runs
        against the tightest worker pool, so an admitted request can
        always prefill and decode."""
        now = self._shared_now()
        spec = self._coerce_spec(request, max_new, eos_id,
                                 ttft_deadline_s, deadline_s, now)
        req = Request(self._next_rid, list(spec.prompt), spec.max_new,
                      spec.eos_id, submit_t=now,
                      ttft_deadline_s=(self.ttft_deadline_s
                                       if spec.ttft_deadline_s is None
                                       else spec.ttft_deadline_s),
                      deadline_s=(self.deadline_s if spec.deadline_s is None
                                  else spec.deadline_s),
                      route_hint=spec.route_hint)
        self._next_rid += 1                    # rids stay unique on reject
        if spec.budget_tokens > self.max_seq:
            self._reject(req, RejectReason.TOO_LONG,
                         f"prompt {len(req.prompt)} + max_new "
                         f"{spec.max_new} exceeds max_seq {self.max_seq}")
        need = pages_for(spec.budget_tokens, self.page_size)
        if need > self._pool_cap:
            self._reject(req, RejectReason.OVER_CAPACITY,
                         f"request needs {need} pages, tightest worker "
                         f"pool holds {self._pool_cap}")
        if self.max_queue and len(self.queue) >= self.max_queue:
            victim = self._shed_victim(req)
            if victim is None:
                self._reject(req, RejectReason.QUEUE_FULL,
                             f"queue at max_queue={self.max_queue}")
            self._drop_queued(victim, RequestStatus.EXPIRED,
                              "shed: queue full")
            self.shed += 1
        req.status = RequestStatus.QUEUED
        self.queue.append(req)
        self.assigned[req.rid] = ("queued", -1)
        return req.rid

    def _drop_queued(self, req: Request, status: RequestStatus, error: str,
                     now: Optional[float] = None):
        self.queue.remove(req)
        self._finish(req, status, error, now)

    def _finish(self, req: Request, status: RequestStatus, error: str,
                now: Optional[float] = None):
        """Retire ``req`` at the router, stamped at the shared reading
        (``now``: a reading taken already, where the ranks may not all get
        here)."""
        req.status = status
        req.error = error
        req.done_t = self._shared_now() if now is None else now
        req.admit_t = self.admitted_t.get(req.rid, 0.0)
        if req.length < 0:
            req.length = len(req.tokens)
        self.finished[req.rid] = req
        self.handoffs.pop(req.rid, None)
        self.assigned[req.rid] = ("done", -1)

    # -- scheduling ---------------------------------------------------------

    @staticmethod
    def _free_slots(w: ServeEngine) -> int:
        return sum(1 for s in range(w.B)
                   if not w.live[s] and w.slot_req[s] is None)

    def _capacity(self, w: ServeEngine) -> int:
        return self._free_slots(w) - len(w.queue)

    def _pick_prefill(self, req: Request) -> Optional[int]:
        """The prefill worker for the queue's head: the route hint wins
        when it can admit (best-effort affinity), else the most-free
        worker that can. None: nobody can this tick (FIFO: wait, do not
        reorder around the head)."""
        budget = len(req.prompt) + req.max_new
        hinted = None
        if req.route_hint is not None:
            hinted = req.route_hint % len(self.prefills)
        best, best_cap = None, 0
        for i, w in enumerate(self.prefills):
            cap = self._capacity(w)
            if cap > 0 and w.alloc.can_admit(budget):
                if i == hinted:
                    return i
                if cap > best_cap:
                    best, best_cap = i, cap
        return best

    def _dispatch(self):
        while self.queue:
            req = self.queue[0]
            widx = self._pick_prefill(req)
            if widx is None:
                break
            self.queue.popleft()
            self.prefills[widx].enqueue(req)
            self.assigned[req.rid] = ("prefill", widx)

    def _drain_outboxes(self):
        for w in self.prefills:
            for h in w.outbox:
                st = self.assigned.get(h.rid, ("", -1))[0]
                if h.rid in self.handoffs or h.rid in self.finished \
                        or st in ("ready", "decode", "done"):
                    # a crash-replayed prefill re-exported a rid that
                    # already crossed the boundary: drop the duplicate
                    self.duplicate_handoffs += 1
                    continue
                self.handoffs[h.rid] = h
                self.ready.append(h.rid)
                self.assigned[h.rid] = ("ready", -1)
            w.outbox.clear()

    def _pick_decode(self, h: Handoff) -> Optional[int]:
        best, best_free = None, -1
        for i, w in enumerate(self.decodes):
            if w.can_import(h):
                free = self._free_slots(w)
                if free > best_free:
                    best, best_free = i, free
        return best

    def _migrate_ready(self):
        while self.ready:
            rid = self.ready[0]
            h = self.handoffs[rid]
            widx = self._pick_decode(h)
            if widx is None or not self.decodes[widx].migrate(h):
                break        # backpressure: hold the handoff, stay FIFO
            self.ready.popleft()
            self.assigned[rid] = ("decode", widx)
            self.migrations += 1
            self.pages_moved += h.n_content_pages

    def _expire_ready(self):
        """Total-latency deadlines apply while a handoff waits for decode
        capacity too: the prefill worker no longer owns the request."""
        now = self._shared_now()
        for rid in list(self.ready):
            h = self.handoffs[rid]
            d = h.req_json.get("deadline_s")
            if d is not None and now - h.req_json["submit_t"] > d:
                self.ready.remove(rid)
                req = _req_from_json(h.req_json)
                self._finish(req, RequestStatus.EXPIRED,
                             f"deadline {d:.3f}s exceeded awaiting "
                             f"decode capacity", now)
                self.expired += 1

    # -- worker stepping and crash reconciliation ---------------------------

    def _step_worker(self, role: str, idx: int, w: ServeEngine):
        before = w.recoveries
        w.step()
        if w.recoveries != before:
            # the worker restored a snapshot and replayed its log; patch
            # up what the restore cannot know about the rest of the fleet
            if role == "prefill":
                self._reconcile_prefill(w)
            else:
                self._reconcile_decode(idx, w)

    def _reconcile_prefill(self, w: PrefillWorker):
        """A recovered prefill worker replays every logged submission,
        rids that already crossed the handoff boundary included: purge
        those from its queue (their prefill would only give duplicate
        handoffs for the dedup to drop)."""
        for r in list(w.queue):
            st = self.assigned.get(r.rid, ("", -1))[0]
            if st in ("ready", "decode", "done"):
                w.queue.remove(r)

    def _reconcile_decode(self, idx: int, w: DecodeWorker):
        """A recovered decode worker holds only what its last snapshot
        saw: every rid migrated to it after that snapshot is gone.
        Re-migrate those from the held handoffs (regeneration from the
        prefill position is bit-identical, and the shared watermark
        suppresses tokens already delivered)."""
        present = {r.rid for r in w.slot_req if r is not None}
        present |= set(w.finished)
        lost = sorted(rid for rid, (st, wi) in self.assigned.items()
                      if st == "decode" and wi == idx
                      and rid not in present)
        for rid in reversed(lost):        # extend left, keep rid order
            self.ready.appendleft(rid)
            self.assigned[rid] = ("ready", -1)
        self.remigrations += len(lost)

    # -- the fleet tick -----------------------------------------------------

    def step(self) -> bool:
        """One tick of the whole topology; returns whether work remains.
        Worker crashes recover inside ``w.step()`` (snapshot restore and
        log replay) and the router reconciles the boundary; an exception
        escaping here means a worker exhausted ``max_restarts``: every
        request in flight then fails terminally before it re-raises."""
        self.step_idx += 1
        try:
            self._expire_queued()
            self._expire_ready()
            self._dispatch()
            for i, w in enumerate(self.prefills):
                self._step_worker("prefill", i, w)
            self._drain_outboxes()
            self._migrate_ready()
            for i, w in enumerate(self.decodes):
                self._step_worker("decode", i, w)
            self._collect_finished()
        except Exception as e:
            self._fail_all(e)
            raise
        return self.pending

    def _collect_finished(self):
        for w in self.workers:
            for rid in list(w.finished):
                req = w.finished.pop(rid)
                if rid in self.finished:
                    continue    # duplicate terminal after a recovery race
                # not ServeEngine.collect: the emission watermark must
                # outlive the worker's retirement (a restore could replay
                # the tail of a finished stream); it drops only when the
                # user collects from the router
                self.finished[rid] = req
                self.handoffs.pop(rid, None)
                self.assigned[rid] = ("done", -1)

    def _fail_all(self, error: Exception):
        msg = f"router failure: {type(error).__name__}: {error}"
        now = self._clock()       # a failure may be one rank's alone
        for r in list(self.queue):
            self._drop_queued(r, RequestStatus.FAILED, msg, now)
        for rid in list(self.ready):
            self.ready.remove(rid)
            self._finish(_req_from_json(self.handoffs[rid].req_json),
                         RequestStatus.FAILED, msg, now)
        self._collect_finished()     # the workers' own _fail_all records

    def cancel(self, rid: int) -> bool:
        """Cancel wherever the request lives: the router's queue, a
        handoff awaiting migration, or inside a worker."""
        for r in self.queue:
            if r.rid == rid:
                self._drop_queued(r, RequestStatus.CANCELLED, "cancelled")
                return True
        if rid in self.ready:
            self.ready.remove(rid)
            self._finish(_req_from_json(self.handoffs[rid].req_json),
                         RequestStatus.CANCELLED, "cancelled")
            return True
        for w in self.workers:
            if w.cancel(rid):
                req = w.finished.pop(rid)
                self._finish(req, RequestStatus.CANCELLED, req.error)
                return True
        return False

    # -- the ServeEngine surface --------------------------------------------

    @property
    def pending(self) -> bool:
        return bool(self.queue) or bool(self.ready) \
            or any(w.pending or w.outbox for w in self.prefills) \
            or any(w.pending for w in self.decodes)

    @property
    def decode_steps(self) -> int:
        return sum(w.decode_steps for w in self.decodes)

    @property
    def prefill_tokens(self) -> int:
        return sum(w.prefill_tokens for w in self.workers)

    @property
    def decode_tokens(self) -> int:
        return sum(w.decode_tokens for w in self.workers)

    @property
    def failures(self) -> int:
        return sum(w.failures for w in self.workers)

    @property
    def recoveries(self) -> int:
        return sum(w.recoveries for w in self.workers)

    @property
    def quarantined(self) -> int:
        return sum(w.quarantined for w in self.workers)

    def summary(self) -> Dict:
        """The fleet's accounting (the CLI's robustness summary)."""
        def agg(name: str) -> float:
            return sum(getattr(w, name) for w in self.workers)
        return {
            "requests_finished": len(self.finished),
            "migrations": self.migrations,
            "remigrations": self.remigrations,
            "duplicate_handoffs": self.duplicate_handoffs,
            "pages_moved": self.pages_moved,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_s": agg("prefill_s"),
            "decode_s": agg("decode_s"),
            "failures": self.failures,
            "recoveries": self.recoveries,
            "quarantined": self.quarantined,
            "expired": self.expired + int(agg("expired")),
            "shed": self.shed + int(agg("shed")),
            "per_worker": {
                f"prefill{i}": {"admissions": w.admissions,
                                "handoffs_out": w.handoffs_out,
                                "pages_exported": w.pages_exported,
                                "failures": w.failures,
                                "recoveries": w.recoveries}
                for i, w in enumerate(self.prefills)
            } | {
                f"decode{i}": {"migrations_in": w.migrations_in,
                               "pages_imported": w.pages_imported,
                               "decode_steps": w.decode_steps,
                               "failures": w.failures,
                               "recoveries": w.recoveries}
                for i, w in enumerate(self.decodes)
            },
        }
