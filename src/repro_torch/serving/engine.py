"""Continuous-batching serving engine: slot scheduler + masked chunked
prefill + per-row-position decode over a contiguous or a paged KV cache,
with the JAX engine's fault model.

``repro.serving.engine.ServeEngine``, behaviour for behaviour:
requests are ``submit()``-ed into a queue and admitted mid-flight into a
fixed pool of decode slots. Admission runs the prompts' chunks through
``lm.prefill_chunk``, batched: up to ``admit_k`` queued requests (0: one
for every free slot) run their chunks in one stacked call per chunk step,
the stack padded to a power of two with free slots as identity rows.
Decoding advances every slot at its own position; free slots decode too
and their tokens are ignored, as in the JAX engine, so both engines route
the same tokens through the MoE.
Attention, SSM and hybrid configs go through the same code: the cache
holds K/V or SSM carries per layer kind (``lm.init_cache``), and a slot's
SSM carry is reset inside the prefill step where a request starts.
With a tuned plan cache (``plan_cache``, ``plan_hw``) every MoE layer of a
prefill chunk resolves the cache's ``prefill`` entry and of a decode step
its ``decode`` entry, as the JAX engine's step builders thread them.

With ``page_size`` > 0 the K/V cache is paged (``serving/paged_cache.py``):
K/V live in page pools shared by every slot, a request owns just enough
pages for its ``prompt + max_new`` budget through a block table, claimed
at admission and freed when it retires, and admission waits, in arrival
order, for the free pages a request's budget needs. A budget no pool
could ever hold is rejected at ``submit`` (``OVER_CAPACITY``).

The lifecycle (the JAX engine's robustness model):

* Every request ends in a terminal ``status`` (ok, rejected, cancelled,
  expired, quarantined, failed); a malformed submission raises a typed
  :class:`RejectedRequest`.
* Per-request deadlines (TTFT and total) are checked at step boundaries;
  a bounded queue (``max_queue``) sheds load by a policy (reject the
  newcomer, or drop the queued request of least deadline slack).
* ``cancel(rid)`` retires a queued or a live request; a live one frees its
  slot and pages at once.
* A row whose logits are not all finite (or that the fault injector
  poisons) retires alone as ``quarantined``.
* ``snapshot()``/``restore()`` commit the scheduler's state with the cache
  through ``checkpoint/manager.py``'s atomic writer; a failed step
  restores the last snapshot and replays the event log written since, and
  a per-request emission watermark keeps ``on_token`` exactly-once.
* :class:`~repro_torch.serving.faults.FaultInjector` drives all of it
  through ``step()``'s hook.

Both calls go through the step builders of ``launch/train_step.py``,
built from one shape, so they share one cache layout. On a mesh
(``mesh=``, a ``parallel.mesh.Mesh`` with ("data", "model") axes over
the ranks of ``torch.distributed``) every rank runs this engine on the
same submissions: it holds its shard of the parameters
(``sharding.to_mesh``), its slice of the decode cache
(``sharding.cache_specs``) and the ranked MoE in every MoE layer. Every
rank sees every next token and every row's health (the decode step
all-gathers them together), and the request clock is rank 0's reading,
shared, so every rank takes the same lifecycle decisions. Each step
checks that the host schedulers agree with one all-reduce of a checksum
of the scheduler's state (the queue, the slots, the block tables and the
free list, the requests retired since the last check and the event log's
length), and raises if not. Each rank snapshots its own slice of the
cache under ``snapshot_dir/rank_<r>``; a restore takes the newest step
every rank committed.

The worker API of the disaggregated topology (``serving/disagg.py``):
``prefill_step()``/``decode_step()``, the two phases of ``step()``; a
``role`` ("prefill", "decode") that builds only the step it runs; and the
page-migration handoff, ``export_handoff(slot)`` -> :class:`Handoff` ->
``migrate(handoff)``: a finished prefill's written pages and per-slot SSM
carry move into another engine's pool as copies, and the request resumes
there at its prefill position without a second prefill. On a mesh each
rank's handoff holds its own slice of the pages (its kv heads, or the
whole pool where the pool is not cut), and a slot's SSM row, which lives
on one dp rank where the slots are cut, is gathered over dp at export.
``EngineConfig(disagg=True).build`` returns the ``Router``.

``stitch_prefill_cache`` writes a monolithic prefill's cache
(``lm.prefill``) into a contiguous decode cache, for the batched
(non-chunked) prefill path outside the engine.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.train_step import (build_decode_step,
                                           build_prefill_chunk_step)
from repro_torch.models import lm
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import sharding as SH
from repro_torch.serving.paged_cache import BlockAllocator, pages_for
from repro_torch.training.trainer import StragglerMonitor


def stitch_prefill_cache(cfg, decode_cache, prefill_cache, prompt_len: int):
    """Insert a monolithic prefill's cache (``lm.prefill``: stacked
    (n_periods, B, S, ...) per period position) into a contiguous decode
    cache of B slots at positions [0, prompt_len) (``repro/serving/
    engine.py:95-116``): K/V rows, the SSM's conv window and state. The
    port's caches are updated in place, so this writes into
    ``decode_cache`` and returns it (the JAX function returns a new
    tree)."""
    for entry, pre in zip(decode_cache, prefill_cache):
        for k, buf in entry.items():
            if k in ("k", "v"):
                buf[:, :, :prompt_len] = pre[k].to(buf.dtype)
            else:                            # conv window, ssm state
                buf.copy_(pre[k])
    return decode_cache


class RequestStatus(str, enum.Enum):
    """Lifecycle states. QUEUED/RUNNING are transient; the rest terminal."""
    QUEUED = "queued"
    RUNNING = "running"
    OK = "ok"
    REJECTED = "rejected"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    QUARANTINED = "quarantined"
    FAILED = "failed"


TERMINAL_STATUSES = frozenset({
    RequestStatus.OK, RequestStatus.REJECTED, RequestStatus.CANCELLED,
    RequestStatus.EXPIRED, RequestStatus.QUARANTINED, RequestStatus.FAILED})
# a status's index, for the schedulers' checksum on a mesh
_STATUS_CODE = {st: i for i, st in enumerate(RequestStatus)}


class RejectReason(str, enum.Enum):
    EMPTY_PROMPT = "empty_prompt"
    TOO_LONG = "too_long"               # prompt + max_new > max_seq
    OVER_CAPACITY = "over_capacity"     # page budget beyond the whole pool
    QUEUE_FULL = "queue_full"           # bounded queue, shed policy said no
    INVALID = "invalid"                 # spec field failed validation


class RejectedRequest(Exception):
    """Typed submission rejection, carrying the reason and the (terminal,
    status=rejected) request record; the engine stays serviceable."""

    def __init__(self, reason: RejectReason, msg: str, request=None):
        super().__init__(f"{reason.value}: {msg}")
        self.reason = reason
        self.msg = msg
        self.request = request


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """Typed submission. Validation runs in ``__post_init__`` and raises
    :class:`RejectedRequest` (``EMPTY_PROMPT``/``INVALID``); engine-relative
    checks (``TOO_LONG``, ``OVER_CAPACITY``, ``QUEUE_FULL``) stay in
    ``submit()``. Deadlines of None take the engine's defaults at submit.
    ``route_hint`` is the disaggregated topology's preferred prefill
    worker; a single engine ignores it."""
    prompt: Tuple[int, ...]
    max_new: int = 32
    eos_id: Optional[int] = None
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    route_hint: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.prompt, (str, bytes)):
            raise RejectedRequest(
                RejectReason.INVALID,
                "prompt must be a sequence of token ids, not text")
        try:
            prompt = tuple(int(t) for t in self.prompt)
        except (TypeError, ValueError) as e:
            raise RejectedRequest(
                RejectReason.INVALID,
                f"prompt must be a sequence of token ids ({e})") from e
        object.__setattr__(self, "prompt", prompt)
        if not prompt:
            raise RejectedRequest(RejectReason.EMPTY_PROMPT, "empty prompt")
        if not isinstance(self.max_new, (int, np.integer)) or \
                self.max_new < 1:
            raise RejectedRequest(
                RejectReason.INVALID,
                f"max_new must be a positive int, got {self.max_new!r}")
        if self.eos_id is not None and \
                not isinstance(self.eos_id, (int, np.integer)):
            raise RejectedRequest(
                RejectReason.INVALID,
                f"eos_id must be an int or None, got {self.eos_id!r}")
        for name in ("ttft_deadline_s", "deadline_s"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, (int, float))
                                  or isinstance(v, bool) or v <= 0):
                raise RejectedRequest(
                    RejectReason.INVALID,
                    f"{name} must be a positive number or None, got {v!r}")
        if self.route_hint is not None and \
                (not isinstance(self.route_hint, (int, np.integer))
                 or self.route_hint < 0):
            raise RejectedRequest(
                RejectReason.INVALID,
                f"route_hint must be a worker index >= 0 or None, "
                f"got {self.route_hint!r}")

    @property
    def budget_tokens(self) -> int:
        """Cache budget this request admits against (prompt + max_new)."""
        return len(self.prompt) + self.max_new


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray          # (B, max_new) generated ids
    lengths: np.ndarray         # (B,) tokens before eos/max
    prefill_tokens: int
    decode_steps: int
    statuses: List[str] = dataclasses.field(default_factory=list)
    rejected: Dict[int, RejectedRequest] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class Request:
    """One in-flight generation request (streaming API handle)."""
    rid: int
    prompt: List[int]
    max_new: int
    eos_id: Optional[int]
    tokens: List[int] = dataclasses.field(default_factory=list)
    length: int = -1            # tokens before eos; -1 while running
    slot: int = -1
    submit_t: float = 0.0
    first_token_t: float = 0.0  # TTFT = first_token_t - submit_t
    done_t: float = 0.0
    status: RequestStatus = RequestStatus.QUEUED
    error: str = ""
    ttft_deadline_s: Optional[float] = None   # first token within this
    deadline_s: Optional[float] = None        # whole request within this
    route_hint: Optional[int] = None          # preferred prefill worker

    @property
    def done(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.submit_t


_REQ_FIELDS = ("rid", "prompt", "max_new", "eos_id", "tokens", "length",
               "slot", "submit_t", "first_token_t", "done_t", "error",
               "ttft_deadline_s", "deadline_s", "route_hint")


def _req_to_json(r: Request) -> Dict:
    d = {k: getattr(r, k) for k in _REQ_FIELDS}
    d["status"] = r.status.value
    return d


def _req_from_json(d: Dict) -> Request:
    # .get: route_hint is absent from the JAX engine's older records
    kw = {k: d.get(k) if k == "route_hint" else d[k] for k in _REQ_FIELDS}
    kw["prompt"] = list(kw["prompt"])
    kw["tokens"] = list(kw["tokens"])
    return Request(status=RequestStatus(d["status"]), **kw)


@dataclasses.dataclass(frozen=True)
class Handoff:
    """One finished prefill crossing the worker boundary: what a decode
    pool needs to resume the request at its prefill position without a
    second prefill (``repro.serving.engine.Handoff``). ``kv`` holds copies
    of the written pages and of the slot's SSM carry, never views of the
    exporting pool: that pool reclaims the pages as the export returns and
    updates its cache in place, and the router re-migrates from the same
    record after a decode worker is lost.

    ``pages``: the source pool's page ids for the request's whole
    ``prompt + max_new`` budget; only the ``n_content_pages`` prefix holds
    written K/V and travels in ``kv`` (the tail's contents are masked by
    position, as in a reused slot). On a mesh ``kv`` is this rank's
    slice."""
    rid: int
    req_json: Dict              # request state at handoff (tokens=[first])
    pos: int                    # cache position = prompt length
    last_tok: int               # feeds the first decode step
    budget_tokens: int          # prompt + max_new (import page budget)
    pages: Tuple[int, ...]      # source page ids, block-table order
    block_table: Tuple[int, ...]  # source row (import cross-check)
    n_content_pages: int        # written prefix actually copied
    kv: Tuple                   # per cache entry: K/V page copies | SSM row


class ServeEngine:
    """``params``: the full one-rank tree (``lm.init_params``' layout), or
    None to draw it from ``seed``. On a mesh every rank draws or is handed
    the same full tree and keeps its shard of it (``sharding.to_mesh``,
    cut with FSDP as the JAX builders' default cuts it).

    ``page_size`` > 0: the paged cache, its page legalized to a divisor of
    ``max_seq`` (a block table tiles [0, max_seq) exactly), with
    ``n_pages`` pages counting the null page (0: parity capacity, every
    slot able to hold ``max_seq``: ``batch_size * max_seq / page_size +
    1``). ``admit_k``: at most that many admissions per stacked prefill
    call (0: every free slot).

    The lifecycle knobs are the JAX engine's: ``max_queue`` (0:
    unbounded) and ``shed_policy`` ("reject", "deadline" or a callable
    ``(engine, new_request) -> victim or None``), the default
    ``ttft_deadline_s``/``deadline_s``, ``snapshot_dir`` with a snapshot
    every ``snapshot_every`` steps (0: only by ``snapshot()``),
    ``max_restarts`` consecutive failed steps before the engine fails
    every request and re-raises, ``recover`` (default: on iff
    ``snapshot_dir`` is given), ``faults`` (a ``FaultInjector``),
    ``straggler_factor`` for ``monitor``, ``clock`` (every request stamp
    and deadline reads it; default ``time.perf_counter``), ``on_token(rid,
    idx, tok)`` (called exactly once per token) and ``role`` ("both",
    "prefill" or "decode": a role-restricted engine builds only its
    step)."""

    def __init__(self, cfg, params=None, max_seq: int = 256,
                 batch_size: int = 4, seed: int = 0, chunk: int = 0,
                 device: DeviceLike = None,
                 plan_cache: Optional[str] = None, plan_hw: str = "",
                 mesh=None, page_size: int = 0, n_pages: int = 0,
                 admit_k: int = 0, max_queue: int = 0,
                 shed_policy: Union[str, Callable] = "reject",
                 ttft_deadline_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 snapshot_dir: Optional[str] = None, snapshot_every: int = 8,
                 max_restarts: int = 3, recover: Optional[bool] = None,
                 faults=None, straggler_factor: float = 2.5,
                 clock: Optional[Callable[[], float]] = None,
                 on_token: Optional[Callable[[int, int, int], None]] = None,
                 role: str = "both"):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode, got {role!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.role = role
        self.max_seq = max_seq
        self.B = batch_size                       # decode slots
        # a chunk that divides max_seq tiles the cache exactly, so the last
        # chunk of any admissible prompt stays inside [0, max_seq)
        chunk = max(1, min(chunk or min(32, max_seq), max_seq))
        while max_seq % chunk:
            chunk -= 1
        self.chunk = chunk
        if page_size:
            page_size = max(1, min(page_size, max_seq))
            while max_seq % page_size:
                page_size -= 1
        self.page_size = page_size
        self.paged = page_size > 0
        self.max_blocks = max_seq // page_size if self.paged else 0
        if self.paged and not n_pages:
            n_pages = batch_size * self.max_blocks + 1
        self.n_pages = n_pages if self.paged else 0
        self.admit_k = admit_k
        # -- lifecycle knobs ------------------------------------------------
        self.max_queue = max_queue               # 0 = unbounded
        self.shed_policy = shed_policy           # "reject"|"deadline"|callable
        self.ttft_deadline_s = ttft_deadline_s   # per-request defaults
        self.deadline_s = deadline_s
        self.max_restarts = max_restarts         # consecutive step failures
        self.faults = faults                     # FaultInjector or None
        self.monitor = StragglerMonitor(straggler_factor)
        self._clock = clock or time.perf_counter
        self.on_token = on_token                 # exactly-once emission cb
        self.snapshot_every = snapshot_every
        self._world = (mesh.group(mesh.axis_names) if mesh is not None
                       else None)
        if snapshot_dir and self._world is not None:
            # each rank commits its own slice of the cache
            snapshot_dir = os.path.join(snapshot_dir,
                                        f"rank_{self._world_rank()}")
        self.ckpt = (CheckpointManager(snapshot_dir, keep=3,
                                       async_save=False)
                     if snapshot_dir else None)
        self.auto_recover = (recover if recover is not None
                             else snapshot_dir is not None)
        # one shape gives both steps the cache layout they share; a
        # role-restricted engine builds only the step it runs
        shape = ShapeConfig("serve_decode", seq_len=max_seq,
                            global_batch=batch_size, kind="decode",
                            page_size=self.page_size, n_pages=self.n_pages)
        self.prefill = (build_prefill_chunk_step(
            cfg, shape, mesh, chunk=chunk, plan_cache=plan_cache,
            plan_hw=plan_hw) if role != "decode" else None)
        self.decode = (build_decode_step(cfg, shape, mesh,
                                         plan_cache=plan_cache,
                                         plan_hw=plan_hw)
                       if role != "prefill" else None)
        # the configs the chunk and decode calls run under: each MoE layer
        # resolves its phase's plan from the cache, if one is given
        self.prefill_cfg = self.prefill["cfg"] if self.prefill else None
        self.decode_cfg = self.decode["cfg"] if self.decode else None
        self.ctx = (self.decode or self.prefill)["ctx"]
        if params is None:
            params = lm.init_params(cfg, seed, self.device)
        if mesh is not None:
            params = SH.to_mesh(params, cfg, self.ctx)
        self.params = params
        # the decode cache, updated in place, on a mesh this rank's slice
        # of it: one region (batch row) per slot, or page pools shared by
        # the slots and the page allocator's host state
        ctx = self.ctx if mesh is not None else None
        self.alloc = self.block_tables = None
        if self.paged:
            self.cache = lm.init_paged_cache(cfg, batch_size, self.n_pages,
                                             page_size, self.device, ctx)
            self.alloc = BlockAllocator(self.n_pages, page_size,
                                        self.max_blocks)
            self.block_tables = np.zeros((batch_size, self.max_blocks),
                                         np.int64)
        else:
            self.cache = lm.init_cache(cfg, batch_size, max_seq,
                                       self.device, ctx)
        # host scheduler state
        self.slot_req: List[Optional[Request]] = [None] * batch_size
        self.pos = np.zeros((batch_size,), np.int64)      # next write index
        self.live = np.zeros((batch_size,), bool)
        self.last_tok = np.zeros((batch_size,), np.int64)
        self.queue: deque = deque()
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        # exactly-once delivery ledger: rid -> tokens emitted so far. Never
        # rolled back by restore: replayed tokens below the watermark are
        # regenerated (bit-identically) but not re-emitted
        self.emitted: Dict[int, int] = {}
        # write-ahead event log since the last committed snapshot, replayed
        # after a restore so post-snapshot submits and drops are not lost
        self._log: List[Tuple] = []
        # (rid, status) retired since the last scheduler check (a mesh's)
        self._retired: List[Tuple[int, int]] = []
        # per-phase accounting (the CLI summary prints these)
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.prefill_tokens = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.admissions = 0
        self.admit_rounds = 0       # stacked chunk-admission calls
        # fault/recovery accounting
        self.step_idx = 0           # monotonic; NEVER rolled back by restore
        self.failures = 0           # total step failures
        self.recoveries = 0         # successful restore+replay cycles
        self.shed = 0               # queued requests dropped by load shedding
        self.expired = 0
        self.quarantined = 0
        self._consec_failures = 0
        # page-migration accounting (the disaggregated handoff)
        self.handoffs_out = 0       # finished prefills exported
        self.migrations_in = 0      # handoffs imported into this pool
        self.pages_exported = 0     # content pages copied out
        self.pages_imported = 0     # content pages copied in

    # -- the mesh's shared readings ----------------------------------------

    def _world_rank(self) -> int:
        return self._world.ranks.index(self.mesh.rank)

    def _ranked(self) -> bool:
        return self._world is not None and self._world.size > 1

    def _shared_now(self) -> float:
        """The clock every decision reads (a request's submit time, the
        deadline checks, the "deadline" shed policy): ``clock()``, on a
        mesh rank 0's reading, so every rank decides against the same
        time. A collective on a mesh: every rank reads it at the same
        points, once per ``submit`` and once per expiry check, whatever
        its state. Record-only stamps (first token, done) read the rank's
        own clock."""
        now = self._clock()
        if not self._ranked():
            return now
        t = torch.tensor([now if self._world_rank() == 0 else -np.inf],
                         dtype=torch.float64, device=self.device)
        return float(CL.all_reduce_(t, self._world, op="max")[0])

    # -- streaming API ------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device)

    def _reject(self, req: Request, reason: RejectReason, msg: str):
        req.status = RequestStatus.REJECTED
        req.error = f"{reason.value}: {msg}"
        req.done_t = self._clock()
        raise RejectedRequest(reason, msg, request=req)

    def _coerce_spec(self, request, max_new, eos_id, ttft_deadline_s,
                     deadline_s, now: float) -> RequestSpec:
        """Kwargs -> :class:`RequestSpec` (a spec passes through); a spec
        failure is re-raised with a terminal request record attached,
        submitted at ``now``."""
        if isinstance(request, RequestSpec):
            return request
        try:
            return RequestSpec(prompt=request, max_new=max_new,
                               eos_id=eos_id,
                               ttft_deadline_s=ttft_deadline_s,
                               deadline_s=deadline_s)
        except RejectedRequest as e:
            try:
                prompt = ([] if isinstance(request, (str, bytes))
                          else [int(t) for t in request])
            except (TypeError, ValueError):
                prompt = []
            rec = Request(self._next_rid, prompt,
                          max_new if isinstance(max_new, int) else 0,
                          None, submit_t=now)
            self._next_rid += 1            # rids stay unique on reject
            rec.status = RequestStatus.REJECTED
            rec.error = f"{e.reason.value}: {e.msg}"
            rec.done_t = self._clock()
            raise RejectedRequest(e.reason, e.msg, request=rec) from e

    def submit(self, request: Union[RequestSpec, Sequence[int]],
               max_new: int = 32, eos_id: Optional[int] = None,
               ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; returns its id. ``request`` is a
        :class:`RequestSpec` or a raw prompt plus the kwargs, which build
        a spec. Admission happens on the next ``step()``. Malformed
        requests raise :class:`RejectedRequest`; a full bounded queue
        applies the shedding policy first."""
        if self.role == "decode":
            raise RuntimeError(
                "decode-role worker takes migrated requests only "
                "(migrate()); submit through the router")
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
                         f"{spec.max_new} exceeds engine max_seq "
                         f"{self.max_seq}")
        if self.paged:
            # a budget beyond the whole pool would stall the FIFO page
            # gate, and everything queued behind it, forever
            need = pages_for(spec.budget_tokens, self.page_size)
            cap = min(self.n_pages - 1, self.max_blocks)
            if need > cap:
                self._reject(req, RejectReason.OVER_CAPACITY,
                             f"request needs {need} pages, pool holds {cap}")
        if self.max_queue and len(self.queue) >= self.max_queue:
            victim = self._shed_victim(req)
            if victim is None:
                self._reject(req, RejectReason.QUEUE_FULL,
                             f"queue at max_queue={self.max_queue}")
            self._drop_queued(victim, RequestStatus.EXPIRED,
                              "shed: queue full")
            self.shed += 1
        self.enqueue(req)
        return req.rid

    def enqueue(self, req: Request) -> None:
        """Append an already validated Request to the queue and the
        write-ahead log (``submit()`` lands here): a restore after a later
        snapshot replays it from token 0, watermark-deduped."""
        req.status = RequestStatus.QUEUED
        self.queue.append(req)
        self._log.append(("submit", _req_to_json(req)))

    def _shed_victim(self, new_req: Request) -> Optional[Request]:
        """The queued request to drop when the bounded queue is full (None:
        reject the newcomer). "deadline" drops the request of least
        deadline slack, if it has less than the newcomer; requests without
        deadlines have infinite slack and are never shed."""
        if callable(self.shed_policy):
            return self.shed_policy(self, new_req)
        if self.shed_policy == "reject":
            return None
        if self.shed_policy == "deadline":
            now = self._shared_now()

            def slack(r: Request) -> float:
                dls = [d for d in (r.ttft_deadline_s, r.deadline_s)
                       if d is not None]
                if not dls:
                    return float("inf")
                return min(dls) - (now - r.submit_t)

            if not self.queue:
                return None
            victim = min(self.queue, key=slack)
            return victim if slack(victim) < slack(new_req) else None
        raise ValueError(f"unknown shed_policy {self.shed_policy!r}")

    def _drop_queued(self, req: Request, status: RequestStatus, error: str):
        """Remove a queued request and retire it terminally (shed, cancel,
        deadline, failure); logged so a replay re-applies the drop."""
        self.queue.remove(req)
        req.status = status
        req.error = error
        req.done_t = self._clock()
        if req.length < 0:
            req.length = len(req.tokens)
        self.finished[req.rid] = req
        self._retired.append((req.rid, _STATUS_CODE[status]))
        self._log.append(("drop", req.rid, status.value, error))

    def cancel(self, rid: int) -> bool:
        """Cancel a request by id: a queued one leaves the queue, a live one
        retires at once (slot and pages freed, partial tokens kept).
        False if the rid is unknown or already terminal."""
        for r in self.queue:
            if r.rid == rid:
                self._drop_queued(r, RequestStatus.CANCELLED, "cancelled")
                return True
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                self._retire(slot, RequestStatus.CANCELLED, "cancelled")
                self._log.append(("drop", rid,
                                  RequestStatus.CANCELLED.value, "cancelled"))
                return True
        return False

    @property
    def pending(self) -> bool:
        return bool(self.queue) or bool(self.live.any())

    @property
    def free_pages(self) -> int:
        """Free pages in the pool (0 with the contiguous cache)."""
        return self.alloc.free_pages if self.paged else 0

    def _record_token(self, req: Request, tok: int, t_idx: int) -> bool:
        """Append a generated token; True when the request is done (eos,
        possibly on its very first token, or max_new). Emission is
        exactly-once: a token below the request's watermark (regenerated
        by a replay) is recorded but not passed to ``on_token`` again."""
        req.tokens.append(tok)
        idx = len(req.tokens) - 1
        if idx >= self.emitted.get(req.rid, 0):
            self.emitted[req.rid] = idx + 1
            if self.on_token is not None:
                self.on_token(req.rid, idx, tok)
        if req.eos_id is not None and tok == req.eos_id:
            req.length = t_idx
            return True
        if t_idx + 1 >= req.max_new:
            req.length = req.max_new
            return True
        return False

    def _retire(self, slot: int, status: RequestStatus = RequestStatus.OK,
                error: str = ""):
        req = self.slot_req[slot]
        req.done_t = self._clock()
        req.slot = -1
        req.status = status
        req.error = error
        if req.length < 0:
            req.length = len(req.tokens)
        self.finished[req.rid] = req
        self._retired.append((req.rid, _STATUS_CODE[status]))
        self.slot_req[slot] = None
        self.live[slot] = False
        if self.paged:
            # pages back to the free list; the zeroed table row steers this
            # (now dead) decode row's writes into the null page
            self.alloc.free_slot(slot)
            self.block_tables[slot] = 0

    # -- deadlines ----------------------------------------------------------

    def _expire_queued(self):
        now = self._shared_now()
        for r in list(self.queue):
            age = now - r.submit_t
            if r.ttft_deadline_s is not None and age > r.ttft_deadline_s:
                self._drop_queued(r, RequestStatus.EXPIRED,
                                  f"ttft deadline {r.ttft_deadline_s:.3f}s "
                                  f"exceeded in queue")
                self.expired += 1
            elif r.deadline_s is not None and age > r.deadline_s:
                self._drop_queued(r, RequestStatus.EXPIRED,
                                  f"deadline {r.deadline_s:.3f}s exceeded "
                                  f"in queue")
                self.expired += 1

    def _expire_live(self):
        now = self._shared_now()
        for slot in range(self.B):
            r = self.slot_req[slot]
            if r is None or not self.live[slot]:
                continue
            if r.deadline_s is not None and now - r.submit_t > r.deadline_s:
                self._retire(slot, RequestStatus.EXPIRED,
                             f"deadline {r.deadline_s:.3f}s exceeded "
                             f"after {len(r.tokens)} tokens")
                self.expired += 1

    # -- admission ----------------------------------------------------------

    def _gather_admissions(self) -> List[Tuple[int, Request]]:
        """Pop up to ``admit_k`` queued requests (FIFO) into free slots.
        With the paged cache each one's pages are claimed here, before the
        stacked call, so the stack never oversubscribes the pool; when the
        head of the queue does not fit, admission waits for pages rather
        than admitting around it."""
        k = self.admit_k or self.B
        free = [s for s in range(self.B) if not self.live[s]
                and self.slot_req[s] is None]
        pairs: List[Tuple[int, Request]] = []
        while self.queue and free and len(pairs) < k:
            req = self.queue[0]
            if self.paged:
                budget = len(req.prompt) + req.max_new
                if not self.alloc.can_admit(budget):
                    break
                pages = self.alloc.allocate(free[0], budget)
                self.block_tables[free[0], :len(pages)] = pages
            pairs.append((free.pop(0), self.queue.popleft()))
        return pairs

    def _admit_batch(self, pairs: List[Tuple[int, Request]]):
        """Chunked prefill of every (slot, request) pair in ONE stacked call
        per chunk step; rows whose prompt already ended ride along as
        identity rows. Each request's first token comes from its LAST
        chunk's logits row, and so does its health: a row whose last
        chunk's logits are not all finite is quarantined. The stack is
        padded up to a power of two with free slots as parking rows
        (valid_len 0: a parking row only scribbles on a free slot's
        region), as the JAX engine pads it to bound its compiles; the port
        keeps the padding so both engines run the same tokens through the
        MoE."""
        t0 = time.perf_counter()
        C = self.chunk
        A = len(pairs)
        taken = {s for s, _ in pairs}
        parking = [s for s in range(self.B)
                   if not self.live[s] and self.slot_req[s] is None
                   and s not in taken]
        n_pad = min(len(parking), (1 << max(0, A - 1).bit_length()) - A)
        slots = np.array([s for s, _ in pairs] + parking[:n_pad], np.int64)
        plens = np.array([len(r.prompt) for _, r in pairs] + [0] * n_pad,
                         np.int64)
        A = A + n_pad
        nchunks = np.maximum(1, -(-plens // C))
        first_tok = np.zeros((A,), np.int64)
        row_ok = np.ones((A,), bool)
        slots_t = self._tensor(slots)
        tables = ((self._tensor(self.block_tables[slots]),) if self.paged
                  else ())
        for j in range(int(nchunks.max())):
            toks = np.zeros((A, C), np.int64)
            valids = np.clip(plens - j * C, 0, C)
            for a, (_, r) in enumerate(pairs):
                part = r.prompt[j * C:(j + 1) * C]
                toks[a, :len(part)] = part
            offs = np.full((A,), j * C, np.int64)
            logits, self.cache = self.prefill["fn"](
                self.params, self.cache, self._tensor(toks),
                self._tensor(offs), self._tensor(valids), slots_t, *tables)
            # the next tokens and the rows' health in one copy to the host
            got = torch.stack([torch.argmax(logits, dim=-1),
                               torch.isfinite(logits).all(-1).long()],
                              -1).cpu().numpy()
            last = nchunks == j + 1
            first_tok[last] = got[last, 0]
            row_ok[last] = got[last, 1].astype(bool)
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += int(plens.sum())
        self.admissions += len(pairs)            # parking rows don't count
        self.admit_rounds += 1
        now = self._clock()
        for a, (slot, req) in enumerate(pairs):
            req.slot = slot
            req.status = RequestStatus.RUNNING
            if req.first_token_t <= 0:           # preserve TTFT on replay
                req.first_token_t = now
            self.slot_req[slot] = req
            self.pos[slot] = int(plens[a])
            self.last_tok[slot] = int(first_tok[a])
            self.live[slot] = True
            if not row_ok[a]:
                # non-finite prefill logits: quarantine THIS request only;
                # its garbage first token is never recorded
                self._retire(slot, RequestStatus.QUARANTINED,
                             "non-finite prefill logits")
                self.quarantined += 1
            elif self._record_token(req, int(first_tok[a]), 0):
                self._retire(slot)                # finished on token 0
        return pairs

    # -- the scheduler step -------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: fault hooks first, then queued deadline
        expiry, one stacked chunk-admission call, one decoded token per
        live slot (non-finite rows quarantined), live deadline expiry and
        a periodic snapshot. A failed step recovers (restore + replay)
        when ``auto_recover`` is on, re-raising only after
        ``max_restarts`` consecutive failures. Returns whether any work
        remains."""
        self.step_idx += 1
        t0 = self._clock()
        try:
            self._step_inner()
        except RejectedRequest:
            raise
        except Exception as e:
            self.failures += 1
            self._consec_failures += 1
            if not self.auto_recover or \
                    self._consec_failures > self.max_restarts:
                self._fail_all(e)
                raise
            self._recover(e)
            return self.pending
        self._consec_failures = 0
        self.monitor.observe(self.step_idx, self._clock() - t0)
        return self.pending

    def _step_inner(self):
        if self.faults is not None:
            self.faults.begin_step(self)   # latency / pressure / crash hook
        self._check_agreement()
        if self.role != "decode":
            self.prefill_step()
        if self.role != "prefill":
            self.decode_step()
        self._after_phases()
        if self.ckpt is not None and self.snapshot_every and \
                self.step_idx % self.snapshot_every == 0:
            self.snapshot()

    def _check_agreement(self):
        """Raises unless every rank's scheduler holds the same state before
        any collective of the step: the queue (ids, prompt lengths,
        budgets), the slots' requests, positions and last tokens, the
        block tables and free pages where the cache is paged (a diverged
        allocator would write other pages on each rank), the requests
        retired since the last check with their statuses, and the event
        log's length. One all-reduce (MAX) of (checksum, -checksum) over
        every rank. Without ranks it only clears the retired list."""
        retired, self._retired = self._retired, []
        if not self._ranked():
            return
        parts = [np.array([v for r in self.queue for v in (
            r.rid, len(r.prompt), r.max_new)], np.int64),
            np.array([-1 if r is None else r.rid for r in self.slot_req],
                     np.int64),
            self.live.astype(np.int64), self.pos, self.last_tok,
            np.array(retired, np.int64).reshape(-1),
            np.array([len(self._log)], np.int64)]
        if self.paged:
            parts += [self.block_tables.reshape(-1),
                      np.array(self.alloc.snapshot_state()["free"],
                               np.int64)]
        c = zlib.crc32(np.concatenate(parts).tobytes())
        t = torch.tensor([c, -c], dtype=torch.int64, device=self.device)
        CL.all_reduce_(t, self._world, op="max")
        lo, hi = -int(t[1]), int(t[0])
        if lo != c or hi != c:
            raise RuntimeError(f"the ranks' schedulers diverged: checksum "
                               f"{c} here, {lo}..{hi} over the ranks")

    # -- the two phases of step(), callable separately ----------------------

    def prefill_step(self) -> List[Tuple[int, Request]]:
        """The admission phase of one scheduler iteration: queued-deadline
        expiry, then one stacked chunk-admission call (free-page gated
        when paged). Returns the admitted (slot, request) pairs."""
        self._expire_queued()
        pairs = self._gather_admissions()
        if pairs:
            self._admit_batch(pairs)
        return pairs

    def decode_step(self) -> int:
        """The decode phase of one scheduler iteration: one decoded token
        per live slot (non-finite or poisoned rows quarantined), then
        live-deadline expiry. Returns how many rows decoded."""
        n = int(self.live.sum())
        if n:
            self._decode_once()
        self._expire_live()
        return n

    def _after_phases(self):
        """Hook between the scheduler phases and the periodic snapshot
        (``disagg.PrefillWorker`` exports its handoffs here)."""

    def _decode_once(self):
        t0 = time.perf_counter()
        tables = ((None, self._tensor(self.block_tables)) if self.paged
                  else ())
        # no live mask: only the live slots' tokens are read below; the
        # rows' health comes back with the tokens, in one copy
        got, _, self.cache = self.decode["fn"](
            self.params, self.cache, self._tensor(self.last_tok[:, None]),
            self._tensor(self.pos), *tables, health=True)
        got = got.cpu().numpy()
        nxt, row_ok = got[:, 0], got[:, 1].astype(bool)
        # a poisoned request retires alone instead of taking the engine
        # (or its batch neighbours) down
        poisoned = (set(self.faults.poison_rows(self))
                    if self.faults is not None else set())
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        self.decode_tokens += int(self.live.sum())
        for slot in range(self.B):
            if not self.live[slot]:
                continue
            req = self.slot_req[slot]
            if slot in poisoned or not row_ok[slot]:
                self._retire(slot, RequestStatus.QUARANTINED,
                             f"non-finite logits after {len(req.tokens)} "
                             f"tokens")
                self.quarantined += 1
                continue
            self.pos[slot] += 1
            self.last_tok[slot] = int(nxt[slot])
            if self._record_token(req, int(nxt[slot]), len(req.tokens)):
                self._retire(slot)

    # -- page-migration handoff (disaggregated prefill/decode) --------------

    def _slot_home(self, slot: int) -> Tuple[bool, int]:
        """Whether this rank holds ``slot``'s SSM row, and its index here:
        on a mesh whose slots are cut over dp only one dp rank holds it."""
        layout = (self.decode or self.prefill)["layout"]
        if layout is None or not layout.slots_cut:
            return True, slot
        base = SH._dp_index(self.ctx, self.ctx.dp_axes) * layout.local_slots
        return base <= slot < base + layout.local_slots, slot - base

    def _slot_row(self, t: torch.Tensor, slot: int) -> torch.Tensor:
        """A copy of ``slot``'s row of a per-slot cache entry (n_periods,
        slots, ...); where the slots are cut over dp, gathered over dp from
        the rank that holds it (a collective every rank reaches)."""
        layout = (self.decode or self.prefill)["layout"]
        if layout is None or not layout.slots_cut:
            return t[:, slot].clone()
        mine, local = self._slot_home(slot)
        row = (t[:, local] if mine else torch.zeros_like(t[:, 0]))
        got = CL.all_gather(row.contiguous(),
                            self.mesh.group(self.ctx.dp_axes))
        return got[slot // layout.local_slots].clone()

    def export_handoff(self, slot: int) -> Handoff:
        """Detach a live request from this engine as a :class:`Handoff`:
        copy its written K/V pages (and its slot's SSM carry) out of the
        pools, free the slot and its pages, and return the record. The
        request is not retired: it goes on in whichever engine imports
        the handoff, and this one forgets it (its capacity is back at
        once)."""
        if not self.paged:
            raise RuntimeError("page-migration handoff needs a paged cache")
        req = self.slot_req[slot]
        if req is None or not self.live[slot]:
            raise RuntimeError(f"export_handoff({slot}): slot is not live")
        pos = int(self.pos[slot])
        n_content = pages_for(pos, self.page_size)
        owned = self.alloc.owned(slot)
        content = self._tensor(np.asarray(owned[:n_content]))
        kv = []
        for e in self.cache:
            if "k" in e:     # shared page pool: copy the written prefix
                kv.append({k: e[k].index_select(1, content)
                           for k in ("k", "v")})
            else:            # dense per-slot SSM carry: copy the slot row
                kv.append({k: self._slot_row(e[k], slot) for k in e})
        hand = Handoff(rid=req.rid, req_json=_req_to_json(req), pos=pos,
                       last_tok=int(self.last_tok[slot]),
                       budget_tokens=len(req.prompt) + req.max_new,
                       pages=tuple(owned),
                       block_table=tuple(int(p) for p in
                                         self.block_tables[slot]),
                       n_content_pages=n_content, kv=tuple(kv))
        self.alloc.export_pages(slot)
        self.block_tables[slot] = 0
        self.slot_req[slot] = None
        self.live[slot] = False
        self.pos[slot] = 0
        req.slot = -1
        self.handoffs_out += 1
        self.pages_exported += n_content
        return hand

    def can_import(self, hand: Handoff) -> bool:
        """Whether :meth:`migrate` would succeed now (a free slot and the
        handoff's whole page budget): the router's backpressure gate; a
        False keeps the handoff queued at the router."""
        free = any(not self.live[s] and self.slot_req[s] is None
                   for s in range(self.B))
        return (self.paged and free
                and self.alloc.can_admit(hand.budget_tokens))

    def migrate(self, hand: Handoff) -> bool:
        """Import a migrated prefill: bind a free slot, allocate the
        destination page budget (``import_pages``: fresh ids, the
        handoff's metadata cross-checked), copy the content pages and the
        SSM carry into the pools, and resume the request at its handoff
        position. Returns False with no side effect when no slot or pages
        are free (backpressure); raises AllocatorError on a torn handoff,
        and ValueError on a handoff whose copies have another dtype or
        device than this pool (no conversion)."""
        if not self.paged:
            raise RuntimeError("page-migration handoff needs a paged cache")
        if self.role == "prefill":
            raise RuntimeError("prefill-role worker cannot import decodes")
        if not self.can_import(hand):
            return False
        for e, h in zip(self.cache, hand.kv):
            for k, t in h.items():
                if t.dtype != e[k].dtype or t.device != e[k].device:
                    raise ValueError(
                        f"migrate: handoff {hand.rid}'s {k} is {t.dtype} on "
                        f"{t.device}, this pool's {e[k].dtype} on "
                        f"{e[k].device}")
        slot = next(s for s in range(self.B)
                    if not self.live[s] and self.slot_req[s] is None)
        dst = self.alloc.import_pages(slot, hand.pages, hand.block_table)
        row = np.zeros((self.max_blocks,), np.int64)
        row[:len(dst)] = dst
        self.block_tables[slot] = row
        dst_content = self._tensor(np.asarray(dst[:hand.n_content_pages]))
        mine, local = self._slot_home(slot)
        for e, h in zip(self.cache, hand.kv):
            if "k" in e:
                for k in ("k", "v"):
                    e[k].index_copy_(1, dst_content, h[k])
            elif mine:
                for k in e:
                    e[k][:, local] = h[k]
        req = _req_from_json(hand.req_json)
        req.slot = slot
        req.status = RequestStatus.RUNNING
        self.slot_req[slot] = req
        self.pos[slot] = hand.pos
        self.last_tok[slot] = hand.last_tok
        self.live[slot] = True
        self.migrations_in += 1
        self.pages_imported += hand.n_content_pages
        return True

    # -- snapshot / restore / recovery --------------------------------------

    def _device_state(self) -> Dict:
        state = {"cache": self.cache, "pos": self.pos, "live": self.live,
                 "last_tok": self.last_tok}
        if self.paged:
            state["block_tables"] = self.block_tables
        return state

    def snapshot(self):
        """Commit the scheduler's state and the cache (this rank's slice of
        it) in one atomic rename, and clear the write-ahead event log:
        what came before is in the snapshot, what comes after replays. The
        cache is copied to the host before ``snapshot`` returns, so the
        next step's in-place updates never reach it."""
        if self.ckpt is None:
            raise RuntimeError("snapshot() needs snapshot_dir")
        by_rid: Dict[int, Request] = {r.rid: r for r in self.queue}
        by_rid.update({r.rid: r for r in self.slot_req if r is not None})
        by_rid.update(self.finished)
        extra = {
            "requests": {str(rid): _req_to_json(r)
                         for rid, r in by_rid.items()},
            "queue": [r.rid for r in self.queue],
            "slots": [r.rid if r is not None else None
                      for r in self.slot_req],
            "finished": sorted(self.finished),
            "next_rid": self._next_rid,
            "alloc": self.alloc.snapshot_state() if self.paged else None,
        }
        self.ckpt.save(self.step_idx, self._device_state(), wait=True,
                       extra=extra)
        self._log = []

    def _latest_common_step(self) -> Optional[int]:
        """The newest snapshot step, on a mesh the newest that every rank
        committed (an all-reduce MIN)."""
        have = self.ckpt.latest_step()
        if not self._ranked():
            return have
        t = torch.tensor([-(have if have is not None else -1)],
                         dtype=torch.int64, device=self.device)
        common = -int(CL.all_reduce_(t, self._world, op="max")[0])
        return None if common < 0 else common

    def restore(self, step: Optional[int] = None):
        """Restore the scheduler and the cache from the latest (or a given)
        committed snapshot, the cache copied into the live tensors (their
        device, dtypes and layout). The monotonic step counter and the
        emission ledger are not rolled back."""
        if self.ckpt is None:
            raise RuntimeError("restore() needs snapshot_dir")
        self.ckpt.wait()
        if step is None:
            step = self._latest_common_step()
            if step is None:
                raise FileNotFoundError(
                    f"no snapshot every rank committed in {self.ckpt.dir}")
        state, step = self.ckpt.restore(self._device_state(), step=step,
                                        device="cpu")
        extra = self.ckpt.load_extra(step)
        for live, saved in zip(self.cache, state["cache"]):
            for k, t in live.items():
                t.copy_(saved[k])
        self.pos = state["pos"].astype(np.int64)
        self.live = state["live"].astype(bool)
        self.last_tok = state["last_tok"].astype(np.int64)
        if self.paged:
            self.block_tables = state["block_tables"].astype(np.int64)
            self.alloc.restore_state(extra["alloc"])
            # injected page squeezes (negative pseudo-slots) are transient
            # memory pressure, not scheduler state: not resurrected (the
            # injector's own release is owns()-guarded, no double free)
            for s in [int(s) for s in extra["alloc"]["owned"]
                      if int(s) < 0]:
                self.alloc.free_slot(s)
        reqs = {int(rid): _req_from_json(d)
                for rid, d in extra["requests"].items()}
        self.queue = deque(reqs[rid] for rid in extra["queue"])
        self.slot_req = [reqs[rid] if rid is not None else None
                         for rid in extra["slots"]]
        self.finished = {rid: reqs[rid] for rid in extra["finished"]}
        self._next_rid = max(self._next_rid, int(extra["next_rid"]))

    def _reset_empty(self):
        """No committed snapshot: back to the engine's initial (empty)
        state, the cache zeroed in place; the whole event log then replays
        every submission."""
        for e in self.cache:
            for t in e.values():
                t.zero_()
        self.pos[:] = 0
        self.live[:] = False
        self.last_tok[:] = 0
        self.queue = deque()
        self.slot_req = [None] * self.B
        if self.paged:
            self.alloc = BlockAllocator(self.n_pages, self.page_size,
                                        self.max_blocks)
            self.block_tables = np.zeros((self.B, self.max_blocks), np.int64)

    def _replay_log(self):
        """Re-apply the post-snapshot external events (submits, drops) in
        order. Replayed submissions start from token 0: regeneration is
        bit-identical and the emission watermark suppresses duplicates."""
        log, self._log = self._log, []
        for ev in log:
            if ev[0] == "submit":
                d = dict(ev[1])
                d["tokens"], d["length"] = [], -1
                d["slot"], d["first_token_t"], d["done_t"] = -1, 0.0, 0.0
                d["status"] = RequestStatus.QUEUED.value
                self.queue.append(_req_from_json(d))
                self._log.append(("submit", ev[1]))
            elif ev[0] == "drop":
                _, rid, status, error = ev
                self._apply_drop(int(rid), RequestStatus(status), error)

    def _apply_drop(self, rid: int, status: RequestStatus, error: str):
        for r in list(self.queue):
            if r.rid == rid:
                self._drop_queued(r, status, error)
                return
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                self._retire(slot, status, error)
                self._log.append(("drop", rid, status.value, error))
                return

    def _recover(self, error: Exception):
        """Restore the last committed snapshot (or reset empty) and replay
        the event log: in-flight work resumes where the snapshot left it;
        post-snapshot submissions re-enter the queue."""
        have = (self._latest_common_step() if self.ckpt is not None
                else None)
        if have is not None:
            self.restore(have)
        else:
            self._reset_empty()
        self._replay_log()
        self.recoveries += 1
        print(f"[serve] step {self.step_idx} failed "
              f"({type(error).__name__}: {error}); restored snapshot "
              f"{'@step %d' % have if have is not None else '(initial)'} "
              f"+ replayed log ({self._consec_failures}/"
              f"{self.max_restarts} consecutive)")

    def _fail_all(self, error: Exception):
        """Unrecoverable engine failure: every non-terminal request reaches
        the terminal ``failed`` status, so no caller is left waiting."""
        msg = f"engine failure: {type(error).__name__}: {error}"
        for r in list(self.queue):
            self._drop_queued(r, RequestStatus.FAILED, msg)
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                self._retire(slot, RequestStatus.FAILED, msg)

    # -- drain / collect ----------------------------------------------------

    def run(self) -> Dict[int, Request]:
        """Drain queue + slots; returns {rid: finished Request}."""
        while self.pending:
            self.step()
        return self.finished

    def collect(self, rid: int) -> Request:
        """Pop a finished request's record (a long-running server must
        collect, or clear ``finished``: the engine keeps every uncollected
        request)."""
        self.emitted.pop(rid, None)
        return self.finished.pop(rid)

    def generate(self, prompts: Sequence[Union[Sequence[int], RequestSpec]],
                 max_new: int = 32,
                 eos_id: Optional[int] = None) -> GenerateResult:
        """Submit every prompt, run to completion, return a batch result
        (rows in submit order). More prompts than slots simply queue. A
        malformed prompt comes back zeroed (length 0, status "rejected")
        with its typed exception in ``result.rejected``."""
        base_steps = self.decode_steps
        rids: List[Optional[int]] = []
        rejected: Dict[int, RejectedRequest] = {}
        widths: List[int] = []
        pre_toks = 0
        for i, p in enumerate(prompts):
            widths.append(p.max_new if isinstance(p, RequestSpec)
                          else max_new)
            try:
                rids.append(self.submit(p, max_new=max_new, eos_id=eos_id))
                pre_toks += len(p.prompt if isinstance(p, RequestSpec)
                                else p)
            except RejectedRequest as e:
                rejected[i] = e
                rids.append(None)
        self.run()
        n = len(prompts)
        width = max(widths, default=max_new)
        out = np.zeros((n, width), np.int32)
        lengths = np.zeros((n,), np.int64)
        statuses: List[str] = []
        for i, rid in enumerate(rids):
            if rid is None:
                statuses.append(RequestStatus.REJECTED.value)
                continue
            req = self.collect(rid)
            t = req.tokens[:width]
            out[i, :len(t)] = t
            lengths[i] = req.length
            statuses.append(req.status.value)
        return GenerateResult(out, lengths, prefill_tokens=pre_toks,
                              decode_steps=self.decode_steps - base_steps,
                              statuses=statuses, rejected=rejected)


# ---------------------------------------------------------------------------
# Engine construction config
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineConfig:
    """Engine construction as one validated dataclass, in the groups the
    CLI shows (engine / paging / robustness / chaos / disagg), with the
    JAX package's fields, defaults and flag names. ``build(model_cfg)``
    returns a :class:`ServeEngine`, or with ``disagg`` set the
    ``serving.disagg.Router`` topology. ``add_cli_args``/``from_cli_args``
    map the flags."""
    # engine
    max_seq: int = 256
    batch_size: int = 4
    chunk: int = 0
    seed: int = 0
    plan_cache: Optional[str] = None
    plan_hw: str = ""
    # paging
    page_size: int = 0
    n_pages: int = 0
    admit_k: int = 0
    # robustness
    max_queue: int = 0
    shed_policy: Union[str, Callable] = "reject"
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 8
    max_restarts: int = 3
    recover: Optional[bool] = None
    # chaos (seeded fault injection; rate 0 = off)
    chaos_rate: float = 0.0
    chaos_seed: int = 0
    chaos_horizon: int = 256
    # disagg (router/worker topology; requires paging: the handoff is page
    # migration)
    disagg: bool = False
    prefill_workers: int = 1
    decode_workers: int = 1
    prefill_slots: int = 0      # 0 = batch_size
    decode_slots: int = 0       # 0 = batch_size

    def __post_init__(self):
        for name in ("max_seq", "batch_size", "prefill_workers",
                     "decode_workers"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        for name in ("chunk", "page_size", "n_pages", "admit_k",
                     "max_queue", "snapshot_every", "max_restarts",
                     "prefill_slots", "decode_slots"):
            if int(getattr(self, name)) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if not callable(self.shed_policy) and \
                self.shed_policy not in ("reject", "deadline"):
            raise ValueError(f"shed_policy must be reject|deadline|callable,"
                             f" got {self.shed_policy!r}")
        if self.chaos_rate < 0:
            raise ValueError(f"chaos_rate must be >= 0, "
                             f"got {self.chaos_rate}")
        if self.disagg and self.page_size <= 0:
            raise ValueError(
                "disagg mode needs a paged KV cache (page_size > 0): the "
                "prefill→decode handoff is page migration")

    # -- chaos --------------------------------------------------------------

    def worker_targets(self) -> Tuple[Tuple[str, int], ...]:
        """Every (role, index) in the disagg topology, crash-target
        order."""
        return (tuple(("prefill", i) for i in range(self.prefill_workers))
                + tuple(("decode", i) for i in range(self.decode_workers)))

    def make_faults(self, role: Optional[Tuple[str, int]] = None):
        """Seeded chaos injector from the chaos group (None when the rate
        is 0). In disagg mode crash draws target single workers, and each
        worker gets a role-scoped injector over the same plan."""
        if self.chaos_rate <= 0:
            return None
        from repro_torch.serving.faults import FaultInjector, FaultPlan
        plan = FaultPlan.poisson(
            self.chaos_seed, self.chaos_horizon,
            crash_rate=self.chaos_rate, nan_rate=self.chaos_rate,
            spike_rate=self.chaos_rate,
            workers=self.worker_targets() if self.disagg else ())
        return FaultInjector(plan, role=role)

    # -- construction -------------------------------------------------------

    def build(self, model_cfg, params=None, mesh=None,
              clock: Optional[Callable[[], float]] = None,
              on_token: Optional[Callable[[int, int, int], None]] = None,
              faults="auto", device: DeviceLike = None):
        """The engine this config describes (with ``disagg``, the
        ``Router``). ``faults="auto"`` derives the injector from the chaos
        group; pass an injector or None to override (disagg: a mapping
        ``{(role, index): FaultInjector}``). Chaos with ``recover`` unset
        turns recovery on."""
        if self.disagg:
            from repro_torch.serving.disagg import Router
            return Router(model_cfg, self, params=params, mesh=mesh,
                          clock=clock, on_token=on_token, faults=faults,
                          device=device)
        recover = self.recover
        if recover is None and self.chaos_rate > 0:
            recover = True
        inj = self.make_faults() if faults == "auto" else faults
        return ServeEngine(
            model_cfg, params=params, mesh=mesh, max_seq=self.max_seq,
            batch_size=self.batch_size, seed=self.seed,
            plan_cache=self.plan_cache, plan_hw=self.plan_hw,
            chunk=self.chunk, page_size=self.page_size,
            n_pages=self.n_pages, admit_k=self.admit_k,
            max_queue=self.max_queue, shed_policy=self.shed_policy,
            ttft_deadline_s=self.ttft_deadline_s, deadline_s=self.deadline_s,
            snapshot_dir=self.snapshot_dir,
            snapshot_every=self.snapshot_every,
            max_restarts=self.max_restarts, recover=recover, faults=inj,
            clock=clock, on_token=on_token, device=device)

    # -- CLI mapping --------------------------------------------------------

    @staticmethod
    def add_cli_args(ap) -> None:
        """Register the flag groups on an argparse parser (the JAX
        package's flag names and defaults)."""
        g = ap.add_argument_group("engine")
        g.add_argument("--max-seq", type=int, default=128)
        g.add_argument("--batch", type=int, default=4,
                       help="decode slots (disagg: default per-role slots)")
        g.add_argument("--chunk", type=int, default=16,
                       help="prefill chunk length")
        g.add_argument("--seed", type=int, default=0)
        g.add_argument("--plan-cache", default=None)
        g.add_argument("--plan-hw", default="")
        g = ap.add_argument_group("paging")
        g.add_argument("--page-size", type=int, default=0,
                       help="paged KV page length (0 = contiguous cache)")
        g.add_argument("--pages", type=int, default=0,
                       help="pool size incl. null page (0 = parity)")
        g.add_argument("--admit-k", type=int, default=0,
                       help="max stacked admissions per step (0 = slots)")
        g = ap.add_argument_group("robustness")
        g.add_argument("--max-queue", type=int, default=0,
                       help="bounded queue (0 = unbounded)")
        g.add_argument("--shed", default="reject",
                       choices=["reject", "deadline"])
        g.add_argument("--ttft-deadline", type=float, default=None)
        g.add_argument("--deadline", type=float, default=None)
        g.add_argument("--snapshot-dir", default=None)
        g.add_argument("--snapshot-every", type=int, default=8)
        g.add_argument("--max-restarts", type=int, default=3)
        g = ap.add_argument_group("chaos")
        g.add_argument("--chaos", type=float, default=0.0,
                       help="per-step fault rate (0 = off)")
        g.add_argument("--chaos-seed", type=int, default=0)
        g = ap.add_argument_group("disagg")
        g.add_argument("--disagg", action="store_true",
                       help="router/worker topology (needs --page-size)")
        g.add_argument("--prefill-workers", type=int, default=1)
        g.add_argument("--decode-workers", type=int, default=1)
        g.add_argument("--prefill-slots", type=int, default=0,
                       help="slots per prefill worker (0 = --batch)")
        g.add_argument("--decode-slots", type=int, default=0,
                       help="slots per decode worker (0 = --batch)")

    @classmethod
    def from_cli_args(cls, args, chaos_horizon: int = 0) -> "EngineConfig":
        """Parsed argparse namespace -> EngineConfig (flag names as
        registered by :meth:`add_cli_args`)."""
        return cls(max_seq=args.max_seq, batch_size=args.batch,
                   chunk=args.chunk, seed=args.seed,
                   plan_cache=args.plan_cache, plan_hw=args.plan_hw,
                   page_size=args.page_size, n_pages=args.pages,
                   admit_k=args.admit_k, max_queue=args.max_queue,
                   shed_policy=args.shed,
                   ttft_deadline_s=args.ttft_deadline,
                   deadline_s=args.deadline,
                   snapshot_dir=args.snapshot_dir,
                   snapshot_every=args.snapshot_every,
                   max_restarts=args.max_restarts,
                   chaos_rate=args.chaos, chaos_seed=args.chaos_seed,
                   chaos_horizon=chaos_horizon or 256,
                   disagg=args.disagg,
                   prefill_workers=args.prefill_workers,
                   decode_workers=args.decode_workers,
                   prefill_slots=args.prefill_slots,
                   decode_slots=args.decode_slots)
