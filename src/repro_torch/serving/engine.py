"""Continuous-batching serving engine: slot scheduler + masked chunked
prefill + per-row-position decode over a contiguous KV cache.

The core of ``repro.serving.engine.ServeEngine``, behaviour for behaviour:
requests are ``submit()``-ed into a queue and admitted mid-flight into a
fixed pool of decode slots. Admission runs the prompts' chunks through
``lm.prefill_chunk``, batched: queued requests for every free slot run their
chunks in one stacked call per chunk step, the stack padded to a power
of two with free slots as identity rows. Decoding advances every slot at its
own position; free slots decode too and their tokens are ignored, as in
the JAX engine, so both engines route the same tokens through the MoE.
Attention, SSM and hybrid configs go through the same code: the cache
holds K/V or SSM carries per layer kind (``lm.init_cache``), and a slot's
SSM carry is reset inside the prefill step where a request starts.
With a tuned plan cache (``plan_cache``, ``plan_hw``) every MoE layer of a
prefill chunk resolves the cache's ``prefill`` entry and of a decode step
its ``decode`` entry, as the JAX engine's step builders thread them.

Not ported yet: the paged cache, deadlines and load shedding, cancel,
NaN quarantine, snapshot/restore and fault injection, and the
disaggregated topology.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.train_step import _with_plan_cache
from repro_torch.models import lm


class RequestStatus(str, enum.Enum):
    """Lifecycle states. QUEUED/RUNNING are transient; the rest terminal."""
    QUEUED = "queued"
    RUNNING = "running"
    OK = "ok"
    REJECTED = "rejected"


TERMINAL_STATUSES = frozenset({RequestStatus.OK, RequestStatus.REJECTED})


class RejectReason(str, enum.Enum):
    EMPTY_PROMPT = "empty_prompt"
    TOO_LONG = "too_long"               # prompt + max_new > max_seq
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
    :class:`RejectedRequest`; engine-relative checks (``TOO_LONG``) stay in
    ``submit()``."""
    prompt: Tuple[int, ...]
    max_new: int = 32
    eos_id: Optional[int] = None

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

    @property
    def done(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.submit_t


class ServeEngine:
    def __init__(self, cfg, params=None, max_seq: int = 256,
                 batch_size: int = 4, seed: int = 0, chunk: int = 0,
                 device: DeviceLike = None,
                 plan_cache: Optional[str] = None, plan_hw: str = ""):
        self.device = resolve_device(device)
        self.cfg = cfg
        # the configs the chunk and decode calls run under: each MoE layer
        # resolves its phase's plan from the cache, if one is given
        self.prefill_cfg = _with_plan_cache(cfg, plan_cache, plan_hw,
                                            "prefill")
        self.decode_cfg = _with_plan_cache(cfg, plan_cache, plan_hw,
                                           "decode")
        self.max_seq = max_seq
        self.B = batch_size                       # decode slots
        # a chunk that divides max_seq tiles the cache exactly, so the last
        # chunk of any admissible prompt stays inside [0, max_seq)
        chunk = max(1, min(chunk or min(32, max_seq), max_seq))
        while max_seq % chunk:
            chunk -= 1
        self.chunk = chunk
        if params is None:
            params = lm.init_params(cfg, seed, self.device)
        self.params = params
        # the decode cache, one region (batch row) per slot, updated in place
        self.cache = lm.init_cache(cfg, batch_size, max_seq, self.device)
        # host scheduler state
        self.slot_req: List[Optional[Request]] = [None] * batch_size
        self.pos = np.zeros((batch_size,), np.int64)      # next write index
        self.live = np.zeros((batch_size,), bool)
        self.last_tok = np.zeros((batch_size,), np.int64)
        self.queue: deque = deque()
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        # per-phase accounting (the CLI summary prints these)
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.prefill_tokens = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.admit_rounds = 0       # stacked chunk-admission calls

    # -- streaming API ------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device)

    def _reject(self, req: Request, reason: RejectReason, msg: str):
        req.status = RequestStatus.REJECTED
        req.error = f"{reason.value}: {msg}"
        req.done_t = time.perf_counter()
        raise RejectedRequest(reason, msg, request=req)

    def _coerce_spec(self, request, max_new, eos_id) -> RequestSpec:
        """Kwargs -> :class:`RequestSpec` (a spec passes through); a spec
        failure is re-raised with a terminal request record attached."""
        if isinstance(request, RequestSpec):
            return request
        try:
            return RequestSpec(prompt=request, max_new=max_new,
                               eos_id=eos_id)
        except RejectedRequest as e:
            try:
                prompt = ([] if isinstance(request, (str, bytes))
                          else [int(t) for t in request])
            except (TypeError, ValueError):
                prompt = []
            rec = Request(self._next_rid, prompt,
                          max_new if isinstance(max_new, int) else 0,
                          None, submit_t=time.perf_counter())
            self._next_rid += 1            # rids stay unique on reject
            rec.status = RequestStatus.REJECTED
            rec.error = f"{e.reason.value}: {e.msg}"
            rec.done_t = time.perf_counter()
            raise RejectedRequest(e.reason, e.msg, request=rec) from e

    def submit(self, request: Union[RequestSpec, Sequence[int]],
               max_new: int = 32, eos_id: Optional[int] = None) -> int:
        """Queue a request; returns its id. Admission happens on the next
        ``step()``. Malformed requests raise :class:`RejectedRequest`."""
        spec = self._coerce_spec(request, max_new, eos_id)
        req = Request(self._next_rid, list(spec.prompt), spec.max_new,
                      spec.eos_id, submit_t=time.perf_counter())
        self._next_rid += 1
        if spec.budget_tokens > self.max_seq:
            self._reject(req, RejectReason.TOO_LONG,
                         f"prompt {len(req.prompt)} + max_new "
                         f"{spec.max_new} exceeds engine max_seq "
                         f"{self.max_seq}")
        self.queue.append(req)
        return req.rid

    @property
    def pending(self) -> bool:
        return bool(self.queue) or bool(self.live.any())

    def _record_token(self, req: Request, tok: int, t_idx: int) -> bool:
        """Append a generated token; True when the request is done (eos,
        possibly on its very first token, or max_new)."""
        req.tokens.append(tok)
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
        req.done_t = time.perf_counter()
        req.slot = -1
        req.status = status
        req.error = error
        if req.length < 0:
            req.length = len(req.tokens)
        self.finished[req.rid] = req
        self.slot_req[slot] = None
        self.live[slot] = False

    # -- admission ----------------------------------------------------------

    def _gather_admissions(self) -> List[Tuple[int, Request]]:
        """Pop queued requests (FIFO) into free slots."""
        free = [s for s in range(self.B) if not self.live[s]
                and self.slot_req[s] is None]
        pairs: List[Tuple[int, Request]] = []
        while self.queue and free:
            pairs.append((free.pop(0), self.queue.popleft()))
        return pairs

    def _admit_batch(self, pairs: List[Tuple[int, Request]]):
        """Chunked prefill of every (slot, request) pair in ONE stacked call
        per chunk step; rows whose prompt already ended ride along as
        identity rows. Each request's first token comes from its LAST
        chunk's logits row. The stack is padded up to a power of two with
        free slots as parking rows (valid_len 0: a parking row only
        scribbles on a free slot's region), as the JAX engine pads it to
        bound its compiles; the port keeps the padding so both engines run
        the same tokens through the MoE."""
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
        slots_t = self._tensor(slots)
        for j in range(int(nchunks.max())):
            toks = np.zeros((A, C), np.int64)
            valids = np.clip(plens - j * C, 0, C)
            for a, (_, r) in enumerate(pairs):
                part = r.prompt[j * C:(j + 1) * C]
                toks[a, :len(part)] = part
            offs = np.full((A,), j * C, np.int64)
            logits, self.cache = lm.prefill_chunk(
                self.prefill_cfg, self.params, self.cache, self._tensor(toks),
                self._tensor(offs), self._tensor(valids), slots_t)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            last = nchunks == j + 1
            first_tok[last] = nxt[last]
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += int(plens.sum())
        self.admit_rounds += 1
        now = time.perf_counter()
        for a, (slot, req) in enumerate(pairs):
            req.slot = slot
            req.status = RequestStatus.RUNNING
            req.first_token_t = now
            self.slot_req[slot] = req
            self.pos[slot] = int(plens[a])
            self.last_tok[slot] = int(first_tok[a])
            self.live[slot] = True
            if self._record_token(req, int(first_tok[a]), 0):
                self._retire(slot)                # finished on token 0
        return pairs

    # -- the scheduler step -------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: one stacked chunk-admission call for
        queued requests, then one decoded token per live slot. Returns
        whether any work remains."""
        pairs = self._gather_admissions()
        if pairs:
            self._admit_batch(pairs)
        if self.live.any():
            self._decode_once()
        return self.pending

    def _decode_once(self):
        t0 = time.perf_counter()
        logits, self.cache = lm.decode_step(
            self.decode_cfg, self.params, self.cache,
            self._tensor(self.last_tok[:, None]), self._tensor(self.pos))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        self.decode_tokens += int(self.live.sum())
        for slot in range(self.B):
            if not self.live[slot]:
                continue
            req = self.slot_req[slot]
            self.pos[slot] += 1
            self.last_tok[slot] = int(nxt[slot])
            if self._record_token(req, int(nxt[slot]), len(req.tokens)):
                self._retire(slot)

    # -- drain / collect ----------------------------------------------------

    def run(self) -> Dict[int, Request]:
        """Drain queue + slots; returns {rid: finished Request}."""
        while self.pending:
            self.step()
        return self.finished

    def collect(self, rid: int) -> Request:
        """Pop a finished request's record."""
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
