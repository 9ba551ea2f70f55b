"""The serving loops: the program's engine (``serving/engine.py``,
``EngineConfig(...).build``), driven through ``submit`` and ``step``.

Set-up makes the weights from the seed, builds the engine and warms every
stack of admissions the window can make (one, two, four ... up to every
slot, prompts of one chunk) and its decode. The harness stamps, on the
host, each request's arrival and each token as ``on_token`` hands it over.

* ``batch``: an offline batch. Set-up fills every slot and the window
  keeps ``queue_depth`` requests waiting, so the engine never runs dry.
  The window ends with the first step that ends ``seconds`` after it
  began; the rate is the tokens stamped inside it over its length.
* ``rate``: open-loop arrivals on the traffic's schedule from the start of
  the window, each request timed from when it was due. After the window
  the schedule runs on until every request that arrived inside it has its
  first token (at most a minute).

Once the window has closed and the engine is freed, a sample of the
finished requests, drawn from the seed with the longest among them, is
run through the reference over prompt and served tokens.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import adapter
from portbench import weights as W
from portbench.reference import compare as RC
from portbench.reference import model as RM
from portbench.trace import Trace
from portbench.yardstick import kernels as K
from portbench.yardstick import costs, stats
from portbench.yardstick import traffic as TR

DRAIN_S = 60.0
COUNTERS = ("decode_steps", "decode_tokens", "prefill_tokens", "decode_s",
            "prefill_s", "admit_rounds")


def _counters(eng) -> Dict[str, float]:
    return {k: getattr(eng, k) for k in COUNTERS}


def _warm(eng, chunk: int, vocab: int) -> None:
    """Every admission stack the window can make, largest first."""
    rng = np.random.default_rng(0)
    A = 1
    while A * 2 <= eng.B:
        A *= 2
    while A >= 1:
        for _ in range(A):
            eng.submit(rng.integers(0, vocab, size=chunk).tolist(),
                       max_new=2)
        while eng.step():
            pass
        A //= 2


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        mode: str, fault: Optional[Callable] = None, control: bool = False,
        check: bool = True) -> Dict:
    from repro_torch.serving import EngineConfig, RequestStatus

    model, spec, traf = cell.conf["model"], cell.spec, cell.traffic
    V = model["vocab_size"]
    cuda = str(device).startswith("cuda")
    cfg = adapter.program_config(cell.conf)
    layout = RM.param_layout(model)
    pdt = adapter.param_dtype(cell.conf)
    init_std = cell.conf.get("init_std")
    params = adapter.program_params(W.make(layout, seed, device, pdt,
                                           init_std))
    toks: Dict[int, List] = {}              # rid -> [(t, token)]

    def on_token(rid, idx, tok):
        toks.setdefault(rid, []).append((time.perf_counter(), tok))

    eng = EngineConfig(max_seq=spec["max_seq"], batch_size=spec["slots"],
                       chunk=spec["chunk"]).build(
        cfg, params=params, on_token=on_token, device=device)
    if fault is not None:
        fault(eng)
    _warm(eng, eng.chunk, V)
    toks.clear()
    pool = TR.requests(seed, traf, V, int(spec["pool"]))
    arrival: Dict[int, float] = {}          # rid -> due time
    plen: Dict[int, int] = {}
    nxt = 0

    def submit(due: float):
        nonlocal nxt
        r = pool[nxt]
        nxt += 1
        rid = eng.submit(r.prompt.tolist(), max_new=r.max_new)
        arrival[rid], plen[rid] = due, len(r.prompt)

    steps: List[tuple] = []                 # (start, end)
    first_step: Dict[int, int] = {}         # rid -> step of its 1st token
    tr = Trace(trace)

    def one_step():
        ts = time.perf_counter()
        before = {rid for rid in arrival if rid not in toks}
        with tr.span("engine.step"):
            eng.step()
        steps.append((ts, time.perf_counter()))
        for rid in before:
            if rid in toks:
                first_step[rid] = len(steps) - 1

    if mode == "batch":
        depth = int(traf["queue_depth"])
        now = time.perf_counter()
        for _ in range(eng.B + depth):
            submit(now)
        one_step()                           # fills every slot
    _sync = torch.cuda.synchronize if cuda else (lambda: None)
    _sync()
    base = _counters(eng)
    pre_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with tr.window_ctx():
        tw0 = time.perf_counter()
        close = tw0 + seconds
        if mode == "batch":
            while True:
                while len(eng.queue) < depth and nxt < len(pool):
                    submit(time.perf_counter())
                one_step()
                if steps[-1][1] >= close:
                    break
        else:
            while True:
                now = time.perf_counter()
                while nxt < len(pool) and tw0 + pool[nxt].arrival_s <= now:
                    submit(tw0 + pool[nxt].arrival_s)
                if eng.pending:
                    one_step()
                elif nxt < len(pool):
                    time.sleep(max(0.0, min(0.002, tw0 + pool[nxt].arrival_s
                                            - now)))
                if time.perf_counter() >= close:
                    break
        tw1 = time.perf_counter()
        backlog = len(eng.queue)
    counters = {k: v - base[k] for k, v in _counters(eng).items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    end = tw1 if mode == "batch" else close
    in_window = [rid for rid, t in arrival.items() if t < end]
    if mode == "rate":                       # first tokens of the window's
        drain_end = time.perf_counter() + DRAIN_S
        while (any(rid not in toks for rid in in_window)
               and time.perf_counter() < drain_end):
            now = time.perf_counter()
            while nxt < len(pool) and tw0 + pool[nxt].arrival_s <= now:
                submit(tw0 + pool[nxt].arrival_s)
            if eng.pending:
                one_step()
    finished = {rid: eng.finished[rid] for rid in arrival
                if rid in eng.finished}
    failed = sum(1 for rid in in_window
                 if (rid in finished
                     and finished[rid].status != RequestStatus.OK)
                 or (mode == "rate" and rid not in toks))
    out_tokens = sum(1 for rid in toks for t, _ in toks[rid]
                     if tw0 <= t <= end)
    e2e: Dict[str, float] = {"setup_s": tw0 - t0}
    if mode == "batch":
        e2e["output_tokens_per_s"] = stats.rate(out_tokens, tw1 - tw0)
    else:
        ttft = [toks[rid][0][0] - arrival[rid] if rid in toks else end -
                arrival[rid] for rid in in_window]
        gaps = [b[0] - a[0] for rid in toks
                for a, b in zip(toks[rid], toks[rid][1:]) if tw0 <= b[0] <= end]
        e2e["ttft_p50_ms"] = 1e3 * stats.percentile(ttft, 50)
        e2e["itl_p95_ms"] = 1e3 * stats.percentile(gaps, 95)
    out: Dict = {"attempted": len(in_window), "failed": failed,
                 "end_to_end": e2e, "peak_bytes": max(pre_peak, peak)}
    if trace:
        rec = tr.record()
        # admitted after the close: the close bounds the wait from below
        waits = [min(steps[first_step[rid]][0], end) - arrival[rid]
                 if rid in first_step else end - arrival[rid]
                 for rid in in_window]
        # tokens the window processed and the query-key pairs they attend
        admitted = [rid for rid in first_step
                    if tw0 <= steps[first_step[rid]][0] < tw1]
        pairs = sum(costs.causal_pairs(plen[rid]) for rid in admitted)
        pairs += sum(plen[rid] + i for rid in toks
                     for i, (t, _) in enumerate(toks[rid])
                     if i >= 1 and tw0 <= t <= tw1)
        rec.update(loop="serve", mode=mode, model=model, chips=cell.chips,
                   host_window_s=tw1 - tw0, counters=counters,
                   slots=eng.B, queue_waits_s=waits,
                   model_flops=costs.serve_flops(
                       model, counters["prefill_tokens"]
                       + counters["decode_tokens"], pairs))
        out["record"] = rec
        out["breakdown"] = tr.breakdown(rec)
        out["moe"] = {"bounds": K.moe_bounds(rec),
                      "device_s": K.moe_device_s(rec)}
    done_in = sum(1 for r in finished.values() if tw0 <= r.done_t <= end)
    out["detail"] = {"backlog": backlog, "done_per_s": done_in / (end - tw0),
                     "arrived": len(in_window)}
    if mode == "rate":              # the tail, beside the median it stands in for
        out["detail"]["ttft_p90_ms"] = 1e3 * stats.percentile(ttft, 90)
    if not check:
        return out
    # the engine goes before the reference runs
    del eng, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ok = [rid for rid, r in finished.items()
          if r.status == RequestStatus.OK and rid in toks]
    sample = _sample(seed, ok, finished, int(spec["check_tokens"]))
    ref_w = W.make(layout, seed, device, pdt, init_std)
    gaps_ref, gaps_ctl = [], []
    for rid in sample:
        r = finished[rid]
        served = [tok for _, tok in toks[rid]]
        seq = torch.tensor(list(r.prompt) + served[:-1], device=device)
        rows = torch.arange(len(r.prompt) - 1, len(seq), device=device)
        ref = RM.logits(model, ref_w, seq, rows=rows)
        gaps_ref += RC.logit_gaps(ref, served)
        if control:
            ctl = RM.logits(model, ref_w, seq, RM.Prec("fp8"), rows=rows)
            gaps_ctl += RC.logit_gaps(ref, ctl.argmax(-1).tolist())
        del ref
    numbers = RC.gap_numbers(gaps_ref)
    limits = spec["limits"]
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    # a count that has to reach its limit, not stay under it
    out["checks"]["tokens_checked"] = {"value": len(gaps_ref),
                                       "limit": int(spec["check_tokens"])}
    out["correct"] = (RC.judge(numbers, limits) and failed == 0
                      and len(gaps_ref) >= int(spec["check_tokens"]))
    out["detail"].update(sampled=len(sample), finished_ok=len(ok),
                         **{k: v for k, v in numbers.items()
                            if k not in limits})
    if control:
        ctl = RC.gap_numbers(gaps_ctl)
        out["control"] = {**ctl, "correct": RC.judge(ctl, limits)}
    return out


def _sample(seed: int, ok: List[int], finished: Dict, target: int):
    """The longest finished request, then others in an order drawn from
    the seed, until ``target`` served tokens are covered."""
    if not ok:
        return []
    size = {rid: len(finished[rid].prompt) + len(finished[rid].tokens)
            for rid in ok}
    longest = max(ok, key=lambda rid: (size[rid], rid))
    rest = [rid for rid in sorted(ok) if rid != longest]
    order = np.random.default_rng([int(seed), 7]).permutation(len(rest))
    out, n = [longest], len(finished[longest].tokens)
    for i in order:
        if n >= target:
            break
        out.append(rest[i])
        n += len(finished[rest[i]].tokens)
    return out
