"""The port's disaggregated serving (``repro_torch/serving/disagg.py``
and the handoff API of ``serving/engine.py``) against the JAX package's:
every test of ``tests/test_disagg.py`` runs as a scenario on both
packages, with bridged weights, the same fault plan and the same tick
clock, at the JAX file's geometry (qwen2-0.5b-smoke, max_seq 64, chunk 4,
page 8, 2 prefill and 2 decode slots). Each scenario asserts the JAX
test's own asserts on whichever package it drives and returns what it
saw: every request's tokens, length, status and error, the router's
``summary()`` (its wall-clock seconds left out), the ``on_token``
emissions in order and the injectors' counts. The port's must equal the
JAX package's exactly.

Added: the router against the shared engine on qwen2-moe-2.7b-smoke at
no-drop capacity (the MoE path migrates); a handoff that must hold copies
(a request admitted into the freed slot and pages before the first one
migrates); the serve CLI's ``--disagg`` with chaos.
"""
import contextlib
import dataclasses
import functools
import io
import tempfile
import types

import jax
import numpy as np
import pytest
import torch

import repro.serving as JS
import repro_torch.serving as TS
from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.serving import paged_cache as jpc
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serving import paged_cache as tpc

torch.set_num_threads(1)

DENSE, MOE, SSM = "qwen2-0.5b-smoke", "qwen2-moe-2.7b-smoke", \
    "mamba2-780m-smoke"
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 10, 11, 12, 13, 14, 15, 16, 17],
           [6, 5]]


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


class Ticks:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _side(pkg, cfg, params):
    """One package's factories: the JAX file's ``make_ec``,
    ``make_router``, ``make_shared`` and its two workers."""
    mod = JS if pkg == "jax" else TS
    dev = {} if pkg == "jax" else {"device": "cpu"}

    def ec(**kw):
        for k, v in dict(max_seq=64, chunk=4, page_size=8, disagg=True,
                         prefill_workers=1, decode_workers=1,
                         prefill_slots=2, decode_slots=2).items():
            kw.setdefault(k, v)
        return mod.EngineConfig(**kw)

    def build(econfig, **kw):
        return econfig.build(cfg, params=params, **dev, **kw)

    def shared(**kw):
        for k, v in dict(max_seq=64, batch_size=4, chunk=4,
                         page_size=8).items():
            kw.setdefault(k, v)
        return build(mod.EngineConfig(**kw))

    def worker(kind, **kw):
        return getattr(mod, kind)(cfg, params=params, max_seq=64,
                                  batch_size=2, chunk=4, page_size=8,
                                  **dev, **kw)

    return types.SimpleNamespace(
        pkg=pkg, mod=mod, cfg=cfg, params=params, ec=ec, build=build,
        router=lambda **kw: build(ec(**kw)), shared=shared, worker=worker,
        pc=jpc if pkg == "jax" else tpc)


@functools.lru_cache(maxsize=None)
def _sides(arch):
    """Both packages' sides of ``arch`` at no-drop capacity, the JAX
    weights drawn from seed 0 and bridged to the port."""
    jcfg, cfg = _no_drop(jax_config(arch)), _no_drop(get_config(arch))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return {"jax": _side("jax", jcfg, jp), "torch": _side("torch", cfg, tp)}


@pytest.fixture(scope="module")
def dense():
    return _sides(DENSE)


def _both(scenario, sides, *args):
    got = {pkg: scenario(side, *args) for pkg, side in sides.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def run_all(eng, prompts, max_new=4, **submit_kw):
    rids = [eng.submit(p, max_new=max_new, **submit_kw) for p in prompts]
    eng.run()
    return {r: list(map(int, eng.finished[r].tokens)) for r in rids}


def _seen(eng, emissions=None):
    """Everything a scenario compares: each finished request's tokens,
    length, status and error, the router's summary (its seconds left
    out), the emissions and the injectors' counts."""
    out = {"requests": {rid: (list(map(int, r.tokens)), int(r.length),
                              r.status.value, r.error)
                        for rid, r in sorted(eng.finished.items())}}
    if hasattr(eng, "summary"):
        out["summary"] = {k: v for k, v in eng.summary().items()
                          if k not in ("prefill_s", "decode_s")}
    if emissions is not None:
        out["emissions"] = [tuple(map(int, e)) for e in emissions]
    return out


# ---------------------------------------------------------------------------
# allocator page migration (no model)
# ---------------------------------------------------------------------------


def _alloc(E, n_pages=9, page_size=8, max_blocks=8):
    return E.pc.BlockAllocator(n_pages, page_size, max_blocks)


def _export_frees(E):
    a = _alloc(E)
    got = a.allocate(0, 20)                       # 3 pages
    free_before = a.free_pages
    pages = a.export_pages(0)
    assert pages == got
    assert a.free_pages == free_before + 3        # capacity back at handoff
    assert a.owned(0) == []
    return pages, a.free_pages


def _double_export(E):
    a = _alloc(E)
    a.allocate(0, 8)
    a.export_pages(0)
    with pytest.raises(E.pc.AllocatorError) as ei:
        a.export_pages(0)
    return str(ei.value)


def _import_count(E):
    src, dst = _alloc(E), _alloc(E)
    pages = src.allocate(0, 17)                   # 3 pages
    table = pages + [0] * 5
    src.export_pages(0)
    got = dst.import_pages(1, pages, table)
    assert len(got) == 3 and dst.owned(1) == got
    return got


def _import_torn(E):
    src, dst = _alloc(E), _alloc(E)
    pages = src.allocate(0, 17)
    src.export_pages(0)
    bad = list(pages)
    bad[1] = bad[1] + 1 if bad[1] + 1 not in bad else bad[1] + 2
    errs = []
    for p, t in [(pages, bad + [0] * 5),           # table disagrees
                 ([0] + pages[1:], [0] + pages[1:] + [0] * 5),  # null page
                 ([], [0] * 8)]:                   # empty handoff
        with pytest.raises(E.pc.AllocatorError) as ei:
            dst.import_pages(1, p, t)
        errs.append(str(ei.value))
    return errs


@pytest.mark.parametrize("case", [_export_frees, _double_export,
                                  _import_count, _import_torn],
                         ids=lambda f: f.__name__[1:])
def test_allocator_migration(dense, case):
    _both(case, dense)


# ---------------------------------------------------------------------------
# engine-level handoff: export on one engine, migrate into another
# ---------------------------------------------------------------------------


def _export_migrate(E):
    ref = run_all(E.shared(), PROMPTS[:1], max_new=5)
    a = E.worker("PrefillWorker")
    b = E.worker("DecodeWorker")
    b.emitted = a.emitted                         # shared watermark
    rid = a.submit(PROMPTS[0], max_new=5)
    while not a.outbox:                           # _after_phases exports
        a.step()                                  # each finished prefill
    hand = a.outbox.pop()
    assert not any(a.live) and a.handoffs_out == 1
    assert hand.n_content_pages == E.pc.pages_for(len(PROMPTS[0]),
                                                  a.page_size)
    assert b.can_import(hand) and b.migrate(hand)
    while b.pending:
        b.step()
    assert list(b.finished[rid].tokens) == ref[0]
    assert b.prefill_tokens == 0                  # pages moved, no re-prefill
    return (ref, hand.pos, hand.last_tok, hand.pages, hand.block_table,
            hand.n_content_pages, a.pages_exported, b.migrations_in,
            b.pages_imported, _seen(b))


def test_export_migrate_continues_bit_exact(dense):
    _both(_export_migrate, dense)


def _role_refusals(E):
    a = E.worker("PrefillWorker")
    assert a.decode is None
    errs = []
    with pytest.raises(RuntimeError) as ei:
        a.migrate(None)
    errs.append(str(ei.value))
    b = E.worker("DecodeWorker")
    assert b.prefill is None
    with pytest.raises(RuntimeError) as ei:       # decode role takes no
        b.submit(PROMPTS[0], max_new=2)           # direct submissions
    errs.append(str(ei.value))
    return errs


def test_prefill_worker_cannot_decode_or_migrate(dense):
    _both(_role_refusals, dense)


def test_migrate_refuses_other_dtype_unpaged_engine():
    """No conversion across the boundary: a handoff whose copies have
    another dtype than the pool raises; an unpaged engine raises."""
    E = _sides(DENSE)["torch"]
    a = E.worker("PrefillWorker")
    a.submit(PROMPTS[0], max_new=3)
    while not a.outbox:
        a.step()
    hand = a.outbox.pop()
    bad = dataclasses.replace(hand, kv=tuple(
        {k: t.double() for k, t in e.items()} for e in hand.kv))
    b = E.worker("DecodeWorker")
    with pytest.raises(ValueError, match="float64"):
        b.migrate(bad)
    assert b.migrations_in == 0 and not b.live.any()
    assert b.free_pages == b.n_pages - 1
    flat = TS.ServeEngine(E.cfg, params=E.params, max_seq=64, batch_size=2,
                          chunk=4, device="cpu")
    with pytest.raises(RuntimeError, match="paged cache"):
        flat.migrate(hand)


# ---------------------------------------------------------------------------
# router topology: parity, scheduling, accounting
# ---------------------------------------------------------------------------


def _router_parity(E):
    ref = run_all(E.shared(), PROMPTS, max_new=4)
    router = E.router()
    got = run_all(router, PROMPTS, max_new=4)
    assert got == ref
    assert all(router.finished[r].status == "ok" for r in got)
    return got, _seen(router)


def test_router_parity_vs_shared_engine(dense):
    _both(_router_parity, dense)


def test_router_parity_moe_no_drop():
    """The MoE path across the boundary: qwen2-moe smoke at no-drop
    capacity, the router's streams the shared engine's, in both
    packages."""
    _both(_router_parity, _sides(MOE))


def _generate_parity(E):
    ref = E.shared().generate(PROMPTS, max_new=4)
    got = E.router().generate(PROMPTS, max_new=4)
    assert np.array_equal(np.asarray(ref.tokens), np.asarray(got.tokens))
    assert got.statuses == ["ok"] * len(PROMPTS)
    return (np.asarray(got.tokens).tolist(), list(map(int, got.lengths)),
            got.prefill_tokens, got.decode_steps, got.statuses)


def test_router_generate_parity(dense):
    _both(_generate_parity, dense)


def _eos_parity(E):
    ref_full = run_all(E.shared(), PROMPTS[:1], max_new=6)
    eos = ref_full[0][2]                          # stop after 3 tokens
    ref = run_all(E.shared(), PROMPTS[:1], max_new=6, eos_id=eos)
    router = E.router()
    got = run_all(router, PROMPTS[:1], max_new=6, eos_id=eos)
    assert got == ref and len(got[0]) <= 3
    return got, _seen(router)


def test_router_eos_parity(dense):
    _both(_eos_parity, dense)


def _accounting(E):
    router = E.router()
    run_all(router, PROMPTS, max_new=4)
    s = router.summary()
    assert s["migrations"] == len(PROMPTS)
    assert s["pages_moved"] == sum(E.pc.pages_for(len(p), router.page_size)
                                   for p in PROMPTS)
    assert all(w.prefill_tokens == 0 for w in router.decodes)
    assert all(w.decode_tokens == 0 for w in router.prefills)
    assert router.prefill_tokens == sum(len(p) for p in PROMPTS)
    return _seen(router)


def test_migration_accounting_no_reprefill(dense):
    _both(_accounting, dense)


def _backpressure(E):
    ref = run_all(E.shared(), PROMPTS, max_new=4)
    router = E.router(decode_slots=1)
    got = run_all(router, PROMPTS, max_new=4)
    assert got == ref
    assert router.summary()["migrations"] == len(PROMPTS)
    return _seen(router)


def test_backpressure_single_decode_slot(dense):
    _both(_backpressure, dense)


def _route_hints(E):
    ref = run_all(E.shared(), PROMPTS, max_new=4)
    router = E.router(prefill_workers=2, decode_workers=2, prefill_slots=1,
                      decode_slots=1)
    rids = [router.submit(E.mod.RequestSpec(tuple(p), max_new=4,
                                            route_hint=i))
            for i, p in enumerate(PROMPTS)]
    router.run()
    assert {r: list(router.finished[r].tokens) for r in rids} == ref
    assert all(w.prefill_tokens > 0 for w in router.prefills)
    assert sum(w.decode_tokens > 0 for w in router.decodes) >= 1
    return _seen(router)


def test_multi_worker_spread_with_route_hints(dense):
    _both(_route_hints, dense)


def _rejections(E):
    router = E.router()
    seen = []
    for prompt, kw, reason in [
            ([], {}, "empty_prompt"),
            ([1, 2, 3], {"max_new": 62}, "too_long"),
            ("text", {}, "invalid")]:
        with pytest.raises(E.mod.RejectedRequest) as ei:
            router.submit(prompt, **kw)
        assert ei.value.reason.value == reason
        assert ei.value.request.status == "rejected"
        seen.append((str(ei.value), ei.value.request.rid))
    got = run_all(router, PROMPTS[:1], max_new=3)   # still serviceable
    assert len(next(iter(got.values()))) == 3
    return seen, got


def test_router_rejections_match_engine_reasons(dense):
    _both(_rejections, dense)


def _over_capacity(E):
    router = E.router(n_pages=5)                  # 4 usable pages
    with pytest.raises(E.mod.RejectedRequest) as ei:
        router.submit(list(range(1, 35)), max_new=8)   # 6 pages > 4
    assert ei.value.reason.value == "over_capacity"
    return str(ei.value)


def test_router_over_capacity_uses_tightest_pool(dense):
    _both(_over_capacity, dense)


def _bounded_queue(E):
    router = E.router(max_queue=2, shed_policy="reject")
    rids = [router.submit(p, max_new=2) for p in PROMPTS[:2]]
    # workers haven't stepped: both sit in the router queue
    with pytest.raises(E.mod.RejectedRequest) as ei:
        router.submit(PROMPTS[2], max_new=2)
    assert ei.value.reason.value == "queue_full"
    router.run()
    assert all(router.finished[r].status == "ok" for r in rids)
    return str(ei.value), _seen(router)


def test_router_bounded_queue_and_shed(dense):
    _both(_bounded_queue, dense)


def _cancel(E):
    router = E.router()
    r0 = router.submit(PROMPTS[0], max_new=16)
    r1 = router.submit(PROMPTS[1], max_new=16)
    assert router.cancel(r1)                      # still router-queued
    assert router.finished[r1].status == "cancelled"
    for _ in range(3):
        router.step()
    assert router.cancel(r0)                      # live on a worker
    router.run()
    assert router.finished[r0].status == "cancelled"
    assert not router.cancel(r0)                  # already terminal
    return _seen(router)


def test_router_cancel_queued_and_running(dense):
    _both(_cancel, dense)


def _requires_paging(E):
    with pytest.raises(ValueError) as ei:
        E.mod.EngineConfig(disagg=True, page_size=0)
    return str(ei.value)


def test_engineconfig_disagg_requires_paging(dense):
    _both(_requires_paging, dense)


# ---------------------------------------------------------------------------
# TTFT at equal total slots (a tick clock)
# ---------------------------------------------------------------------------


def _ttft_trace(build, prompts, arrivals, max_new):
    clock = Ticks()
    eng = build(clock)
    rids, nxt = [], 0
    while nxt < len(prompts) or eng.pending:
        while nxt < len(prompts) and arrivals[nxt] <= clock.t:
            rids.append(eng.submit(prompts[nxt], max_new=max_new))
            nxt += 1
        if not eng.pending and nxt < len(prompts):
            rids.append(eng.submit(prompts[nxt], max_new=max_new))
            nxt += 1
        eng.step()
        clock.t += 1.0
    toks = {r: list(map(int, eng.finished[r].tokens)) for r in rids}
    ttfts = [float(eng.finished[r].ttft_s) for r in rids]
    return eng, toks, ttfts


def _ttft(E):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, E.cfg.vocab_size,
                            size=int(rng.integers(8, 33))).tolist()
               for _ in range(10)]
    arrivals = np.cumsum(rng.exponential(1.5, size=len(prompts))).astype(int)
    shared_ec = E.mod.EngineConfig(max_seq=64, batch_size=4, chunk=4,
                                   page_size=8)
    _, ref, tt_shared = _ttft_trace(
        lambda c: E.build(shared_ec, clock=c), prompts, arrivals, max_new=8)
    router, got, tt_dis = _ttft_trace(
        lambda c: E.build(E.ec(), clock=c), prompts, arrivals, max_new=8)
    assert got == ref
    assert float(np.mean(tt_dis)) < float(np.mean(tt_shared))
    return tt_shared, tt_dis, _seen(router)


def test_disagg_ttft_below_shared_on_poisson_trace(dense):
    _both(_ttft, dense)


# ---------------------------------------------------------------------------
# exactly once across the handoff boundary under single-worker crashes
# ---------------------------------------------------------------------------


def _crash(E, crash_workers, injected_want):
    ref = run_all(E.router(), PROMPTS, max_new=4)
    emissions = []
    with tempfile.TemporaryDirectory(prefix="disagg_t_") as snap:
        ec = E.ec(snapshot_dir=snap, snapshot_every=2, max_restarts=16,
                  recover=True)
        plan = E.mod.FaultPlan(crash_workers=crash_workers)
        inj = {t: E.mod.FaultInjector(plan, role=t)
               for t in ec.worker_targets()}
        router = E.build(ec, faults=inj,
                         on_token=lambda r, i, t: emissions.append((r, i, t)))
        toks = run_all(router, PROMPTS, max_new=4)
        injected = sum(i.counts["crash"] for i in inj.values())
    assert injected == injected_want
    assert router.recoveries == injected_want
    assert router.failures == injected_want
    assert toks == ref
    assert all(router.finished[r].status == "ok" for r in toks)
    seen, dup = set(), 0
    for r, i, _ in emissions:
        dup += (r, i) in seen
        seen.add((r, i))
    lost = sum((r, i) not in seen
               for r, t in toks.items() for i in range(len(t)))
    assert dup == 0 and lost == 0
    return (_seen(router, emissions),
            {str(t): dict(i.counts) for t, i in inj.items()})


@pytest.mark.parametrize("crash_workers,injected", [
    ({4: ("decode", 0)}, 1),
    ({3: ("prefill", 0)}, 1),
    ({3: ("prefill", 0), 6: ("decode", 0)}, 2)],
    ids=["decode", "prefill", "both"])
def test_worker_crash_exactly_once(dense, crash_workers, injected):
    _both(_crash, dense, crash_workers, injected)


# ---------------------------------------------------------------------------
# the SSM carry across the boundary (per-slot state beside the pages)
# ---------------------------------------------------------------------------


def _ssm(E):
    ref = run_all(E.shared(), PROMPTS[:2], max_new=4)
    router = E.router()
    got = run_all(router, PROMPTS[:2], max_new=4)
    assert got == ref
    assert router.summary()["migrations"] == 2
    return got, _seen(router)


def test_ssm_state_migration_parity():
    _both(_ssm, _sides(SSM))


# ---------------------------------------------------------------------------
# a handoff holds copies, never views of the exporting pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [SSM, DENSE])
def test_handoff_survives_reuse_of_its_slot_and_pages(arch):
    """Export a handoff, admit and prefill another request into the freed
    slot and pages of a one-slot prefill worker, then migrate the first:
    its stream is the shared engine's. The port updates its cache in
    place, so a handoff that held views of the pool (the SSM row
    ``e[k][:, slot]`` without a copy) would carry the second request's
    carry and pages."""
    E = _sides(arch)["torch"]
    ref = run_all(E.shared(), PROMPTS[:2], max_new=5)
    a = TS.PrefillWorker(E.cfg, params=E.params, max_seq=64,
                         batch_size=1, chunk=4, page_size=8, n_pages=3,
                         device="cpu")
    b = E.worker("DecodeWorker")
    b.emitted = a.emitted
    first = a.submit(PROMPTS[0], max_new=5)
    while not a.outbox:
        a.step()
    hand = a.outbox.pop()
    second = a.submit(PROMPTS[1], max_new=5)
    while not a.outbox:
        a.step()
    other = a.outbox.pop()
    assert set(hand.pages) & set(other.pages)     # the same pages reused
    assert b.migrate(hand) and b.migrate(other)
    while b.pending:
        b.step()
    assert list(map(int, b.finished[first].tokens)) == ref[0]
    assert list(map(int, b.finished[second].tokens)) == ref[1]


# ---------------------------------------------------------------------------
# the serve CLI's --disagg
# ---------------------------------------------------------------------------


def test_serve_cli_disagg_chaos():
    """``launch.serve --disagg`` on qwen2-0.5b-smoke with chaos: every
    request terminal, the router's summary printed, its keys the JAX
    router's."""
    from repro_torch.launch import serve
    argv = ["--arch", DENSE, "--disagg", "--page-size", "8", "--max-seq",
            "64", "--batch", "2", "--chunk", "4", "--requests", "6",
            "--prompt-max", "16", "--max-new", "4", "--chaos", "0.05",
            "--decode-workers", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        router = serve.main(argv, device="cpu")
    text = buf.getvalue()
    assert isinstance(router, TS.Router)
    assert len(router.finished) == 6 and not router.pending
    assert all(r.done for r in router.finished.values())
    assert "migration: " in text and "chaos: " in text
    assert "robustness: statuses" in text
    jr = _sides(DENSE)["jax"].router()
    assert router.summary().keys() == jr.summary().keys()
    assert router.summary()["per_worker"].keys() == {
        "prefill0", "decode0", "decode1"}
    for name, w in router.summary()["per_worker"].items():
        want = jr.summary()["per_worker"][name[:-1] + "0"]
        assert w.keys() == want.keys()
