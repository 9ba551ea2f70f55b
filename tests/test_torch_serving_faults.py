"""The serving lifecycle of the port against the JAX package's: every test
of ``tests/test_serving_faults.py`` runs as a scenario on both engines,
with bridged weights, the same ``FaultPlan`` and the same ``FakeClock``,
at the JAX file's geometry (qwen2-0.5b-smoke, max_seq 64, 2 slots, chunk
4). Each scenario asserts the JAX test's own asserts on whichever engine
it drives, and returns what it saw: every request's tokens, length,
status and error, the counters (failures, recoveries, shed, expired,
quarantined, admission rounds), the ``on_token`` emissions in order, the
free pages and the injector's counts and events. The port's must equal
the JAX engine's exactly.

The crash-recovery, quarantine and chaos scenarios run on
qwen2-moe-2.7b-smoke as well, at no-drop capacity (capacity_factor =
num_experts / top_k: a dead row reading the null page, or a replay's
other batch composition, cannot change a live token), so the MoE path
replays too. The chaos trace runs at seeds 0, 1 and 2 on both configs.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

import repro.serving as JS
import repro_torch.serving as TS
from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config

torch.set_num_threads(1)

DENSE, MOE = "qwen2-0.5b-smoke", "qwen2-moe-2.7b-smoke"
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 10, 11, 12], [6, 5]]


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _side(pkg, cfg, params):
    """One package's engine factory and lifecycle types."""
    mod = JS if pkg == "jax" else TS

    def make(**kw):
        kw.setdefault("max_seq", 64)
        kw.setdefault("batch_size", 2)
        kw.setdefault("chunk", 4)
        if pkg == "torch":
            kw["device"] = "cpu"
        return mod.ServeEngine(cfg, params=params, **kw)

    return types.SimpleNamespace(
        pkg=pkg, make=make, FaultPlan=mod.FaultPlan,
        FaultInjector=mod.FaultInjector, InjectedFault=mod.InjectedFault,
        RejectedRequest=mod.RejectedRequest, RejectReason=mod.RejectReason)


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


@pytest.fixture(scope="module", params=[DENSE, MOE])
def sides(request):
    return _sides(request.param)


def _summary(eng, rids=None, emissions=None):
    rids = sorted(eng.finished) if rids is None else rids
    out = {"requests": {rid: (list(map(int, eng.finished[rid].tokens)),
                              int(eng.finished[rid].length),
                              eng.finished[rid].status.value,
                              eng.finished[rid].error) for rid in rids},
           "counters": (eng.failures, eng.recoveries, eng.shed, eng.expired,
                        eng.quarantined, eng.admit_rounds, eng.step_idx),
           "free_pages": eng.free_pages, "queue": [r.rid for r in eng.queue],
           "pending": eng.pending}
    if emissions is not None:
        out["emissions"] = [tuple(map(int, e)) for e in emissions]
    if eng.faults is not None:
        out["injected"] = (dict(eng.faults.counts),
                           [(int(t), str(e)) for t, e in eng.faults.events])
    return out


def _both(scenario, sides, *args):
    got = {pkg: scenario(side, *args) for pkg, side in sides.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ---------------------------------------------------------------------------
# typed rejections
# ---------------------------------------------------------------------------


def _rejections(E):
    eng = E.make()
    with pytest.raises(E.RejectedRequest) as ei:
        eng.submit([], max_new=4)
    assert ei.value.reason == E.RejectReason.EMPTY_PROMPT
    assert ei.value.request.status == "rejected"
    reasons = [ei.value.reason.value]
    with pytest.raises(E.RejectedRequest) as ei:
        eng.submit([1, 2, 3], max_new=62)            # 3 + 62 > 64
    assert ei.value.reason == E.RejectReason.TOO_LONG
    reasons.append((ei.value.reason.value, str(ei.value),
                    ei.value.request.rid))
    assert not eng.queue and not eng.pending
    res = eng.generate([[5, 6, 7]], max_new=3)
    assert res.tokens.shape == (1, 3)
    return reasons, res.tokens.tolist(), _summary(eng)


def test_submit_rejections_typed_and_engine_survives(dense):
    _both(_rejections, dense)


def _over_capacity(E):
    eng = E.make(max_seq=32, page_size=4, n_pages=5)
    with pytest.raises(E.RejectedRequest) as ei:
        eng.submit(list(range(1, 21)), max_new=6)    # 7 pages > 4 usable
    assert ei.value.reason == E.RejectReason.OVER_CAPACITY
    res = eng.generate([[1, 2, 3]], max_new=3)
    return str(ei.value), res.tokens.tolist(), _summary(eng)


def test_submit_over_capacity_paged(dense):
    _both(_over_capacity, dense)


def _reject_no_recovery(E):
    eng = E.make(recover=True)
    with pytest.raises(E.RejectedRequest):
        eng.submit([], max_new=2)
    assert eng.failures == 0 and eng.recoveries == 0
    return _summary(eng)


def test_rejection_inside_step_does_not_trip_recovery(dense):
    _both(_reject_no_recovery, dense)


# ---------------------------------------------------------------------------
# bounded queue and shedding
# ---------------------------------------------------------------------------


def _queue_reject(E):
    eng = E.make(max_queue=2)
    eng.submit([1, 2], max_new=2)
    eng.submit([3, 4], max_new=2)
    with pytest.raises(E.RejectedRequest) as ei:
        eng.submit([5, 6], max_new=2)
    assert ei.value.reason == E.RejectReason.QUEUE_FULL
    assert len(eng.queue) == 2 and eng.shed == 0
    eng.run()
    assert all(r.status == "ok" for r in eng.finished.values())
    return str(ei.value), _summary(eng)


def test_bounded_queue_reject_policy(dense):
    _both(_queue_reject, dense)


def _queue_deadline_shed(E):
    clock = FakeClock()
    eng = E.make(max_queue=2, shed_policy="deadline", clock=clock)
    ra = eng.submit([1, 2], max_new=2, deadline_s=0.5)    # least slack
    rb = eng.submit([3, 4], max_new=2, deadline_s=50.0)
    rc = eng.submit([5, 6], max_new=2, deadline_s=50.0)   # sheds ra
    assert eng.shed == 1
    assert eng.finished[ra].status == "expired"
    assert [r.rid for r in eng.queue] == [rb, rc]
    eng2 = E.make(max_queue=1, shed_policy="deadline")
    rd = eng2.submit([1, 2], max_new=2)
    with pytest.raises(E.RejectedRequest):
        eng2.submit([3, 4], max_new=2)
    assert eng2.queue[0].rid == rd and eng2.shed == 0
    eng.run()
    return _summary(eng), _summary(eng2)


def test_bounded_queue_deadline_shed(dense):
    _both(_queue_deadline_shed, dense)


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------


def _cancel(E):
    eng = E.make(batch_size=1, page_size=8)
    ra = eng.submit(PROMPTS[0], max_new=8)
    rb = eng.submit(PROMPTS[1], max_new=8)
    eng.step()                                   # admits ra; rb queued
    assert eng.live[0] and eng.slot_req[0].rid == ra
    assert eng.alloc.used_pages > 0
    assert eng.cancel(ra)                        # live cancel: slot + pages
    assert not eng.live[0] and eng.slot_req[0] is None
    assert eng.alloc.used_pages == 0
    assert eng.finished[ra].status == "cancelled"
    assert len(eng.finished[ra].tokens) >= 1     # partial tokens kept
    assert eng.cancel(rb)                        # queued cancel
    assert eng.finished[rb].status == "cancelled"
    assert not eng.cancel(ra)                    # already terminal
    assert not eng.cancel(12345)                 # unknown rid
    res = eng.generate([[7, 8, 9]], max_new=3)
    assert res.tokens.shape == (1, 3)
    return res.tokens.tolist(), _summary(eng)


def test_cancel_queued_and_live(dense):
    _both(_cancel, dense)


# ---------------------------------------------------------------------------
# deadlines (the fake clock)
# ---------------------------------------------------------------------------


def _ttft_deadline(E):
    clock = FakeClock()
    eng = E.make(batch_size=1, clock=clock)
    ra = eng.submit(PROMPTS[0], max_new=4)               # takes the slot
    rb = eng.submit(PROMPTS[1], max_new=4, ttft_deadline_s=1.0)
    eng.step()
    assert eng.live[0]
    clock.t = 2.0                                        # rb is now late
    eng.step()
    assert eng.finished[rb].status == "expired"
    assert "ttft" in eng.finished[rb].error
    assert eng.expired == 1
    eng.run()
    assert eng.finished[ra].status == "ok"
    return _summary(eng), eng.finished[rb].done_t


def test_ttft_deadline_expires_queued(dense):
    _both(_ttft_deadline, dense)


def _total_deadline(E):
    clock = FakeClock()
    eng = E.make(clock=clock)
    ra = eng.submit(PROMPTS[0], max_new=32, deadline_s=5.0)
    eng.step()                                           # admit + token 0
    assert eng.live.any()
    clock.t = 6.0
    eng.step()                                           # decode then expire
    got = eng.finished[ra]
    assert got.status == "expired"
    assert len(got.tokens) >= 1                          # partial kept
    assert not eng.pending
    return _summary(eng)


def test_total_deadline_expires_live(dense):
    _both(_total_deadline, dense)


# ---------------------------------------------------------------------------
# NaN quarantine
# ---------------------------------------------------------------------------


def _nan_row(E):
    clean = E.make()
    ref = clean.generate(PROMPTS[:2], max_new=6)
    emissions = []
    eng = E.make(faults=E.FaultInjector(E.FaultPlan(nan_rows={3: 1})),
                 on_token=lambda *e: emissions.append(e))
    rids = [eng.submit(p, max_new=6) for p in PROMPTS[:2]]
    eng.run()
    statuses = [eng.finished[r].status for r in rids]
    assert statuses.count("quarantined") == 1
    assert eng.quarantined == 1
    ok_i = statuses.index("ok")
    bad_i = 1 - ok_i
    assert eng.finished[rids[ok_i]].tokens == ref.tokens[ok_i].tolist()
    bad = eng.finished[rids[bad_i]].tokens
    assert bad == ref.tokens[bad_i].tolist()[:len(bad)]
    assert not eng.pending
    return ref.tokens.tolist(), _summary(eng, rids, emissions)


def test_nan_row_quarantined_neighbors_exact(sides):
    _both(_nan_row, sides)


def _nan_prefill(E):
    """A row whose prefill logits are not finite retires at admission
    (the admission's health check), its neighbour untouched."""
    eng = E.make()
    eng.submit(PROMPTS[0], max_new=4)
    eng.submit(PROMPTS[1], max_new=4)
    real = eng.prefill["jit" if E.pkg == "jax" else "fn"]

    def poisoned(*a):
        logits, cache = real(*a)
        return logits.at[1].set(np.nan) if E.pkg == "jax" else (
            logits.index_fill(0, torch.tensor([1]), float("nan"))), cache

    eng.prefill["jit" if E.pkg == "jax" else "fn"] = poisoned
    eng.run()
    assert [eng.finished[r].status for r in (0, 1)] == ["ok", "quarantined"]
    assert eng.finished[1].tokens == []
    return _summary(eng)


def test_nan_prefill_row_quarantined(dense):
    _both(_nan_prefill, dense)


# ---------------------------------------------------------------------------
# crash recovery: exactly-once
# ---------------------------------------------------------------------------


def _run_faulted(E, plan, tmp=None, n=4, max_new=6, paged=True, **kw):
    emissions = []
    eng = E.make(page_size=8 if paged else 0,
                 snapshot_dir=str(tmp) if tmp is not None else None,
                 snapshot_every=2, faults=E.FaultInjector(plan),
                 on_token=lambda rid, idx, tok: emissions.append(
                     (rid, idx, tok)), **kw)
    rids = [eng.submit(p, max_new=max_new) for p in PROMPTS[:n]]
    eng.run()
    return eng, rids, emissions


def _assert_exactly_once(eng, rids, emissions):
    seen = {}
    for rid, idx, tok in emissions:
        assert (rid, idx) not in seen, f"duplicate emission {(rid, idx)}"
        seen[(rid, idx)] = tok
    for rid in rids:
        toks = eng.finished[rid].tokens
        assert [seen[(rid, i)] for i in range(len(toks))] == toks


def _crash_with_snapshots(E, tmp):
    ref = E.make(page_size=8).generate(PROMPTS, max_new=6)
    eng, rids, emissions = _run_faulted(
        E, E.FaultPlan(crash_steps=(5,)), tmp=tmp / E.pkg)
    assert eng.failures == 1 and eng.recoveries == 1
    for i, rid in enumerate(rids):
        assert eng.finished[rid].status == "ok"
        assert eng.finished[rid].tokens == ref.tokens[i].tolist(), i
    _assert_exactly_once(eng, rids, emissions)
    assert eng.free_pages == eng.n_pages - 1
    return ref.tokens.tolist(), _summary(eng, rids, emissions)


def test_crash_recovery_exactly_once_with_snapshots(sides, tmp_path):
    _both(_crash_with_snapshots, sides, tmp_path)


def _crash_from_scratch(E):
    ref = E.make().generate(PROMPTS[:2], max_new=5)
    eng, rids, emissions = _run_faulted(
        E, E.FaultPlan(crash_steps=(4,)), paged=False, n=2, max_new=5,
        recover=True)
    assert eng.recoveries == 1
    for i, rid in enumerate(rids):
        assert eng.finished[rid].tokens == ref.tokens[i].tolist(), i
    _assert_exactly_once(eng, rids, emissions)
    return _summary(eng, rids, emissions)


def test_crash_recovery_without_snapshot_replays_from_scratch(sides):
    _both(_crash_from_scratch, sides)


def _unrecoverable(E):
    eng = E.make(faults=E.FaultInjector(E.FaultPlan(crash_steps=(2,))))
    rids = [eng.submit(p, max_new=4) for p in PROMPTS[:2]]
    with pytest.raises(E.InjectedFault) as ei:
        eng.run()
    for rid in rids:
        assert eng.finished[rid].status == "failed"
    assert not eng.pending
    return str(ei.value), _summary(eng, rids)


def test_unrecoverable_crash_fails_all_terminally(dense):
    _both(_unrecoverable, dense)


def _max_restarts(E, tmp):
    plan = E.FaultPlan(crash_steps=tuple(range(1, 50)))
    eng = E.make(snapshot_dir=str(tmp / E.pkg), max_restarts=2,
                 faults=E.FaultInjector(plan))
    rid = eng.submit(PROMPTS[0], max_new=4)
    with pytest.raises(E.InjectedFault):
        eng.run()
    assert eng.failures == 3 and eng.recoveries == 2
    assert eng.finished[rid].status == "failed"
    return _summary(eng)


def test_max_restarts_caps_consecutive_failures(dense, tmp_path):
    _both(_max_restarts, dense, tmp_path)


def _cache_np(eng):
    return [{k: np.array(v) for k, v in e.items()} for e in eng.cache]


def _manual_snapshot(E, tmp):
    eng = E.make(page_size=8, snapshot_dir=str(tmp / E.pkg),
                 snapshot_every=0)
    rid = eng.submit(PROMPTS[0], max_new=8)
    eng.step()
    eng.step()
    eng.snapshot()
    toks_at_snap = list(eng.finished.get(rid, eng.slot_req[0]).tokens)
    pos_at_snap = eng.pos.copy()
    cache_at_snap = _cache_np(eng)
    eng.step()
    eng.step()
    eng.restore()
    assert eng.slot_req[0].rid == rid
    assert eng.slot_req[0].tokens == toks_at_snap
    np.testing.assert_array_equal(eng.pos, pos_at_snap)
    # the cache leaves after the restore, bit for bit
    for got, want in zip(_cache_np(eng), cache_at_snap):
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    if E.pkg == "torch":
        assert all(t.device == eng.device for e in eng.cache
                   for t in e.values())
    eng.alloc.check()
    eng.run()
    assert eng.finished[rid].status == "ok"
    return _summary(eng)


def test_manual_snapshot_restore_roundtrip(dense, tmp_path):
    _both(_manual_snapshot, dense, tmp_path)


# ---------------------------------------------------------------------------
# latency spikes and page pressure
# ---------------------------------------------------------------------------


def _latency_spike(E):
    slept = []
    inj = E.FaultInjector(E.FaultPlan(latency_s={4: 0.5}),
                          sleep=slept.append)
    eng = E.make(faults=inj)
    res = eng.generate(PROMPTS[:2], max_new=6)
    assert inj.counts["latency"] == 1 and slept == [0.5]
    return res.tokens.tolist(), _summary(eng)


def test_latency_spike_flags_straggler(dense):
    _both(_latency_spike, dense)


def _page_squeeze(E):
    ref = E.make(max_seq=32, page_size=4, n_pages=9).generate(
        PROMPTS[:2], max_new=4)
    inj = E.FaultInjector(E.FaultPlan(page_squeeze={1: (6, 3)}))
    eng = E.make(max_seq=32, page_size=4, n_pages=9, faults=inj)
    rids = [eng.submit(p, max_new=4) for p in PROMPTS[:2]]
    eng.step()
    assert inj.counts["page_squeeze"] == 1
    assert len(eng.queue) >= 1                      # someone had to wait
    eng.run()
    for i, rid in enumerate(rids):
        assert eng.finished[rid].status == "ok"
        assert eng.finished[rid].tokens == ref.tokens[i].tolist(), i
    assert eng.free_pages == eng.n_pages - 1
    return _summary(eng, rids)


def test_page_squeeze_stalls_then_admits(dense):
    _both(_page_squeeze, dense)


# ---------------------------------------------------------------------------
# chaos traces
# ---------------------------------------------------------------------------


def _chaos(E, tmp, seed):
    ref = E.make(page_size=8).generate(PROMPTS, max_new=8)
    plan = E.FaultPlan.poisson(seed, horizon=64, crash_rate=0.08,
                               nan_rate=0.05, spike_rate=0.1, spike_s=0.0,
                               squeeze_rate=0.1, squeeze_hold=2)
    eng, rids, emissions = _run_faulted(E, plan, tmp=tmp / E.pkg / "s",
                                        max_new=8, max_restarts=10)
    for i, rid in enumerate(rids):
        got = eng.finished[rid]
        assert got.status in ("ok", "quarantined")
        if got.status == "ok":
            assert got.tokens == ref.tokens[i].tolist(), (seed, i)
        else:
            assert got.tokens == ref.tokens[i].tolist()[:len(got.tokens)]
    _assert_exactly_once(eng, rids, emissions)
    eng.faults.release_all(eng)
    assert eng.free_pages == eng.n_pages - 1
    assert eng.failures == eng.recoveries == eng.faults.counts["crash"]
    return _summary(eng, rids, emissions)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_trace_exactly_once(sides, tmp_path, seed):
    _both(_chaos, sides, tmp_path, seed)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_serve_cli_chaos_snapshots_paged(tmp_path, capsys):
    """``launch.serve.main`` with a chaos plan, snapshots and the paged
    cache: every request terminal, every injected crash recovered, the
    pages home, and the plan's and the robustness summaries printed."""
    from repro_torch.launch import serve
    eng = serve.main(["--arch", DENSE, "--batch", "2", "--max-seq", "32",
                      "--chunk", "8", "--prompt-min", "3",
                      "--prompt-max", "12", "--max-new", "4",
                      "--requests", "6", "--page-size", "8", "--pages", "9",
                      "--chaos", "0.2", "--chaos-seed", "1",
                      "--snapshot-dir", str(tmp_path / "snap"),
                      "--snapshot-every", "2"], device="cpu")
    out = capsys.readouterr().out
    assert len(eng.finished) == 6 and not eng.pending
    assert all(r.done for r in eng.finished.values())
    assert eng.faults.counts["crash"] > 0
    assert eng.failures == eng.recoveries == eng.faults.counts["crash"]
    assert eng.ckpt.latest_step() is not None
    eng.faults.release_all(eng)
    assert eng.free_pages == eng.n_pages - 1
    assert "chaos: {'crash':" in out and "robustness: statuses" in out
    assert "injected: {'crash':" in out
