"""The port's typed serving API against ``tests/test_serving_api.py``:
RequestSpec validation (reason for reason, as the JAX package's), the
kwargs and spec doors rejecting alike, per-row rejection in generate(),
and EngineConfig (validation, `build` against a direct engine, the
CLI's flag round trip with the JAX package's defaults, the chaos
injector). Plus: the port's ``FaultPlan.poisson`` draws the JAX module's
plans for seeds 0-4, and the disaggregated topology's build."""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

import repro.serving as JS
from repro.serving import faults as JF
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import (EngineConfig, RejectedRequest, RejectReason,
                                 RequestSpec, RequestStatus, ServeEngine)
from repro_torch.serving import faults as TF

torch.set_num_threads(1)

ARCH = "qwen2-0.5b-smoke"


@pytest.fixture(scope="module")
def params():
    return lm.init_params(get_config(ARCH), 0, "cpu")


def make_engine(params, **kw):
    kw.setdefault("max_seq", 64)
    kw.setdefault("batch_size", 2)
    kw.setdefault("chunk", 4)
    return ServeEngine(get_config(ARCH), params=params, device="cpu", **kw)


# ---------------------------------------------------------------------------
# RequestSpec validation
# ---------------------------------------------------------------------------


def test_spec_normalizes_and_freezes():
    s = RequestSpec(np.asarray([3, 1, 4], np.int32), max_new=5)
    assert s.prompt == (3, 1, 4)
    assert all(isinstance(t, int) for t in s.prompt)
    assert s.budget_tokens == 8
    with pytest.raises(AttributeError):
        s.max_new = 9


MALFORMED = [
    (([],), {}, RejectReason.EMPTY_PROMPT),
    (("text",), {}, RejectReason.INVALID),
    ((b"bytes",), {}, RejectReason.INVALID),
    (([1, "x", 3],), {}, RejectReason.INVALID),
    (([1, 2],), {"max_new": 0}, RejectReason.INVALID),
    (([1, 2],), {"max_new": -3}, RejectReason.INVALID),
    (([1, 2],), {"eos_id": 1.5}, RejectReason.INVALID),
    (([1, 2],), {"deadline_s": 0}, RejectReason.INVALID),
    (([1, 2],), {"deadline_s": True}, RejectReason.INVALID),
    (([1, 2],), {"ttft_deadline_s": -1.0}, RejectReason.INVALID),
    (([1, 2],), {"route_hint": -1}, RejectReason.INVALID),
]


@pytest.mark.parametrize("args,kw,reason", MALFORMED)
def test_spec_rejects_malformed(args, kw, reason):
    with pytest.raises(RejectedRequest) as ei:
        RequestSpec(*args, **kw)
    assert ei.value.reason == reason
    # the JAX package's spec rejects it with the same reason and message
    with pytest.raises(JS.RejectedRequest) as ej:
        JS.RequestSpec(*args, **kw)
    assert ej.value.reason.value == reason.value
    assert str(ej.value) == str(ei.value)


def test_spec_accepts_numpy_scalars():
    s = RequestSpec((np.int32(7), np.int64(9)), max_new=np.int32(3),
                    eos_id=np.int64(2))
    assert s.prompt == (7, 9) and s.budget_tokens == 5


# ---------------------------------------------------------------------------
# kwargs <-> spec parity
# ---------------------------------------------------------------------------


def test_submit_parity_malformed(params):
    eng = make_engine(params)
    for args, kw, reason in MALFORMED:
        if "route_hint" in kw:                     # spec-only field
            continue
        with pytest.raises(RejectedRequest) as via_kwargs:
            eng.submit(args[0], **kw)
        with pytest.raises(RejectedRequest) as via_spec:
            eng.submit(RequestSpec(args[0], **kw))
        assert via_kwargs.value.reason == via_spec.value.reason == reason
        assert via_kwargs.value.request.status == RequestStatus.REJECTED
    assert not eng.queue and not eng.pending


def test_submit_spec_fields_win(params):
    eng = make_engine(params)
    ref = eng.generate([[5, 6, 7]], max_new=3)
    got = eng.generate([RequestSpec((5, 6, 7), max_new=3)], max_new=31)
    assert np.array_equal(ref.tokens, got.tokens[:, :3])
    assert int(got.lengths[0]) == 3


def test_submit_spec_eos_and_deadline(params):
    eng = make_engine(params, deadline_s=None)
    full = eng.generate([[5, 6, 7]], max_new=6)
    eos = int(full.tokens[0, 1])
    rid = eng.submit(RequestSpec((5, 6, 7), max_new=6, eos_id=eos,
                                 deadline_s=123.0, route_hint=2))
    req = eng.queue[-1]
    assert req.rid == rid
    assert req.eos_id == eos and req.deadline_s == 123.0
    assert req.route_hint == 2                     # carried, not used
    eng.run()
    assert len(eng.finished[rid].tokens) <= 2


def test_engine_deadline_defaults_apply(params):
    eng = make_engine(params, ttft_deadline_s=7.0, deadline_s=9.0)
    eng.submit([1, 2], max_new=2)
    eng.submit([1, 2], max_new=2, deadline_s=3.0)
    assert [(r.ttft_deadline_s, r.deadline_s) for r in eng.queue] == [
        (7.0, 9.0), (7.0, 3.0)]


def test_rejected_rid_not_reused(params):
    eng = make_engine(params)
    with pytest.raises(RejectedRequest) as ei:
        eng.submit([], max_new=2)
    good_rid = eng.submit([1, 2], max_new=2)
    assert good_rid != ei.value.request.rid
    eng.run()


def test_request_json_round_trip():
    from repro_torch.serving.engine import (Request, _req_from_json,
                                            _req_to_json)
    r = Request(3, [1, 2], 4, None, tokens=[5], length=-1, slot=1,
                submit_t=0.5, status=RequestStatus.RUNNING,
                ttft_deadline_s=1.0, deadline_s=2.0, route_hint=0)
    d = _req_to_json(r)
    assert _req_from_json(d) == r
    # the JAX engine's record of the same request reads back the same
    jd = JS.engine._req_to_json(JS.engine._req_from_json(d))
    assert jd == d


# ---------------------------------------------------------------------------
# generate(): per-row rejection
# ---------------------------------------------------------------------------


def test_generate_survives_malformed_rows(params):
    eng = make_engine(params)
    ref = eng.generate([[5, 6, 7], [9, 10]], max_new=3)
    res = eng.generate([[5, 6, 7], [], [9, 10], "oops"], max_new=3)
    assert res.statuses == ["ok", "rejected", "ok", "rejected"]
    assert set(res.rejected) == {1, 3}
    assert res.rejected[1].reason == RejectReason.EMPTY_PROMPT
    assert res.rejected[3].reason == RejectReason.INVALID
    assert not res.tokens[1].any() and not res.tokens[3].any()
    assert int(res.lengths[1]) == 0 and int(res.lengths[3]) == 0
    assert np.array_equal(res.tokens[[0, 2]], ref.tokens)
    assert res.prefill_tokens == 5


def test_generate_all_rejected_is_not_an_error(params):
    eng = make_engine(params)
    res = eng.generate([[], ""], max_new=2)
    assert res.statuses == ["rejected", "rejected"]
    assert res.tokens.shape == (2, 2) and not res.tokens.any()
    assert eng.generate([[4, 2]], max_new=2).statuses == ["ok"]


# ---------------------------------------------------------------------------
# EngineConfig
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(max_seq=0), dict(batch_size=0), dict(shed_policy="yolo"),
    dict(disagg=True, page_size=0),
    dict(disagg=True, page_size=8, prefill_workers=0),
    dict(chunk=-1), dict(chaos_rate=-0.1)])
def test_engineconfig_validates(kw):
    with pytest.raises(ValueError) as ei:
        EngineConfig(**kw)
    with pytest.raises(ValueError) as ej:
        JS.EngineConfig(**kw)
    assert str(ei.value) == str(ej.value)


def test_engineconfig_fields_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(EngineConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JS.EngineConfig)]


def test_engineconfig_build_equivalent_to_direct(params):
    direct = make_engine(params, page_size=8, max_queue=3, deadline_s=9.0)
    built = EngineConfig(max_seq=64, batch_size=2, chunk=4, page_size=8,
                         max_queue=3, deadline_s=9.0).build(
        get_config(ARCH), params=params, device="cpu")
    assert (built.max_seq, built.B, built.page_size, built.max_queue,
            built.deadline_s) == (direct.max_seq, direct.B,
                                  direct.page_size, direct.max_queue,
                                  direct.deadline_s)
    a = direct.generate([[3, 1, 4], [1, 5]], max_new=4)
    b = built.generate([[3, 1, 4], [1, 5]], max_new=4)
    assert np.array_equal(a.tokens, b.tokens)


def _cli(argv):
    ap = argparse.ArgumentParser()
    EngineConfig.add_cli_args(ap)
    return ap.parse_args(argv)


def test_engineconfig_cli_round_trip():
    args = _cli([
        "--max-seq", "128", "--batch", "3", "--chunk", "16", "--seed", "5",
        "--page-size", "8", "--pages", "33", "--admit-k", "2",
        "--max-queue", "7", "--shed", "deadline", "--deadline", "4.5",
        "--snapshot-every", "3", "--chaos", "0.25", "--chaos-seed", "9",
        "--disagg", "--prefill-workers", "2", "--decode-workers", "3",
        "--prefill-slots", "1", "--decode-slots", "2"])
    ec = EngineConfig.from_cli_args(args, chaos_horizon=77)
    assert (ec.max_seq, ec.batch_size, ec.chunk, ec.seed) == (128, 3, 16, 5)
    assert (ec.page_size, ec.n_pages, ec.admit_k) == (8, 33, 2)
    assert (ec.max_queue, ec.shed_policy, ec.deadline_s) == (7, "deadline",
                                                             4.5)
    assert (ec.chaos_rate, ec.chaos_seed, ec.chaos_horizon) == (0.25, 9, 77)
    assert ec.disagg and (ec.prefill_workers, ec.decode_workers) == (2, 3)
    assert (ec.prefill_slots, ec.decode_slots) == (1, 2)
    assert ec.worker_targets() == (("prefill", 0), ("prefill", 1),
                                   ("decode", 0), ("decode", 1),
                                   ("decode", 2))
    # the JAX package's parser gives the same config from the same line
    jap = argparse.ArgumentParser()
    JS.EngineConfig.add_cli_args(jap)
    jec = JS.EngineConfig.from_cli_args(jap.parse_args([
        "--max-seq", "128", "--batch", "3", "--chunk", "16", "--seed", "5",
        "--page-size", "8", "--pages", "33", "--admit-k", "2",
        "--max-queue", "7", "--shed", "deadline", "--deadline", "4.5",
        "--snapshot-every", "3", "--chaos", "0.25", "--chaos-seed", "9",
        "--disagg", "--prefill-workers", "2", "--decode-workers", "3",
        "--prefill-slots", "1", "--decode-slots", "2"]), chaos_horizon=77)
    assert dataclasses.asdict(ec) == dataclasses.asdict(jec)


def test_engineconfig_defaults_round_trip():
    ec = EngineConfig.from_cli_args(_cli([]))
    assert ec == EngineConfig(max_seq=128, chunk=16)


def test_engineconfig_make_faults():
    assert EngineConfig().make_faults() is None
    ec = EngineConfig(chaos_rate=0.5, chaos_seed=3, chaos_horizon=64)
    inj = ec.make_faults()
    assert isinstance(inj, TF.FaultInjector) and inj.plan.seed == 3
    assert dataclasses.asdict(inj.plan) == dataclasses.asdict(
        JS.EngineConfig(chaos_rate=0.5, chaos_seed=3,
                        chaos_horizon=64).make_faults().plan)
    dis = EngineConfig(chaos_rate=0.5, chaos_horizon=64, page_size=8,
                       disagg=True, prefill_workers=1, decode_workers=1)
    plan = dis.make_faults(role=("decode", 0)).plan
    assert plan.crash_workers and not plan.crash_steps
    assert all(t in dis.worker_targets()
               for t in plan.crash_workers.values())


def test_engineconfig_chaos_turns_recovery_on(params):
    eng = EngineConfig(max_seq=64, batch_size=2, chunk=4, chaos_rate=0.1,
                       chaos_horizon=16).build(get_config(ARCH),
                                               params=params, device="cpu")
    assert eng.auto_recover and eng.faults is not None


def test_disagg_build_raises_naming_item_9():
    """The disaggregated topology is ported: the config builds its Router
    (the test keeps the name it had while the build raised)."""
    from repro_torch.serving import Router
    router = EngineConfig(disagg=True, page_size=8, prefill_workers=2,
                          decode_workers=1).build(get_config(ARCH),
                                                  device="cpu")
    assert isinstance(router, Router)
    assert (len(router.prefills), len(router.decodes)) == (2, 1)


# ---------------------------------------------------------------------------
# the fault plans: the JAX module's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_poisson_plans_equal_jax(seed):
    kw = dict(horizon=96, crash_rate=0.08, nan_rate=0.05, spike_rate=0.1,
              spike_s=0.01, squeeze_rate=0.1, squeeze_hold=2)
    got = TF.FaultPlan.poisson(seed, **kw)
    want = JF.FaultPlan.poisson(seed, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    workers = (("prefill", 0), ("decode", 0), ("decode", 1))
    assert dataclasses.asdict(TF.FaultPlan.poisson(seed, workers=workers,
                                                 **kw)) == \
        dataclasses.asdict(JF.FaultPlan.poisson(seed, workers=workers, **kw))


@pytest.mark.parametrize("seed", range(5))
def test_poisoned_rows_equal_jax(seed):
    """The same plan poisons the same rows of the same live mask."""
    class Eng:
        def __init__(self, step, live):
            self.step_idx, self.live = step, live

    plan_kw = dict(nan_rows={t: 1 + t % 3 for t in range(1, 9)})
    t_inj = TF.FaultInjector(TF.FaultPlan(seed=seed, **plan_kw))
    j_inj = JF.FaultInjector(JF.FaultPlan(seed=seed, **plan_kw))
    rng = np.random.default_rng(seed)
    for step in range(1, 9):
        live = rng.random(8) < 0.6
        assert t_inj.poison_rows(Eng(step, live)) == \
            j_inj.poison_rows(Eng(step, live))
    assert t_inj.counts == j_inj.counts and t_inj.events == j_inj.events
