"""The program's spans (``repro_torch/tracing.py``): off, they record
nothing, read no clock and change no token, counter or parameter; on,
they give the span tree of the engine's phases, the model's blocks, the
MoE layer and the train step, and stamp each admission; under a torch
profiler they lie on its clock as ``repro:<name>`` events."""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.train_step import build_train_step
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.optim.adamw import AdamW
from repro_torch.serving import EngineConfig, RequestStatus, ServeEngine
from repro_torch.serving.engine import _req_from_json, _req_to_json

torch.set_num_threads(1)

SERVE_ARCH = "jamba-v0.1-52b-smoke"      # SSM, attention, MoE, dense FFN
TRAIN_ARCH = "qwen2-moe-2.7b-smoke"
PROMPTS = [[5, 7, 11, 13, 17, 19, 23], [2, 3], [29, 31, 37, 41, 43], [8]]

ENGINE_SPANS = {"engine.expire", "engine.admit", "engine.prefill.inputs",
                "engine.prefill.forward", "engine.prefill.readback",
                "engine.decode", "engine.decode.inputs",
                "engine.decode.forward", "engine.decode.readback",
                "engine.decode.emit"}
MODEL_SPANS = {"model.attn", "model.ssm", "model.moe", "model.ffn",
               "model.head"}
MOE_SPANS = {"moe.route", "moe.experts", "moe.combine"}


class CountingClock:
    def __init__(self):
        self.reads = 0

    def __call__(self) -> int:
        self.reads += 1
        return self.reads


@pytest.fixture
def clock():
    """The tracer's clock, stubbed to count its reads (and restored)."""
    real = tracing._STATE.clock
    tracing._STATE.clock = c = CountingClock()
    yield c
    tracing._STATE.clock = real
    tracing.drain()


@pytest.fixture(scope="module")
def serve_params():
    return lm.init_params(get_config(SERVE_ARCH), 0, "cpu")


def _engine(params, **kw):
    return ServeEngine(get_config(SERVE_ARCH), params=params, max_seq=32,
                       batch_size=2, chunk=4, device="cpu", **kw)


def _serve(params, **kw):
    eng = _engine(params, **kw)
    rids = [eng.submit(p, max_new=3) for p in PROMPTS]
    eng.run()
    counters = (eng.prefill_tokens, eng.decode_steps, eng.decode_tokens,
                eng.admit_rounds, eng.admissions)
    return eng, [eng.finished[r].tokens for r in rids], counters


def _train(accum: int = 1):
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat="full")
    built = build_train_step(cfg, ShapeConfig("smoke", 16, 2, "train"),
                             accum=accum)
    params = lm.init_params(cfg, seed=0, device="cpu")
    state = {"params": params, "opt": AdamW().init(params), "step": 0}
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, v)
                                 .astype(np.int32))
             for k, v in built["batch_structs"].items()}
    state, m = built["fn"](state, batch)
    assert state["step"] == 1 and np.isfinite(float(m["loss"]))
    return state


def _leaves(tree):
    return [(k, t) for k, t in tree_leaves(tree) if torch.is_tensor(t)]


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s[1] == i]


def _under(spans, i):
    """Names of span i's ancestors, innermost first."""
    out, p = [], spans[i][1]
    while p >= 0:
        out.append(spans[p][0])
        p = spans[p][1]
    return out


# ---------------------------------------------------------------------------
# off: nothing recorded, no clock read, the same results
# ---------------------------------------------------------------------------


def test_off_is_one_shared_noop():
    assert not tracing.enabled()
    a, b = tracing.span("engine.decode"), tracing.span("model.moe")
    assert a is b is tracing.OFF
    with a as sp:
        sp.set("step", 3)
    assert tracing.drain() == []


def test_off_serving_records_nothing_and_matches_on(serve_params, clock):
    eng, toks, counters = _serve(serve_params)
    assert clock.reads == 0 and tracing.drain() == []
    with tracing.recording():
        _, toks_on, counters_on = _serve(serve_params)
    assert clock.reads > 0
    assert toks_on == toks and counters_on == counters
    assert all(r.status == RequestStatus.OK for r in eng.finished.values())


def test_off_train_step_records_nothing_and_matches_on(clock):
    off = _train()
    assert clock.reads == 0 and tracing.drain() == []
    with tracing.recording():
        on = _train()
    assert clock.reads == 2 * len(tracing.drain())
    for key in ("params", "opt"):
        a, b = dict(_leaves(off[key])), dict(_leaves(on[key]))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (key, k)


# ---------------------------------------------------------------------------
# on: the engine's span tree and the admission stamp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced_engine(serve_params):
    real = tracing._STATE.clock
    tracing._STATE.clock = CountingClock()
    try:
        with tracing.recording():
            eng, _, _ = _serve(serve_params)
        spans = tracing.drain()
    finally:
        tracing._STATE.clock = real
    return eng, spans


def test_engine_span_names(traced_engine):
    _, spans = traced_engine
    names = {s[0] for s in spans}
    assert ENGINE_SPANS | MODEL_SPANS | MOE_SPANS <= names
    assert names <= ENGINE_SPANS | MODEL_SPANS | MOE_SPANS
    assert not names & {"engine.step", "train_step", "window"}


def test_engine_span_nesting(traced_engine):
    _, spans = traced_engine
    for i, (name, parent, s, e, _) in enumerate(spans):
        assert s < e and (parent < i)
        up = _under(spans, i)
        if name in ("engine.expire", "engine.admit", "engine.decode"):
            assert up == [], name
        elif name.startswith("engine.prefill."):
            assert up == ["engine.admit"], name
        elif name.startswith("engine.decode."):
            assert up == ["engine.decode"], name
        elif name in ("model.attn", "model.ssm", "model.moe", "model.ffn",
                      "model.head"):
            assert up[0] in ("engine.prefill.forward",
                             "engine.decode.forward"), (name, up)
        else:
            assert up[0] == "model.moe", (name, up)
        if parent >= 0:
            p = spans[parent]
            assert p[2] <= s and e <= p[3]
    for i, (name, *_rest) in enumerate(spans):
        kids = [spans[j][0] for j in _children(spans, i)]
        if name == "engine.decode":
            assert kids == ["engine.decode.inputs", "engine.decode.forward",
                            "engine.decode.readback", "engine.decode.emit"]
        if name == "model.moe":
            assert kids == ["moe.route", "moe.experts", "moe.combine"]
        if name in ("engine.decode.forward", "engine.prefill.forward"):
            assert kids[-1] == "model.head"


def test_engine_span_attrs(traced_engine):
    eng, spans = traced_engine
    admits = [s for s in spans if s[0] == "engine.admit"]
    decodes = [s for s in spans if s[0] == "engine.decode"]
    steps = [a[4]["step"] for a in admits]
    assert steps == list(range(1, eng.step_idx + 1))
    assert all(d[4]["step"] in steps for d in decodes)
    assert [d[4]["step"] for d in decodes] == sorted(
        {d[4]["step"] for d in decodes})
    rids = [r for a in admits for r in a[4]["rids"]]
    assert sorted(rids) == sorted(eng.finished)
    for a in admits:                 # chunks of one stack: one per chunk
        chunks = [spans[j][0] for j in _children(spans, spans.index(a))]
        if a[4]["rids"]:
            assert chunks and chunks.count("engine.prefill.forward") == \
                chunks.count("engine.prefill.readback") >= 1
        else:
            assert chunks == []
    assert all(s[4] is None for s in spans
               if s[0] not in ("engine.admit", "engine.decode"))


def test_admission_stamp_order(traced_engine):
    eng, _ = traced_engine
    for r in eng.finished.values():
        assert 0 < r.submit_t <= r.admit_t <= r.first_token_t <= r.done_t
        assert eng.admitted_t[r.rid] == r.admit_t
    # one stamp per stacked call: requests admitted together share it
    assert len({r.admit_t for r in eng.finished.values()}) == \
        eng.admit_rounds


def test_admission_stamp_off_the_record_and_kept_by_restore(serve_params):
    """The snapshot's request records keep the JAX engine's fields (the
    mesh tests hold them equal to its records); a restore takes each
    request's stamp from the engine's own ledger, as it keeps the
    emission watermark."""
    with tempfile.TemporaryDirectory() as tmp:
        eng = _engine(serve_params, snapshot_dir=tmp, snapshot_every=0)
        for p in PROMPTS:
            eng.submit(p, max_new=3)
        eng.step()
        live = [r for r in eng.slot_req if r is not None]
        assert live and all(r.admit_t > 0 for r in live)
        d = _req_to_json(live[0])
        assert "admit_t" not in d and _req_from_json(d).admit_t == 0.0
        eng.snapshot()
        stamps = {r.rid: r.admit_t for r in live}
        eng.step()
        eng.restore()
        back = {r.rid: r.admit_t for r in eng.slot_req if r is not None}
        assert back == stamps
        eng.run()
        for r in eng.finished.values():
            assert r.submit_t <= r.admit_t <= r.first_token_t


def test_admission_stamp_order_kept_by_a_restore_in_a_new_engine(
        serve_params):
    """An engine that restores another's snapshot has no stamps of its
    own: the requests admitted before the snapshot take their first
    token's time, which keeps the order."""
    with tempfile.TemporaryDirectory() as tmp:
        eng = _engine(serve_params, snapshot_dir=tmp, snapshot_every=0)
        for p in PROMPTS:
            eng.submit(p, max_new=3)
        eng.step()
        eng.snapshot()
        eng.ckpt.wait()
        fresh = _engine(serve_params, snapshot_dir=tmp, snapshot_every=0)
        fresh.restore()
        live = [r for r in fresh.slot_req if r is not None]
        assert live and all(r.admit_t == r.first_token_t > 0 for r in live)
        assert all(r.admit_t == 0.0 for r in fresh.queue)
        fresh.run()
        assert len(fresh.finished) == len(PROMPTS)
        for r in fresh.finished.values():
            assert 0 < r.submit_t <= r.admit_t <= r.first_token_t


@pytest.mark.parametrize("kind", ["engine", "router"])
def test_collect_empties_both_ledgers(serve_params, kind):
    """``collect`` drops a request's admission stamp with its emission
    watermark; a disaggregated router shares both ledgers with its
    workers, so its requests keep the prefill worker's stamp across the
    handoff."""
    if kind == "engine":
        eng, _, _ = _serve(serve_params)
    else:
        eng = EngineConfig(max_seq=32, chunk=4, page_size=8, disagg=True,
                           prefill_workers=1, decode_workers=1,
                           prefill_slots=2, decode_slots=2).build(
            get_config(SERVE_ARCH), params=serve_params, device="cpu")
        for p in PROMPTS:
            eng.submit(p, max_new=3)
        eng.run()
        assert all(w.admitted_t is eng.admitted_t for w in eng.workers)
    assert set(eng.admitted_t) == set(eng.emitted) == set(eng.finished)
    for rid in list(eng.finished):
        r = eng.collect(rid)
        assert 0 < r.submit_t <= r.admit_t <= r.first_token_t
    assert eng.admitted_t == {} and eng.emitted == {}


# ---------------------------------------------------------------------------
# on: the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(clock, accum):
    with tracing.recording():
        _train(accum)
    spans = tracing.drain()
    top = [s[0] for s in spans if s[1] < 0]
    assert top == ["train.grad"] * accum + ["train.guard", "train.update"]
    names = {s[0] for s in spans}
    assert {"model.attn", "model.moe", "model.head"} | MOE_SPANS <= names
    for i, s in enumerate(spans):
        up = _under(spans, i)
        if s[0].startswith("moe."):
            assert up[0] == "model.moe"
        if s[0].startswith("model."):
            assert up[-1] == "train.grad"
    # remat: every block's forward runs again inside the backward
    n_moe = sum(1 for s in spans if s[0] == "model.moe")
    assert n_moe == 2 * accum * get_config(TRAIN_ARCH).n_layers


# ---------------------------------------------------------------------------
# the tracer itself
# ---------------------------------------------------------------------------


def test_summary_self_time(clock):
    with tracing.recording():
        with tracing.span("engine.decode"):          # clock 1 .. 6
            with tracing.span("engine.decode.forward"):   # 2 .. 5
                with tracing.span("model.ssm"):           # 3 .. 4
                    pass
        with tracing.span("engine.decode"):          # 7 .. 8
            pass
    spans = tracing.drain()
    assert [s[:4] for s in spans] == [
        ("engine.decode", -1, 1, 6), ("engine.decode.forward", 0, 2, 5),
        ("model.ssm", 1, 3, 4), ("engine.decode", -1, 7, 8)]
    assert tracing.summarize(spans) == {
        "engine.decode": (2, 6, 3), "engine.decode.forward": (1, 3, 2),
        "model.ssm": (1, 1, 1)}


def test_drain_inside_an_open_span_raises(clock):
    with tracing.recording():
        with tracing.span("engine.admit"):
            with pytest.raises(RuntimeError):
                tracing.drain()
    assert [s[0] for s in tracing.drain()] == ["engine.admit"]


def test_recording_nests_and_ends():
    with tracing.recording():
        with tracing.recording():
            assert tracing.enabled()
        assert tracing.enabled()
    assert not tracing.enabled()
    assert tracing.span("model.head") is tracing.OFF


def test_spans_lie_on_the_profiler_clock(serve_params):
    """Under a torch profiler each span is also a ``repro:<name>`` host
    event; without one no ``record_function`` is entered."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof, tracing.recording():
        with tracing.span("engine.admit"):
            with tracing.span("engine.prefill.forward"):
                torch.ones(4).sum()
    ours = tracing.drain()
    names = [e.name for e in prof.events()
             if e.name.startswith(tracing.PREFIX)]
    assert sorted(names) == ["repro:engine.admit",
                             "repro:engine.prefill.forward"]
    assert [s[0] for s in ours] == ["engine.admit", "engine.prefill.forward"]
    # op-scope host ranges: no device-side annotation for a trace's
    # readers to tell from the kernels
    assert not any(e.is_user_annotation() for e in
                   prof.profiler.kineto_results.events()
                   if e.name().startswith(tracing.PREFIX))


def test_serve_launcher_prints_the_spans(capsys):
    """``launch/serve.py --trace``: each span name's count, total and self
    time, after the engine's summary, then the admission wait's p50
    and p90."""
    from repro_torch.launch import serve
    serve.main(["--arch", SERVE_ARCH, "--device", "cpu", "--requests", "3",
                "--batch", "2", "--max-seq", "32", "--chunk", "8",
                "--prompt-min", "4", "--prompt-max", "12", "--max-new", "2",
                "--trace"])
    out = capsys.readouterr().out.splitlines()
    head = next(i for i, ln in enumerate(out) if ln.startswith("span "))
    wait = next(ln for ln in out if ln.startswith("admission wait:"))
    rows = {ln.split()[0]: ln.split()[1:] for ln in out[head + 1:]
            if not ln.startswith("admission wait:")}
    assert ENGINE_SPANS | MODEL_SPANS | MOE_SPANS <= set(rows)
    # one admission phase a step, a deadline pass before it and after the
    # decode
    assert int(rows["engine.expire"][0]) == 2 * int(rows["engine.admit"][0])
    for n, tot, own in rows.values():
        assert int(n) > 0 and float(tot) >= float(own) >= 0.0
    p50, p90 = float(wait.split()[3]), float(wait.split()[6])
    assert 0.0 <= p50 <= p90 and "(3 of 3 requests admitted)" in wait
    assert not tracing.enabled() and tracing.drain() == []


def test_train_launcher_prints_the_spans(capsys):
    """``launch/train.py --trace``: the train step's spans, each step's
    ``train.grad``, ``train.guard`` and ``train.update``, with the model's
    and the MoE layer's under them, and the head products by path."""
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as t:
        train.main(["--arch", TRAIN_ARCH, "--steps", "2", "--batch", "2",
                    "--seq", "16", "--ckpt-dir", t, "--trace"],
                   device="cpu")
    out = capsys.readouterr().out.splitlines()
    head = next(i for i, ln in enumerate(out) if ln.startswith("span "))
    # the summary's rows, then the head products' count by path: one
    # chunk, its forward and its recompute, each step
    calls = next(i for i, ln in enumerate(out)
                 if ln.startswith("head products: "))
    assert out[calls] == ("head products: bf16_exact 0 (0 a step), "
                          "fp32 4 (2 a step)")
    rows = {ln.split()[0]: ln.split()[1:] for ln in out[head + 1:calls]}
    for name in ("train.grad", "train.guard", "train.update"):
        assert int(rows[name][0]) == 2
    assert {"model.attn", "model.moe", "model.head"} | MOE_SPANS <= set(rows)
    for n, tot, own in rows.values():
        assert float(tot) >= float(own) >= 0.0
    assert not tracing.enabled() and tracing.drain() == []


def test_linter_stays_clean():
    from repro_torch.analysis.verify import conventions
    assert conventions.lint_tree() == []
