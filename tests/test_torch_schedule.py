"""The port's block-schedule IR (``core/schedule.py``), its race detector
(``analysis/verify/schedule_check.py``), the whole-graph cost terms and
tuner candidates (``core/adaptive.py``), and the scheduled forward
(``lm.forward_scheduled``, ``blocks.block_segments``), against the JAX
package.

* The IR: every case of ``tests/test_schedule.py`` on the port, at both
  ``tpu_v5e`` and ``h100_nvlink``; then the two packages on the same
  inputs: the same segments (names, kinds, blocks, deps, resources, costs
  to 1e-12 relative), the same ``overlap_order``, equal ``schedule_time``
  and ``graph_step_time`` dicts, the same candidate stream with
  ``include_graph``, the same tuner pick, the same race-detector
  diagnostics.
* Execution order: the same ``exec_order`` for every registered smoke
  arch (segments lowered from ``layer_schema``, no weights).
* Parity: the port's ``sequential`` against ``overlap`` bitwise in the
  forward, the aux loss and every gradient leaf; the port's scheduled
  forward, aux and gradients within fp32 1e-4 of the JAX package's
  scheduled ones, on the bridged weights.

No spawn; the JAX references are computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.verify import schedule_check as JV
from repro.configs import get_config as jax_config
from repro.core import adaptive as JA
from repro.core import schedule as JSCH
from repro.models import blocks as JB
from repro.models import lm as jlm
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro_torch import bridge
from repro_torch.analysis import simulator as SIM
from repro_torch.analysis.verify import schedule_check as V
from repro_torch.configs import ShapeConfig, get_config, list_archs
from repro_torch.core import adaptive as A
from repro_torch.core import schedule as SCH
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)

HWS = ["tpu_v5e", "h100_nvlink"]
MIXTRAL = dict(M=8192, N=4096, K=14336, E=8, topk=2, ep=8, etp=1)
PLAN = dict(impl="comet", ring_group=2, n_col_blocks=4,
            gemm_impl="pallas_fused", fused_combine=True)


def _shape(mod=A, **kw):
    return mod.MoEShape(**{**MIXTRAL, **kw})


def _plan(mod=A, **kw):
    return mod.Plan(**{**PLAN, **kw})


def _jplan(p):
    """The JAX package's Plan with the port's plan's knobs."""
    return JA.Plan.from_json(p.to_json())


# ---------------------------------------------------------------------------
# the cases of tests/test_schedule.py, on the port
# ---------------------------------------------------------------------------


def test_graph_rejects_unknown_kind_and_forward_deps():
    g = SCH.ScheduleGraph()
    with pytest.raises(ValueError, match="unknown segment kind"):
        g.add("x", "not_a_kind", 0)
    a = g.add("a", "attn", 0)
    with pytest.raises(ValueError, match="earlier segment"):
        g.add("b", "router", 0, deps=[a + 1])


def test_validate_order_catches_violations():
    g = SCH.ScheduleGraph()
    a = g.add("a", "attn", 0, cost_s=1.0)
    r = g.add("r", "router", 0, deps=[a], cost_s=1.0)
    assert SCH.validate_order(g, [a, r]) == []
    errs = SCH.validate_order(g, [r, a])
    assert errs and "must precede" in errs[0]
    assert SCH.validate_order(g, [a])
    assert SCH.validate_order(g, [a, a])


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("ns", [1, 2, 4])
def test_overlap_order_is_legal_on_lowered_graphs(hw, training, ns):
    s = _shape()
    g = SCH.lower_model_graph(A.HW[hw], s, _plan(), d_model=s.N,
                              n_blocks=3, n_slices=ns, training=training)
    order = SCH.overlap_order(g)
    assert SCH.validate_order(g, order) == []
    t = SCH.schedule_time(g, order)
    assert t["total"] >= max(v for k, v in t.items()
                             if k.startswith("busy_")) - 1e-12


@pytest.mark.parametrize("hw", HWS)
def test_next_block_attn_depends_on_prev_combine_per_slice(hw):
    s = _shape()
    g = SCH.lower_model_graph(A.HW[hw], s, _plan(), d_model=s.N,
                              n_blocks=2, n_slices=2)
    segs = {x.name: x for x in g.segments}
    for j in range(2):
        attn1 = segs[f"L1.s{j}.attn"]
        assert len(attn1.deps) == 1
        dep = g.segments[attn1.deps[0]]
        assert dep.kind == "combine_hop" and dep.block == 0
        assert dep.slice_id == j
        combines = [x for x in g.segments if x.kind == "combine_hop"
                    and x.block == 0 and x.slice_id == j]
        assert dep.sid == max(x.sid for x in combines)


@pytest.mark.parametrize("hw", HWS)
def test_wgrad_flush_floats_freely(hw):
    s = _shape()
    g = SCH.lower_model_graph(A.HW[hw], s, _plan(), d_model=s.N,
                              n_blocks=2, training=True)
    flushes = {x.sid for x in g.segments if x.kind == "wgrad_flush"}
    assert flushes
    for x in g.segments:
        assert not (flushes & set(x.deps)), x.name


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("ns", [1, 2])
def test_race_detector_clean_on_lowered_graphs(hw, training, ns):
    s = _shape()
    plan = A.legalize_plan(_plan(), s.N, s.ep)
    diags = V.check_lowered(A.HW[hw], s, plan, d_model=s.N, n_blocks=3,
                            n_slices=ns, training=training)
    assert diags == [], "\n".join(str(d) for d in diags)


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("training", [False, True])
def test_scheduled_no_worse_and_barriers_no_better(hw, training):
    s = _shape()
    g = SCH.lower_model_graph(A.HW[hw], s, _plan(), d_model=s.N,
                              n_blocks=2, n_slices=2, training=training)
    seq = SCH.sequential_order(g)
    t_sched = SCH.schedule_time(g, SCH.overlap_order(g))["total"]
    t_free = SCH.schedule_time(g, seq)["total"]
    t_barrier = SCH.schedule_time(g, seq, layer_barriers=True)["total"]
    assert t_sched <= t_free + 1e-12
    assert t_barrier >= t_free - 1e-12


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("training", [False, True])
def test_whole_graph_scheduled_strictly_below_baseline(hw, training):
    s, p, h = _shape(), _plan(), A.HW[hw]
    base = SCH.graph_step_time(h, s, p, d_model=s.N, training=training,
                               scheduled=False)
    sched = min(SCH.graph_step_time(h, s, p, d_model=s.N, n_slices=ns,
                                    training=training)["total"]
                for ns in (1, 2, 4))
    assert sched < base["total"]
    assert base["lump_s"] == pytest.approx(SCH.graph_step_time(
        h, s, p, d_model=s.N, n_slices=2, training=training)["lump_s"])


def test_ring_counts_match_transport():
    from repro_torch.core.transport import comet_ring_segments
    for ep in (2, 4, 8):
        for rg in (1, 2, 4):
            for n_col in (1, 2, 4):
                assert (SCH.comet_ring_counts(ep, rg, n_col)
                        == comet_ring_segments(ep, rg, n_col)), \
                    (ep, rg, n_col)


@pytest.mark.parametrize("hw", HWS)
def test_adaptive_graph_terms(hw):
    s, p, h = _shape(), _plan(), A.HW[hw]
    bub = A.ring_bubble_time(h, s, p)
    fill = A.cross_layer_fill_time(h, s, p, n_slices=2)
    fill_t = A.cross_layer_fill_time(h, s, p, n_slices=2, training=True)
    assert bub > 0.0
    assert 0.0 < fill <= bub * 2 + 1e-9
    assert fill_t > 0.0


@pytest.mark.parametrize("hw", HWS)
def test_tuner_ranks_graph_candidates(hw):
    s, h = _shape(), A.HW[hw]
    cands = list(A.candidate_plans(s, include_graph=True, hw=h))
    graph = [p for p in cands if p.schedule == "overlap"]
    assert graph and all(p.n_slices in (2, 4) for p in graph)
    assert all(p.impl == "comet" for p in graph)
    plan = A.tune_plan(s, h, candidates=cands)
    assert plan.schedule == "overlap"
    m = A.phase_measure(h, s, "train")
    assert m(plan) <= m(dataclasses.replace(plan, schedule="", n_slices=1))


def test_plan_cache_v6_roundtrip_and_compat():
    p6 = A.Plan("comet_hier", 2, 4, "pallas_fused", fused_combine=True,
                schedule="overlap", n_slices=4, intra_group=4,
                wire_dtype="bf16")
    assert A.Plan.from_json(p6.to_json()) == p6
    v5 = {k: v for k, v in p6.to_json().items()
          if k not in ("intra_group", "wire_dtype")}
    p = A.Plan.from_json(v5)
    assert p.intra_group == 1 and p.wire_dtype == "fp32"
    v4 = {k: v for k, v in v5.items() if k not in ("schedule", "n_slices")}
    p = A.Plan.from_json(v4)
    assert p.schedule == "" and p.n_slices == 1
    assert A.PLAN_CACHE_VERSION == 6


@dataclasses.dataclass(frozen=True)
class _Seg:
    name: str
    kind: str
    block: int
    reads: tuple
    writes: tuple


DATAFLOW = [_Seg("a", "attn", 0, ("x",), ("h",)),
            _Seg("b", "residual", 0, ("x", "h"), ("x2",)),
            _Seg("c", "moe", 0, ("x2",), ("y",)),
            _Seg("d", "attn", 1, ("y",), ("h2",))]
WAR = [_Seg("w0", "attn", 0, (), ("v",)),
       _Seg("rd", "moe", 0, ("v",), ("y",)),
       _Seg("w1", "norm", 1, (), ("v",))]


def test_exec_order_respects_dataflow():
    out = SCH.exec_order(DATAFLOW, "overlap")
    pos = {s.name: i for i, s in enumerate(out)}
    assert sorted(pos) == ["a", "b", "c", "d"]
    assert pos["a"] < pos["b"] < pos["c"] < pos["d"]
    with pytest.raises(ValueError, match="unknown schedule mode"):
        SCH.exec_order(DATAFLOW, "bogus")


def test_exec_order_war_hazard():
    out = SCH.exec_order(WAR, "overlap")
    pos = {s.name: i for i, s in enumerate(out)}
    assert pos["rd"] < pos["w1"]


# ---------------------------------------------------------------------------
# the two packages on the same inputs
# ---------------------------------------------------------------------------


# (hardware key, plan knobs): the flat comet ring with the fused backend
# and with bmm, and the two-level ring where the preset has node structure
IR_GRID = {
    "tpu_v5e-fused": ("tpu_v5e", PLAN),
    "tpu_v5e-xla": ("tpu_v5e", dict(impl="comet", ring_group=1,
                                    n_col_blocks=2, gemm_impl="xla")),
    "h100_nvlink-fused": ("h100_nvlink", PLAN),
    "h100_nvlink-xla": ("h100_nvlink", dict(impl="comet", ring_group=1,
                                            n_col_blocks=2,
                                            gemm_impl="xla")),
    "h100_crossnode-hier": ("h100_crossnode", dict(
        impl="comet_hier", ring_group=2, n_col_blocks=4,
        gemm_impl="pallas_fused", fused_combine=True, intra_group=4,
        wire_dtype="bf16")),
}


def _close(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-30)


def _same_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        assert _close(got[k], want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("cell", list(IR_GRID))
def test_ir_matches_jax(cell, training):
    hw, knobs = IR_GRID[cell]
    s, js = _shape(), _shape(JA)
    p = A.legalize_plan(A.Plan(**knobs), s.N, s.ep)
    jp = JA.legalize_plan(JA.Plan(**knobs), js.N, js.ep)
    assert p.to_json() == jp.to_json()
    for ns in (1, 2, 4):
        g = SCH.lower_model_graph(A.HW[hw], s, p, d_model=s.N, n_blocks=3,
                                  n_slices=ns, training=training)
        jg = JSCH.lower_model_graph(JA.HW[hw], js, jp, d_model=js.N,
                                    n_blocks=3, n_slices=ns,
                                    training=training)
        assert len(g) == len(jg)
        for a, b in zip(g.segments, jg.segments):
            assert (a.sid, a.name, a.kind, a.block, a.deps, a.resource,
                    a.slice_id) == (b.sid, b.name, b.kind, b.block, b.deps,
                                    b.resource, b.slice_id)
            assert _close(a.cost_s, b.cost_s), (a.name, a.cost_s, b.cost_s)
        order = SCH.overlap_order(g)
        assert order == JSCH.overlap_order(jg)
        for o in (order, SCH.sequential_order(g)):
            for bar in (False, True):
                _same_dict(SCH.schedule_time(g, o, layer_barriers=bar),
                           JSCH.schedule_time(jg, o, layer_barriers=bar))
        for sched in (False, True):
            _same_dict(
                SCH.graph_step_time(A.HW[hw], s, p, d_model=s.N,
                                    n_slices=ns, training=training,
                                    scheduled=sched),
                JSCH.graph_step_time(JA.HW[hw], js, jp, d_model=js.N,
                                     n_slices=ns, training=training,
                                     scheduled=sched))
        # the race detector on the scheduler's order and on a corrupted one
        for o in (order, order[::-1]):
            got = [str(d) for d in V.check_graph_order(g, o)]
            assert got == [str(d) for d in JV.check_graph_order(jg, o)]
        assert V.check_lowered(A.HW[hw], s, p, d_model=s.N, n_slices=ns,
                               training=training) == []
        assert JV.check_lowered(JA.HW[hw], js, jp, d_model=js.N,
                                n_slices=ns, training=training) == []
    ps = dataclasses.replace(p, schedule="overlap", n_slices=2)
    for t in (A.ring_bubble_time(A.HW[hw], s, p, training),
              A.cross_layer_fill_time(A.HW[hw], s, p, n_slices=2,
                                      training=training),
              A.modeled_graph_step_time(A.HW[hw], s, ps, training=training),
              SIM.sim_e2e_graph(A.HW[hw], s, p, s.N, 8, training=training)):
        assert np.isfinite(t) and t >= 0
    from repro.analysis import simulator as JSIM
    assert _close(A.ring_bubble_time(A.HW[hw], s, p, training),
                  JA.ring_bubble_time(JA.HW[hw], js, jp, training))
    assert _close(A.cross_layer_fill_time(A.HW[hw], s, p, n_slices=2,
                                          training=training),
                  JA.cross_layer_fill_time(JA.HW[hw], js, jp, n_slices=2,
                                           training=training))
    assert _close(A.modeled_graph_step_time(A.HW[hw], s, ps,
                                            training=training),
                  JA.modeled_graph_step_time(JA.HW[hw], js, _jplan(ps),
                                             training=training))
    for sched in (False, True):
        assert _close(SIM.sim_e2e_graph(A.HW[hw], s, p, s.N, 8,
                                        training=training, scheduled=sched),
                      JSIM.sim_e2e_graph(JA.HW[hw], js, jp, js.N, 8,
                                         training=training,
                                         scheduled=sched))


def test_check_model_archs_matches_jax():
    """The standalone pass over every registered MoE arch, both packages,
    on both presets: clean, and the same (empty) list."""
    for hw in HWS:
        assert V.check_model_archs(A.HW[hw], tokens=1024) == \
            JV.check_model_archs(JA.HW[hw], tokens=1024) == []


# the tuner's shapes: the paper's qwen2-moe-2.7b layer at ep 4, mixtral's
# at ep 8, and a decode-sized shape
TUNE_SHAPES = {"qwen2-ep4": dict(M=4096, N=2048, K=1408, E=64, topk=4,
                                 ep=4, etp=1),
               "mixtral-ep8": MIXTRAL,
               "mixtral-decode": dict(MIXTRAL, M=64)}


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("shape", list(TUNE_SHAPES))
def test_graph_candidates_and_tuner_match_jax(hw, shape):
    s, js = A.MoEShape(**TUNE_SHAPES[shape]), JA.MoEShape(**TUNE_SHAPES[shape])
    cands = list(A.candidate_plans(s, include_graph=True, hw=A.HW[hw]))
    base = list(A.candidate_plans(s, hw=A.HW[hw]))
    # the graph variants: two per gated comet candidate, right after it
    assert [p for p in cands if not p.schedule] == base
    for i, p in enumerate(cands):
        if p.impl == "comet" and not p.schedule:
            assert [(q.schedule, q.n_slices) for q in cands[i + 1:i + 3]] \
                == [("overlap", 2), ("overlap", 4)]
    if hw == "tpu_v5e":      # both packages gate a TPU preset alike
        want = list(JA.candidate_plans(js, include_graph=True,
                                       hw=JA.HW[hw]))
        assert [p.to_json() for p in cands] == [p.to_json() for p in want]
    jcands = [_jplan(p) for p in cands]
    for phase in ("train", "prefill", "decode"):
        got = A.tune_plan(s, A.HW[hw], candidates=cands, phase=phase)
        want = JA.tune_plan(js, JA.HW[hw], candidates=jcands, phase=phase)
        assert got.to_json() == want.to_json(), phase


# ---------------------------------------------------------------------------
# executed segments: the same order in both packages
# ---------------------------------------------------------------------------


SMOKE = [a for a in list_archs(include_smoke=True) if a.endswith("-smoke")]
# an encoder-decoder's layers lower with their cross-attention segments
# when given the encoder's output (any object: lowering runs no segment)
ENC_OUT = object()


def _exec_names(cfg, jcfg):
    """exec_order's names of every layer of cfg lowered from its schema,
    in each package."""
    p = lm.period_of(cfg)
    segs, jsegs = [], []
    for i in range(cfg.n_layers):
        enc = ENC_OUT if cfg.n_enc_layers else None
        segs += B.block_segments(cfg, i % p, B.layer_schema(cfg, i % p),
                                 None, block=i, x_in=f"x{i}",
                                 x_out=f"x{i + 1}", enc_out=enc)
        jsegs += JB.block_segments(jcfg, i % p,
                                   JB.layer_schema(jcfg, i % p, JAxisCtx()),
                                   JAxisCtx(), None, enc_out=enc, block=i,
                                   x_in=f"x{i}", x_out=f"x{i + 1}")
    assert [(s.name, s.kind, s.block, s.reads, s.writes) for s in segs] == \
        [(s.name, s.kind, s.block, s.reads, s.writes) for s in jsegs]
    return ([s.name for s in SCH.exec_order(segs, "overlap")],
            [s.name for s in JSCH.exec_order(jsegs, "overlap")])


@pytest.mark.parametrize("arch", SMOKE)
def test_exec_order_matches_jax(arch):
    got, want = _exec_names(get_config(arch), jax_config(arch))
    assert got == want
    # no registered config has a shared expert and every layer depends on
    # the one before: the order is program order
    cfg = get_config(arch)
    if not (cfg.moe is not None and cfg.moe.num_shared_experts):
        p = lm.period_of(cfg)
        enc = ENC_OUT if cfg.n_enc_layers else None
        names = [s.name for i in range(cfg.n_layers)
                 for s in B.block_segments(cfg, i % p,
                                           B.layer_schema(cfg, i % p), None,
                                           block=i, enc_out=enc)]
        assert got == names


def test_exec_order_with_a_shared_expert_matches_jax():
    cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, num_shared_experts=1)) for c in (
        get_config("granite-moe-3b-a800m-smoke"),
        jax_config("granite-moe-3b-a800m-smoke")))
    got, want = _exec_names(cfg, jcfg)
    assert got == want
    for segs in (DATAFLOW, WAR):
        assert [s.name for s in SCH.exec_order(segs, "overlap")] == \
            [s.name for s in JSCH.exec_order(segs, "overlap")]


# ---------------------------------------------------------------------------
# the scheduled forward and backward
# ---------------------------------------------------------------------------


PARITY_ARCHS = [
    "qwen2-0.5b-smoke",
    "granite-moe-3b-a800m-smoke",
    "granite-moe-bigmac-smoke",
    "mamba2-780m-smoke",
    pytest.param("jamba-v0.1-52b-smoke", marks=pytest.mark.slow),
    "granite-shared",           # granite with one shared expert
]


def _configs(name):
    if name == "granite-shared":
        return tuple(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_shared_experts=1)) for c in (
            get_config("granite-moe-3b-a800m-smoke"),
            jax_config("granite-moe-3b-a800m-smoke")))
    return get_config(name), jax_config(name)


def _sched(cfg, mode):
    return dataclasses.replace(cfg, block_schedule=mode)


@pytest.fixture(scope="module")
def jax_refs():
    """name -> (weights as numpy, tokens, JAX's scheduled h, aux, loss and
    gradients); each computed at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            _, jcfg = _configs(name)
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
            toks = np.random.default_rng(7).integers(
                0, jcfg.vocab_size, (2, 16)).astype(np.int32)
            jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
            jc = _sched(jcfg, "overlap")
            (h, aux, _), ((loss, _), g) = jax.jit(lambda p: (
                jlm.forward(jc, p, jb), jax.value_and_grad(
                    lambda q: jlm.loss_fn(jc, q, jb), has_aux=True)(p)))(jp)
            cache[name] = (jax.tree.map(np.asarray, jp), toks,
                           np.asarray(h), float(aux), float(loss),
                           dict(tree_leaves(jax.tree.map(np.asarray, g))))
        return cache[name]

    return get


def _port_run(cfg, params_np, toks):
    """(h, aux, loss, {path: grad}) of the port on fresh bridged weights."""
    tp = bridge.from_jax(params_np, cfg, "cpu")
    b = {"tokens": torch.from_numpy(toks).long(),
         "labels": torch.from_numpy(toks).long()}
    with torch.no_grad():
        h, aux, _ = lm.forward(cfg, tp, b)
    leaves = [(p, t.requires_grad_(True)) for p, t in tree_leaves(tp)]
    loss, _ = lm.loss_fn(cfg, tp, b)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return h, aux, loss.detach(), {p: g for (p, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_scheduled_forward_and_backward(jax_refs, name):
    """sequential and overlap give the same bits in the forward, the aux
    loss and every gradient leaf; the scheduled forward and gradients lie
    within fp32 1e-4 of the JAX package's scheduled ones, and the
    scheduled forward within 1e-4 of the port's period-at-a-time one."""
    cfg, _ = _configs(name)
    params_np, toks, jh, jaux, jloss, jgrads = jax_refs(name)
    seq = _port_run(_sched(cfg, "sequential"), params_np, toks)
    ovl = _port_run(_sched(cfg, "overlap"), params_np, toks)
    for a, b in zip(seq[:3], ovl[:3]):
        assert torch.equal(a, b)
    assert seq[3].keys() == ovl[3].keys() == jgrads.keys()
    for path in seq[3]:
        assert torch.equal(seq[3][path], ovl[3][path]), path
    h, aux, loss, grads = ovl
    np.testing.assert_allclose(h.numpy(), jh, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aux.item(), jaux, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[path], rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))
    with torch.no_grad():
        h0, _, _ = lm.forward(cfg, bridge.from_jax(params_np, cfg, "cpu"),
                              {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(h0.numpy(), h.numpy(), rtol=1e-4, atol=1e-4)


def test_race_detector_guards_scheduled_execution(monkeypatch):
    """forward_scheduled runs the race detector before any segment runs
    (``REPRO_VERIFY_SCHEDULE=0`` opts out): a corrupted emission order is
    refused."""
    cfg = _sched(get_config("qwen2-0.5b-smoke"), "overlap")
    params = lm.init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    real = SCH.exec_order

    def corrupt(segs, mode):
        out = list(real(segs, mode))
        out[0], out[-1] = out[-1], out[0]
        return out

    monkeypatch.delenv("REPRO_VERIFY_SCHEDULE", raising=False)
    monkeypatch.setattr(SCH, "exec_order", corrupt)
    with pytest.raises(RuntimeError, match="hazard"):
        lm.forward_scheduled(cfg, params, {"tokens": toks})
    with pytest.raises(ValueError, match="block_schedule"):
        lm.forward_scheduled(get_config("qwen2-0.5b-smoke"), params,
                             {"tokens": toks})


def test_train_step_schedule_knob():
    """build_train_step(schedule=) runs the step through the IR: the two
    orders give the same bits (loss and every parameter after one AdamW
    step), within 1e-5 of the period-at-a-time step; an unknown mode
    raises."""
    import inspect

    from repro_torch.launch.train_step import build_train_step
    assert "schedule" in inspect.signature(build_train_step).parameters
    cfg = get_config("granite-moe-3b-a800m-smoke")
    shape = ShapeConfig("smoke", seq_len=16, global_batch=2, kind="train")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for mode in ("", "sequential", "overlap"):
        built = build_train_step(cfg, shape, schedule=mode)
        params = lm.init_params(cfg, 0, device="cpu")
        from repro_torch.optim.adamw import AdamW
        state = {"params": params, "opt": AdamW().init(params), "step": 0}
        state, m = built["fn"](state, batch)
        out[mode] = (m["loss"], [t.detach().clone() for _, t in
                                 tree_leaves(state["params"])])
    assert torch.equal(out["sequential"][0], out["overlap"][0])
    for a, b in zip(out["sequential"][1], out["overlap"][1]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(out["overlap"][0].item(), out[""][0].item(),
                               rtol=1e-5)
    built = build_train_step(cfg, shape, schedule="bogus")
    params = lm.init_params(cfg, 0, device="cpu")
    from repro_torch.optim.adamw import AdamW
    with pytest.raises(ValueError, match="unknown schedule mode"):
        built["fn"]({"params": params, "opt": AdamW().init(params),
                     "step": 0}, batch)


def test_diagnostics_match_jax():
    """The shared diagnostic core: ignore comments (with and without a
    justification), their filtering, and the report's text and JSON, as
    the JAX package's."""
    from repro.analysis.verify import diagnostics as JD
    from repro_torch.analysis.verify import diagnostics as D
    src = ("x = 1  # verify: ignore[raw-hazard] -- checked by hand\n"
           "y = 2  # verify: ignore[*]\n"
           "z = 3\n")
    assert D.parse_ignores(src) == JD.parse_ignores(src)
    args = [("schedule", "raw-hazard", "error", f"f.py:{i}", "m", "h")
            for i in (1, 2, 3)]
    got = D.apply_ignores([D.Diagnostic(*a) for a in args], "f.py", src,
                          "schedule")
    want = JD.apply_ignores([JD.Diagnostic(*a) for a in args], "f.py", src,
                            "schedule")
    assert [str(d) for d in got] == [str(d) for d in want]
    assert [d.location for d in got] == ["f.py:2", "f.py:3", "f.py:2"]
    rep, jrep = D.Report(got), JD.Report(want)
    assert (rep.text(), rep.to_json(), rep.ok) == (jrep.text(),
                                                  jrep.to_json(), jrep.ok)
    with pytest.raises(ValueError, match="severity"):
        D.Diagnostic("schedule", "x", "fatal", "f.py:1", "m")
