"""The port's adaptive workload assignment (``repro_torch.core.adaptive``,
``analysis/simulator.py``, ``analysis/kernel_check.py``,
``launch/tune.py``) against the JAX package's, on the CPU.

Cost model: over the grid (the paper's three shapes and the qwen2 and
granite smoke shapes; M 8, 256, 4096, 16384; ep 1, 2, 4, 8; etp 1, 2;
train, prefill, decode; every preset with the gate off, tpu_v5e also with
its VMEM gate on) the two packages give the same candidate stream, the
same modeled times for every candidate, and the same ``analytic_plan``
(knobs and objective identical, ``measured_s``/``t_bwd_s`` within rel
1e-12); ``choose_n_col``/``resolve_n_col`` and the simulator agree.

Cache files cross both ways (the JAX ``tools/tune.py`` in-process, the
port's ``launch.tune``) and resolve the same plan for every key; version-3
and corrupt files behave as in ``tests/test_adaptive_plan.py``.

Layer: the one-rank ``moe_ffn`` with a cache resolves the cached plan, as
the JAX ``moe_ffn`` does with the same file (forward and gradients, fp32
1e-4, bf16 2e-2), and gives the bits of the port's ``moe_ffn`` under
``plan.apply``; ``plan_override`` pins the explicit knobs; an
``n_col_blocks`` of 0 takes the cost model's split. The serving engine
threads the prefill and decode phases. The whole-graph terms, graph
candidates and ``tune --graph`` give the JAX package's values, and the
Hopper gate agrees with the fused kernel's plan.
"""
import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import simulator as JSIM
from repro.configs import get_config as jax_config
from repro.core import adaptive as JA
from repro.core import moe_layer as JM
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro_torch.analysis import kernel_check as KC
from repro_torch.analysis import simulator as SIM
from repro_torch.configs import get_config
from repro_torch.core import adaptive as A
from repro_torch.core import moe_layer as M
from repro_torch.kernels import fused_mlp as FM
from repro_torch.launch import tune

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12
SMOKE_ARCHS = ("qwen2-moe-2.7b-smoke", "granite-moe-3b-a800m-smoke")


def _shapes():
    out = {name: (m["N"], m["K"], m["E"], m["topk"])
           for name, m in tune.PAPER_MODELS.items()}
    for arch in SMOKE_ARCHS:
        c = get_config(arch)
        out[arch] = (c.d_model, c.moe.d_expert, c.moe.num_experts,
                     c.moe.top_k)
    return out


SHAPES = _shapes()
MS = (8, 256, 4096, 16384)
EPS = (1, 2, 4, 8)
ETPS = (1, 2)
PHASES = ("train", "prefill", "decode")
# every preset with the gate off, and tpu_v5e with its VMEM gate on
HWS = [(name, False) for name in sorted(A.HW)] + [("tpu_v5e", True)]


def _grid():
    for N, K, E, k in SHAPES.values():
        for M_ in MS:
            for ep in EPS:
                for etp in ETPS:
                    yield dict(M=M_, N=N, K=K // etp, E=E, topk=k, ep=ep,
                               etp=etp)


def _hw(mod, name, gate=False):
    hw = mod.HW[name]
    return hw if gate else dataclasses.replace(hw, vmem_bytes=0)


def _close(a, b, rel=REL):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def _jplan(plan):
    return JA.Plan(**plan.to_json())


def _same_plan(got, want):
    """Knobs, provenance and objective identical; the two times within
    rel 1e-12."""
    g, w = got.to_json(), want.to_json()
    for key in ("measured_s", "t_bwd_s"):
        assert _close(g.pop(key), w.pop(key)), (key, got, want)
    assert g == w


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


def test_presets_and_constants_match_jax():
    assert set(A.HW) == set(JA.HW)
    for name in A.HW:
        assert dataclasses.asdict(A.HW[name]) == dataclasses.asdict(
            JA.HW[name])
    assert (A.PLAN_CACHE_VERSION, A.TRANSPORTS, A.PLAN_PHASES,
            A.PHASE_OBJECTIVES, A.WIRE_DTYPES, A.MAX_COL_BLOCKS) == (
        JA.PLAN_CACHE_VERSION, JA.TRANSPORTS, JA.PLAN_PHASES,
        JA.PHASE_OBJECTIVES, JA.WIRE_DTYPES, JA.MAX_COL_BLOCKS)
    assert [f.name for f in dataclasses.fields(A.Plan)] == \
        [f.name for f in dataclasses.fields(JA.Plan)]
    from benchmarks.figures import PAPER_MODELS
    assert tune.PAPER_MODELS == PAPER_MODELS


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("hw_name,gate", HWS)
def test_cost_model_matches_jax(hw_name, gate, phase):
    hw, jhw = _hw(A, hw_name, gate), _hw(JA, hw_name, gate)
    n_plans = 0
    for kw in _grid():
        s, js = A.MoEShape(**kw), JA.MoEShape(**kw)
        cands = list(A.candidate_plans(s, hw=hw))
        assert [p.to_json() for p in cands] == \
            [p.to_json() for p in JA.candidate_plans(js, hw=jhw)], kw
        n_plans += len(cands)
        model = A.phase_measure(hw, s, phase)
        jmodel = JA.phase_measure(jhw, js, phase)
        for p in cands:
            jp = _jplan(p)
            assert _close(model(p), jmodel(jp)), (kw, p)
            assert A.hot_path_hbm_bytes(s, p) == JA.hot_path_hbm_bytes(js, jp)
            if p.impl in ("comet", "comet_hier"):
                assert A.hop_time_profile(hw, s, p) == \
                    JA.hop_time_profile(jhw, js, jp)
                assert _close(A.fwd_exposed_comm_time(hw, s, p),
                              JA.fwd_exposed_comm_time(jhw, js, jp))
            if phase == "train":
                for fn in ("modeled_plan_time_bwd", "bwd_exposed_comm_time"):
                    assert _close(getattr(A, fn)(hw, s, p),
                                  getattr(JA, fn)(jhw, js, jp)), (fn, kw, p)
                assert A.hot_path_hbm_bytes_bwd(s, p) == \
                    JA.hot_path_hbm_bytes_bwd(js, jp)
        _same_plan(A.analytic_plan(s, hw, phase),
                   JA.analytic_plan(js, jhw, phase))
        assert A.choose_n_col(hw, s) == JA.choose_n_col(jhw, js)
        assert _close(A.autodiff_bwd_time(hw, s),
                      JA.autodiff_bwd_time(jhw, js))
        assert A.autodiff_bwd_hbm_bytes(s) == JA.autodiff_bwd_hbm_bytes(js)
        assert A.layer_times(hw, s) == JA.layer_times(jhw, js)
    assert n_plans > 1000


def test_resolve_n_col_and_legalization_match_jax():
    mcfg, jmcfg = get_config(SMOKE_ARCHS[0]).moe, jax_config(
        SMOKE_ARCHS[0]).moe
    for name in sorted(A.HW):
        for kw in _grid():
            over = dict(num_experts=kw["E"], top_k=kw["topk"],
                        d_expert=kw["K"] * kw["etp"], n_col_blocks=0)
            m = dataclasses.replace(mcfg, **over)
            jm = dataclasses.replace(jmcfg, **over)
            args = (kw["N"], kw["M"], kw["ep"], kw["etp"])
            assert A.resolve_n_col(m, *args, hw=A.HW[name]) == \
                JA.resolve_n_col(jm, *args, hw=JA.HW[name])
    # the port's default key is h100_nvlink; an explicit split passes
    m = dataclasses.replace(mcfg, n_col_blocks=0)
    jm = dataclasses.replace(jmcfg, n_col_blocks=0)
    assert A.resolve_n_col(m, 2048, 4096, 1, 1) == \
        JA.resolve_n_col(jm, 2048, 4096, 1, 1, hw=JA.H100_NVL)
    assert A.resolve_n_col(dataclasses.replace(m, n_col_blocks=3), 2048,
                           4096, 1, 1) == 3
    for d in (128, 1536, 2048, 7168):
        for ep in (1, 2, 3, 4, 8, 16):
            for knob in range(0, 13):
                assert A.legalize_n_col(d, knob) == JA.legalize_n_col(d, knob)
                assert A.legalize_ring_group(ep, knob) == \
                    JA.legalize_ring_group(ep, knob)
                assert A.legalize_intra_group(ep, knob) == \
                    JA.legalize_intra_group(ep, knob)
                for impl in ("comet", "comet_hier"):
                    p = A.Plan(impl, knob or 1, knob or 1, intra_group=knob
                               or 1)
                    assert A.legalize_plan(p, d, ep).to_json() == \
                        JA.legalize_plan(_jplan(p), d, ep).to_json()
                    assert A.hier_step_order(ep, knob or 1) == \
                        JA.hier_step_order(ep, knob or 1)


@pytest.mark.parametrize("hw_name", sorted(A.HW))
def test_simulator_matches_jax(hw_name):
    hw, jhw = A.HW[hw_name], JA.HW[hw_name]
    assert SIM.A2A_EFF == JSIM.A2A_EFF
    assert SIM.HOST_LAUNCH_S == JSIM.HOST_LAUNCH_S
    hier = A.Plan("comet_hier", 1, 2, intra_group=2, wire_dtype="bf16")

    def same(got, want, what):
        for key in ("total", "comm", "overlapped"):
            assert _close(got[key], want[key]), (what, key, got, want)

    for kw in _grid():
        s, js = A.MoEShape(**kw), JA.MoEShape(**kw)
        for imb in (0.0, 0.02):
            assert dataclasses.asdict(SIM.layer_work(s, imb)) == \
                dataclasses.asdict(JSIM.layer_work(js, imb))
            same(SIM.sim_megatron(hw, s, imb), JSIM.sim_megatron(jhw, js, imb),
                 "megatron")
            same(SIM.sim_megatron(hw, s, imb, te=True),
                 JSIM.sim_megatron(jhw, js, imb, te=True), "megatron_te")
            same(SIM.sim_tutel(hw, s, imb), JSIM.sim_tutel(jhw, js, imb),
                 "tutel")
            if s.etp == 1:
                same(SIM.sim_fastermoe(hw, s, imb),
                     JSIM.sim_fastermoe(jhw, js, imb), "fastermoe")
            for n_col in (0, 2):
                for tpu in (False, True):
                    same(SIM.sim_comet(hw, s, imb, n_col=n_col, tpu=tpu),
                         JSIM.sim_comet(jhw, js, imb, n_col=n_col, tpu=tpu),
                         "comet")
                    same(SIM.sim_comet_hier(hw, s, hier, imb, n_col=n_col,
                                            tpu=tpu),
                         JSIM.sim_comet_hier(jhw, js, _jplan(hier), imb,
                                             n_col=n_col, tpu=tpu), "hier")
        for mech in SIM.MECHANISMS:
            if mech == "fastermoe" and s.etp > 1:
                continue
            assert _close(SIM.sim_e2e(hw, mech, s, s.N, 4, s.ep),
                          JSIM.sim_e2e(jhw, mech, js, js.N, 4, js.ep))
        assert _close(SIM.attn_time(hw, s.N, s.M, s.ep),
                      JSIM.attn_time(jhw, js.N, js.M, js.ep))


# ---------------------------------------------------------------------------
# cache files across the packages
# ---------------------------------------------------------------------------


def _jax_tuner():
    spec = importlib.util.spec_from_file_location("_jax_tools_tune",
                                                  ROOT / "tools" / "tune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_KEY = re.compile(r"^(\w+):M(\d+):N(\d+):K(\d+):E(\d+):k(\d+):ep(\d+):"
                  r"etp(\d+)(?::ph(\w+))?$")


def _resolve_every_key(path, keys):
    """Each key's plan as both packages' ``resolve_plan`` resolves it
    from ``path`` through a config naming the cache."""
    mcfg, jmcfg = get_config(SMOKE_ARCHS[0]).moe, jax_config(
        SMOKE_ARCHS[0]).moe
    for key in keys:
        hw, M_, N, K, E, k, ep, etp, phase = _KEY.match(key).groups()
        M_, N, K, E, k, ep, etp = map(int, (M_, N, K, E, k, ep, etp))
        over = dict(num_experts=E, top_k=k, d_expert=K * etp,
                    plan_cache=str(path), plan_hw=hw,
                    plan_phase=phase or "train")
        got = A.resolve_plan(dataclasses.replace(mcfg, **over), N, M_, ep,
                             etp)
        want = JA.resolve_plan(dataclasses.replace(jmcfg, **over), N, M_,
                               ep, etp)
        assert got.to_json() == want.to_json(), key


TUNE_ARGV = ["--phase", "train", "prefill", "decode", "--ep", "4",
             "--M", "1024", "4096", "--decode-M", "8", "32"]


@pytest.mark.parametrize("hw_name", ["tpu_v5e", "h100_nvlink"])
def test_jax_tuner_cache_resolves_in_the_port(hw_name, tmp_path, capsys):
    path = tmp_path / "jax.json"
    assert _jax_tuner().main(["--hw", hw_name, "--out", str(path)]
                             + TUNE_ARGV) == 0
    jcache, cache = JA.PlanCache(str(path)), A.PlanCache(str(path))
    assert len(cache.plans) == 3 * (3 * 2 + 1)     # (models x M + smoke)
    assert {k: p.to_json() for k, p in cache.plans.items()} == \
        {k: p.to_json() for k, p in jcache.plans.items()}
    _resolve_every_key(path, cache.plans)


@pytest.mark.parametrize("hw_name", ["tpu_v5e", "h100_nvlink"])
def test_port_tuner_cache_resolves_in_jax(hw_name, tmp_path, capsys):
    path = tmp_path / "port.json"
    rows = tune.main(["--hw", hw_name, "--out", str(path)] + TUNE_ARGV)
    jcache, cache = JA.PlanCache(str(path)), A.PlanCache(str(path))
    assert len(rows["rows"]) == len(jcache.plans) == 21
    assert json.loads(path.read_text())["version"] == JA.PLAN_CACHE_VERSION
    assert {k: p.to_json() for k, p in jcache.plans.items()} == \
        {k: p.to_json() for k, p in cache.plans.items()}
    _resolve_every_key(path, jcache.plans)
    # the port's rows are the JAX tuner's rows for the same plans
    jt = _jax_tuner()
    capsys.readouterr()
    for tag, s, plan in rows["rows"]:
        jt._print_plan(tag, JA.MoEShape(**dataclasses.asdict(s)),
                       _jplan(plan))
        assert capsys.readouterr().out.strip() == tune.plan_row(tag, s, plan)


def test_measured_port_cache_loads_in_jax(tmp_path, capsys):
    path = tmp_path / "measured.json"
    out = tune.main(["--measured", "--device", "cpu", "--out", str(path),
                     "--iters", "1", "--phase", "prefill", "--gemm", "xla",
                     "pallas"])
    (tag, s, plan), = out["rows"]
    assert plan.source == "measured" and plan.phase == "prefill"
    assert plan.objective == "prefill_tput" and plan.measured_s > 0
    assert len(out["timed"]) == len(list(A.candidate_plans(
        s, gemm_impls=("xla", "pallas"))))
    assert all(t is not None and t > 0 for _, t, _ in out["timed"])
    jcache = JA.PlanCache(str(path))
    key = JA.PlanCache.key(JA.MoEShape(**dataclasses.asdict(s)),
                           JA.H100_NVL, "prefill")
    assert jcache.plans[key].to_json() == plan.to_json()
    _resolve_every_key(path, jcache.plans)


def test_measured_tuner_on_gloo_ranks(tmp_path, capfd):
    """``--measured --device cpu --ranks 4`` at ep 2 x etp 2: the ranks
    time every candidate alike (each takes the slowest rank's time), rank
    0 writes one measured train plan under the key of its local tokens,
    and the JAX package loads it."""
    path = tmp_path / "ranked.json"
    out = tune.main(["--measured", "--device", "cpu", "--ranks", "4",
                     "--ep", "2", "--etp", "2", "--iters", "1", "--out",
                     str(path)])
    assert out == {"rows": [], "timed": []}
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("granite-moe-3b-a800m-smoke,")]
    assert len(lines) == 1 and lines[0].endswith(",measured")
    jcache = JA.PlanCache(str(path))
    (key, plan), = jcache.plans.items()
    # 4 x 32 tokens, the sequence sharded over the 4 model ranks
    assert key == "h100_nvlink:M32:N128:K32:E8:k8:ep2:etp2"
    assert plan.source == "measured" and plan.objective == "fwd_bwd"
    _resolve_every_key(path, jcache.plans)


def test_measured_tuner_times_every_comet_hier_candidate(tmp_path, capfd):
    """``--measured --hw h100_crossnode`` on 8 gloo ranks at ep 8 (nodes
    of 4 groups; at ep 4 the node is the whole axis and the candidate
    stream holds no two-level plan): every comet_hier candidate the
    stream proposes, over the three wire formats, runs the two-level ring
    and is timed; no candidate fails."""
    path = tmp_path / "crossnode.json"
    tune.main(["--measured", "--device", "cpu", "--ranks", "8", "--ep", "8",
               "--hw", "h100_crossnode", "--iters", "1", "--out",
               str(path)])
    timed = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("# timed ")]
    s = A.MoEShape(M=16, N=128, K=64, E=8, topk=8, ep=8, etp=1)
    cands = list(A.candidate_plans(s, gemm_impls=("xla", "pallas_fused"),
                                   hw=A.H100_CROSSNODE))
    hier = [ln for ln in timed if " comet_hier " in ln]
    assert len(timed) == len(cands)
    assert len(hier) == sum(p.impl == "comet_hier" for p in cands) > 0
    assert {ln.split(":")[0].split()[-1] for ln in hier} == {
        "fp32", "bf16", "fp8_e4m3"}
    assert all(" ig4 " in ln for ln in hier)
    assert not [ln for ln in timed if "failed" in ln]
    (key, plan), = A.PlanCache(str(path)).plans.items()
    assert key.startswith("h100_crossnode:M16:N128:K64:E8:k8:ep8:etp1")


def test_v3_cache_without_phase_still_loads(tmp_path):
    """As ``test_adaptive_plan.test_v3_cache_without_phase_still_loads``:
    train lookups resolve the v3 entry, serving phases fall back to the
    model (in both packages alike)."""
    path = str(tmp_path / "v3.json")
    s = A.MoEShape(M=1024, N=2048, K=1408, E=64, topk=4, ep=8, etp=1)
    key = A.PlanCache.key(s, A.TPU_V5E)
    entry = {"impl": "comet", "ring_group": 2, "n_col_blocks": 4,
             "gemm_impl": "xla", "fused_combine": False,
             "measured_s": 2e-3, "t_bwd_s": 1e-3, "source": "measured",
             "objective": "fwd_bwd"}
    with open(path, "w") as f:
        json.dump({"version": 3, "plans": {key: entry}}, f)
    cache = A.PlanCache(path)
    hit = cache.get(s, A.TPU_V5E, "train")
    assert hit is not None and hit.ring_group == 2 and hit.phase == "train"
    assert hit.to_json() == JA.PlanCache(path).get(
        JA.MoEShape(**dataclasses.asdict(s)), JA.TPU_V5E).to_json()
    assert cache.get(s, A.TPU_V5E, "decode") is None
    m2 = dataclasses.replace(get_config(SMOKE_ARCHS[1]).moe,
                             plan_cache=path, plan_phase="decode",
                             plan_hw="tpu_v5e")
    plan = A.resolve_plan(m2, s.N, s.M, s.ep, s.etp)
    assert plan is not None and plan.source == "model"
    _resolve_every_key(path, [key, key + ":phdecode"])


def test_corrupt_cache_files_start_empty(tmp_path):
    """As ``test_adaptive_plan.test_corrupt_cache_files_start_empty``."""
    good = A.PlanCache(str(tmp_path / "good.json"))
    s = A.MoEShape(M=64, N=128, K=64, E=4, topk=2, ep=1, etp=1)
    good.put(s, A.TPU_V5E, A.Plan("comet", 1, 2), save=True)
    blob = (tmp_path / "good.json").read_text()
    trunc = tmp_path / "trunc.json"
    trunc.write_text(blob[:len(blob) // 2])
    with pytest.warns(UserWarning, match="unreadable"):
        assert A.PlanCache(str(trunc)).plans == {}
    garbage = tmp_path / "garbage.json"
    garbage.write_text("\x00\xffnot json at all{{{")
    with pytest.warns(UserWarning, match="unreadable"):
        assert A.PlanCache(str(garbage)).plans == {}
    future = tmp_path / "future.json"
    future.write_text('{"version": %d, "plans": {"k": {"impl": "comet"}}}'
                      % (A.PLAN_CACHE_VERSION + 1))
    with pytest.warns(UserWarning, match="version"):
        assert A.PlanCache(str(future)).plans == {}
    raw = json.loads(blob)
    key = next(iter(raw["plans"]))
    raw["plans"]["bad1"] = {"impl": "comet", "n_col_blocks": "not-an-int",
                            "unknown_field": 1}
    raw["plans"]["bad2"] = ["not", "a", "dict"]
    raw["plans"][A.PlanCache.key(dataclasses.replace(s, M=8), A.TPU_V5E)] \
        = {"impl": "comet", "n_col_blocks": 3}   # re-legalized to 2
    mixed = tmp_path / "mixed.json"
    mixed.write_text(json.dumps(raw))
    with pytest.warns(UserWarning, match="malformed"):
        cache = A.PlanCache(str(mixed))
    with pytest.warns(UserWarning, match="malformed"):
        jcache = JA.PlanCache(str(mixed))
    assert key in cache.plans and len(cache.plans) == 2
    assert {k: p.to_json() for k, p in cache.plans.items()} == \
        {k: p.to_json() for k, p in jcache.plans.items()}
    with pytest.warns(UserWarning, match="unreadable"):
        cache = A.PlanCache(str(trunc))
    cache.put(s, A.TPU_V5E, A.Plan("comet", 1, 2), save=True)
    assert A.PlanCache(str(trunc)).get(s, A.TPU_V5E).impl == "comet"
    with pytest.raises(ValueError, match="illegal"):
        cache.put(s, A.TPU_V5E, A.Plan("comet", 1, 3))


def test_plan_cache_is_reloaded_after_a_rewrite(tmp_path):
    """``load_plan_cache`` memoises by mtime: a rewritten file is read
    again on the next lookup."""
    import os
    path = str(tmp_path / "p.json")
    s = A.MoEShape(M=64, N=128, K=64, E=4, topk=2, ep=1, etp=1)
    A.PlanCache(path).put(s, A.H100_NVL, A.Plan("naive"))
    assert A.load_plan_cache(path).get(s, A.H100_NVL).impl == "naive"
    c = A.PlanCache(path)
    c.put(s, A.H100_NVL, A.Plan("coarse"))
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 5))
    assert A.load_plan_cache(path).get(s, A.H100_NVL).impl == "coarse"


# ---------------------------------------------------------------------------
# the layer resolves its plan
# ---------------------------------------------------------------------------


E_, D_, F_, B_, S_ = 8, 128, 64, 2, 16


def _layer(dtype="float32", seed=0):
    """The JAX test's problem (granite smoke, d 128, E 8, f 64, top-2,
    no drop) in both packages, from numpy."""
    over = dict(num_experts=E_, d_expert=F_, top_k=2,
                capacity_factor=float(E_), impl="naive", gemm_impl="xla",
                n_col_blocks=1)
    cfg = dataclasses.replace(get_config(SMOKE_ARCHS[1]), d_model=D_)
    jcfg = dataclasses.replace(jax_config(SMOKE_ARCHS[1]), d_model=D_)
    mcfg = dataclasses.replace(cfg.moe, **over)
    jmcfg = dataclasses.replace(jcfg.moe, **over)
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D_, E_)) * 0.1,
         "experts": {"w_gate": rng.standard_normal((1, E_, D_, F_)) * 0.05,
                     "w_up": rng.standard_normal((1, E_, D_, F_)) * 0.05,
                     "w_down": rng.standard_normal((1, E_, F_, D_)) * 0.05}}
    x = rng.standard_normal((B_, S_, D_))
    return cfg, jcfg, mcfg, jmcfg, p, x


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _port_run(cfg, mcfg, p, x, dtype):
    dt = getattr(torch, dtype)
    params = _tree(p, lambda a: torch.tensor(a, dtype=torch.float32).to(dt)
                   .requires_grad_(True))
    xt = torch.tensor(x, dtype=torch.float32).to(dt)
    y, aux = M.moe_ffn(cfg, mcfg, params, xt)
    leaves = [params["router"]] + [params["experts"][k]
                                   for k in sorted(params["experts"])]
    grads = torch.autograd.grad((y.float() ** 2).sum() + aux, leaves)
    return [y.detach(), aux.detach(), *grads]


def _jax_run(jcfg, jmcfg, p, x, dtype):
    dt = getattr(jnp, dtype)
    params = _tree(p, lambda a: jnp.asarray(a, jnp.float32).astype(dt))
    xj = jnp.asarray(x, jnp.float32).astype(dt)

    def loss(pp):
        y, aux = JM.moe_ffn(jcfg, jmcfg, pp, xj, JAxisCtx())
        return jnp.sum(y.astype(jnp.float32) ** 2) + aux, (y, aux)

    (_, (y, aux)), g = jax.value_and_grad(loss, has_aux=True)(params)
    return [y, aux, g["router"]] + [g["experts"][k]
                                    for k in sorted(g["experts"])]


LAYER_PLANS = {
    "naive-fused": A.Plan("naive", 1, 1, "pallas_fused"),
    "coarse-xla": A.Plan("coarse", 1, 1, "xla"),
    "comet-nc2-fc-xla": A.Plan("comet", 1, 2, "xla", True),
    "comet-nc4-fused": A.Plan("comet", 1, 4, "pallas_fused"),
    "comet-nc2-pallas": A.Plan("comet", 1, 2, "pallas"),
    "bcast-fused": A.Plan("bcast", 1, 1, "pallas_fused"),
    "hier-bf16-fc": A.Plan("comet_hier", 1, 2, "xla", True,
                           wire_dtype="bf16"),
}


def _write_cache(path, mcfg, plan, phase="train", hw=A.H100_NVL,
                 tokens=B_ * S_):
    s = A.plan_shape(mcfg, D_, tokens, 1, 1)
    cache = A.PlanCache(str(path))
    cache.put(s, hw, dataclasses.replace(plan, phase=phase), phase=phase)
    return str(path)


class _Spy:
    """Records the knobs each ``_moe_body`` call ran under."""

    def __init__(self, monkeypatch, stop=False):
        self.calls = []
        real = M._moe_body

        def spy(cfg, mcfg, n_col, gemm_impl, x, *a, **kw):
            self.calls.append(dict(impl=mcfg.impl, ring_group=mcfg.ring_group,
                                   n_col=n_col, gemm_impl=gemm_impl,
                                   fused_combine=mcfg.fused_combine,
                                   wire_dtype=mcfg.wire_dtype,
                                   tokens=x.shape[0] * x.shape[1],
                                   S=x.shape[1]))
            if stop:
                raise _Stop
            return real(cfg, mcfg, n_col, gemm_impl, x, *a, **kw)

        monkeypatch.setattr(M, "_moe_body", spy)


class _Stop(Exception):
    pass


def _knobs(plan):
    return dict(impl=plan.impl, ring_group=plan.ring_group,
                n_col=plan.n_col_blocks, gemm_impl=plan.gemm_impl,
                fused_combine=plan.fused_combine, wire_dtype=plan.wire_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYER_PLANS))
def test_moe_ffn_with_a_cache_matches_jax(name, dtype, tmp_path,
                                          monkeypatch):
    plan = LAYER_PLANS[name]
    cfg, jcfg, mcfg, jmcfg, p, x = _layer()
    path = _write_cache(tmp_path / "plans.json", mcfg, plan)
    over = dict(plan_cache=path, plan_hw="h100_nvlink")
    spy = _Spy(monkeypatch)
    got = _port_run(cfg, dataclasses.replace(mcfg, **over), p, x, dtype)
    ran = {k: v for k, v in spy.calls[0].items() if k not in ("tokens", "S")}
    assert ran == _knobs(plan)
    want = _jax_run(jcfg, dataclasses.replace(jmcfg, **over), p, x, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    # the bits of the port under plan.apply
    explicit = _port_run(cfg, plan.apply(mcfg), p, x, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, explicit))


def test_plan_override_pins_the_explicit_knobs(tmp_path, monkeypatch):
    cfg, _, mcfg, _, p, x = _layer()
    path = _write_cache(tmp_path / "plans.json", mcfg,
                        LAYER_PLANS["comet-nc4-fused"])
    m_over = dataclasses.replace(mcfg, plan_cache=path, plan_override=True,
                                 impl="coarse", gemm_impl="xla")
    assert not A.plan_lookup_enabled(m_over)
    assert A.resolve_plan(m_over, D_, B_ * S_, 1, 1) is None
    spy = _Spy(monkeypatch)
    got = _port_run(cfg, m_over, p, x, "float32")
    assert spy.calls[0]["impl"] == "coarse"
    assert spy.calls[0]["gemm_impl"] == "xla"
    plain = _port_run(cfg, dataclasses.replace(m_over, plan_cache=""), p, x,
                      "float32")
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_moe_ffn_resolves_the_config_cache(tmp_path, monkeypatch):
    """The parent ignored ``mcfg.plan_cache``: the cached plan now runs,
    under the phase and hardware key the config names."""
    cfg, _, mcfg, _, p, x = _layer()
    plan = A.Plan("comet", 1, 2, "pallas", True)
    path = _write_cache(tmp_path / "plans.json", mcfg, plan, phase="decode",
                        hw=A.TPU_V5E)
    spy = _Spy(monkeypatch, stop=True)
    m2 = dataclasses.replace(mcfg, plan_cache=path, plan_hw="tpu_v5e",
                             plan_phase="decode")
    with pytest.raises(_Stop):
        M.moe_ffn(cfg, m2, _tree(p, torch.tensor), torch.tensor(x))
    assert {k: v for k, v in spy.calls[0].items()
            if k not in ("tokens", "S")} == _knobs(plan)


def test_moe_ffn_resolves_the_env_cache(tmp_path, monkeypatch):
    """The parent ignored ``$REPRO_PLAN_CACHE``/``$REPRO_PLAN_HW``."""
    cfg, _, mcfg, _, p, x = _layer()
    plan = A.Plan("coarse", 1, 1, "pallas_fused")
    path = _write_cache(tmp_path / "plans.json", mcfg, plan,
                        hw=A.L20_PCIE)
    monkeypatch.setenv("REPRO_PLAN_CACHE", path)
    monkeypatch.setenv("REPRO_PLAN_HW", "l20_pcie")
    spy = _Spy(monkeypatch, stop=True)
    with pytest.raises(_Stop):
        M.moe_ffn(cfg, mcfg, _tree(p, torch.tensor), torch.tensor(x))
    assert spy.calls[0]["impl"] == "coarse"
    assert spy.calls[0]["gemm_impl"] == "pallas_fused"


def test_missing_cache_entry_takes_the_model_plan(tmp_path, monkeypatch):
    cfg, _, mcfg, _, p, x = _layer()
    m2 = dataclasses.replace(mcfg, plan_cache=str(tmp_path / "never.json"))
    want = A.analytic_plan(A.plan_shape(mcfg, D_, B_ * S_, 1, 1),
                           A.H100_NVL, "train")
    spy = _Spy(monkeypatch)
    y = _port_run(cfg, m2, p, x, "float32")[0]
    assert np.isfinite(y.numpy()).all()
    assert {k: v for k, v in spy.calls[0].items()
            if k not in ("tokens", "S")} == _knobs(want)


def test_zero_n_col_takes_the_cost_models_split(monkeypatch):
    """``n_col_blocks == 0`` with no cache: the cost model's column split
    on h100_nvlink (the parent took 1). A shape where that split is 2: d
    256, a wide expert (f 8192), 1024 tokens, top-4."""
    cfg = dataclasses.replace(get_config(SMOKE_ARCHS[0]), d_model=256)
    mcfg = dataclasses.replace(cfg.moe, d_expert=8192, n_col_blocks=0,
                               impl="comet")
    s = A.plan_shape(mcfg, 256, 1024, 1, 1)
    want = A.choose_n_col(A.H100_NVL, s)
    assert want == JA.choose_n_col(JA.H100_NVL,
                                   JA.MoEShape(**dataclasses.asdict(s))) == 2
    p = {"router": torch.zeros(256, mcfg.num_experts),
         "experts": {"w_up": torch.zeros(1, 1, 1, 1)}}
    spy = _Spy(monkeypatch, stop=True)
    with pytest.raises(_Stop):
        M.moe_ffn(cfg, mcfg, p, torch.zeros(2, 512, 256))
    assert spy.calls[0]["n_col"] == 2 and spy.calls[0]["tokens"] == 1024
    with pytest.raises(_Stop):
        M.moe_ffn(cfg, dataclasses.replace(mcfg, n_col_blocks=4), p,
                  torch.zeros(2, 512, 256))
    assert spy.calls[1]["n_col"] == 4


def test_cached_overlap_plan_resolves_and_apply_ignores_the_schedule(
        tmp_path):
    """As in the JAX package: a cached whole-graph plan resolves, and
    ``Plan.apply`` carries no schedule."""
    _, _, mcfg, jmcfg, _, _ = _layer()
    plan = A.Plan("comet", 1, 1, "xla", schedule="overlap", n_slices=2)
    path = _write_cache(tmp_path / "plans.json", mcfg, plan)
    over = dict(plan_cache=path, plan_hw="h100_nvlink")
    got = A.resolve_plan(dataclasses.replace(mcfg, **over), D_, B_ * S_, 1, 1)
    want = JA.resolve_plan(dataclasses.replace(jmcfg, **over), D_, B_ * S_,
                           1, 1)
    assert got.to_json() == want.to_json() and got.schedule == "overlap"
    applied = got.apply(mcfg)
    assert applied.impl == "comet" and applied.plan_override
    assert dataclasses.asdict(applied) == dataclasses.asdict(
        want.apply(jmcfg))


# ---------------------------------------------------------------------------
# train, serve and the measured objective
# ---------------------------------------------------------------------------


def test_train_step_and_trainer_thread_the_cache(tmp_path):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.train_step import _with_plan_cache, \
        build_train_step
    from repro_torch.training.trainer import Trainer, TrainerConfig
    from repro.launch.train_step import _with_plan_cache as j_with
    cfg, jcfg = get_config(SMOKE_ARCHS[0]), jax_config(SMOKE_ARCHS[0])
    path = str(tmp_path / "plans.json")
    for phase in PHASES:
        got = _with_plan_cache(cfg, path, "tpu_v5e", phase).moe
        want = j_with(jcfg, path, "tpu_v5e", phase).moe
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _with_plan_cache(cfg, "", "x") is cfg
    shape = ShapeConfig("t", 16, 2, "train")
    built = build_train_step(cfg, shape, plan_cache=path)
    assert built["fn"] is not None
    tr = Trainer(cfg, shape, tcfg=TrainerConfig(
        ckpt_dir=str(tmp_path / "ck"), plan_cache=path, plan_hw="l20_pcie"),
        device="cpu")
    out = tr.run(1)
    assert out["final_step"] == 1 and np.isfinite(out["metrics"][0]["loss"])


def test_serve_engine_threads_prefill_and_decode_phases(tmp_path,
                                                        monkeypatch):
    """As ``test_serve_engine_threads_decode_phase``, and through the
    engine's own calls: prefill chunks resolve the ``prefill`` entry of
    their token count, decode steps the ``decode`` entry."""
    from repro_torch.serving import ServeEngine
    cfg = get_config(SMOKE_ARCHS[1])
    mcfg = cfg.moe
    chunk, slots = 8, 2
    path = str(tmp_path / "plans.json")
    cache = A.PlanCache(path)
    pre = A.Plan("naive", 1, 1, "pallas_fused", phase="prefill")
    dec = A.Plan("coarse", 1, 1, "pallas", phase="decode")
    cache.put(A.plan_shape(mcfg, cfg.d_model, slots * chunk, 1, 1),
              A.H100_NVL, pre, phase="prefill")
    cache.put(A.plan_shape(mcfg, cfg.d_model, slots, 1, 1), A.H100_NVL,
              dec, phase="decode")
    eng = ServeEngine(cfg, max_seq=32, batch_size=slots, chunk=chunk,
                      device="cpu", plan_cache=path)
    assert eng.prefill_cfg.moe.plan_phase == "prefill"
    assert eng.decode_cfg.moe.plan_phase == "decode"
    assert eng.cfg.moe.plan_cache == ""
    spy = _Spy(monkeypatch)
    res = eng.generate([[5, 7, 11, 13, 17], [2, 3]], max_new=3)
    assert res.statuses == ["ok", "ok"] and res.tokens.shape == (2, 3)
    pre_calls = [c for c in spy.calls if c["S"] > 1]
    dec_calls = [c for c in spy.calls if c["S"] == 1]
    assert pre_calls and dec_calls
    assert all(c["impl"] == "naive" and c["gemm_impl"] == "pallas_fused"
               for c in pre_calls)
    assert all(c["impl"] == "coarse" and c["gemm_impl"] == "pallas"
               for c in dec_calls)


def test_measured_tuning_roundtrip(tmp_path):
    """As ``test_adaptive_plan.test_measured_tuning_roundtrip``, timed by
    ``perf_counter`` on the CPU; the train objective (``grad=True``) skips
    the forward-only ``pallas`` backend outside the comet arms by name."""
    cfg, _, mcfg, _, p, x = _layer()
    params = _tree(p, lambda a: torch.tensor(a, dtype=torch.float32))
    xt = torch.tensor(x, dtype=torch.float32)
    calls = []
    inner = A.make_timing_measure(cfg, mcfg, params, xt, iters=1, warmup=1)

    def measure(plan):
        calls.append(plan)
        return inner(plan)

    s = A.plan_shape(mcfg, D_, B_ * S_, 1, 1)
    cache = A.PlanCache(str(tmp_path / "m.json"))
    plan = A.tune_plan(s, A.H100_NVL, cache, measure=measure,
                       phase="prefill")
    assert plan.source == "measured" and plan.measured_s > 0
    assert plan.objective == "prefill_tput" and len(calls) >= 3
    n = len(calls)
    assert A.tune_plan(s, A.H100_NVL, cache, measure=measure,
                       phase="prefill") == plan and len(calls) == n
    grad = A.make_timing_measure(cfg, mcfg, params, xt, iters=1, grad=True)
    cands = [A.Plan("naive", 1, 1, "pallas"), A.Plan("naive", 1, 1, "xla"),
             A.Plan("comet", 1, 1, "pallas")]
    with pytest.warns(UserWarning, match="1/3 candidates failed.*no "
                                         "backward"):
        won = A.tune_plan(s, A.H100_NVL, measure=grad, candidates=cands)
    assert (won.impl, won.gemm_impl) in {("naive", "xla"),
                                          ("comet", "pallas")}


def test_measure_on_a_missing_gpu_raises_by_name(tmp_path):
    """``--measured`` runs on the card unless asked for the CPU; with no
    card it raises rather than timing the CPU."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        tune.main(["--measured", "--out", str(tmp_path / "x.json")])
    with pytest.raises(SystemExit, match="world 1"):
        tune.main(["--measured", "--ep", "2", "--out",
                   str(tmp_path / "x.json")])


# ---------------------------------------------------------------------------
# raises by name; the Hopper gate
# ---------------------------------------------------------------------------


def test_unported_whole_graph_terms_raise_by_name(tmp_path):
    """The whole-graph terms once raised by name here; now ported, the
    same calls return the JAX package's values: the three graph terms,
    the graph candidates' phase measure and ranking, ``include_graph``'s
    candidate stream, ``sim_e2e_graph`` and ``tune --graph``'s cache. So
    does the mesh monolithic prefill: it builds on a mesh with that
    cache."""
    s = A.MoEShape(M=4096, N=2048, K=1408, E=64, topk=4, ep=4, etp=1)
    js = JA.MoEShape(**dataclasses.asdict(s))
    p = A.Plan("comet", 1, 1, schedule="overlap", n_slices=2)
    jp = _jplan(p)
    for hw in ("tpu_v5e", "h100_nvlink"):
        h, jh = A.HW[hw], JA.HW[hw]
        for training in (False, True):
            pairs = [
                (A.modeled_graph_step_time(h, s, p, training=training),
                 JA.modeled_graph_step_time(jh, js, jp, training=training)),
                (A.ring_bubble_time(h, s, p, training),
                 JA.ring_bubble_time(jh, js, jp, training)),
                (A.cross_layer_fill_time(h, s, p, training=training),
                 JA.cross_layer_fill_time(jh, js, jp, training=training)),
                (SIM.sim_e2e_graph(h, s, p, 2048, 4, training=training),
                 JSIM.sim_e2e_graph(jh, js, jp, 2048, 4,
                                    training=training))]
            for got, want in pairs:
                assert got == pytest.approx(want, rel=REL) and got > 0
        for phase in ("train", "prefill", "decode"):
            assert A.phase_measure(h, s, phase)(p) == pytest.approx(
                JA.phase_measure(jh, js, phase)(jp), rel=REL)
        _same_plan(A.tune_plan(s, h, candidates=[A.Plan(), p]),
                   JA.tune_plan(js, jh, candidates=[JA.Plan(), jp]))
    got = list(A.candidate_plans(s, include_graph=True, hw=A.TPU_V5E))
    want = list(JA.candidate_plans(js, include_graph=True, hw=JA.TPU_V5E))
    assert [q.to_json() for q in got] == [q.to_json() for q in want]
    assert any(q.schedule == "overlap" for q in got)
    path, jpath = tmp_path / "g.json", tmp_path / "jg.json"
    rows = tune.main(["--graph", "--hw", "tpu_v5e", "--out", str(path)]
                     + TUNE_ARGV)
    assert _jax_tuner().main(["--graph", "--hw", "tpu_v5e", "--out",
                              str(jpath)] + TUNE_ARGV) == 0
    jcache, cache = JA.PlanCache(str(jpath)), A.PlanCache(str(path))
    assert len(rows["rows"]) == len(cache.plans) == 21
    assert {k: q.to_json() for k, q in cache.plans.items()} == \
        {k: q.to_json() for k, q in jcache.plans.items()}
    assert any(q.schedule == "overlap" for q in cache.plans.values())
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import train_step as TS

    class Mesh:                 # the axis sizes: enough to build the step
        shape = {"data": 1, "model": 4}

        def model_subgroups(self, model_axis, etp):
            return None, None

    # the mesh monolithic prefill, refused by name until it was ported,
    # builds on a mesh and resolves the prefill phase's plans from the
    # graph tuner's cache
    built = TS.build_prefill_step(get_config("qwen2-moe-2.7b-smoke"),
                                  ShapeConfig("p", 32, 4, "prefill"),
                                  mesh=Mesh(), plan_cache=str(path),
                                  plan_hw="tpu_v5e")
    assert built["ctx"].seq_shard and built["ctx"].model_size == 4
    assert (built["cfg"].moe.plan_cache, built["cfg"].moe.plan_hw,
            built["cfg"].moe.plan_phase) == (str(path), "tpu_v5e",
                                             "prefill")


def _cu_consts(*sources):
    """``constexpr int NAME = EXPR;`` of CUDA sources, each EXPR an
    arithmetic of numbers and the names before it."""
    out = {}
    for src in sources:
        for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                     src):
            try:
                out[name] = int(eval(expr, {"__builtins__": {}}, dict(out)))
            except (NameError, SyntaxError):
                continue
    return out


def test_hopper_gate_mirrors_the_fused_kernel():
    """The gate's shared-memory arithmetic is csrc/fused_mlp_hopper.cu's
    (constants read from the sources): 5 ring stages at F_s 128, 4 up to
    512, 3 at 640 and 768, each within a block's shared memory."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    c = _cu_consts((csrc / "hopper.cuh").read_text(),
                   (csrc / "fused_mlp_hopper.cu").read_text())
    assert (c["SMEM_MAX"], c["PANEL"], c["SLOT"], c["FS_MAX"],
            c["kMaxStages"], c["kBarBytes"]) == (
        FM.HOPPER_SMEM_MAX, FM.HOPPER_PANEL, FM.HOPPER_SLOT,
        FM.HOPPER_FS_MAX, FM.HOPPER_MAX_STAGES, FM.HOPPER_BAR_BYTES)
    from repro_torch.kernels import grouped_gemm
    assert FM.HOPPER_SMEM_MAX == grouped_gemm.HOPPER_SMEM_MAX
    assert [FM.hopper_stages(fs) for fs in range(128, 769, 128)] == \
        [5, 4, 4, 4, 3, 3]
    assert all(FM.hopper_fits(fs) for fs in range(128, 769, 128))
    assert not FM.hopper_fits(896)


@pytest.mark.parametrize("hw_name", ["h100_nvlink", "h100_crossnode",
                                     "l20_pcie"])
def test_gpu_gate_agrees_with_fused_mlp_plan(hw_name):
    """For a GPU preset a fused candidate passes exactly when the split
    ``fused_mlp_plan`` picks for its column slice fits one block; at the
    paper's widest shape the TPU rule rejects what the port's kernel
    runs."""
    hw = A.HW[hw_name]
    seen = 0
    for kw in _grid():
        s = A.MoEShape(**kw)
        for n_col in range(1, 9):
            for impl in ("naive", "comet"):
                p = A.Plan(impl, 1, n_col, "pallas_fused")
                nc = n_col if impl == "comet" else 1
                fp = FM.fused_mlp_plan(max(1, s.E // s.ep),
                                       max(1, -(-s.M * s.topk // s.E)),
                                       s.N, s.K, max(1, s.N // nc))
                assert KC.plan_vmem_ok(s, p, hw) == FM.hopper_fits(fp["fs"])
                seen += 1
        assert all(KC.plan_vmem_ok(s, p, hw)
                   for p in A.candidate_plans(s, hw=hw))
    assert seen == 160 * 16
    wide = A.MoEShape(M=4096, N=16384, K=4096, E=16, topk=2, ep=8, etp=1)
    fused = [p for p in A.candidate_plans(wide, hw=hw)
             if p.gemm_impl == "pallas_fused"]
    tpu = [p for p in A.candidate_plans(wide, hw=A.TPU_V5E)
           if p.gemm_impl == "pallas_fused"]
    assert len(fused) > len(tpu)
    assert any(p.impl == "naive" for p in fused)
    assert not any(p.impl == "naive" for p in tpu)
    assert KC.check_candidate_plans(hw=hw) == []
    assert KC.check_candidate_plans(hw=A.TPU_V5E) == []


def test_tpu_gate_is_the_jax_rule():
    from repro.analysis.verify.kernel_check import plan_vmem_ok
    for kw in _grid():
        s, js = A.MoEShape(**kw), JA.MoEShape(**kw)
        for n_col in (1, 2, 4, 8):
            p = A.Plan("comet", 1, n_col, "pallas_fused")
            assert KC.plan_vmem_ok(s, p, A.TPU_V5E) == plan_vmem_ok(
                js, _jplan(p), JA.TPU_V5E)
            assert KC.fused_mlp_vmem_bytes(s.N, s.K, n_col) > 0
