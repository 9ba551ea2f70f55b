"""The ranked MoE layer on 4 gloo CPU ranks against the JAX package's
local ``moe_ffn`` (``AxisCtx()``), fp32, at the JAX self-test's bounds
(forward and decode broadcast rel 2e-5, aux 1e-4 absolute, gradients rel
5e-5).

Layouts (data, model): (1, 4) at ep 4 / etp 1 and at ep 2 / etp 2, and
(2, 2) at ep 2 / etp 1. Problems: the self-test's (granite-moe-3b-a800m-
smoke cut to E 8, f 64, top-2), mixtral-8x7b-smoke and qwen2-moe-2.7b-smoke,
all at no-drop capacity. Impls: naive, coarse (two token slices), comet at
ring_group 1 and 2, and comet with two column blocks and the fused
combine, each with and without sequence sharding, and the decode
broadcast. Each layout is one spawn of 4 ranks (``selftest.spawn``, with
its own time limit) that writes every cell's gathered output, aux and
reduced gradients to a temporary directory; the gradients are of the
global loss sum(y**2) + aux, shared out by ``selftest.rank_loss``.
"""
import dataclasses
import json
import operator
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import moe_layer as JM
from repro.core import transport as JT
from repro.core.adaptive import legalize_ring_group as j_legalize_ring_group
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro_torch import bridge
from repro_torch.core import moe_layer as M
from repro_torch.core import transport as T
from repro_torch.launch import selftest as ST
from repro_torch.parallel import collectives as CL

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 150.0          # seconds for one layout's 4 ranks

LAYOUTS = {"dp1mp4-ep4": ((1, 4), 4, 1),
           "dp1mp4-ep2etp2": ((1, 4), 2, 2),
           "dp2mp2-ep2": ((2, 2), 2, 1)}
PROBLEMS = {"selftest": {},
            "mixtral": dict(arch="mixtral-8x7b-smoke", E=0, f=0, top_k=0),
            "qwen2": dict(arch="qwen2-moe-2.7b-smoke", E=0, f=0, top_k=0)}
IMPLS = {"naive": dict(impl="naive"),
         "coarse": dict(impl="coarse"),
         "comet-rg1": dict(impl="comet", ring_group=1),
         "comet-rg2": dict(impl="comet", ring_group=2),
         "comet-ncol2-fused": dict(impl="comet", n_col=2,
                                   fused_combine=True)}
CELLS = [(lay, prob, impl, seq) for lay in LAYOUTS for prob in PROBLEMS
         for impl in IMPLS for seq in (False, True)]


def _jobs(layout):
    _, ep, etp = LAYOUTS[layout]
    jobs = []
    for pname, pkw in PROBLEMS.items():
        for iname, ikw in IMPLS.items():
            for seq in (False, True):
                jobs.append(dict(name=f"{pname}-{iname}-sp{int(seq)}",
                                 problem=pkw, ep=ep, etp=etp, seq_shard=seq,
                                 grads=True, **ikw))
        jobs.append(dict(name=f"{pname}-bcast", problem=pkw, ep=ep, etp=etp,
                         impl="comet", decode=True, grads=True))
    if layout == "dp1mp4-ep4":
        jobs.append(dict(name="census", kind="census", ep=ep, etp=etp,
                         n_col=2))
        jobs.append(dict(name="hier", kind="hier", ep=ep, etp=etp))
    return jobs


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """layout -> the directory its spawn wrote; each layout spawned once,
    on first use."""
    done = {}

    def get(layout):
        if layout not in done:
            out = tmp_path_factory.mktemp(layout)
            ST.spawn(4, ST.dump_cells,
                     (LAYOUTS[layout][0], _jobs(layout), str(out)),
                     device="cpu", timeout=SPAWN_TIMEOUT)
            done[layout] = out
        return done[layout]
    return get


@pytest.fixture(scope="module")
def jax_ref():
    """problem -> the JAX package's local moe_ffn (naive) on the whole
    batch and on its first token: y, aux and the gradients of
    sum(y**2) + aux."""
    done = {}

    def get(pname):
        if pname not in done:
            prob = ST.problem(**PROBLEMS[pname])
            pm = prob["mcfg"]
            jcfg = jax_config(PROBLEMS[pname].get("arch", ST.SELFTEST_ARCH))
            m = dataclasses.replace(
                jcfg.moe, num_experts=pm.num_experts, d_expert=pm.d_expert,
                top_k=pm.top_k, capacity_factor=pm.capacity_factor,
                n_col_blocks=0, impl="naive")
            params = {"router": jnp.asarray(prob["router"]),
                      "experts": {k: jnp.asarray(v)[None]
                                  for k, v in prob["full"].items()}}

            def run(x):
                def loss(p):
                    y, aux = JM.moe_ffn(jcfg, m, p, x, JAxisCtx())
                    return jnp.sum(y ** 2) + aux, (y, aux)
                (_, (y, aux)), g = jax.value_and_grad(loss, has_aux=True)(
                    params)
                return {"y": np.asarray(y), "aux": float(aux),
                        "router": np.asarray(g["router"]),
                        "experts": {k: np.asarray(v[0])
                                    for k, v in g["experts"].items()}}
            x = jnp.asarray(prob["x"])
            done[pname] = {"full": run(x), "decode": run(x[:, :1])}
        return done[pname]
    return get


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _check(res, ref, ep, etp):
    """Forward, aux and gradients of one ranked cell against JAX."""
    assert _rel(res["y"], ref["y"]) < ST.FWD_REL
    assert abs(float(res["aux"]) - ref["aux"]) < ST.AUX_ABS
    assert _rel(res["router"], ref["router"]) < ST.GRAD_REL
    want = JM.pack_expert_weights(
        {k: jnp.asarray(v) for k, v in ref["experts"].items()}, ep, etp)
    for k, v in want.items():
        got = res[f"experts/{k}"]
        assert got.shape == v.shape
        assert _rel(got, np.asarray(v)) < ST.GRAD_REL, k


@pytest.mark.parametrize("layout,pname,impl,seq", CELLS,
                         ids=[f"{a}-{b}-{c}-sp{int(d)}"
                              for a, b, c, d in CELLS])
def test_ranked_moe_matches_jax(ranked, jax_ref, layout, pname, impl, seq):
    _, ep, etp = LAYOUTS[layout]
    res = np.load(ranked(layout) / f"{pname}-{impl}-sp{int(seq)}.npz")
    _check(res, jax_ref(pname)["full"], ep, etp)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("pname", list(PROBLEMS))
def test_ranked_decode_bcast_matches_jax(ranked, jax_ref, layout, pname):
    _, ep, etp = LAYOUTS[layout]
    res = np.load(ranked(layout) / f"{pname}-bcast.npz")
    assert res["y"].shape[1] == 1
    _check(res, jax_ref(pname)["decode"], ep, etp)


def test_ring_census_counts_hops_and_chunk_bytes(ranked):
    """One ep-4 comet forward (two column blocks) permutes as
    ``comet_ring_segments`` counts: ep - 1 dispatches of a whole chunk and
    n_col (ep - 1) returns of a column block, each a full permutation."""
    rec = json.loads((ranked("dp1mp4-ep4") / "census.json").read_text())
    seg, census = rec["segments"], rec["census"]
    disp = [c for c in census if c["op"] == "disp"]
    comb = [c for c in census if c["op"] == "comb"]
    assert seg == JT.comet_ring_segments(4, 1, 2)
    assert len(disp) == seg["dispatch_hops"] == 3
    assert len(comb) == seg["combine_hops"] == 6
    assert {c["bytes"] for c in disp} == {rec["chunk_bytes"]}
    assert {c["bytes"] for c in comb} == {rec["block_bytes"]}
    for c in census:
        assert sorted(s for s, _ in c["pairs"]) == [0, 1, 2, 3]
        assert sorted(d for _, d in c["pairs"]) == [0, 1, 2, 3]


def test_comet_hier_raises_at_world_4(ranked):
    rec = json.loads((ranked("dp1mp4-ep4") / "hier.json").read_text())
    assert "transport_comet_hier" in rec["raised"]
    assert "not ported" in rec["raised"]


def test_spawn_kills_ranks_that_outlive_their_time():
    with pytest.raises(TimeoutError, match="killed"):
        ST.spawn(2, time.sleep, (120,), device="cpu", timeout=8.0)


def test_spawn_fails_as_soon_as_a_rank_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with code 1"):
        ST.spawn(2, operator.truediv, (1, 0), device="cpu", timeout=120.0)
    assert time.monotonic() - t0 < 60


def test_selftest_cli_passes_on_4_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.selftest", "--device",
         "cpu", "--ranks", "4", "--case", "moe", "--timeout", "120"],
        capture_output=True, text=True, env=env, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    assert len(lines) == 57 and all(ln.startswith("[PASS]") for ln in lines)
    assert "OK: 0 failed" in proc.stdout


@pytest.mark.parametrize("ep,etp", [(4, 1), (2, 2), (1, 4), (8, 1), (4, 2)])
@pytest.mark.parametrize("gs,ts", [(1, 0), (-1, 0), (-3, 1), (2, -1),
                                   (0, 1)])
def test_perm_matches_jax(ep, etp, gs, ts):
    port = T._perm(ST.AxisCtx(ep=ep, etp=etp), gs, ts)
    assert port == JT._perm(JAxisCtx(ep=ep, etp=etp), gs, ts)
    if (gs % ep, ts % etp) != (0, 0):
        CL.check_permutation(port, ep * etp)


def test_ppermute_refuses_a_partial_or_self_permutation():
    with pytest.raises(ValueError, match="permutation"):
        CL.check_permutation([(0, 1), (1, 1)], 2)
    with pytest.raises(ValueError, match="permutation"):
        CL.check_permutation([(0, 0), (1, 1)], 2)


@pytest.mark.parametrize("ep", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("rg", [0, 1, 2, 3, 4, 9])
def test_ring_segments_and_ring_group_match_jax(ep, rg):
    assert T.legalize_ring_group(ep, rg) == j_legalize_ring_group(ep, rg)
    for n_col in (1, 2, 4):
        assert T.comet_ring_segments(ep, rg, n_col) == \
            JT.comet_ring_segments(ep, rg, n_col)


@pytest.mark.parametrize("pname", list(PROBLEMS))
def test_problem_weights_cross_by_from_jax(pname):
    """The workers build the problem's weights from its seed; the same
    numpy tree crossed from the JAX side by ``bridge.from_jax`` gives the
    same tensors."""
    prob = ST.problem(**PROBLEMS[pname])
    cfg, mcfg = prob["cfg"], prob["mcfg"]
    tree = {"router": prob["router"],
            "experts": {k: v[None] for k, v in prob["full"].items()}}
    got = bridge.from_jax(tree, cfg, device="cpu",
                          schema=M.moe_schema(cfg, mcfg))
    router, packed = ST._params(prob, 1, 1, "cpu")
    assert torch.equal(got["router"], router)
    for k, v in packed.items():
        assert torch.equal(got["experts"][k], v)


@pytest.mark.parametrize("argv,what", [
    (["--plan-cache", "plans.json"], "plan-cache"),
    (["--sp-residual"], "sequence-parallel residual")])
def test_train_flags_name_what_is_not_ported(argv, what, tmp_path):
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match=what):
        train.main(["--arch", "qwen2-moe-2.7b-smoke", "--ckpt-dir",
                    str(tmp_path)] + argv, device="cpu")


class _StubMesh:
    """Just the shape of a mesh: enough for the token-sharding decisions
    and ``make_ctx``, in both packages."""

    def __init__(self, shape):
        self.shape = shape

    def model_subgroups(self, model_axis, etp):
        return None, None


MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
          {"data": 2, "model": 4}, {"data": 4, "model": 1}]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    map(str, s.values())))
@pytest.mark.parametrize("B,S", [(4, 32), (1, 32), (3, 6), (4, 1)])
@pytest.mark.parametrize("seq_shard", [False, True])
def test_token_sharding_matches_jax(shape, B, S, seq_shard):
    from repro_torch.parallel.mesh import AxisCtx
    mesh = _StubMesh(shape)
    kw = dict(mesh=mesh, dp_axes=("data",), model_axis="model",
              ep=shape["model"], etp=1, seq_shard=seq_shard)
    port, ref = AxisCtx(**kw), JAxisCtx(**kw)
    assert M.resolve_token_sharding(port, B, S) == \
        JM.resolve_token_sharding(ref, B, S)
    assert M.local_token_count(port, B, S) == JM.local_token_count(ref, B, S)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    map(str, s.values())))
@pytest.mark.parametrize("arch", ["qwen2-moe-2.7b-smoke", "mixtral-8x7b-smoke",
                                  "qwen2-0.5b-smoke"])
def test_make_ctx_matches_jax(shape, arch):
    from repro.configs import get_config as jget
    from repro.parallel.sharding import make_ctx as jmake_ctx
    from repro_torch.configs import get_config
    from repro_torch.parallel.sharding import make_ctx
    mesh = _StubMesh(shape)
    port = make_ctx(get_config(arch), mesh)
    ref = jmake_ctx(jget(arch), mesh)
    assert (port.dp_axes, port.model_axis, port.ep, port.etp,
            port.seq_shard) == (ref.dp_axes, ref.model_axis, ref.ep,
                                ref.etp, ref.seq_shard)
