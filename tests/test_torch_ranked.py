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
broadcast. The two-level ring (``comet_hier``) on the self-test's problem
at one, two and four groups a node (ep 4) and one and two (ep 2 / etp 2),
on the fp32, bf16 and fp8_e4m3 wires at JAX's bounds for each
(``WIRE_REL``), beside the flat ring at the same knobs, with its census
of hops, link classes and wire bytes. Each layout is one spawn of 4 ranks
(``selftest.spawn``, with its own time limit) that writes every cell's
gathered output, aux and reduced gradients to a temporary directory; the
spawns run on a thread while the test process computes the JAX
references. The gradients are of the global loss sum(y**2) + aux, shared
out by ``selftest.rank_loss``.
"""
import dataclasses
import json
import operator
import os
import subprocess
import sys
import threading
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

# the two-level ring on the self-test's problem: node sizes per layout, and
# per node size every (ring_group, fused_combine, backend) at the fp32 wire
# with gradients, beside the flat ring at the same knobs; the bf16 and fp8
# wires at two of them; the forward-only "pallas" backend at one
HIER_IGS = {"dp1mp4-ep4": (1, 2, 4), "dp1mp4-ep2etp2": (1, 2)}
WIRE_REL = {"fp32": 2e-5, "bf16": 2e-2, "fp8_e4m3": 2e-1}   # JAX's bounds
AUX_REL = 1e-6
FLAT_REL = 1e-6
WIRES = ("fp32", "bf16", "fp8_e4m3")


def _hier_knobs():
    """(name, run_cell keywords) of one node size's cells."""
    out = []
    for rg in (1, 2):
        for fc in (False, True):
            for gi in ("xla", "pallas_fused"):
                out.append((f"rg{rg}-fc{int(fc)}-{gi}-fp32",
                            dict(ring_group=rg, fused_combine=fc,
                                 gemm_impl=gi, wire_dtype="fp32",
                                 grads=True)))
    for wire in WIRES[1:]:
        out.append((f"rg2-fc1-xla-{wire}", dict(
            ring_group=2, fused_combine=True, gemm_impl="xla",
            wire_dtype=wire)))
        out.append((f"rg1-fc0-pallas_fused-{wire}", dict(
            ring_group=1, fused_combine=False, gemm_impl="pallas_fused",
            wire_dtype=wire)))
    out.append(("rg1-fc1-pallas-fp32", dict(
        ring_group=1, fused_combine=True, gemm_impl="pallas",
        wire_dtype="fp32")))
    return out


HIER_CELLS = [(lay, ig, name) for lay, igs in HIER_IGS.items()
              for ig in igs for name, _ in _hier_knobs()]
FLAT_TWINS = [(lay, ig, name) for lay, ig, name in HIER_CELLS
              if name.endswith("-fp32") and "pallas-" not in name]


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
    for ig in HIER_IGS.get(layout, ()):
        for name, kw in _hier_knobs():
            jobs.append(dict(name=f"hier-ig{ig}-{name}", ep=ep, etp=etp,
                             impl="comet_hier", intra_group=ig, n_col=2,
                             seq_shard=True, **kw))
    if layout in HIER_IGS:
        for name, kw in _hier_knobs():
            if kw["wire_dtype"] == "fp32" and kw["gemm_impl"] != "pallas":
                jobs.append(dict(name=f"flat-{name}", ep=ep, etp=etp,
                                 impl="comet", n_col=2, seq_shard=True,
                                 **{k: v for k, v in kw.items()
                                    if k != "wire_dtype"}))
    if layout == "dp1mp4-ep4":
        jobs.append(dict(name="census", kind="census", ep=ep, etp=etp,
                         n_col=2))
        jobs.append(dict(name="hier", kind="hier", ep=ep, etp=etp, n_col=2,
                         intra_groups=HIER_IGS[layout], wires=WIRES))
    return jobs


@pytest.fixture(scope="module")
def ranked(tmp_path_factory, jax_ref):
    """layout -> the directory its spawn wrote. The layouts are spawned one
    after the other on a thread while this process computes the JAX
    references."""
    outs = {lay: tmp_path_factory.mktemp(lay) for lay in LAYOUTS}
    done = {lay: threading.Event() for lay in LAYOUTS}
    errors = []

    def spawn_all():
        try:
            for lay in LAYOUTS:
                ST.spawn(4, ST.dump_cells,
                         (LAYOUTS[lay][0], _jobs(lay), str(outs[lay])),
                         device="cpu", timeout=SPAWN_TIMEOUT)
                done[lay].set()
        except BaseException as e:        # re-raised in the test process
            errors.append(e)
        finally:
            for ev in done.values():
                ev.set()

    th = threading.Thread(target=spawn_all)
    th.start()
    for pname in PROBLEMS:
        jax_ref(pname)

    def get(layout):
        done[layout].wait()
        if errors:
            raise errors[0]
        return outs[layout]
    yield get
    th.join()


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


@pytest.mark.parametrize("layout,ig,name", HIER_CELLS,
                         ids=[f"{a}-ig{b}-{c}" for a, b, c in HIER_CELLS])
def test_ranked_comet_hier_matches_jax(ranked, jax_ref, layout, ig, name):
    """The two-level ring on 4 gloo ranks against the JAX package's
    one-rank naive layer, at JAX's bounds for the wire (max abs over max
    |ref|), aux within rel 1e-6, and at the fp32 wire every gradient
    within rel 5e-5."""
    _, ep, etp = LAYOUTS[layout]
    res = np.load(ranked(layout) / f"hier-ig{ig}-{name}.npz")
    ref = jax_ref("selftest")["full"]
    wire = name.rsplit("-", 1)[1]
    assert _rel(res["y"], ref["y"]) < WIRE_REL[wire]
    assert abs(float(res["aux"]) - ref["aux"]) <= AUX_REL * abs(ref["aux"])
    if wire == "fp32" and "pallas-" not in name:
        _check(res, ref, ep, etp)


@pytest.mark.parametrize("layout,ig,name", FLAT_TWINS,
                         ids=[f"{a}-ig{b}-{c}" for a, b, c in FLAT_TWINS])
def test_comet_hier_fp32_wire_matches_the_flat_ring(ranked, layout, ig,
                                                    name):
    """At the fp32 wire the two-level ring computes what the flat ring
    computes at the same knobs: y, aux and every gradient with the same
    bits, or within rel 1e-6 where a macro-step groups other chunks."""
    hier = np.load(ranked(layout) / f"hier-ig{ig}-{name}.npz")
    flat = np.load(ranked(layout) / f"flat-{name}.npz")
    assert set(hier.files) == set(flat.files)
    for k in flat.files:
        if not np.array_equal(hier[k], flat[k]):
            assert _rel(hier[k], flat[k]) < FLAT_REL, k


@pytest.mark.parametrize("wire", WIRES)
def test_hier_census_counts_hops_classes_and_wire_bytes(ranked, wire):
    """One ep-4 forward at two groups a node (two column blocks) permutes
    as ``comet_hier_segments`` counts: 2 inter-node and then 1 intra-node
    dispatch of a whole chunk in the wire's width (4, 2 or 1 bytes an
    element) with its fp32 scale beside it under fp8, and 3 n_col returns
    of a column block in the wire's width, each a full permutation."""
    rec = json.loads((ranked("dp1mp4-ep4") / "hier.json").read_text())
    run = rec["runs"][f"ig2-{wire}"]
    seg, census = run["segments"], run["census"]
    assert seg == JT.comet_hier_segments(4, 1, 2, 2)
    assert (seg["intra_hops"], seg["inter_hops"]) == (1, 2)
    disp = [c for c in census if c["op"] == "disp"]
    comb = [c for c in census if c["op"] == "comb"]
    assert len(disp) == seg["dispatch_hops"] == 3
    assert len(comb) == seg["combine_hops"] == 6
    assert [c["cls"] for c in disp] == ["inter", "inter", "intra"]
    width = {"fp32": 4, "bf16": 2, "fp8_e4m3": 1}[wire]
    elems = run["chunk_bytes"] // 4                  # the buffer is fp32
    assert {c["bytes"] for c in disp} == {elems * width}
    assert {c["scale_bytes"] for c in disp} == {4 if wire == "fp8_e4m3"
                                                else 0}
    assert {c["bytes"] for c in comb} == {elems * width // 2}
    for c in census:
        CL.check_permutation([tuple(p) for p in c["pairs"]], 4)


@pytest.mark.parametrize("wire", WIRES[1:])
def test_hier_wire_payload_bits_do_not_depend_on_the_substep(ranked, wire):
    """Each dispatch chunk is encoded once from the whole buffer: the bits
    on the wire (payload and scale) are those of that encoding, whichever
    sub-step and link class carries the chunk at one, two or four groups
    a node."""
    rec = json.loads((ranked("dp1mp4-ep4") / "hier.json").read_text())
    seen = {}
    for ig in HIER_IGS["dp1mp4-ep4"]:
        run = rec["runs"][f"ig{ig}-{wire}"]
        for c in run["census"]:
            if c["op"] == "disp":
                assert c["digest"] == run["chunk_digests"][c["chunk"]]
                seen.setdefault(c["chunk"], set()).add((c["step"], ig))
        assert len({c["chunk"] for c in run["census"]
                    if c["op"] == "disp"}) == 3
    # chunks travelled at other sub-steps under other node sizes
    assert any(len({st for st, _ in v}) > 1 for v in seen.values())


@pytest.mark.parametrize("ep,etp,ig", [(4, 1, 1), (4, 1, 2), (4, 1, 4),
                                       (2, 2, 2), (8, 1, 4), (8, 1, 2),
                                       (4, 2, 2), (6, 1, 3)])
def test_hier_permutes_and_orders_match_jax(ep, etp, ig):
    """``_hier_perm`` of every (node, local, tp) shift, ``_hier_dst``,
    ``_hier_dest_order`` and ``comet_hier_segments`` as the JAX package
    computes them; every remote sub-step's pairs a full permutation."""
    from repro.core import adaptive as JA
    port_ctx, jax_ctx = ST.AxisCtx(ep=ep, etp=etp), JAxisCtx(ep=ep, etp=etp)
    nn = ep // ig
    for sn, sl in JA.hier_step_order(ep, ig):
        for o in range(etp):
            for sgn in (1, -1):
                got = T._hier_perm(port_ctx, ig, sgn * sn, sgn * sl, o)
                assert got == JT._hier_perm(jax_ctx, ig, sgn * sn, sgn * sl,
                                            o)
                if (sn, sl, o) != (0, 0, 0):
                    CL.check_permutation(got, ep * etp)
        for g_r in range(ep):
            assert T._hier_dst(g_r, sn, sl, ig, nn) == int(
                JT._hier_dst(g_r, sn, sl, ig, nn))
    for g_r in range(ep):
        assert T._hier_dest_order(g_r, ep, ig) == [
            int(v) for v in JT._hier_dest_order(g_r, ep, ig)]
    for rg in (1, 2):
        for n_col in (1, 2):
            assert T.comet_hier_segments(ep, rg, n_col, ig) == \
                JT.comet_hier_segments(ep, rg, n_col, ig)


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
    """The flat ring's permutations are the two-level ring's on one node
    of ep groups."""
    port = T._hier_perm(ST.AxisCtx(ep=ep, etp=etp), ep, 0, gs, ts)
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
    """``--plan-cache`` and ``--sp-residual``, both ported since, train
    (a missing cache file resolves the cost model's plans; without a mesh
    the residual stays whole)."""
    from repro_torch.launch import train
    base = ["--arch", "qwen2-moe-2.7b-smoke", "--ckpt-dir",
            str(tmp_path / "ckpt")]
    if what == "plan-cache":
        argv = ["--plan-cache", str(tmp_path / argv[1])]
    out = train.main(base + argv + ["--steps", "1", "--batch", "2", "--seq",
                                    "8"], device="cpu")
    assert out["final_step"] == 1


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
