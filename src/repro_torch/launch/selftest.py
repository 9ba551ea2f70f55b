"""Ranked self-test of the port, the counterpart of the JAX package's
``launch/selftest.py``:

  python -m repro_torch.launch.selftest --device cpu --ranks 4 --case moe
  python -m repro_torch.launch.selftest --device cpu --ranks 4 --case all
  python -m repro_torch.launch.selftest --device cuda --case all

``--device cpu`` spawns ``--ranks`` processes joined by gloo; ``--device
cuda`` one NCCL rank per visible GPU. The problem is the JAX self-test's
(granite-moe-3b-a800m-smoke cut to 8 experts of width 64, top-2, no-drop
capacity, 4 x 32 tokens, seeded weights) and so are the cells: the
(data, model) layouts for the rank count, the naive, comet (ring_group 1
and 2, two column blocks) and coarse transports with and without sequence
sharding, the gradients of naive, comet and comet with ring_group 2, two
column blocks and the fused combine, and the decode broadcast. Each is
held against the port's own one-rank ``moe_ffn`` at the JAX self-test's
bounds (``FWD_REL``, ``AUX_ABS``, ``GRAD_REL``). Rank 0 prints one
``[PASS]``/``[FAIL]`` line per check; the exit code is 0 iff all pass.
Every spawn has a time limit and kills its ranks when it runs out, so a
deadlocked rank fails the run instead of hanging it.

``--case all`` adds, and ``--case train`` runs alone, the JAX self-test's
mesh train steps (``repro/launch/selftest.py:151-163``): four Trainer
steps of granite-moe-3b-a800m-smoke and of jamba-v0.1-52b-smoke on a
(ranks / mp, mp) mesh, mp = min(4, ranks), whose losses must be finite
and not rise by more than 1; the port also holds them against its own
mesh-less Trainer on the same seed (``LOSS_REL``). Both runs take the
no-drop capacity (``trainer.smoke_train``): a mesh routes its local
tokens, so a dropping capacity drops other tokens than one rank does.

``mesh_cells`` runs the model-level cells of ``tests/test_torch_mesh_
train.py`` on the ranks, reading their weights and batches from files.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import sys
import tempfile
import time
from multiprocessing import connection
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import moe_layer as M
from repro_torch.core import transport as T
from repro_torch.device import resolve_device
from repro_torch.models.common import is_glu
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import AxisCtx, choose_ep, make_mesh

# the JAX self-test's bounds (launch/selftest.py:103-161 of the JAX package)
FWD_REL = 2e-5        # forward and decode broadcast, max abs / max |ref|
AUX_ABS = 1e-4        # aux loss, absolute
GRAD_REL = 5e-5       # gradients, max abs / max |ref|
LOSS_REL = 2e-5       # a mesh run's losses against the mesh-less run's
SELFTEST_ARCH = "granite-moe-3b-a800m-smoke"
TRAIN_ARCHS = ("granite-moe-3b-a800m-smoke", "jamba-v0.1-52b-smoke")


def problem(arch: str = SELFTEST_ARCH, E: int = 8, f: int = 64,
            top_k: int = 2, B: int = 4, S: int = 32, seed: int = 7) -> Dict:
    """A seeded MoE problem at no-drop capacity (capacity_factor = E, so
    one-rank and ranked runs route every token): the config, the logical
    expert weights (E, d, f)/(E, f, d), the router (d, E) and x (B, S, d),
    all numpy fp32. E, f or top_k 0 keeps the arch's own."""
    cfg = get_config(arch)
    m = cfg.moe
    E, f, top_k = E or m.num_experts, f or m.d_expert, top_k or m.top_k
    mcfg = dataclasses.replace(m, num_experts=E, d_expert=f, top_k=top_k,
                               capacity_factor=float(E), n_col_blocks=0)
    d = cfg.d_model
    rng = np.random.default_rng(seed)

    def nrm(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    full = {"w_gate": nrm(E, d, f, scale=0.05) if is_glu(cfg.activation)
            else None,
            "w_up": nrm(E, d, f, scale=0.05),
            "w_down": nrm(E, f, d, scale=0.05)}
    return {"cfg": cfg, "mcfg": mcfg,
            "full": {k: v for k, v in full.items() if v is not None},
            "router": nrm(d, E, scale=0.1), "x": nrm(B, S, d, scale=1.0)}


def holders(ctx: AxisCtx) -> int:
    """How many ranks hold the same tokens under ``ctx`` (the context
    ``sharding.shard_tokens`` returned)."""
    return ((1 if ctx.seq_shard else ctx.model_size)
            * (1 if ctx.dp_axes else
               dist.get_world_size() // ctx.model_size))


def rank_loss(ctx: AxisCtx, y: torch.Tensor, aux: torch.Tensor):
    """This rank's share of the global loss sum(y**2) + aux: its own
    sum(y**2) over the ranks that hold the same tokens, plus aux over the
    world (every rank holds the same aux). The shares sum to the loss the
    one-rank layer takes on the whole batch."""
    return ((y.float() ** 2).sum() / holders(ctx)
            + aux / dist.get_world_size())


def reduce_grads(ctx: AxisCtx, router_grad: torch.Tensor,
                 expert_grads: Dict[str, torch.Tensor]):
    """Gradients of the replicated parameters summed over their replicas
    (the router over every rank, the expert shards over the data group),
    the shards then gathered: (router (d, E), packed {k: (W, E_loc, ...)})."""
    world = ctx.mesh.group(ctx.mesh.axis_names)
    router = CL.psum(router_grad, world)
    data = ctx.data_group
    packed = {k: SH.gather_experts(
        ctx, g if data is None else CL.psum(g, data))
        for k, g in expert_grads.items()}
    return router, packed


def _params(prob, ep: int, etp: int, device):
    full = {k: torch.from_numpy(v).to(device) for k, v in prob["full"].items()}
    return (torch.from_numpy(prob["router"]).to(device),
            M.pack_expert_weights(full, ep, etp))


def local_run(prob, mcfg, x: torch.Tensor, grads: bool, device):
    """The one-rank reference: y, aux and (with ``grads``) the gradients of
    sum(y**2) + aux, the experts' in the logical (E, ...) layout."""
    router, packed = _params(prob, 1, 1, device)
    params = {"router": router.requires_grad_(grads),
              "experts": {k: v.requires_grad_(grads)
                          for k, v in packed.items()}}
    y, aux = M.moe_ffn(prob["cfg"], mcfg, params, x)
    out = {"y": y.detach(), "aux": aux.item()}
    if grads:
        ((y.float() ** 2).sum() + aux).backward()
        out["router"] = params["router"].grad
        out["experts"] = {k: v.grad[0] for k, v in params["experts"].items()}
    return out


def run_cell(prob, ctx: AxisCtx, impl: str, ring_group: int = 1,
             n_col: int = 0, fused_combine: bool = False,
             seq_shard: bool = False, decode: bool = False,
             grads: bool = False, device="cpu") -> Dict:
    """One ranked cell, collective over every rank: the global x cut to
    this rank's share, the ranked ``moe_ffn``, and (with ``grads``) the
    backward of ``rank_loss``. Returns the gathered global y, aux and the
    reduced gradients (router (d, E), experts packed (W, E_loc, ...))."""
    mcfg = dataclasses.replace(prob["mcfg"], impl=impl,
                               ring_group=ring_group, n_col_blocks=n_col,
                               fused_combine=fused_combine)
    x = torch.from_numpy(prob["x"]).to(device)
    if decode:
        x = x[:, :1]
    router, packed = _params(prob, ctx.ep, ctx.etp, device)
    experts = SH.shard_experts(ctx, packed)
    params = {"router": router.requires_grad_(grads),
              "experts": {k: v.requires_grad_(grads)
                          for k, v in experts.items()}}
    x_loc, bctx = SH.shard_tokens(
        dataclasses.replace(ctx, seq_shard=seq_shard), x)
    y, aux = M.moe_ffn(prob["cfg"], mcfg, params, x_loc, bctx)
    out = {"y": SH.gather_tokens(bctx, y.detach()), "aux": aux.item()}
    if grads:
        rank_loss(bctx, y, aux).backward()
        out["router"], out["experts"] = reduce_grads(
            bctx, params["router"].grad,
            {k: v.grad for k, v in params["experts"].items()})
    return out


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()
                 / (want.abs().max() + 1e-9))


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def _rank_main(rank: int, n: int, init: str, device: str, fn, args):
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    resolve_device(device)
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank)
    try:
        code = fn(*args)
    finally:
        dist.destroy_process_group()
    sys.exit(code or 0)


def spawn(n_ranks: int, fn, args=(), device: str = "cpu",
          timeout: float = 600.0) -> None:
    """Runs ``fn(*args)`` on ``n_ranks`` fresh processes joined in one
    process group (gloo on the CPU; NCCL on CUDA, rank r on GPU
    r % device_count), meeting through a file in a temporary directory.
    ``fn`` is pickled by name, so it lives at a module's top level; a
    truthy return is the rank's exit code. Raises RuntimeError as soon as
    a rank fails, TimeoutError when they have not all ended within
    ``timeout`` seconds; either way every rank still running is killed."""
    mpc = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [mpc.Process(target=_rank_main,
                             args=(r, n_ranks, init, device, fn, args))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {[procs.index(p) for p in running]} still "
                        f"running after {timeout:.0f} s: killed")
                connection.wait([p.sentinel for p in running], timeout=left)
                for p in [p for p in running if p.exitcode is not None]:
                    running.remove(p)
                    if p.exitcode != 0:
                        raise RuntimeError(f"rank {procs.index(p)} exited "
                                           f"with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()


# ---------------------------------------------------------------------------
# the self-test's cells (every rank runs them; rank 0 prints)
# ---------------------------------------------------------------------------


def moe_cells(device: str = "cpu") -> int:
    """The JAX self-test's MoE cells at this process group's size. Returns
    the number of failed checks (the same on every rank)."""
    rank, n = dist.get_rank(), dist.get_world_size()
    failures: List[str] = []

    def check(name, ok, detail=""):
        if rank == 0:
            print(f"[{'PASS' if ok else 'FAIL'}] {name} {detail}",
                  flush=True)
        if not ok:
            failures.append(name)

    prob = problem()
    E, f = prob["mcfg"].num_experts, prob["mcfg"].d_expert
    S = prob["x"].shape[1]
    mref = dataclasses.replace(prob["mcfg"], impl="naive")
    x = torch.from_numpy(prob["x"]).to(device)
    ref = local_run(prob, mref, x, True, device)
    for dp, mp in ([(n // 4, 4), (n // 8, 8)] if n >= 8 else [(1, n)]):
        if dp < 1:
            continue
        mesh = make_mesh((dp, mp), ("data", "model"))
        eps = {choose_ep(E, mp)[0]}
        if mp >= 2:
            eps.add(mp // 2)                    # forces etp == 2
        for ep in sorted(eps):
            etp = mp // ep
            if E % ep or f % etp:
                continue
            ctx = AxisCtx(mesh=mesh, dp_axes=("data",), model_axis="model",
                          ep=ep, etp=etp)
            for impl, rg in (("naive", 1), ("comet", 1), ("comet", 2),
                             ("coarse", 1)):
                for seq in (False, True):
                    if seq and S % mp:
                        continue
                    r = run_cell(prob, ctx, impl, rg,
                                 2 if impl == "comet" else 0,
                                 seq_shard=seq, device=device)
                    tag = (f"dp{dp} mp{mp} ep{ep} etp{etp} {impl}"
                           f"{'-rg' + str(rg) if rg > 1 else ''} "
                           f"sp={int(seq)}")
                    e = rel(r["y"], ref["y"])
                    check(f"moe_fwd {tag}", e < FWD_REL, f"rel_err={e:.2e}")
                    check(f"moe_aux {tag}", abs(r["aux"] - ref["aux"])
                          < AUX_ABS, f"aux={r['aux']:.5f} "
                          f"ref={ref['aux']:.5f}")
            want = M.pack_expert_weights(ref["experts"], ep, etp)
            for name, kw in (("naive", dict(impl="naive")),
                             ("comet", dict(impl="comet")),
                             ("cometbwd", dict(impl="comet", ring_group=2,
                                               n_col=2,
                                               fused_combine=True))):
                r = run_cell(prob, ctx, grads=True, device=device, **kw)
                for k in want:
                    e = rel(r["experts"][k], want[k])
                    check(f"moe_grad[{k}] ep{ep} etp{etp} {name}-vs-local",
                          e < GRAD_REL, f"rel={e:.2e}")
                e = rel(r["router"], ref["router"])
                check(f"moe_grad[router] ep{ep} etp{etp} {name}",
                      e < GRAD_REL, f"rel={e:.2e}")

        # decode (S = 1): the broadcast path
        ref1 = local_run(prob, mref, x[:, :1], False, device)
        ep, etp = choose_ep(E, mp)
        ctx = AxisCtx(mesh=mesh, dp_axes=("data",), model_axis="model",
                      ep=ep, etp=etp)
        r = run_cell(prob, ctx, "comet", decode=True, device=device)
        e = rel(r["y"], ref1["y"])
        check(f"moe_decode_bcast mp{mp} ep{ep} etp{etp}", e < FWD_REL,
              f"rel={e:.2e}")
    if rank == 0:
        print(f"\n{'OK' if not failures else 'FAILURES'}: "
              f"{len(failures)} failed", flush=True)
    return len(failures)


def train_cells(device: str = "cpu") -> int:
    """The mesh train steps of ``TRAIN_ARCHS``, each beside the mesh-less
    Trainer on the same seed (rank 0 runs it and shares its losses).
    Returns the number of failed checks (the same on every rank)."""
    import math
    import traceback

    from repro_torch.training.trainer import smoke_train
    rank, n = dist.get_rank(), dist.get_world_size()
    mp = min(4, n)
    mesh = make_mesh((n // mp, mp), ("data", "model"))
    failures = 0
    for arch in TRAIN_ARCHS:
        try:
            got = smoke_train(arch, mesh, 4, device, no_drop=True)
            want = [smoke_train(arch, None, 4, device, no_drop=True)
                    if rank == 0 else None]
            dist.broadcast_object_list(want, src=0)
            want = want[0]
            ok = (all(math.isfinite(v) for v in got)
                  and got[-1] < got[0] + 1.0)
            err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            res = [(f"mesh_train {arch}", ok,
                    f"loss {got[0]:.3f} -> {got[-1]:.3f}"),
                   (f"mesh_vs_local {arch}", err < LOSS_REL,
                    f"max rel {err:.2e} over {len(got)} steps "
                    f"(dp{n // mp} mp{mp})")]
        except Exception as e:        # reported as a failed check
            traceback.print_exc()
            res = [(f"mesh_train {arch}", False, str(e)[:200])]
        for name, ok, detail in res:
            if rank == 0:
                print(f"[{'PASS' if ok else 'FAIL'}] {name} {detail}",
                      flush=True)
            failures += not ok
    return failures


def _selftest_rank(device: str, case: str) -> int:
    failures = 0
    if case in ("moe", "all"):
        failures += moe_cells(device)
    if case in ("train", "all"):
        failures += train_cells(device)
        if dist.get_rank() == 0:
            print(f"\n{'OK' if not failures else 'FAILURES'}: {failures} "
                  f"failed in all", flush=True)
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# cells for the tests: results written to a directory
# ---------------------------------------------------------------------------


def dump_cells(layout, jobs: List[Dict], out_dir: str) -> int:
    """Runs ``jobs`` on a (data, model) mesh of shape ``layout`` (every
    rank) and writes each job's gathered results to ``out_dir/<name>.npz``
    (rank 0). A job: name, problem (``problem``'s keyword arguments), ep,
    etp, and ``run_cell``'s keywords; kind "census" records the permutes of
    one ``transport_comet_blocks`` forward, kind "hier" the error that
    impl="comet_hier" raises."""
    mesh = make_mesh(tuple(layout), ("data", "model"))
    probs: Dict[str, Dict] = {}
    for job in jobs:
        job = dict(job)
        name, pkw = job.pop("name"), job.pop("problem", {})
        kind = job.pop("kind", "cell")
        key = json.dumps(pkw, sort_keys=True)
        if key not in probs:
            probs[key] = problem(**pkw)
        prob = probs[key]
        ctx = AxisCtx(mesh=mesh, dp_axes=("data",), model_axis="model",
                      ep=job.pop("ep"), etp=job.pop("etp"))
        if kind == "census":
            res = _census_job(prob, ctx, **job)
        elif kind == "hier":
            try:
                run_cell(prob, ctx, "comet_hier", **job)
                res = {"raised": ""}
            except NotImplementedError as e:
                res = {"raised": str(e)}
        else:
            r = run_cell(prob, ctx, **job)
            res = {"y": r["y"].numpy(), "aux": r["aux"]}
            if "router" in r:
                res["router"] = r["router"].numpy()
                res.update({f"experts/{k}": v.numpy()
                            for k, v in r["experts"].items()})
        if dist.get_rank() == 0:
            if kind == "cell":
                np.savez(Path(out_dir) / f"{name}.npz", **res)
            else:
                (Path(out_dir) / f"{name}.json").write_text(json.dumps(res))
    return 0


def _census_job(prob, ctx: AxisCtx, ring_group: int = 1, n_col: int = 1):
    """One ranked comet forward on a seeded dispatch buffer, its permutes
    recorded by ``census``; the segment counts and chunk bytes beside."""
    cfg, mcfg = prob["cfg"], prob["mcfg"]
    E, d = mcfg.num_experts, cfg.d_model
    C = 8
    gen = torch.Generator().manual_seed(3 + ctx.model_rank)
    send = torch.randn((ctx.ep, E // ctx.ep, C, d), generator=gen)
    _, packed = _params(prob, ctx.ep, ctx.etp, "cpu")
    w = {k: v[0] for k, v in SH.shard_experts(ctx, packed).items()}
    census: List[Dict] = []
    with torch.no_grad():
        T.transport_comet_blocks(send, w, cfg.activation, n_col_blocks=n_col,
                                 ring_group=ring_group, ctx=ctx,
                                 census=census)
    n_col = T.legalize_n_col(d, n_col)
    return {"census": census,
            "segments": T.comet_ring_segments(ctx.ep, ring_group, n_col),
            "chunk_bytes": send[0].numel() * send.element_size(),
            "block_bytes": send[0].numel() * send.element_size() // n_col}


# ---------------------------------------------------------------------------
# model-level cells for the tests: weights and batches read from files
# ---------------------------------------------------------------------------


def cell_config(arch: str, over: Optional[Dict] = None):
    """``arch``'s config with ``over``'s replacements: top-level fields,
    and the "moe" and "attn" sub-configs' fields under those keys."""
    cfg = get_config(arch)
    over = dict(over or {})
    for key in ("moe", "attn"):
        if key in over:
            cfg = dataclasses.replace(cfg, **{key: dataclasses.replace(
                getattr(cfg, key), **over.pop(key))})
    return dataclasses.replace(cfg, **over)


def _flat(tree) -> Dict[str, np.ndarray]:
    """Copies of the leaves (a CPU tensor's numpy view would follow the
    in-place updates of the next step) under flat "a/b/c" keys."""
    from repro_torch.models.common import tree_leaves
    return {"/".join(map(str, p)): np.array(
        t.detach().cpu() if isinstance(t, torch.Tensor) else t)
        for p, t in tree_leaves(tree)}


def _unflat(cfg, flat: Dict[str, np.ndarray], prefix: str = ""):
    """The one-rank tree of ``cfg`` from flat "a/b/c" keys."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map_path
    return tree_map_path(lambda p, _: flat[prefix + "/".join(map(str, p))],
                         lm.model_schema(cfg))


def _batch(data, key: str, device) -> Dict[str, torch.Tensor]:
    return {k.split("/", 1)[1]: torch.from_numpy(data[k]).long().to(device)
            for k in data.files if k.startswith(key + "/")}


def _grad_job(job, data, mesh, device):
    from repro_torch import bridge
    from repro_torch.launch import specs as SP
    from repro_torch.launch.train_step import _reduce_over_dp, _unflatten
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    cfg = cell_config(job["arch"], job.get("over"))
    fsdp = job.get("fsdp", True)
    ctx = SH.make_ctx(cfg, mesh, seq_shard=job.get("seq_shard", True))
    params = bridge.from_jax_sharded(_unflat(cfg, data, "params/"), cfg,
                                     ctx, fsdp, device)
    batch = _batch(data, "batch", device)
    B, S = batch["tokens"].shape
    pspecs = SP.train_batch_pspecs(cfg, ShapeConfig("cell", S, B, "train"),
                                   1, ctx.dp_axes)
    batch = SP.local_batch(batch, pspecs, mesh)
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(params)]
    loss, met = lm.loss_fn(cfg, params, batch, ctx, fsdp)
    grads = list(torch.autograd.grad(loss, leaves))
    specs = [sp for _, sp in tree_leaves(
        SH.state_specs(cfg, ctx, fsdp)["params"])]
    _reduce_over_dp(ctx, grads, specs)
    g = SH.from_mesh(_unflatten(params, grads), cfg, ctx, fsdp)
    return {"loss": loss.item(), "aux": met["aux"].item(),
            "xent": met["xent"].item(),
            **{"grad/" + k: v for k, v in _flat(g).items()}}


def _plan_job(job, data, mesh, device):
    """A plan-cache cell: rank 0 writes a cache (``job["cache"]``) holding
    ``job["plan"]`` (a ``Plan.to_json``) under the h100_nvlink train key of
    the cell's MoE shape, its M the JAX package's ``local_token_count`` of
    the global batch; then every rank runs the grad job with the cache
    set. Records the knobs each ``moe_ffn`` body ran under and its tokens
    ("ran/*"), and the key's M; a layer that raises (a ranked comet_hier
    plan) records its error ("raised") instead of the grad job's
    results."""
    from repro_torch.core import adaptive as A
    cfg = cell_config(job["arch"], job.get("over"))
    ctx = SH.make_ctx(cfg, mesh, seq_shard=job.get("seq_shard", True))
    B, S = data["batch/tokens"].shape
    toks = M.local_token_count(ctx, B, S)
    if dist.get_rank() == 0:
        s = A.plan_shape(cfg.moe, cfg.d_model, toks, ctx.ep, ctx.etp)
        A.PlanCache(job["cache"]).put(s, A.H100_NVL,
                                      A.Plan.from_json(job["plan"]))
    dist.barrier()
    over = dict(job.get("over") or {})
    over["moe"] = {**over.get("moe", {}), "plan_cache": job["cache"],
                   "plan_hw": "h100_nvlink"}
    ran = []
    real = M._moe_body

    def spy(cfg_, mcfg, n_col, gemm_impl, x, *a, **kw):
        ran.append([mcfg.impl, mcfg.ring_group, n_col, gemm_impl,
                    int(mcfg.fused_combine), x.shape[0] * x.shape[1]])
        return real(cfg_, mcfg, n_col, gemm_impl, x, *a, **kw)

    M._moe_body = spy
    try:
        res = _grad_job({**job, "over": over}, data, mesh, device)
    except NotImplementedError as e:
        res = {"raised": str(e)}
    finally:
        M._moe_body = real
    res["key_tokens"] = toks
    for i, name in enumerate(("impl", "ring_group", "n_col", "gemm_impl",
                              "fused_combine", "tokens")):
        res[f"ran/{name}"] = np.array([r[i] for r in ran])
    return res


def _adamw_job(job, data, mesh, device):
    """Two AdamW steps (``accum`` microbatches each) through
    ``build_train_step`` on the mesh: after each, the gathered params and
    moments; the local shapes of every leaf of params, m and v beside
    what the specs cut from the global shapes; with ``nan_rank`` a
    first step whose gradients are made non-finite on that rank only."""
    from repro_torch import bridge
    from repro_torch.launch import specs as SP
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = cell_config(job["arch"], job.get("over"))
    accum, fsdp = job.get("accum", 1), job.get("fsdp", True)
    optim = AdamW(lr=cosine_schedule(*job["lr"]), eps=job.get("eps", 1e-8))
    tok = data["batch0/tokens"]                 # (B, S) or (accum, mb, S)
    shape = ShapeConfig("cell", tok.shape[-1], tok.size // tok.shape[-1],
                        "train")
    built = build_train_step(cfg, shape, mesh, optim, accum, fsdp=fsdp)
    ctx = built["ctx"]
    params = bridge.from_jax_sharded(_unflat(cfg, data, "params/"), cfg,
                                     ctx, fsdp, device)
    state = {"params": params, "opt": optim.init(params), "step": 0}
    out = {}
    pspecs = built["state_specs"]["params"]
    decls = dict(tree_leaves(lm.model_schema(cfg, ctx)))
    for name, tree in (("params", state["params"]),
                       ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
        for (path, t), (_, sp) in zip(tree_leaves(tree),
                                      tree_leaves(pspecs)):
            want = [n // SH._cut(mesh, e)[0]
                    for n, e in zip(decls[path].shape, sp)]
            key = "/".join(map(str, path))
            out[f"shape/{name}/{key}"] = np.array([list(t.shape), want])
    steps = []
    if job.get("nan_rank") is not None:
        steps.append(("nan", "batch0"))
    steps += [(f"step{i}", f"batch{i}") for i in range(2)]
    for tag, bkey in steps:
        batch = SP.local_batch(_batch(data, bkey, device),
                               built["batch_pspecs"], mesh)
        hook = None
        if tag == "nan" and dist.get_rank() == job["nan_rank"]:
            leaf = next(t for _, t in tree_leaves(state["params"]))
            hook = leaf.requires_grad_(True).register_hook(lambda g: g * float("nan"))
        before = _flat(state["params"]) if tag == "nan" else None
        state, met = built["fn"](state, batch)
        if hook is not None:
            hook.remove()
        skipped = [None] * dist.get_world_size()
        dist.all_gather_object(skipped, met["skipped"])
        out[f"{tag}/skipped"] = np.array(skipped)
        out[f"{tag}/loss"] = float(met["loss"])
        out[f"{tag}/grad_norm"] = float(met["grad_norm"])
        if tag == "nan":
            after = _flat(state["params"])
            out["nan/unchanged"] = all(np.array_equal(before[k], after[k])
                                       for k in before)
            continue
        whole = SH.gather_state(state, cfg, ctx, fsdp)
        for name, tree in (("params", whole["params"]),
                           ("m", whole["opt"]["m"]),
                           ("v", whole["opt"]["v"])):
            out.update({f"{tag}/{name}/{k}": v
                        for k, v in _flat(tree).items()})
    return out


def _roundtrip_job(job, mesh, device):
    """``gather_params(shard_params(full))`` against ``full``, bit for bit,
    for the mesh tree of the arch's seeded one-rank weights."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    cfg = cell_config(job["arch"], job.get("over"))
    ctx = SH.make_ctx(cfg, mesh)
    specs = SH.param_specs(lm.model_schema(cfg, ctx), mesh, job["fsdp"])
    full = SH.pack_params(lm.init_params(cfg, 0, device), ctx)
    back = SH.gather_params(SH.shard_params(full, specs, mesh), specs, mesh)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(full), tree_leaves(back)))
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, same)
    return {"same": np.array(flags)}


def _trainer_job(job, mesh, device):
    """Trainer.run on the mesh twice: uninterrupted, and with a fault hook
    that raises once before step ``fail_at`` (the loop restores the last
    checkpoint, every ``ckpt_every`` steps, and replays)."""
    import tempfile

    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = cell_config(job["arch"], job.get("over"))
    shape = ShapeConfig("cell", job["seq"], job["batch"], "train")
    out = {}
    for tag in ("clean", "replay"):
        d = [tempfile.mkdtemp(prefix="repro_torch_cell_")
             if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(d, src=0)
        fired = []

        def hook(step):
            if tag == "replay" and step == job["fail_at"] and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        tcfg = TrainerConfig(ckpt_dir=d[0], ckpt_every=job["ckpt_every"],
                             log_every=10_000, keep=2)
        res = Trainer(cfg, shape, mesh, tcfg, fault_hook=hook,
                      device=device).run(job["steps"])
        out[f"{tag}/losses"] = np.array([m["loss"] for m in res["metrics"]])
        out[f"{tag}/steps"] = np.array([m["step"] for m in res["metrics"]])
        out[f"{tag}/restarts"] = res["restarts"]
    return out


def _cli_job(job, device):
    """``launch.train.main`` with ``job["argv"]`` on the initialised
    process group."""
    from repro_torch.launch import train
    res = train.main(list(job["argv"]), device=device)
    return {"losses": np.array([m["loss"] for m in res["metrics"]]),
            "final_step": res["final_step"]}


def mesh_cells(layout, jobs: List[Dict], in_dir: str, out_dir: str) -> int:
    """Runs ``jobs`` on a (data, model) mesh of shape ``layout`` (every
    rank) and writes each job's results to ``out_dir/<name>.npz`` (rank
    0). A job: name, kind ("grad", "plan", "adamw", "roundtrip",
    "trainer", "cli"), arch and ``over`` (``cell_config``); "grad",
    "plan" and "adamw" read the one-rank weights ("params/<leaf>") and
    batches ("batch*/<key>") from ``in_dir/<data>.npz``. Results are gathered into the one-rank
    layout. Gloo ranks: every tensor on the CPU."""
    device = "cpu"
    mesh = make_mesh(tuple(layout), ("data", "model"))
    for job in jobs:
        kind = job["kind"]
        if kind in ("grad", "plan", "adamw"):
            data = np.load(Path(in_dir) / f"{job['data']}.npz")
            res = {"grad": _grad_job, "plan": _plan_job,
                   "adamw": _adamw_job}[kind](job, data, mesh, device)
        elif kind == "roundtrip":
            res = _roundtrip_job(job, mesh, device)
        elif kind == "trainer":
            res = _trainer_job(job, mesh, device)
        else:
            res = _cli_job(job, device)
        if dist.get_rank() == 0:
            np.savez(Path(out_dir) / f"{job['name']}.npz", **res)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--ranks", type=int, default=0,
                    help="gloo ranks (--device cpu; default 4); on cuda one "
                         "rank per visible GPU")
    ap.add_argument("--case", default="moe", choices=("moe", "train", "all"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before every rank is killed")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        resolve_device("cuda")
        n = torch.cuda.device_count()
    else:
        n = args.ranks or 4
    try:
        spawn(n, _selftest_rank, (args.device, args.case), args.device,
              args.timeout)
    except (RuntimeError, TimeoutError) as e:
        print(f"selftest: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
