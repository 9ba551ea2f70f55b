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
train.py`` and ``tests/test_torch_mesh_serve.py`` on the ranks, reading
their weights and inputs from files.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
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
             grads: bool = False, device="cpu", intra_group: int = 1,
             wire_dtype: str = "fp32", gemm_impl: str = "") -> Dict:
    """One ranked cell, collective over every rank: the global x cut to
    this rank's share, the ranked ``moe_ffn``, and (with ``grads``) the
    backward of ``rank_loss``. Returns the gathered global y, aux and the
    reduced gradients (router (d, E), experts packed (W, E_loc, ...))."""
    mcfg = dataclasses.replace(prob["mcfg"], impl=impl,
                               ring_group=ring_group, n_col_blocks=n_col,
                               fused_combine=fused_combine,
                               intra_group=intra_group,
                               wire_dtype=wire_dtype, gemm_impl=gemm_impl)
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
        dist.barrier()            # no rank tears down while one still talks
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
    one ``transport_comet_blocks`` forward, kind "hier" those of
    ``transport_comet_hier`` forwards (``_census_job``)."""
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
        if kind in ("census", "hier"):
            res = _census_job(prob, ctx, **job)
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


def wire_digest(payload, scale=None) -> str:
    """A digest of a wire payload's bits and its scale's (if any)."""
    h = hashlib.sha1()
    for t in (payload, scale):
        if t is not None:
            h.update(t.detach().contiguous().cpu().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def _census_bits(census):
    """``census`` with each dispatch's wire tensors (payload, scale)
    replaced by the scale's bytes and the digest of their bits."""
    for c in census:
        wire = c.pop("wire", None)
        if wire is not None:
            pay, sc = wire
            c["scale_bytes"] = 0 if sc is None else \
                sc.numel() * sc.element_size()
            c["digest"] = wire_digest(pay, sc)
    return census


def _census_job(prob, ctx: AxisCtx, ring_group: int = 1, n_col: int = 1,
                intra_groups=(), wires=("fp32",)):
    """One ranked comet forward on a seeded dispatch buffer, its permutes
    recorded by ``census``; the segment counts and chunk bytes beside.
    With ``intra_groups``, one ``transport_comet_hier`` forward at each
    node size and wire format instead, under "ig<ig>-<wire>", each beside
    the digests of the dispatch chunks as encoded once from the whole
    buffer."""
    cfg, mcfg = prob["cfg"], prob["mcfg"]
    E, d = mcfg.num_experts, cfg.d_model
    C = 8
    gen = torch.Generator().manual_seed(3 + ctx.model_rank)
    send = torch.randn((ctx.ep, E // ctx.ep, C, d), generator=gen)
    _, packed = _params(prob, ctx.ep, ctx.etp, "cpu")
    w = {k: v[0] for k, v in SH.shard_experts(ctx, packed).items()}
    n_col = T.legalize_n_col(d, n_col)
    chunk_elems = send[0].numel()

    def sizes(census):
        return {"census": _census_bits(census),
                "chunk_bytes": chunk_elems * send.element_size(),
                "block_bytes": chunk_elems * send.element_size() // n_col}

    if not intra_groups:
        census: List[Dict] = []
        with torch.no_grad():
            T.transport_comet_blocks(send, w, cfg.activation,
                                     n_col_blocks=n_col,
                                     ring_group=ring_group, ctx=ctx,
                                     census=census)
        return {**sizes(census), "segments": T.comet_ring_segments(
            ctx.ep, ring_group, n_col)}
    runs = {}
    for ig in intra_groups:
        for wire in wires:
            census = []
            with torch.no_grad():
                T.transport_comet_hier(send, w, cfg.activation,
                                       n_col_blocks=n_col,
                                       ring_group=ring_group,
                                       intra_group=ig, wire_dtype=wire,
                                       ctx=ctx, census=census)
            pay, sc = T._wire_encode(send, wire, per_chunk=True)
            digests = [wire_digest(pay[c], None if sc is None else sc[c])
                       for c in range(ctx.ep)]
            runs[f"ig{ig}-{wire}"] = {
                **sizes(census), "chunk_digests": digests,
                "segments": T.comet_hier_segments(ctx.ep, ring_group,
                                                  n_col, ig),
                "classes": T.hier_step_classes(ctx.ep, ig)}
    return {"runs": runs}


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
    """The entries "key/*": integer arrays as int64 (tokens, labels),
    floats (an encoder-decoder's frames) and masks as they are."""
    out = {}
    for k in data.files:
        if k.startswith(key + "/"):
            t = torch.from_numpy(np.array(data[k]))
            if not (t.is_floating_point() or t.dtype == torch.bool):
                t = t.long()
            out[k.split("/", 1)[1]] = t.to(device)
    return out


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
    carried = []                   # the residual entering each period
    real = lm._period_body

    def spy(cfg_, h, *a, **kw):
        carried.append(list(h.shape))
        return real(cfg_, h, *a, **kw)

    lm._period_body = spy
    try:
        loss, met = lm.loss_fn(cfg, params, batch, ctx, fsdp)
    finally:
        lm._period_body = real
    grads = list(torch.autograd.grad(loss, leaves))
    specs = [sp for _, sp in tree_leaves(
        SH.state_specs(cfg, ctx, fsdp)["params"])]
    _reduce_over_dp(ctx, grads, specs)
    g = SH.from_mesh(_unflatten(params, grads), cfg, ctx, fsdp)
    return {"loss": loss.item(), "aux": met["aux"].item(),
            "xent": met["xent"].item(), "carried": np.array(carried),
            "sp_split": lm.sp_split(cfg, ctx, S),
            **{"grad/" + k: v for k, v in _flat(g).items()}}


def _plan_job(job, data, mesh, device):
    """A plan-cache cell: rank 0 writes a cache (``job["cache"]``) holding
    ``job["plan"]`` (a ``Plan.to_json``) under the h100_nvlink train key of
    the cell's MoE shape, its M the JAX package's ``local_token_count`` of
    the global batch; then every rank runs the grad job with the cache
    set. Records the knobs each ``moe_ffn`` body ran under and its tokens
    ("ran/*"), and the key's M, beside the grad job's results."""
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
                    int(mcfg.fused_combine), mcfg.intra_group,
                    x.shape[0] * x.shape[1]])
        return real(cfg_, mcfg, n_col, gemm_impl, x, *a, **kw)

    M._moe_body = spy
    try:
        res = _grad_job({**job, "over": over}, data, mesh, device)
    finally:
        M._moe_body = real
    res["key_tokens"] = toks
    for i, name in enumerate(("impl", "ring_group", "n_col", "gemm_impl",
                              "fused_combine", "intra_group", "tokens")):
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


def _nested(data, prefix: str) -> Dict:
    """The entries "prefix<a>/<b>..." as a nested dict of CPU tensors."""
    out: Dict = {}
    for k in data.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(np.array(data[k]))
    return out


def _compress_job(job, data, mesh, device):
    """``optim.compression.allreduce_compressed`` of this rank's gradient
    tree "g<rank>/*" with its residuals "r<rank>/*", over the group of the
    mesh axes each entry of ``job["groups"]`` names: every rank's reduced
    tree and new residuals ("<group>/<rank>/out|resid/<leaf>")."""
    from repro_torch.optim import compression as C
    r = dist.get_rank()
    grads, resids = _nested(data, f"g{r}/"), _nested(data, f"r{r}/")
    res: Dict = {}
    for name, axes in job["groups"].items():
        red, new = C.allreduce_compressed(grads, resids, mesh.group(axes))
        mine = {**{f"out/{k}": v for k, v in _flat(red).items()},
                **{f"resid/{k}": v for k, v in _flat(new).items()}}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        for rank, d in enumerate(every):
            res.update({f"{name}/{rank}/{k}": v for k, v in d.items()})
    return res


def _elastic_job(job, data, mesh, device):
    """The elastic path (``Trainer.rescale``) on the job's (1, 4) mesh of
    4 ranks, every Trainer starting from the one-rank weights "params/*"
    (AdamW at ``lr``/``eps``, checkpoints every 2 steps).

    (b) first, on every rank: the weights saved as step 0, ``run(2)`` on
    (1, 4), the state rescaled to (2, 2), then ``run(6)``, which restores
    the step-2 checkpoint onto the (2, 2) shards, with a fault hook that
    raises once after step 5: the loop restores the step-4 checkpoint
    (written on (2, 2)) and replays step 5 ("b/steps", "b/loss",
    "b/restarts").
    (a) then: 2 live steps on (1, 4); the state rescaled to (2, 2) and
    back, gathered before and after ("a/roundtrip_same"); rescaled to
    (2, 2), 2 steps; rescaled to (1, 2) over ranks 0-1 (ranks 2 and 3 get
    None and leave), 2 steps, then a checkpoint on (1, 2) restored onto
    its shards ("a/shrunk_restore_same"). The losses ("a/loss"), the
    gathered state after steps 4 and 6 ("a/s4|s6/<part>/<leaf>"), and the
    plan knobs and tokens of every MoE body ("a/ran/*"): the trainer's
    plan cache ``job["cache"]`` (written by rank 0) holds one plan for
    each layout's key, ``job["plans"]``: [layout, plan json]."""
    from repro_torch import bridge
    from repro_torch.core import adaptive as A
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = cell_config(job["arch"], job.get("over"))
    shape = ShapeConfig("cell", job["seq"], job["batch"], "train")
    optim = AdamW(lr=cosine_schedule(*job["lr"]), eps=job["eps"])
    meshes = {(1, 4): mesh, (2, 2): make_mesh((2, 2), ("data", "model")),
              (1, 2): make_mesh((1, 2), ("data", "model"))}
    if dist.get_rank() == 0:
        cache = A.PlanCache(job["cache"])
        for layout, plan in job["plans"]:
            ctx = SH.make_ctx(cfg, meshes[tuple(layout)])
            toks = M.local_token_count(ctx, job["batch"], job["seq"])
            cache.put(A.plan_shape(cfg.moe, cfg.d_model, toks, ctx.ep,
                                   ctx.etp), A.H100_NVL,
                      A.Plan.from_json(plan))
    dirs = [[tempfile.mkdtemp(prefix="repro_torch_el_") for _ in "ab"]
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(dirs, src=0)

    def trainer(tag):
        tcfg = TrainerConfig(ckpt_dir=dirs[0]["ab".index(tag)],
                             ckpt_every=2, log_every=10_000,
                             plan_cache=job["cache"], plan_hw="h100_nvlink")
        tr = Trainer(cfg, shape, mesh, tcfg, optim=optim, device=device)
        params = bridge.from_jax_sharded(_unflat(cfg, data, "params/"), cfg,
                                         tr.ctx, True, device)
        return tr, {"params": params, "opt": optim.init(params), "step": 0}

    res: Dict = {}
    tr, state = trainer("b")
    tr.save(0, state, wait=True)
    del state
    tr.run(2)
    state, _ = tr.restore_or_init()
    tr.rescale(state, meshes[(2, 2)])
    del state
    fired = []

    def hook(step):
        if step == 5 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    tr.fault_hook = hook
    out = tr.run(6)
    res["b/steps"] = np.array([m["step"] for m in tr.metrics_log])
    res["b/loss"] = np.array([m["loss"] for m in tr.metrics_log])
    res["b/restarts"] = out["restarts"]

    tr, state = trainer("a")
    ran = []
    real = M._moe_body

    def spy(cfg_, mcfg, n_col, gemm_impl, x, *a, **kw):
        ran.append([mcfg.impl, mcfg.ring_group, n_col, gemm_impl,
                    x.shape[0] * x.shape[1]])
        return real(cfg_, mcfg, n_col, gemm_impl, x, *a, **kw)

    def whole(tag, st):
        g = SH.gather_state(st, cfg, tr.ctx)
        res.update({f"a/{tag}/{part}/{k}": v for part, tree in
                    (("params", g["params"]), ("m", g["opt"]["m"]),
                     ("v", g["opt"]["v"])) for k, v in _flat(tree).items()})

    M._moe_body = spy
    try:
        state, step = tr._run_span(state, 0, 2)
        before = _flat(SH.gather_state(state, cfg, tr.ctx))
        state = tr.rescale(tr.rescale(state, meshes[(2, 2)]), meshes[(1, 4)])
        after = _flat(SH.gather_state(state, cfg, tr.ctx))
        res["a/roundtrip_same"] = before.keys() == after.keys() and all(
            np.array_equal(before[k], after[k]) for k in before)
        state = tr.rescale(state, meshes[(2, 2)])
        state, step = tr._run_span(state, step, 4)
        whole("s4", state)
        state = tr.rescale(state, meshes[(1, 2)])
        if state is not None:                   # ranks 0 and 1
            state, step = tr._run_span(state, step, 6)
            whole("s6", state)
            # a checkpoint of the shrunk mesh, restored onto its shards
            tr.save(step, state, wait=True)
            back, at = tr.restore_or_init()
            a, b = _flat(state), _flat(back)
            res["a/shrunk_restore_same"] = at == step and a.keys() == \
                b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    finally:
        M._moe_body = real
    res["a/loss"] = np.array([m["loss"] for m in tr.metrics_log])
    for i, name in enumerate(("impl", "ring_group", "n_col", "gemm_impl",
                              "tokens")):
        res[f"a/ran/{name}"] = np.array([r[i] for r in ran])
    return res


def _cli_job(job, device):
    """``launch.train.main`` with ``job["argv"]`` on the initialised
    process group."""
    from repro_torch.launch import train
    res = train.main(list(job["argv"]), device=device)
    return {"losses": np.array([m["loss"] for m in res["metrics"]]),
            "final_step": res["final_step"]}


# ---------------------------------------------------------------------------
# serving cells (tests/test_torch_mesh_serve.py): decode steps, prefill
# chunks and the engine on the mesh
# ---------------------------------------------------------------------------


def _serve_shape(job):
    """The cell's decode shape; paged where the job gives a page size."""
    return ShapeConfig("cell", job["max_seq"], job["slots"], "decode",
                       page_size=job.get("page_size", 0),
                       n_pages=job.get("n_pages", 0))


def _global_cache(data, cfg):
    """The cell's global one-rank cache (tuple over period positions)."""
    from repro_torch.models import lm
    return tuple({k: torch.from_numpy(np.array(data[f"cache/{i}/{k}"]))
                  for k in e} for i, e in enumerate(lm.cache_shapes(
                      cfg, 1, 1)))


def _cache_res(res: Dict, prefix: str, cache, specs) -> None:
    """Each leaf of this rank's ``cache`` and its spec into ``res``, as
    "<prefix>cache/<pos>/<entry>" and "<prefix>spec/<pos>/<entry>"."""
    for i, (e, sp) in enumerate(zip(cache, specs)):
        for k, v in e.items():
            res[f"{prefix}cache/{i}/{k}"] = v.numpy().copy()
            res[f"{prefix}spec/{i}/{k}"] = json.dumps(list(sp[k]))


def _per_rank(res: Dict) -> Dict:
    """Every rank's entries of ``res`` as "rank<r>/<key>" on rank 0
    (``all_gather_object``)."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    return {f"rank{r}/{k}": v for r, d in enumerate(every)
            for k, v in d.items()}


def _serve_step_job(job, data, mesh, device):
    """One serving step on the mesh from the cell's global cache:
    ``kind`` "decode" (``build_decode_step``'s fn on global tokens, pos
    and live) or "chunk" (``build_prefill_chunk_step``'s on a stacked
    admission). Every rank's logits (decode: gathered over the dp group),
    next tokens, cache leaves after the step, their specs and its mesh
    coordinates. A paged cell (``page_size``) reads its page pools from
    the cache entries and its block tables from "tables"."""
    from repro_torch import bridge
    from repro_torch.launch.train_step import (build_decode_step,
                                               build_prefill_chunk_step)
    cfg = cell_config(job["arch"], job.get("over"))
    build = (build_decode_step if job["kind"] == "decode"
             else build_prefill_chunk_step)
    built = build(cfg, _serve_shape(job), mesh)
    ctx, cspecs = built["ctx"], built["cache_specs"]
    params = bridge.from_jax_sharded(_unflat(cfg, data, "params/"), cfg,
                                     ctx, True, device)
    cache = tuple({k: SH.shard_leaf(v, sp[k], mesh) for k, v in e.items()}
                  for e, sp in zip(_global_cache(data, cfg), cspecs))

    def arr(key):
        return torch.from_numpy(np.array(data[key])).long()

    tables = (arr("tables"),) if job.get("page_size") else ()
    res = {}
    if job["kind"] == "decode":
        nxt, logits, cache = built["fn"](
            params, cache, arr("tokens"), arr("pos"),
            torch.from_numpy(np.array(data["live"])), *tables)
        if built["tok_spec"][0] is not None:
            logits = CL.all_gather(logits, mesh.group(ctx.dp_axes))
            logits = logits.reshape(-1, logits.shape[-1])
        res["next_tok"] = nxt.numpy()
    else:
        logits, cache = built["fn"](params, cache, arr("tokens"),
                                    arr("pos_off"), arr("valid_len"),
                                    arr("slots"), *tables)
    res["logits"] = logits.numpy()
    res["coords"] = np.array([mesh.coords[a] for a in mesh.axis_names])
    _cache_res(res, "", cache, cspecs)
    return _per_rank(res)


def _prefill_job(job, data, mesh, device):
    """The monolithic prefill on the mesh and the decode it feeds:
    ``build_prefill_step(mesh=)``'s fn on the global batch "batch/*"
    ("tokens" (B, S), and "mask" or "frames" where given), its cache
    stitched (``stitch_prefill_cache(ctx=)``) into a decode cache of B
    slots, ``max_seq`` positions and ``enc_len`` encoder rows on the
    serving context, then one ``lm.decode_step`` per row of "dec_tokens"
    (steps, B), step t at index S + t (a left-padded row at RoPE
    position S + t less its pads, its pads excluded). Every rank's
    prefill logits, prefill cache leaves and their specs ("pre_"), each
    step's logits (gathered over dp where the slots are cut), the decode
    cache's leaves after the steps and their specs, and its mesh
    coordinates."""
    from repro_torch import bridge
    from repro_torch.launch.train_step import build_prefill_step
    from repro_torch.models import lm
    from repro_torch.serving import stitch_prefill_cache
    cfg = cell_config(job["arch"], job.get("over"))
    batch = _batch(data, "batch", device)
    B, S = batch["tokens"].shape
    built = build_prefill_step(cfg, ShapeConfig("cell", S, B, "prefill"),
                               mesh)
    params = bridge.from_jax_sharded(_unflat(cfg, data, "params/"), cfg,
                                     built["ctx"], True, device)
    logits, pre = built["fn"](params, batch)
    res = {"prefill_logits": logits.numpy(),
           "coords": np.array([mesh.coords[a] for a in mesh.axis_names])}
    _cache_res(res, "pre_", pre, built["cache_specs"])
    ctx = SH.make_ctx(cfg, mesh, seq_shard=False)
    T, E = job["max_seq"], job.get("enc_len", 0)
    layout = lm.serve_layout(cfg, ctx, B, T, built["param_specs"],
                             enc_len=E)
    cache = stitch_prefill_cache(cfg, lm.init_cache(cfg, B, T, device, ctx,
                                                    E), pre, S, ctx, layout)
    n = layout.local_slots
    base = SH._dp_index(ctx, ctx.dp_axes) * n if layout.slots_cut else 0
    rows = torch.arange(base, base + n)
    pads = (~batch["mask"]).sum(1)[rows] if "mask" in batch else None
    for t, tok in enumerate(torch.from_numpy(np.array(data["dec_tokens"]))):
        kw = {} if pads is None else dict(rope_pos=S + t - pads,
                                          kv_start=pads)
        lg, cache = lm.decode_step(cfg, params, cache,
                                   tok.long()[rows, None],
                                   torch.full((n,), S + t), ctx, layout,
                                   **kw)
        if layout.slots_cut:
            lg = CL.all_gather(lg, mesh.group(ctx.dp_axes)).reshape(
                -1, lg.shape[-1])
        res[f"logits{t}"] = lg.numpy()
    _cache_res(res, "", cache, SH.cache_specs(cfg, ctx, B, T, E))
    return _per_rank(res)


def _engine_job(job, data, mesh, device):
    """``ServeEngine(mesh=)`` on the cell's prompts from the full one-rank
    weights: every rank's token streams, lengths and statuses. With
    ``job["plans"]`` ({phase: (Plan json, [token counts])}) rank 0 first
    writes a plan cache holding each phase's plan at each count, and the
    knobs every moe_ffn body ran under are recorded ("ran/*"). With
    ``job["swap_on_rank"]`` that rank swaps the first two prompts, with
    ``job["reverse_free_on_rank"]`` that rank's page allocator hands its
    pages out in reverse order: every rank's engine must raise, and its
    message is recorded ("error"). ``page_size``, ``n_pages`` and
    ``admit_k`` go to the engine; its admission rounds and, where paged,
    its free pages after the drain are recorded."""
    from repro_torch import bridge
    from repro_torch.core import adaptive as A
    from repro_torch.serving import ServeEngine
    cfg = cell_config(job["arch"], job.get("over"))
    kw = {}
    if job.get("plans"):
        ctx = SH.make_ctx(cfg, mesh, seq_shard=False)
        if dist.get_rank() == 0:
            cache = A.PlanCache(job["cache"])
            for phase, (plan, counts) in job["plans"].items():
                for n in counts:
                    cache.put(A.plan_shape(cfg.moe, cfg.d_model, n, ctx.ep,
                                           ctx.etp), A.H100_NVL,
                              A.Plan.from_json(plan), phase=phase)
        dist.barrier()
        kw = dict(plan_cache=job["cache"], plan_hw="h100_nvlink")
    ran = []
    real = M._moe_body

    def spy(cfg_, mcfg, n_col, gemm_impl, x, *a, **k):
        ran.append([mcfg.impl, gemm_impl, x.shape[0] * x.shape[1],
                    x.shape[1]])
        return real(cfg_, mcfg, n_col, gemm_impl, x, *a, **k)

    M._moe_body = spy
    diverge = "swap_on_rank" in job or "reverse_free_on_rank" in job
    kw.update({k: job[k] for k in ("page_size", "n_pages", "admit_k")
               if k in job})
    try:
        eng = ServeEngine(cfg, params=bridge.from_jax(
            _unflat(cfg, data, "params/"), cfg, device),
            max_seq=job["max_seq"], batch_size=job["slots"],
            chunk=job["chunk"], device=device, mesh=mesh, **kw)
        prompts = json.loads(str(data["prompts"]))
        if job.get("swap_on_rank") == dist.get_rank():
            prompts[0], prompts[1] = prompts[1], prompts[0]
        if job.get("reverse_free_on_rank") == dist.get_rank():
            state = eng.alloc.snapshot_state()
            eng.alloc.restore_state({**state, "free": state["free"][::-1]})
        try:
            out = eng.generate(prompts, max_new=job["max_new"])
        except RuntimeError as e:
            if not diverge:
                raise
            return _per_rank({"error": str(e)})
    finally:
        M._moe_body = real
    res = {"tokens": out.tokens, "lengths": out.lengths,
           "statuses": np.array(out.statuses),
           "admit_rounds": eng.admit_rounds, "free_pages": eng.free_pages}
    if ran:
        for i, name in enumerate(("impl", "gemm_impl", "tokens", "seq")):
            res[f"ran/{name}"] = np.array([r[i] for r in ran])
    return _per_rank(res)


class ScriptClock:
    """The fake clock a lifecycle script sets (``["clock", t]``). Rank r
    reads it skewed, at another rate and offset (``t * (1 + r / 2) + 100
    r``), as hosts' clocks differ: only a clock the ranks share keeps
    their deadline decisions alike. Rank 0 reads ``t``."""

    def __init__(self, rank: int = 0):
        self.t, self.rank = 0.0, rank

    def __call__(self) -> float:
        return self.t * (1 + 0.5 * self.rank) + 100.0 * self.rank


def plan_from_json(fault_plan, d: Dict):
    """A ``FaultPlan`` (either package's class) from a JSON-able dict with
    integer step keys as strings."""
    return fault_plan(
        seed=d.get("seed", 0), crash_steps=tuple(d.get("crash_steps", ())),
        latency_s={int(k): v for k, v in d.get("latency_s", {}).items()},
        nan_rows={int(k): v for k, v in d.get("nan_rows", {}).items()},
        page_squeeze={int(k): tuple(v) for k, v in
                      d.get("page_squeeze", {}).items()},
        crash_workers={int(k): tuple(v) for k, v in
                       d.get("crash_workers", {}).items()})


def run_lifecycle(eng, script, prompts, clock, emissions) -> Dict:
    """Runs a lifecycle script on ``eng`` (either package's engine, its
    ``on_token`` appending to ``emissions``): ops ["submit", prompt index,
    kwargs] (the rid, or the reject reason), ["step"], ["run"], ["clock",
    t] and ["cancel", rid] (its verdict). Releases the injector's page
    squeezes at the end. Returns what a run is compared by: the ops'
    results, every request's tokens, length, status, error and time
    stamps, the counters, the emissions in order, the free pages and the
    injector's counts and events."""
    ops = []
    for op, *a in script:
        if op == "submit":
            try:
                ops.append(eng.submit(prompts[a[0]], **a[1]))
            except Exception as e:    # either package's RejectedRequest
                if type(e).__name__ != "RejectedRequest":
                    raise
                ops.append(e.reason.value)
        elif op == "step":
            eng.step()
        elif op == "run":
            eng.run()
        elif op == "clock":
            clock.t = float(a[0])
        elif op == "cancel":
            ops.append(eng.cancel(a[0]))
        else:
            raise ValueError(f"unknown lifecycle op {op!r}")
    if eng.faults is not None:
        eng.faults.release_all(eng)
    return {
        "ops": ops,
        "requests": {str(rid): [list(map(int, r.tokens)), int(r.length),
                                r.status.value, r.error, r.submit_t,
                                r.first_token_t, r.done_t]
                     for rid, r in sorted(eng.finished.items())},
        "counters": [eng.failures, eng.recoveries, eng.shed, eng.expired,
                     eng.quarantined, eng.admit_rounds, eng.step_idx],
        "emissions": [list(map(int, e)) for e in emissions],
        "free_pages": eng.free_pages, "pending": bool(eng.pending),
        "injected": (None if eng.faults is None else
                     [eng.faults.counts,
                      [[int(t), str(e)] for t, e in eng.faults.events]])}


def _lifecycle_job(job, data, mesh, device, out_dir):
    """A lifecycle script (``run_lifecycle``) on ``ServeEngine(mesh=)``,
    every rank reading its own skewed ``ScriptClock``: the record, as JSON
    ("record"). ``engine_kw`` goes to the engine (``snapshot`` puts its
    snapshots under ``out_dir/<name>``, and the record then holds the
    newest snapshot's scheduler blob, "extra"); ``plan`` is the fault
    plan, ``plan_on_rank`` {rank: plan} another for those ranks (every
    rank must then raise: "error"); ``nan_logits`` [step, slot] makes
    that slot's decode logits NaN on the rank that holds the slot, at
    that step."""
    from repro_torch import bridge
    from repro_torch.models import lm
    from repro_torch.serving import FaultInjector, FaultPlan, ServeEngine
    cfg = cell_config(job["arch"], job.get("over"))
    rank = dist.get_rank()
    clock, emissions = ScriptClock(rank), []
    plan = job.get("plan_on_rank", {}).get(str(rank), job.get("plan"))
    kw = dict(job.get("engine_kw", {}))
    if job.get("snapshot"):
        kw["snapshot_dir"] = str(Path(out_dir) / job["name"])
    eng = ServeEngine(
        cfg, params=bridge.from_jax(_unflat(cfg, data, "params/"), cfg,
                                    device),
        max_seq=job["max_seq"], batch_size=job["slots"], chunk=job["chunk"],
        device=device, mesh=mesh, clock=clock,
        on_token=lambda *e: emissions.append(e),
        faults=(FaultInjector(plan_from_json(FaultPlan, plan))
                if plan else None), **kw)
    real = lm.decode_step
    if job.get("nan_logits"):
        at, slot = job["nan_logits"]

        def decode_step(*a, **k):
            logits, cache = real(*a, **k)
            n = logits.shape[0]
            start = (mesh.coords["data"] * n if n < job["slots"] else 0)
            if eng.step_idx == at and start <= slot < start + n:
                logits = logits.index_fill(
                    0, torch.tensor([slot - start]), float("nan"))
            return logits, cache

        lm.decode_step = decode_step
    try:
        rec = run_lifecycle(eng, job["script"],
                            json.loads(str(data["prompts"])), clock,
                            emissions)
    except RuntimeError as e:
        if "plan_on_rank" not in job:
            raise
        return _per_rank({"error": str(e)})
    finally:
        lm.decode_step = real
    if eng.ckpt is not None:
        rec["extra"] = eng.ckpt.load_extra()
    return _per_rank({"record": json.dumps(rec)})


def run_disagg(router, prompts, max_new: int, emissions,
               injectors=None) -> Dict:
    """Submits every prompt to ``router`` (either package's ``Router``,
    its ``on_token`` appending to ``emissions``) and runs it. Returns
    what a run is compared by: every request's tokens, length, status and
    error, the router's ``summary()`` without its seconds, the emissions
    in order and the injectors' counts."""
    rids = [router.submit(p, max_new=max_new) for p in prompts]
    router.run()
    return {
        "requests": {str(rid): [list(map(int, router.finished[rid].tokens)),
                                int(router.finished[rid].length),
                                router.finished[rid].status.value,
                                router.finished[rid].error]
                     for rid in rids},
        "summary": {k: v for k, v in router.summary().items()
                    if k not in ("prefill_s", "decode_s")},
        "emissions": [list(map(int, e)) for e in emissions],
        "injected": {f"{t[0]}{t[1]}": inj.counts
                     for t, inj in sorted((injectors or {}).items())}}


def _disagg_job(job, data, mesh, device, out_dir):
    """The disaggregated topology (``EngineConfig(disagg=True).build`` on
    the mesh: every worker on it) through ``run_disagg``, every rank on its
    own skewed ``ScriptClock``: the record, as JSON ("record"). ``ec``
    holds the ``EngineConfig`` fields; ``crash_workers`` ({step: [role,
    index]}) gives each worker its role-scoped injector over that plan;
    ``snapshot`` puts the workers' snapshots under ``out_dir/<name>``."""
    from repro_torch import bridge
    from repro_torch.serving import EngineConfig, FaultInjector, FaultPlan
    cfg = cell_config(job["arch"], job.get("over"))
    clock, emissions = ScriptClock(dist.get_rank()), []
    kw = dict(job["ec"])
    if job.get("snapshot"):
        kw["snapshot_dir"] = str(Path(out_dir) / job["name"])
    ec = EngineConfig(disagg=True, **kw)
    inj = None
    if job.get("crash_workers"):
        plan = plan_from_json(FaultPlan,
                              {"crash_workers": job["crash_workers"]})
        inj = {t: FaultInjector(plan, role=t) for t in ec.worker_targets()}
    router = ec.build(cfg, params=bridge.from_jax(
        _unflat(cfg, data, "params/"), cfg, device), mesh=mesh, clock=clock,
        on_token=lambda *e: emissions.append(e), faults=inj, device=device)
    rec = run_disagg(router, json.loads(str(data["prompts"])),
                     job["max_new"], emissions, inj)
    return _per_rank({"record": json.dumps(rec)})


def mesh_cells(layout, jobs: List[Dict], in_dir: str, out_dir: str) -> int:
    """Runs ``jobs`` on a (data, model) mesh of shape ``layout`` (every
    rank) and writes each job's results to ``out_dir/<name>.npz`` (rank
    0). A job: name, kind ("grad", "plan", "adamw", "roundtrip",
    "trainer", "cli", "compress", "elastic", and the serving kinds
    "decode", "chunk", "prefill", "engine", "lifecycle" and "disagg"),
    arch and ``over``
    (``cell_config``); "grad", "plan", "adamw" and the serving kinds read
    the one-rank weights ("params/<leaf>") and their inputs (batches
    "batch*/<key>", a cache "cache/<pos>/<entry>", prompts) from
    ``in_dir/<data>.npz``. Results
    are gathered into the one-rank layout. A serving job with a
    ``page_size`` runs the paged cache (block tables "tables"; the engine
    also takes ``n_pages`` and ``admit_k``). Gloo ranks: every tensor on
    the CPU."""
    device = "cpu"
    mesh = make_mesh(tuple(layout), ("data", "model"))
    for job in jobs:
        kind = job["kind"]
        if kind in ("grad", "plan", "adamw", "decode", "chunk", "prefill",
                    "engine"):
            data = np.load(Path(in_dir) / f"{job['data']}.npz")
            res = {"grad": _grad_job, "plan": _plan_job,
                   "adamw": _adamw_job, "decode": _serve_step_job,
                   "chunk": _serve_step_job, "prefill": _prefill_job,
                   "engine": _engine_job}[kind](job, data, mesh, device)
        elif kind in ("lifecycle", "disagg"):
            data = np.load(Path(in_dir) / f"{job['data']}.npz")
            res = {"lifecycle": _lifecycle_job, "disagg": _disagg_job}[
                kind](job, data, mesh, device, out_dir)
        elif kind in ("compress", "elastic"):
            data = np.load(Path(in_dir) / f"{job['data']}.npz")
            res = {"compress": _compress_job, "elastic": _elastic_job}[
                kind](job, data, mesh, device)
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
