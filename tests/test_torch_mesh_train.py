"""The model-level mesh train step on 4 gloo CPU ranks against the JAX
package's one-rank step (``lm.loss_fn`` with ``AxisCtx()``, ``jax.grad``,
``make_train_fn``), fp32.

Specs: every leaf's partition spec against the JAX package's
``decl_spec(decl, make_rules(fsdp), sizes)`` (no mesh needed), and
``gather_params(shard_params(full))`` bit for bit, on four smoke archs at
layouts (1, 4) and (2, 2), FSDP on and off.

Cells: the mesh ``loss_fn``'s loss, aux and every gradient leaf, gathered
into the one-rank layout, against JAX's on the bridged weights at the JAX
self-test's bounds (loss rel 2e-5, aux 1e-4 absolute, gradients rel 5e-5
per leaf, max abs over max |ref|). qwen2-moe-2.7b-smoke takes the
``heads`` case at mp 4 (and once with a shared expert), granite the
``qheads`` case with tied embeddings, jamba its SSM, MoE and attention
layers at one period (8 layers: at its 16, fp32 rounding alone moves a
gradient leaf of either package by up to 8e-4 of the leaf's largest
entry against an fp64 evaluation, so no fp32 pair meets 5e-5 there),
qwen2-0.5b the dense FFN and qkv bias; n_heads 6 / n_kv_heads 2 at mp 4
reaches ``seq``, and with ``pad_heads`` the padded heads. The naive and
comet transports (ring_group 1 and 2, two column blocks), sequence
sharding on and off, remat, layouts (1, 4), (2, 2) and (4, 1) (pure data
parallel: attention takes ``none``). The sequence-parallel residual
(``sp_residual``) on (1, 4) and (2, 2): qwen2-moe with the comet ring,
qwen2-0.5b, mamba2 and jamba at one period (once under remat), each
period carrying this rank's slice of the sequence, and a sequence of 30
at mp 4, which keeps the residual whole. The block-schedule IR
(``cfg.block_schedule``): a MoE cell at ep 4 and the sequence-parallel
residual on (2, 2), each in both emission orders, the same bits in both
and within the bounds of JAX's step. MoE capacity is the expert count (no
drop): capacity follows the local token count, so a mesh would drop
other tokens than one rank does (the JAX self-test makes the same
choice).

Steps: two AdamW steps with accum 1 and 2 through ``build_train_step``
on the mesh, the gathered params and moments after each against JAX's
at 1e-4 (max abs over max |ref|), every leaf's local shape as its spec
cuts it; a step whose gradient is non-finite on one rank only, which
every rank skips; ``Trainer.run`` on (2, 2) with a checkpoint and a
fault-hook replay; ``launch.train.main`` with ``--mesh 2,2
--distributed`` and with ``--mesh 1,4 --distributed`` with and without
``--sp-residual``; and ``selftest --case all``.

The ranks run ``selftest.mesh_cells``, one spawn per layout, on a thread
while this process computes the JAX references; weights and batches
cross through files.
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.train_step import make_train_fn as jmake_train_fn
from repro.models import lm as JL
from repro.optim import adamw as jadamw
from repro.parallel import sharding as JSH
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro_torch.launch import selftest as ST
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.parallel import sharding as SH

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 240.0          # seconds for one layout's 4 ranks
B, S = 4, 32
LOSS_REL, AUX_ABS, GRAD_REL = 2e-5, 1e-4, 5e-5
STEP_REL = 1e-4
# cosine_schedule(base, warmup, total), as test_torch_train.py holds the
# one-rank steps. Adam's first step divides each gradient entry by its own
# size: with eps 1e-8 an entry at the fp32 noise of either package (1e-6
# of its leaf's largest) steps by up to +-lr whatever its size, so the
# parameters lie further apart than the moments that set them (measured
# here with eps 1e-8: 1.3e-4 of attn/wo and 1.6e-4 of embed, the moments
# within 2e-6; between the one-rank port and JAX, 8.9e-4 at a base of
# 1e-2). Both packages take eps 1e-4 here, which keeps such entries'
# steps in proportion to them.
LR = (1e-3, 2, 10)
EPS = 1e-4

SPEC_ARCHS = ("qwen2-moe-2.7b-smoke", "granite-moe-3b-a800m-smoke",
              "jamba-v0.1-52b-smoke", "qwen2-0.5b-smoke")
LAYOUTS = {"dp1mp4": (1, 4), "dp2mp2": (2, 2), "dp4mp1": (4, 1)}


def _no_drop(arch, over=None):
    """``over`` with the MoE capacity factor set to the expert count."""
    over = dict(over or {})
    E = jax_config(arch).moe
    if E is not None:
        over["moe"] = {"capacity_factor": float(min(E.num_experts, 8)),
                       **over.get("moe", {})}
    return over


# reference problems: name -> (arch, the config's replacements)
REFS = {
    "qmoe": ("qwen2-moe-2.7b-smoke", _no_drop("qwen2-moe-2.7b-smoke")),
    "qmoe_shared": ("qwen2-moe-2.7b-smoke", _no_drop(
        "qwen2-moe-2.7b-smoke", {"moe": {"num_shared_experts": 1}})),
    "granite": ("granite-moe-3b-a800m-smoke",
                _no_drop("granite-moe-3b-a800m-smoke")),
    "jamba": ("jamba-v0.1-52b-smoke",
              _no_drop("jamba-v0.1-52b-smoke", {"n_layers": 8})),
    "q05b": ("qwen2-0.5b-smoke", {}),
    "gqa6": ("qwen2-0.5b-smoke", {"attn": {"n_heads": 6, "n_kv_heads": 2}}),
    "pad6": ("qwen2-0.5b-smoke", {"attn": {"n_heads": 6, "n_kv_heads": 2,
                                           "pad_heads": True}}),
    "mixtral": ("mixtral-8x7b-smoke", _no_drop("mixtral-8x7b-smoke")),
    "phi35": ("phi3.5-moe-smoke", _no_drop("phi3.5-moe-smoke")),
    "mamba2": ("mamba2-780m-smoke", {}),
    "q05b_s30": ("qwen2-0.5b-smoke", {}),
}
# the sequence length of a reference's batch, where it is not S: 30 is not
# a multiple of a model axis of 4
SEQ = {"q05b_s30": 30}
NAIVE = {"impl": "naive"}
COARSE = {"impl": "coarse"}
COMET1 = {"impl": "comet", "ring_group": 1, "n_col_blocks": 2}
COMET2 = {"impl": "comet", "ring_group": 2, "n_col_blocks": 2}
SPRES = {"sp_residual": True}


def _ep(knobs, ep):
    """``knobs`` at an expert-parallel group of ``ep`` ranks (etp the rest
    of the model axis)."""
    return {**knobs, "ep": ep}

# (layout, ref, moe replacements, seq_shard, other replacements, fsdp)
CELLS = {
    "dp1mp4-qmoe-naive-sp1": ("dp1mp4", "qmoe", NAIVE, True, {}, True),
    "dp1mp4-qmoe-naive-sp0": ("dp1mp4", "qmoe", NAIVE, False, {}, True),
    "dp1mp4-qmoe-comet1-sp1": ("dp1mp4", "qmoe", COMET1, True, {}, True),
    "dp1mp4-qmoe-comet2-sp0": ("dp1mp4", "qmoe", COMET2, False, {}, True),
    "dp1mp4-qmoe_shared-comet1-sp1": ("dp1mp4", "qmoe_shared", COMET1, True,
                                      {}, True),
    "dp1mp4-granite-comet2-sp1": ("dp1mp4", "granite", COMET2, True, {},
                                  True),
    "dp1mp4-granite-naive-sp0": ("dp1mp4", "granite", NAIVE, False, {},
                                 True),
    "dp1mp4-jamba-comet1-sp1": ("dp1mp4", "jamba", COMET1, True, {}, True),
    "dp1mp4-q05b": ("dp1mp4", "q05b", None, True, {}, True),
    "dp1mp4-gqa6-seq": ("dp1mp4", "gqa6", None, True, {}, True),
    "dp1mp4-pad6-heads": ("dp1mp4", "pad6", None, True, {}, True),
    "dp2mp2-qmoe-naive-sp1": ("dp2mp2", "qmoe", NAIVE, True, {}, True),
    "dp2mp2-qmoe-comet2-sp0": ("dp2mp2", "qmoe", COMET2, False, {}, True),
    "dp2mp2-qmoe-comet1-sp1-remat": ("dp2mp2", "qmoe", COMET1, True,
                                     {"remat": "full"}, True),
    "dp2mp2-qmoe-naive-sp1-nofsdp": ("dp2mp2", "qmoe", NAIVE, True, {},
                                     False),
    "dp2mp2-qmoe_shared-naive-sp0": ("dp2mp2", "qmoe_shared", NAIVE, False,
                                     {}, True),
    "dp2mp2-granite-comet1-sp1": ("dp2mp2", "granite", COMET1, True, {},
                                  True),
    "dp2mp2-jamba-naive-sp1": ("dp2mp2", "jamba", NAIVE, True, {}, True),
    "dp2mp2-q05b-nofsdp": ("dp2mp2", "q05b", None, True, {}, False),
    "dp2mp2-gqa6-heads": ("dp2mp2", "gqa6", None, True, {}, True),
    "dp4mp1-qmoe-comet1-sp1": ("dp4mp1", "qmoe", COMET1, True, {}, True),
    "dp4mp1-granite-naive-sp0": ("dp4mp1", "granite", NAIVE, False, {},
                                 True),
    # ep > 1: the ring and the all-to-alls cross ranks
    "dp1mp4-qmoe-ep4-naive-sp1": ("dp1mp4", "qmoe", _ep(NAIVE, 4), True, {},
                                  True),
    "dp1mp4-qmoe-ep4-coarse-sp1": ("dp1mp4", "qmoe", _ep(COARSE, 4), True,
                                   {}, True),
    "dp1mp4-qmoe-ep4-comet1-sp1": ("dp1mp4", "qmoe", _ep(COMET1, 4), True,
                                   {}, True),
    "dp1mp4-qmoe-ep4-comet2-sp0": ("dp1mp4", "qmoe", _ep(COMET2, 4), False,
                                   {}, True),
    "dp1mp4-qmoe-ep2etp2-comet1-sp1": ("dp1mp4", "qmoe", _ep(COMET1, 2),
                                       True, {}, True),
    "dp1mp4-qmoe-ep2etp2-naive-sp0": ("dp1mp4", "qmoe", _ep(NAIVE, 2),
                                      False, {}, True),
    "dp1mp4-qmoe_shared-ep4-comet1-sp1": ("dp1mp4", "qmoe_shared",
                                          _ep(COMET1, 4), True, {}, True),
    "dp1mp4-granite-ep4-comet2-sp1": ("dp1mp4", "granite", _ep(COMET2, 4),
                                      True, {}, True),
    "dp1mp4-mixtral-ep4-comet1-sp1": ("dp1mp4", "mixtral", _ep(COMET1, 4),
                                      True, {}, True),
    "dp1mp4-phi35-ep4-comet2-sp1": ("dp1mp4", "phi35", _ep(COMET2, 4), True,
                                    {}, True),
    "dp1mp4-mamba2": ("dp1mp4", "mamba2", None, True, {}, True),
    "dp2mp2-qmoe-ep2-comet1-sp1": ("dp2mp2", "qmoe", _ep(COMET1, 2), True,
                                   {}, True),
    "dp2mp2-qmoe-ep2-naive-sp0": ("dp2mp2", "qmoe", _ep(NAIVE, 2), False,
                                  {}, True),
    "dp2mp2-mamba2": ("dp2mp2", "mamba2", None, True, {}, True),
    # the sequence-parallel residual: the residual between blocks carried
    # as each model rank's slice of the sequence
    "dp1mp4-qmoe-comet1-sp1-spres": ("dp1mp4", "qmoe", COMET1, True, SPRES,
                                     True),
    "dp1mp4-qmoe-ep4-comet1-sp1-spres": ("dp1mp4", "qmoe", _ep(COMET1, 4),
                                         True, SPRES, True),
    "dp1mp4-qmoe-naive-sp0-spres": ("dp1mp4", "qmoe", NAIVE, False, SPRES,
                                    True),
    "dp1mp4-q05b-spres": ("dp1mp4", "q05b", None, True, SPRES, True),
    "dp1mp4-mamba2-spres": ("dp1mp4", "mamba2", None, True, SPRES, True),
    "dp1mp4-jamba-comet1-sp1-spres": ("dp1mp4", "jamba", COMET1, True,
                                      SPRES, True),
    "dp1mp4-q05b_s30-spres": ("dp1mp4", "q05b_s30", None, True, SPRES,
                              True),
    "dp2mp2-qmoe-comet1-sp1-spres": ("dp2mp2", "qmoe", COMET1, True, SPRES,
                                     True),
    "dp2mp2-q05b-spres": ("dp2mp2", "q05b", None, True, SPRES, True),
    "dp2mp2-mamba2-spres": ("dp2mp2", "mamba2", None, True, SPRES, True),
    "dp2mp2-jamba-comet1-sp1-spres-remat": ("dp2mp2", "jamba", COMET1, True,
                                            {**SPRES, "remat": "full"},
                                            True),
}
# the block-schedule IR on the mesh: scheduled twins of a MoE cell at
# ep 4 and of a sequence-parallel-residual cell (over dp 2, its leaves
# cut over the data axis), each in both emission orders
SCHED_BASES = ("dp1mp4-qmoe-ep4-comet1-sp1", "dp2mp2-qmoe-comet1-sp1-spres")
SCHED_MODES = ("sequential", "overlap")
CELLS.update({f"{b}-{m}": CELLS[b][:4] + ({**CELLS[b][4],
                                            "block_schedule": m},
                                           CELLS[b][5])
              for b in SCHED_BASES for m in SCHED_MODES})
SP_CELLS = [c for c in CELLS if CELLS[c][4].get("sp_residual")
            and not CELLS[c][4].get("block_schedule")]
# plan-cache cells at ep 4 (``selftest._plan_job``): the cache's plan for
# the cell's train key runs in place of the config's naive knobs, the
# flat ring's or the two-level ring's. name -> (plan, seq_shard)
PLAN_CELLS = {
    "dp1mp4-qmoe-ep4-plan": (dict(impl="comet", ring_group=2,
                                  n_col_blocks=2, gemm_impl="xla",
                                  fused_combine=True), True),
    "dp1mp4-qmoe-ep4-plan-hier": (dict(impl="comet_hier", ring_group=1,
                                       n_col_blocks=1, intra_group=2), True),
}
# AdamW runs: name -> (layout, accum, the rank whose gradient is made
# non-finite on a first step, or None, the expert-parallel group: 0 for
# the config's)
ADAMW = {"dp2mp2-accum1": ("dp2mp2", 1, None, 0),
         "dp2mp2-accum2": ("dp2mp2", 2, None, 0),
         "dp1mp4-accum1-nan": ("dp1mp4", 1, 2, 0),
         "dp1mp4-ep4-accum1": ("dp1mp4", 1, None, 4)}
TRAINER = dict(arch="qwen2-moe-2.7b-smoke", batch=4, seq=32, steps=5,
               ckpt_every=2, fail_at=3)


def _cell_over(ref, moe, other):
    over = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in REFS[ref][1].items()}
    if moe:
        over["moe"] = {**over.get("moe", {}), **moe}
    over.update(other)
    return over


def _jax_cfg(arch, over):
    cfg = jax_config(arch)
    over = dict(over)
    for key in ("moe", "attn"):
        if key in over:
            cfg = dataclasses.replace(cfg, **{key: dataclasses.replace(
                getattr(cfg, key), **over.pop(key))})
    return dataclasses.replace(cfg, **over)


def _ref_cfg(ref):
    arch, over = REFS[ref]
    over = dict(over)
    if "moe" in over:
        over["moe"] = {**over["moe"], "impl": "naive"}
    return _jax_cfg(arch, over)


def _tokens(rng, shape, V):
    toks = rng.integers(0, V, shape).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[..., -1] = -1
    return toks, labels


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(t)
            for p, t in tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           tree))}


def _inputs(in_dir):
    """The JAX one-rank weights and the batches of every reference, as
    npz files for the ranks; returns {ref: (params, batches)}."""
    out = {}
    for i, ref in enumerate(REFS):
        cfg = _ref_cfg(ref)
        params = JL.init_params(cfg, jax.random.PRNGKey(i))
        rng = np.random.default_rng(100 + i)
        batches = {"batch": _tokens(rng, (B, SEQ.get(ref, S)),
                                    cfg.vocab_size)}
        if ref == "qmoe":
            for a in (1, 2):
                for j in range(2):
                    shape = (B, S) if a == 1 else (a, B // a, S)
                    batches[f"a{a}batch{j}"] = _tokens(rng, shape,
                                                       cfg.vocab_size)
        arrays = {f"params/{k}": v for k, v in _flat(params).items()}
        for name, (t, lab) in batches.items():
            arrays[f"{name}/tokens"], arrays[f"{name}/labels"] = t, lab
        np.savez(Path(in_dir) / f"{ref}.npz", **arrays)
        if ref == "qmoe":
            for a in (1, 2):
                sub = {k: v for k, v in arrays.items()
                       if k.startswith("params/")}
                for j in range(2):
                    for key in ("tokens", "labels"):
                        sub[f"batch{j}/{key}"] = arrays[
                            f"a{a}batch{j}/{key}"]
                np.savez(Path(in_dir) / f"qmoe_accum{a}.npz", **sub)
        out[ref] = (params, batches)
    return out


def _jobs(layout, in_dir, ckpt_dir):
    jobs = []
    for name, (lay, ref, moe, seq, other, fsdp) in CELLS.items():
        if lay == layout:
            jobs.append(dict(name=name, kind="grad", arch=REFS[ref][0],
                             over=_cell_over(ref, moe, other), data=ref,
                             seq_shard=seq, fsdp=fsdp))
    for name, (plan, seq) in PLAN_CELLS.items():
        if name.startswith(layout):
            jobs.append(dict(name=name, kind="plan", arch=REFS["qmoe"][0],
                             over=_cell_over("qmoe", _ep(NAIVE, 4), {}),
                             data="qmoe", seq_shard=seq, plan=plan,
                             cache=str(Path(in_dir) / f"{name}.json")))
    for name, (lay, accum, nan_rank, ep) in ADAMW.items():
        if lay == layout:
            moe = _ep(COMET1, ep) if ep else COMET1
            jobs.append(dict(name=name, kind="adamw",
                             arch=REFS["qmoe"][0],
                             over=_cell_over("qmoe", moe, {}),
                             data=f"qmoe_accum{accum}", accum=accum,
                             lr=LR, eps=EPS, nan_rank=nan_rank))
    if layout in ("dp1mp4", "dp2mp2"):
        for arch in SPEC_ARCHS:
            for fsdp in (True, False):
                jobs.append(dict(name=f"rt-{arch}-{int(fsdp)}",
                                 kind="roundtrip", arch=arch, fsdp=fsdp))
    if layout == "dp2mp2":
        jobs.append(dict(name="trainer", kind="trainer",
                         over=_no_drop(TRAINER["arch"]), **TRAINER))
        jobs.append(dict(name="cli", kind="cli", argv=[
            "--arch", "qwen2-moe-2.7b-smoke", "--mesh", "2,2",
            "--distributed", "--steps", "2", "--batch", "4", "--seq",
            "32", "--ckpt-dir", str(ckpt_dir)]))
    if layout == "dp1mp4":
        for name, extra in (("cli-mp4", []), ("cli-mp4-spres",
                                              ["--sp-residual"])):
            jobs.append(dict(name=name, kind="cli", argv=[
                "--arch", "qwen2-moe-2.7b-smoke", "--mesh", "1,4",
                "--distributed", "--steps", "2", "--batch", "4", "--seq",
                "32", "--ckpt-dir", str(ckpt_dir / name)] + extra))
    return jobs


def _jax_grads(ref, params, batch):
    cfg = _ref_cfg(ref)
    tok, lab = batch
    b = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    (loss, met), g = jax.jit(jax.value_and_grad(
        lambda p: JL.loss_fn(cfg, p, b, JAxisCtx()), has_aux=True))(params)
    return {"loss": float(loss), "aux": float(met["aux"]),
            "grads": _flat(g)}


def _jax_steps(params, batches, accum):
    """Two AdamW steps of JAX's one-rank make_train_fn: per step the
    params and moments."""
    cfg = _ref_cfg("qmoe")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, **{k: v for k, v in COMET1.items()}))
    optim = jadamw.AdamW(lr=jadamw.cosine_schedule(*LR), eps=EPS)
    step = jax.jit(jmake_train_fn(cfg, JAxisCtx(), optim, accum))
    state = {"params": params, "opt": optim.init(params),
             "step": jnp.zeros((), jnp.int32)}
    out = []
    for j in range(2):
        tok, lab = batches[f"a{accum}batch{j}"]
        state, met = step(state, {"tokens": jnp.asarray(tok),
                                  "labels": jnp.asarray(lab)})
        out.append({"loss": float(met["loss"]),
                    "params": _flat(state["params"]),
                    "m": _flat(state["opt"]["m"]),
                    "v": _flat(state["opt"]["v"])})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawns the three layouts on a thread, computes the JAX references
    meanwhile; returns (layout -> out dir, references)."""
    in_dir = tmp_path_factory.mktemp("in")
    inputs = _inputs(in_dir)
    outs = {lay: tmp_path_factory.mktemp(lay) for lay in LAYOUTS}
    ckpt = tmp_path_factory.mktemp("cli_ckpt")
    errors = []

    def spawn_all():
        try:
            for lay, shape in LAYOUTS.items():
                ST.spawn(4, ST.mesh_cells,
                         (shape, _jobs(lay, in_dir, ckpt), str(in_dir),
                          str(outs[lay])), device="cpu",
                         timeout=SPAWN_TIMEOUT)
        except BaseException as e:        # re-raised in the test process
            errors.append(e)

    th = threading.Thread(target=spawn_all)
    th.start()
    refs = {"grads": {ref: _jax_grads(ref, params, batches["batch"])
                      for ref, (params, batches) in inputs.items()},
            "steps": {a: _jax_steps(*inputs["qmoe"], a) for a in (1, 2)}}
    th.join()
    if errors:
        raise errors[0]
    return outs, refs


def _load(run, layout, name):
    outs, _ = run
    return np.load(outs[layout] / f"{name}.npz")


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# ---------------------------------------------------------------------------
# specs (no ranks)
# ---------------------------------------------------------------------------


class _StubMesh:
    """Just a mesh's axis sizes: enough for ``make_ctx`` and the schemas
    in both packages."""

    def __init__(self, shape):
        self.shape = shape

    def model_subgroups(self, model_axis, etp):
        return None, None


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("layout", ["dp1mp4", "dp2mp2"])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_specs_match_jax(arch, layout, fsdp):
    from repro_torch.configs import get_config
    sizes = dict(zip(("data", "model"), LAYOUTS[layout]))
    jcfg, cfg = jax_config(arch), get_config(arch)
    jctx = JSH.make_ctx(jcfg, _StubMesh(sizes))
    ctx = SH.make_ctx(cfg, _StubMesh(sizes))
    assert (ctx.ep, ctx.etp) == (jctx.ep, jctx.etp)
    rules = JSH.make_rules(fsdp)
    jschema = dict(tree_leaves(JL.model_schema(jcfg, jctx)))
    specs = dict(tree_leaves(SH.param_specs(lm.model_schema(cfg, ctx),
                                            sizes, fsdp)))
    assert set(specs) == set(jschema)
    for path, spec in specs.items():
        want = tuple(JSH.decl_spec(jschema[path], rules, sizes))
        assert spec == want, (path, spec, want)
    assert any("model" in sp.axes() for sp in specs.values())
    assert fsdp == any("data" in sp.axes() for sp in specs.values())


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("layout", ["dp1mp4", "dp2mp2"])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_shard_then_gather_is_the_tree(run, arch, layout, fsdp):
    same = _load(run, layout, f"rt-{arch}-{int(fsdp)}")["same"]
    assert same.tolist() == [True] * 4


# ---------------------------------------------------------------------------
# loss and gradients against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS))
def test_loss_and_grads_match_jax(run, cell):
    layout, ref = CELLS[cell][:2]
    got = _load(run, layout, cell)
    want = run[1]["grads"][ref]
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_REL * abs(
        want["loss"]), (float(got["loss"]), want["loss"])
    assert abs(float(got["aux"]) - want["aux"]) < AUX_ABS
    errs = {k: _rel(got["grad/" + k], v) for k, v in want["grads"].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_REL, (worst, errs[worst])


def test_cells_reach_every_attention_case():
    """The cells' configs at their layouts take every attention case and
    both padded and unpadded heads."""
    from repro_torch.models.blocks import attn_case
    cases = set()
    for layout, ref, moe, seq, other, _ in CELLS.values():
        cfg = ST.cell_config(REFS[ref][0], _cell_over(ref, moe, other))
        if cfg.attn is None:              # mamba2: no attention layer
            continue
        a, m = cfg.attn, LAYOUTS[layout][1]
        padded = a.pad_heads and m > 1 and (a.n_heads % m or
                                            a.n_kv_heads % m)
        cases.add("padded" if padded else attn_case(
            SH.make_ctx(cfg, _StubMesh(dict(zip(("data", "model"),
                                                LAYOUTS[layout])))), a, S))
    assert cases == {"heads", "qheads", "seq", "none", "padded"}


# ---------------------------------------------------------------------------
# AdamW steps, the non-finite guard, the Trainer and the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ADAMW))
def test_adamw_steps_match_jax(run, name):
    layout, accum = ADAMW[name][:2]
    got = _load(run, layout, name)
    for j, want in enumerate(run[1]["steps"][accum]):
        assert abs(float(got[f"step{j}/loss"]) - want["loss"]) <= \
            LOSS_REL * abs(want["loss"])
        assert got[f"step{j}/skipped"].tolist() == [0] * 4
        for part in ("params", "m", "v"):
            for k, v in want[part].items():
                e = _rel(got[f"step{j}/{part}/{k}"], v)
                assert e < STEP_REL, (j, part, k, e)


@pytest.mark.parametrize("name", list(ADAMW))
def test_state_is_stored_as_the_specs_cut_it(run, name):
    layout = ADAMW[name][0]
    got = _load(run, layout, name)
    keys = [k for k in got.files if k.startswith("shape/")]
    assert {k.split("/")[1] for k in keys} == {"params", "m", "v"}
    for k in keys:
        local, want = got[k].tolist()
        assert local == want, k
    # the packed experts (n_periods, W, E_loc, d, f): one entry of W here
    experts = [k for k in keys if "experts/w_up" in k]
    assert len(experts) == 3 and all(got[k][0][1] == 1 for k in experts)


def test_plan_cache_cell_runs_the_cached_plan(run):
    """At ep 4 the cached plan (comet, ring_group 2, two column blocks,
    fused combine) runs in every MoE layer in place of the config's naive
    knobs, keyed by the JAX package's local token count, and the loss and
    gradients still match JAX's one-rank step."""
    name = "dp1mp4-qmoe-ep4-plan"
    got = _load(run, "dp1mp4", name)
    plan = PLAN_CELLS[name][0]
    n_moe = 2                          # qwen2-moe smoke: a MoE every layer
    assert got["ran/impl"].tolist() == [plan["impl"]] * n_moe
    assert got["ran/ring_group"].tolist() == [plan["ring_group"]] * n_moe
    assert got["ran/n_col"].tolist() == [plan["n_col_blocks"]] * n_moe
    assert got["ran/gemm_impl"].tolist() == [plan["gemm_impl"]] * n_moe
    assert got["ran/fused_combine"].tolist() == [1] * n_moe
    # sequence sharded over the 4 model ranks: B * S / 4 tokens each
    assert int(got["key_tokens"]) == B * S // 4
    assert got["ran/tokens"].tolist() == [B * S // 4] * n_moe
    want = run[1]["grads"]["qmoe"]
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_REL * abs(
        want["loss"])
    assert abs(float(got["aux"]) - want["aux"]) < AUX_ABS
    errs = {k: _rel(got["grad/" + k], v) for k, v in want["grads"].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_REL, (worst, errs[worst])


def test_ranked_comet_hier_plan_runs_and_matches_jax(run):
    """A cached comet_hier plan (two groups a node) runs the two-level
    ring in every MoE layer at ep 4, and the loss and gradients match
    JAX's one-rank step."""
    name = "dp1mp4-qmoe-ep4-plan-hier"
    got = _load(run, "dp1mp4", name)
    plan = PLAN_CELLS[name][0]
    assert got["ran/impl"].tolist() == ["comet_hier"] * 2
    assert got["ran/intra_group"].tolist() == [plan["intra_group"]] * 2
    assert got["ran/tokens"].tolist() == [B * S // 4] * 2
    want = run[1]["grads"]["qmoe"]
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_REL * abs(
        want["loss"])
    assert abs(float(got["aux"]) - want["aux"]) < AUX_ABS
    errs = {k: _rel(got["grad/" + k], v) for k, v in want["grads"].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_REL, (worst, errs[worst])


@pytest.mark.parametrize("cell", SP_CELLS)
def test_sp_residual_carries_the_sequence_slice(run, cell):
    """Under the sequence-parallel residual every period takes this rank's
    slice of the sequence, (B / dp, S / mp, d): the residual's bytes per
    rank fall by the model axis. A sequence the axis does not divide
    keeps the whole residual, as the JAX package does."""
    layout, ref = CELLS[cell][:2]
    dp, mp = LAYOUTS[layout]
    cfg = _ref_cfg(ref)
    seq = SEQ.get(ref, S)
    got = _load(run, layout, cell)
    split = seq % mp == 0
    assert bool(got["sp_split"]) == split
    # each period once, and once more in the remat recompute
    calls = cfg.n_layers // JL.period_of(cfg) * (
        2 if CELLS[cell][4].get("remat") == "full" else 1)
    want = [B // dp, seq // mp if split else seq, cfg.d_model]
    assert got["carried"].tolist() == [want] * calls


@pytest.mark.parametrize("base", SCHED_BASES)
def test_scheduled_orders_give_the_same_bits(run, base):
    """The scheduled forward on the mesh: ``sequential`` and ``overlap``
    give the same loss, aux and gradient bits (gathered from every rank's
    shard), no period runs through the period-at-a-time body, and the
    sequence-parallel residual is carried as the unscheduled cell carries
    it; each lies within the mesh step's bounds of JAX's one-rank step
    (``test_loss_and_grads_match_jax``)."""
    layout = CELLS[base][0]
    seq, ovl = (_load(run, layout, f"{base}-{m}") for m in SCHED_MODES)
    plain = _load(run, layout, base)
    assert seq.files == ovl.files
    for k in seq.files:
        assert np.array_equal(seq[k], ovl[k]), k
    assert seq["carried"].size == 0
    assert bool(seq["sp_split"]) == bool(plain["sp_split"])


def test_train_cli_sp_residual_on_a_1x4_mesh(run):
    """``--sp-residual --mesh 1,4 --distributed`` trains, and its losses
    are those of the same run with the residual whole."""
    sp = _load(run, "dp1mp4", "cli-mp4-spres")
    whole = _load(run, "dp1mp4", "cli-mp4")
    assert int(sp["final_step"]) == 2 and np.isfinite(sp["losses"]).all()
    np.testing.assert_allclose(sp["losses"], whole["losses"], rtol=LOSS_REL)


def test_nonfinite_gradient_on_one_rank_is_skipped_on_every_rank(run):
    got = _load(run, "dp1mp4", "dp1mp4-accum1-nan")
    assert got["nan/skipped"].tolist() == [1] * 4
    assert bool(got["nan/unchanged"])
    assert not np.isfinite(float(got["nan/grad_norm"]))
    assert got["step0/skipped"].tolist() == [0] * 4


def test_trainer_replays_from_a_sharded_checkpoint(run):
    got = _load(run, "dp2mp2", "trainer")
    clean, replay = got["clean/losses"], got["replay/losses"]
    n, f = TRAINER["steps"], TRAINER["fail_at"]
    assert int(got["clean/restarts"]) == 0 and len(clean) == n
    # steps 1..f, then the restore from the last checkpoint and its replay
    last_ckpt = f - f % TRAINER["ckpt_every"] if f % TRAINER["ckpt_every"] \
        else f
    assert int(got["replay/restarts"]) == 1
    assert got["replay/steps"].tolist() == (list(range(1, f + 1))
                                            + list(range(last_ckpt + 1,
                                                         n + 1)))
    np.testing.assert_allclose(replay[:f], clean[:f], rtol=1e-6)
    np.testing.assert_allclose(replay[f:], clean[last_ckpt:], rtol=1e-6)
    assert np.isfinite(clean).all()


def test_train_cli_runs_on_a_2x2_mesh_under_distributed(run):
    got = _load(run, "dp2mp2", "cli")
    assert int(got["final_step"]) == 2
    assert np.isfinite(got["losses"]).all() and len(got["losses"]) == 2


def test_train_cli_mesh_needs_a_process_group(tmp_path):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="process group"):
        train.main(["--arch", "qwen2-moe-2.7b-smoke", "--mesh", "2,2",
                    "--ckpt-dir", str(tmp_path)], device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--arch", "qwen2-moe-2.7b-smoke", "--distributed",
                    "--ckpt-dir", str(tmp_path)], device="cpu")


def test_selftest_case_all_passes_on_4_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.selftest", "--device",
         "cpu", "--ranks", "4", "--case", "all", "--timeout", "240"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    train = [ln for ln in lines if "mesh_" in ln]
    assert len(lines) == 57 + 4 and len(train) == 4
    assert all(ln.startswith("[PASS]") for ln in lines)
    assert "OK: 0 failed in all" in proc.stdout
