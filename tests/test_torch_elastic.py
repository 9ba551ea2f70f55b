"""Elastic re-meshing (``Trainer.rescale``, ``reshard_state``) against the
JAX package's one-rank training.

One rank: ``tests/test_trainer.py``'s ``test_elastic_rescale_cpu_roundtrip``
in the port's terms (a mesh-less rescale keeps the state exact). Then one
spawn of 4 gloo ranks on a (1, 4) mesh running ``selftest._elastic_job``
on qwen2-moe-2.7b-smoke at ep 4 / 2 (8 experts, no-drop capacity), every
Trainer starting from JAX's one-rank weights:

(a) 2 steps on (1, 4); the state rescaled to (2, 2) and back, gathered
bitwise the original; rescaled to (2, 2), 2 steps; shrunk to (1, 2) on
ranks 0-1 (ranks 2 and 3 leave), 2 steps, and a checkpoint of the
(1, 2) mesh restored onto its shards bitwise. The six losses against JAX's
one-rank ``make_train_fn`` on the same batches (the Trainer's own
synthetic data) at loss rel 2e-5, the gathered state after steps 4 and 6
at 1e-4 per leaf (max abs over max |ref|; both packages at AdamW eps
1e-4, ROADMAP caveat 3), and the plan cache's entry for each layout's key
resolved in every MoE layer after each rescale.
(b) ``run`` after a rescale restores the checkpoint onto the (2, 2) shards
and a fault-hook replay restores a checkpoint written on (2, 2): the
steps and losses against the same JAX run.

The JAX reference is computed after the spawn.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.train_step import make_train_fn as jmake_train_fn
from repro.models import lm as JL
from repro.optim import adamw as jadamw
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import selftest as ST
from repro_torch.launch.specs import train_batch_specs
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "qwen2-moe-2.7b-smoke"
B, S = 4, 32
LOSS_REL, STEP_REL = 2e-5, 1e-4
LR, EPS = (1e-3, 2, 10), 1e-4
SPAWN_TIMEOUT = 300.0
OVER = {"moe": {"capacity_factor": 8.0, "ep": 0}}   # ep: the largest
# the plan cached for each layout's key (M, ep): (1, 4) and (2, 2) share
# M = 32 tokens a model group and differ in ep; (1, 2) has M = 64
PLANS = [((1, 4), dict(impl="comet", ring_group=2, n_col_blocks=2,
                       gemm_impl="xla")),
         ((2, 2), dict(impl="naive", ring_group=1, n_col_blocks=1,
                       gemm_impl="xla")),
         ((1, 2), dict(impl="comet", ring_group=1, n_col_blocks=4,
                       gemm_impl="xla"))]
N_MOE = 2                                  # a MoE every layer, 2 layers


def test_elastic_rescale_cpu_roundtrip():
    """mesh=None -> mesh=None rescale keeps the state exact."""
    with tempfile.TemporaryDirectory() as t:
        cfg = get_config(ARCH)
        shape = ShapeConfig("smoke", seq_len=32, global_batch=2,
                            kind="train")
        tr = Trainer(cfg, shape, None, TrainerConfig(
            ckpt_dir=t, ckpt_every=1000, log_every=1000), device="cpu")
        tr.run(2)
        state, step = tr.restore_or_init()
        state2 = tr.rescale(state, None)
        assert step == 2 and state2["step"] == 2 and tr.mesh is None
        for part in ("params", "opt"):
            a = list(_leaves(state[part]))
            b = list(_leaves(state2[part]))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert not isinstance(x, torch.Tensor) \
                    or y.device.type == "cpu"
                assert np.array_equal(np.asarray(x), np.asarray(y))


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    for _, t in tree_leaves(tree):
        yield t.detach() if isinstance(t, torch.Tensor) else t


def _jax_cfg():
    cfg = jax_config(ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, impl="naive"))


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batches(n):
    """The Trainer's batches for steps 0..n-1 (its synthetic data, seed
    0, the global batch)."""
    cfg = ST.cell_config(ARCH, OVER)
    shape = ShapeConfig("cell", S, B, "train")
    data = SyntheticLM(cfg, train_batch_specs(cfg, shape, 1), seed=0)
    return [data.batch_at(i) for i in range(n)]


def _jax_run(params, steps):
    """JAX's one-rank steps: per step the loss; the state after steps 4, 5
    and 6."""
    optim = jadamw.AdamW(lr=jadamw.cosine_schedule(*LR), eps=EPS)
    step = jax.jit(jmake_train_fn(_jax_cfg(), JAxisCtx(), optim, 1))
    state = {"params": params, "opt": optim.init(params),
             "step": jnp.zeros((), jnp.int32)}
    losses, states = [], {}
    for i, b in enumerate(_batches(steps)):
        state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(met["loss"]))
        if i + 1 in (4, 6):
            states[f"s{i + 1}"] = {"params": _flat(state["params"]),
                                   "m": _flat(state["opt"]["m"]),
                                   "v": _flat(state["opt"]["v"])}
    return np.array(losses), states


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One spawn of 4 gloo ranks, then JAX's 6 steps: (results, (losses,
    states))."""
    d = tmp_path_factory.mktemp("elastic")
    params = JL.init_params(_jax_cfg(), jax.random.PRNGKey(0))
    np.savez(d / "weights.npz",
             **{f"params/{k}": v for k, v in _flat(params).items()})
    job = dict(name="elastic", kind="elastic", data="weights", arch=ARCH,
               over=OVER, batch=B, seq=S, lr=LR, eps=EPS,
               cache=str(d / "plans.json"),
               plans=[[list(lay), p] for lay, p in PLANS])
    ST.spawn(4, ST.mesh_cells, ((1, 4), [job], str(d), str(d)),
             device="cpu", timeout=SPAWN_TIMEOUT)
    return np.load(d / "elastic.npz"), _jax_run(params, 6)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_rescale_there_and_back_gives_the_state_bitwise(run):
    assert bool(run[0]["a/roundtrip_same"])


def test_shrunk_mesh_checkpoint_restores_onto_its_shards(run):
    assert bool(run[0]["a/shrunk_restore_same"])


def test_losses_across_two_rescales_match_jax(run):
    got, (want, _) = run
    assert got["a/loss"].shape == (6,)
    np.testing.assert_allclose(got["a/loss"], want, rtol=LOSS_REL, atol=0)


@pytest.mark.parametrize("tag", ["s4", "s6"])
def test_state_after_rescale_matches_jax(run, tag):
    """s4: after 2 steps on (1, 4) and 2 on (2, 2); s6: after 2 more on
    the (1, 2) mesh of ranks 0-1."""
    got, (_, states) = run
    for part, leaves in states[tag].items():
        for k, v in leaves.items():
            e = _rel(got[f"a/{tag}/{part}/{k}"], v)
            assert e < STEP_REL, (tag, part, k, e)


def test_plan_cache_resolves_the_new_key_after_each_rescale(run):
    got, _ = run
    ran = {k: got[f"a/ran/{k}"].tolist() for k in
           ("impl", "ring_group", "n_col", "tokens")}
    want = {"impl": [], "ring_group": [], "n_col": [], "tokens": []}
    for (dp, mp), plan in PLANS:
        n = 2 * N_MOE                            # 2 steps, forward only
        want["impl"] += [plan["impl"]] * n
        want["ring_group"] += [plan["ring_group"]] * n
        want["n_col"] += [plan["n_col_blocks"]] * n
        want["tokens"] += [B * S // (dp * mp)] * n
    assert ran == want


def test_fault_replay_after_rescale_restores_onto_the_new_shards(run):
    got, (want, _) = run
    assert got["b/steps"].tolist() == [1, 2, 3, 4, 5, 5, 6]
    assert int(got["b/restarts"]) == 1
    loss = got["b/loss"]
    assert loss[4] == loss[5]                   # step 5, then its replay
    np.testing.assert_allclose(np.delete(loss, 5), want, rtol=LOSS_REL,
                               atol=0)
