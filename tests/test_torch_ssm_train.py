"""The port's training path on mamba2-780m-smoke (the SSM family) against
the JAX package, with weights carried by ``bridge.from_jax``: ``loss_fn``
and every gradient (remat none and full), three train steps (losses, grad
norms and parameters), and the padded forward with a mask; fp32 1e-4. The
training CLI runs the family on the CPU when asked (serving:
``test_torch_ssm_serve.py``)."""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.launch.train_step import build_train_step as jbuild
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.train_step import build_train_step
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ARCH = "mamba2-780m-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)


def _bridged(seed, **kw):
    jcfg = dataclasses.replace(jax_config(ARCH), **kw)
    cfg = dataclasses.replace(get_config(ARCH), **kw)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, bridge.from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def _torch_batch(nb):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in nb.items()}


def test_bridge_carries_the_ssm_leaves():
    jcfg, cfg, jp, tp = _bridged(0)
    ssm = tp["layers"][0]["ssm"]
    assert sorted(ssm) == ["A_log", "D", "conv_b", "conv_w", "dt_bias",
                           "in_proj", "norm_scale", "out_proj"]
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    schema = dict(tree_leaves(lm.model_schema(cfg)))
    for path, t in tree_leaves(tp):
        assert tuple(t.shape) == schema[path].shape, path
        np.testing.assert_array_equal(t.numpy(), want[path])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(remat):
    jcfg, cfg, jp, tp = _bridged(3, remat=remat)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels[0, 5] = labels[1, 31] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    for _, t in tree_leaves(tp):
        t.requires_grad_(True)
    loss, met = lm.loss_fn(cfg, tp, _torch_batch({"tokens": toks,
                                                  "labels": labels}))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert float(met["aux"]) == float(jm["aux"]) == 0.0
    want = dict(tree_leaves(jax.tree.map(np.asarray, jg)))
    for path, t in tree_leaves(tp):
        np.testing.assert_allclose(t.grad.numpy(), want[path],
                                   err_msg=str(path), **TOL)


def test_three_train_steps_match_jax():
    jcfg, cfg, jp, tp = _bridged(1)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 10))
    topt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 10))
    jb = jbuild(jcfg, JShape("t", 32, 4, "train"), None, jopt, accum=2)
    tb = build_train_step(cfg, ShapeConfig("t", 32, 4, "train"), None, topt,
                          accum=2)
    p0 = {path: t.clone() for path, t in tree_leaves(tp)}
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": topt.init(tp), "step": 0}
    jdata = JSyntheticLM(jcfg, jb["batch_structs"], seed=0)
    tdata = SyntheticLM(cfg, tb["batch_structs"], seed=0)
    jfn = jax.jit(jb["fn"])
    for s in range(3):
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, jdata.batch_at(s)))
        tstate, tm = tb["fn"](tstate, _torch_batch(tdata.batch_at(s)))
        assert tm["skipped"] == int(jm["skipped"]) == 0
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = dict(tree_leaves(jax.tree.map(np.asarray, jstate["params"])))
    for path, t in tree_leaves(tstate["params"]):
        got = t.detach().numpy()
        np.testing.assert_allclose(got, want[path], err_msg=str(path), **TOL)
        d_want = want[path] - p0[path].numpy()
        if np.abs(d_want).max() > 0:
            d_got = got - p0[path].numpy()
            assert (np.linalg.norm(d_got - d_want)
                    <= 1e-3 * np.linalg.norm(d_want)), path


def test_padded_forward_matches_jax():
    """Left-padded rows: pad steps are identities of the SSM scan, so the
    padded forward is exact; the final hidden states of lm.forward
    against JAX on every position."""
    jcfg, cfg, jp, tp = _bridged(2)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (3, 36)).astype(np.int32)
    mask = np.ones((3, 36), bool)
    mask[0, :9] = False
    mask[2, :20] = False
    jh, jaux, _ = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks),
                                         "mask": jnp.asarray(mask)})
    th, taux, _ = lm.forward(cfg, tp, {"tokens": torch.from_numpy(toks)
                                       .long(),
                                       "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert float(taux) == float(jaux) == 0.0


def test_train_cli_runs_the_ssm_family(monkeypatch):
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as t:
        out = train.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                          "--seq", "32", "--impl", "comet",
                          "--ckpt-dir", t], device="cpu")
        assert out["final_step"] == 2 and out["nan_skips"] == 0
        assert all(np.isfinite(m["loss"]) for m in out["metrics"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(get_config(ARCH), ShapeConfig("t", 32, 2, "train"),
                    None, TrainerConfig(ckpt_dir=t))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", ARCH, "--steps", "1", "--ckpt-dir", t])
