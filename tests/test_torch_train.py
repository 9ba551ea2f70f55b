"""The port's one-rank training path against the JAX package on
qwen2-moe-2.7b-smoke: synthetic batches (bit-identical), ``loss_fn`` and
every gradient (xla and pallas_fused backends, remat none and full; fp32
1e-4; and, at their smoke configs, phi3.5-moe, qwen3-moe, phi3-medium,
nemotron-4, qwen1.5-4b, llava-next-34b, mixtral and whisper-small, the
encoder-decoder, its frames beside the tokens), one AdamW update (fp32
and bf16 parameters), three train steps from
the same weights, and the port's Trainer (restart replay, non-finite skip,
device choice). Weights cross through ``bridge.from_jax``; the JAX Pallas
kernels run in interpret mode."""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.launch import specs as JSP
from repro.launch.train_step import build_train_step as jbuild
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data.synthetic import Prefetcher, SyntheticLM
from repro_torch.launch import specs as SP
from repro_torch.launch.train_step import build_train_step
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ARCH = "qwen2-moe-2.7b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")


def _cfgs(**kw):
    moe_kw = {k: kw.pop(k) for k in ("gemm_impl",) if k in kw}
    out = []
    for c in (jax_config(ARCH), get_config(ARCH)):
        c = dataclasses.replace(c, **kw)
        out.append(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, **moe_kw)))
    return out


def _bridged(jcfg, cfg, seed):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, bridge.from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _torch_batch(nb):
    """Integer entries as int64; float ones (an encoder-decoder's frames)
    as they are."""
    return {k: torch.from_numpy(v) if v.dtype.kind == "f"
            else torch.from_numpy(v).long() for k, v in nb.items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_synthetic_batches_are_bit_identical(accum):
    jcfg, cfg = _cfgs()
    js = JSP.train_batch_specs(jcfg, JShape("t", 24, 4, "train"), accum)[0]
    ts = SP.train_batch_specs(cfg, ShapeConfig("t", 24, 4, "train"), accum)
    assert {k: tuple(v.shape) for k, v in js.items()} == ts
    for seed, step in ((0, 0), (3, 7)):
        want = JSyntheticLM(jcfg, js, seed=seed).batch_at(step)
        got = SyntheticLM(cfg, ts, seed=seed).batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_yields_the_batches_in_order():
    cfg = get_config(ARCH)
    src = SyntheticLM(cfg, SP.train_batch_specs(cfg, SHAPE, 1), seed=5)
    pf = Prefetcher(src, start_step=3)
    try:
        for want_step in (3, 4, 5):
            step, batch = pf.next()
            assert step == want_step
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(step)["tokens"])
    finally:
        pf.close()
    assert not pf.thread.is_alive()


# the archs held at one rank beside ARCH (ROADMAP Queue 1 item 2), each
# at its smoke config
ARCHS = ("phi3.5-moe-smoke", "qwen3-moe-235b-a22b-smoke",
         "phi3-medium-14b-smoke", "nemotron-4-340b-smoke", "qwen1.5-4b-smoke",
         "llava-next-34b-smoke", "mixtral-8x7b-smoke", "whisper-small-smoke")


@pytest.mark.parametrize("gemm_impl", ["xla", "pallas_fused"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(gemm_impl, remat):
    _check_loss_and_grads(*_cfgs(remat=remat, gemm_impl=gemm_impl))


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_loss_and_grads_match_jax(arch):
    """``loss_fn`` and every gradient of each arch's smoke config against
    the JAX package's, fp32 1e-4."""
    _check_loss_and_grads(jax_config(arch), get_config(arch))


def _check_loss_and_grads(jcfg, cfg):
    jp, tp = _bridged(jcfg, cfg, 3)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels[0, 3] = labels[1, 15] = -1                   # ignored labels
    arrs = {"tokens": toks, "labels": labels}
    if cfg.n_enc_layers:                  # whisper: 24 frames of d_model
        arrs["frames"] = (rng.standard_normal((2, 24, cfg.d_model))
                          * 0.02).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrs.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    for _, t in tree_leaves(tp):
        t.requires_grad_(True)
    loss, met = lm.loss_fn(cfg, tp, _torch_batch(arrs))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(met["aux"].item(), float(jm["aux"]),
                               rtol=1e-5)
    assert float(met["tokens"]) == float(jm["tokens"]) == 30
    want = dict(tree_leaves(jax.tree.map(np.asarray, jg)))
    for path, t in tree_leaves(tp):
        np.testing.assert_allclose(t.grad.numpy(), want[path],
                                   err_msg=str(path), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 7), "b": [(3,), (2, 2, 4)]}
    p = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
         "b": [rng.standard_normal(s).astype(np.float32)
               for s in shapes["b"]]}
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 3, p)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-2, 2, 10))
    topt = adamw.AdamW(lr=adamw.cosine_schedule(1e-2, 2, 10))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), p)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(2):                  # bias correction at count 1 and 2
        jp, jstate, jst = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      jp)
        tp, tstate, tst = topt.update(
            jax.tree.map(torch.from_numpy, g), tstate, tp)
    assert tstate["count"] == int(jstate["count"]) == 2
    np.testing.assert_allclose(float(tst["grad_norm"]),
                               float(jst["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tst["lr"], float(jst["lr"]), rtol=1e-6)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else TOL
    for tree_t, tree_j in ((tp, jp), (tstate["m"], jstate["m"]),
                           (tstate["v"], jstate["v"])):
        want = dict(tree_leaves(jax.tree.map(
            lambda a: np.asarray(a, np.float32), tree_j)))
        for path, t in tree_leaves(tree_t):
            assert t.dtype == (tdt if tree_t is tp else torch.float32)
            np.testing.assert_allclose(t.float().numpy(), want[path],
                                       err_msg=str(path), **tol)


@pytest.mark.parametrize("gemm_impl", ["xla", "pallas_fused"])
def test_three_train_steps_match_jax(gemm_impl):
    """Steps 1-3 from the same weights (accum 2: grad accumulation), lr
    1e-3: losses, grad norms and the parameters after the third step."""
    jcfg, cfg = _cfgs(gemm_impl=gemm_impl)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 10))
    topt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 10))
    jb = jbuild(jcfg, JShape("t", 16, 4, "train"), None, jopt, accum=2)
    tb = build_train_step(cfg, ShapeConfig("t", 16, 4, "train"), None, topt,
                          accum=2)
    jp, tp = _bridged(jcfg, cfg, 1)
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
    assert tstate["step"] == int(jstate["step"]) == 3
    want = dict(tree_leaves(jax.tree.map(np.asarray, jstate["params"])))
    for path, t in tree_leaves(tstate["params"]):
        got = t.detach().numpy()
        np.testing.assert_allclose(got, want[path], err_msg=str(path), **TOL)
        # the three updates themselves, not only the weights they moved
        d_want = want[path] - p0[path].numpy()
        if np.abs(d_want).max() > 0:
            d_got = got - p0[path].numpy()
            assert (np.linalg.norm(d_got - d_want)
                    <= 1e-3 * np.linalg.norm(d_want)), path


def _trainer(tmp, **kw):
    tcfg = TrainerConfig(ckpt_dir=tmp, ckpt_every=2, log_every=1000, keep=2,
                         **kw)
    return Trainer(get_config(ARCH), SHAPE, None, tcfg, device="cpu")


def _losses(out):
    return [m["loss"] for m in out["metrics"]]


def test_trainer_restart_is_bit_identical():
    """6 steps straight against 4 steps + a new trainer resuming to 6: the
    same losses and the same final weights, bit for bit."""
    with tempfile.TemporaryDirectory() as t1, \
            tempfile.TemporaryDirectory() as t2:
        out_a = _trainer(t1).run(6)
        _trainer(t2).run(4)
        tr_b = _trainer(t2)                 # a fresh trainer: restore path
        out_b = tr_b.run(6)
        assert _losses(out_a)[4:] == _losses(out_b)[-2:]
        sa, step_a = _trainer(t1).restore_or_init()
        sb, step_b = tr_b.restore_or_init()
        assert step_a == step_b == 6 and sa["step"] == sb["step"] == 6
        assert sa["opt"]["count"] == sb["opt"]["count"] == 6
        for (pa, a), (pb, b) in zip(tree_leaves(sa), tree_leaves(sb)):
            assert pa == pb
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), pa
        assert sorted(os.listdir(t2)) == ["step_00000004", "step_00000006"]


def test_trainer_fault_hook_replays_from_checkpoint():
    with tempfile.TemporaryDirectory() as t1, \
            tempfile.TemporaryDirectory() as t2:
        clean = _trainer(t1).run(5)
        fired = {"n": 0}

        def bomb(step):
            if step == 3 and not fired["n"]:
                fired["n"] += 1
                raise RuntimeError("simulated node failure")

        tr = _trainer(t2)
        tr.fault_hook = bomb
        out = tr.run(5)
        assert out["restarts"] == 1 and out["final_step"] == 5
        assert _losses(out)[-1] == _losses(clean)[-1]


def test_nan_guard_skips_the_update():
    """A poisoned weight makes the loss non-finite: the step reports
    skipped and leaves weights, moments and counters as they were."""
    with tempfile.TemporaryDirectory() as t:
        tr = _trainer(t)
        state = tr.init_state()
        state, met = tr.built["fn"](state,
                                    tr._device_batch(tr.data.batch_at(0)))
        assert met["skipped"] == 0 and state["step"] == 1
        with torch.no_grad():
            state["params"]["embed"].mul_(float("nan"))
        before = {p: t.clone() for p, t in tree_leaves(state)
                  if isinstance(t, torch.Tensor) and p[0] != "params"}
        state, met = tr.built["fn"](state,
                                    tr._device_batch(tr.data.batch_at(1)))
        assert met["skipped"] == 1 and not np.isfinite(float(met["loss"]))
        assert state["step"] == 1 and state["opt"]["count"] == 1
        for p, t in tree_leaves(state):
            if p in before:
                assert torch.equal(t, before[p]), p


def test_nan_limit_escalates_to_checkpoint_replay():
    with tempfile.TemporaryDirectory() as t:
        fired = {"done": False}

        def poison(step, state):
            if step == 3 and not fired["done"]:
                fired["done"] = True
                with torch.no_grad():
                    state["params"]["embed"].mul_(float("nan"))
            return state

        tr = _trainer(t, nan_limit=1)
        tr.fault_hook = poison
        out = tr.run(5)
        assert out["restarts"] == 1 and out["nan_skips"] == 2
        assert np.isfinite(_losses(out)[-1])


def test_entry_points_need_a_gpu_unless_given_the_cpu(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tempfile.TemporaryDirectory() as t:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(get_config(ARCH), SHAPE, None,
                    TrainerConfig(ckpt_dir=t))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", ARCH, "--steps", "1", "--ckpt-dir", t])
        out = train.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                          "--seq", "16", "--ckpt-dir", t], device="cpu")
        assert out["final_step"] == 2
        with pytest.raises(RuntimeError, match="process group"):
            train.main(["--arch", ARCH, "--mesh", "2,2", "--ckpt-dir", t],
                       device="cpu")
