"""The plain reference against the program at the smoke configurations on
the CPU, where both compute in fp32 and must agree to rounding."""
import json

import pytest
import torch

from portbench import adapter
from portbench import weights as W
from portbench.reference import model as RM
from portbench.reference import train as RT
from portbench.tests.conftest import DATA
from portbench.yardstick import traffic as TR

SEED = 2 ** 35 + 11


def _conf(name):
    return json.loads((DATA / f"{name}.json").read_text())


def _tokens(V, B, S, step=0):
    b = TR.train_batch(SEED, step, B, S, V)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_ssd_chunked_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, S, nh, hd, ds = 2, 37, 3, 4, 5
    x = torch.randn(B, S, nh, hd, generator=g, dtype=torch.float64)
    dt = torch.rand(B, S, nh, generator=g, dtype=torch.float64)
    A = -torch.rand(nh, generator=g, dtype=torch.float64) * 2
    Bm = torch.randn(B, S, ds, generator=g, dtype=torch.float64)
    Cm = torch.randn(B, S, ds, generator=g, dtype=torch.float64)
    h = torch.zeros(B, nh, ds, hd, dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + \
            Bm[:, t][:, None, :, None] * (x[:, t] * dt[:, t, :, None])[
                :, :, None, :]
        ys.append(torch.einsum("bs,bhsp->bhp", Cm[:, t], h))
    want = torch.stack(ys, 1)
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    for Q in (8, 16, 64):
        got = RM.ssd_chunked(x, dt, A.float(), Bm, Cm, Q=Q)
        assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-5)


def test_loss_and_every_gradient_match_the_program():
    from repro_torch.models import lm
    conf = _conf("qwen2-smoke")
    model = conf["model"]
    cfg = adapter.program_config(conf)
    layout = RM.param_layout(model)
    w = W.make(layout, SEED, "cpu", torch.float32)
    b = _tokens(model["vocab_size"], 2, 32)
    params = adapter.program_params(
        RM.tree_map(lambda t: t.clone().requires_grad_(True), w))
    lo, _ = lm.loss_fn(cfg, params, b)
    paths = [p for p, _ in RM.leaves(params)]
    got = torch.autograd.grad(lo, [t for _, t in RM.leaves(params)])
    ref_w = RM.tree_map(lambda t: t.clone().requires_grad_(True), w)
    ref_lo = RM.loss(model, ref_w, b["tokens"], b["labels"].long())
    want = torch.autograd.grad(ref_lo, [t for _, t in RM.leaves(ref_w)])
    assert float(lo.detach()) == pytest.approx(float(ref_lo.detach()),
                                              rel=1e-6)
    assert len(paths) == len(want)
    for p, g, r in zip(paths, got, want):
        g = g.reshape(r.shape)
        err = float((g - r).norm() / r.norm().clamp(min=1e-30))
        assert err < 1e-4, (p, err)


def test_three_steps_match_the_program():
    """AdamW as the reference writes it out against the program's step."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.optim.adamw import AdamW
    conf = _conf("qwen2-smoke")
    model = conf["model"]
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "clip_norm": 1.0}
    cfg = adapter.program_config(conf)
    layout = RM.param_layout(model)
    fn = build_train_step(cfg, ShapeConfig("t", 32, 2, "train"),
                          optim=AdamW(lr=lambda s: opt["lr"], b1=0.9,
                                      b2=0.95, eps=1e-8, weight_decay=0.1,
                                      clip_norm=1.0))["fn"]
    params = adapter.program_params(W.make(layout, SEED, "cpu",
                                           torch.float32))
    state = {"params": params, "opt": AdamW().init(params), "step": 0}
    batches = [_tokens(model["vocab_size"], 2, 32, i) for i in range(3)]
    losses = []
    for b in batches:
        state, met = fn(state, b)
        losses.append(float(met["loss"]))
    ref = RT.steps(model, W.make(layout, SEED, "cpu", torch.float32),
                   batches, opt)
    assert losses == pytest.approx(ref["loss"], rel=1e-6)
    w0 = W.make(layout, SEED, "cpu", torch.float32)
    for (p, t), (_, t0) in zip(RM.leaves(state["params"]), RM.leaves(w0)):
        change = float((t.detach().reshape(t0.shape) - t0).norm())
        assert change == pytest.approx(ref["change"][p], rel=1e-4), p


def test_hybrid_logits_match_the_program():
    from repro_torch.models import lm
    conf = _conf("jamba-smoke")
    model = conf["model"]
    cfg = adapter.program_config(conf)
    layout = RM.param_layout(model)
    w = W.make(layout, SEED, "cpu", torch.float32)
    tokens = _tokens(model["vocab_size"], 1, 40)["tokens"]
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, adapter.program_params(w),
                             {"tokens": tokens})
        got = h[0].float() @ w["lm_head"]
    want = RM.logits(model, w, tokens[0])
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_the_weights_regenerate_leaf_by_leaf():
    layout = RM.param_layout(_conf("jamba-smoke")["model"])
    w = W.make(layout, SEED, "cpu")
    for path in W.leaf_paths(layout):
        again = W.make_leaf(W.decl_at(layout, path), SEED, path, "cpu")
        node = w
        for p in path:
            node = node[p]
        assert torch.equal(node, again)
    other = W.make(layout, SEED + 1, "cpu")
    assert not torch.equal(other["embed"], w["embed"])


def test_init_std_draws_a_leaf_at_its_scale():
    layout = RM.param_layout(_conf("qwen2-smoke")["model"])
    w = W.make(layout, SEED, "cpu", torch.float32, {"embed": 1.0})
    plain = W.make(layout, SEED, "cpu", torch.float32)
    assert float(w["embed"].std()) == pytest.approx(1.0, rel=0.05)
    assert float(plain["embed"].std()) == pytest.approx(
        1 / 256 ** 0.5, rel=0.05)
    assert torch.equal(w["lm_head"], plain["lm_head"])
    again = W.make_leaf(W.decl_at(layout, ("embed",)), SEED, ("embed",),
                        "cpu", torch.float32, {"embed": 1.0})
    assert torch.equal(again, w["embed"])
