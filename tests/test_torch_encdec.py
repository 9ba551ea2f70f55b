"""The port's encoder-decoder (whisper-small-smoke: 2 encoder and 2 decoder
layers, d 128) against the JAX package on bridged weights, fp32 1e-4
unless noted:

* ``sinusoid_positions``/``sinusoid_at``; the schema's leaves and shapes
  (the smoke and the full whisper-small, nothing allocated);
* ``encode``; ``loss_fn`` and every gradient under remat "full" (remat
  "none" is ``test_torch_train.py``'s ``ARCHS`` case);
* the scheduled forward in both orders: the bits of ``forward``, and JAX's
  scheduled forward;
* ``tests/test_archs.py:86``'s whisper case (prefill S tokens, decode
  token S: 5e-3 to the port's own full forward, 1e-4 to JAX's decode);
  ``lm.prefill``'s logits and cache (``xk``/``xv`` too), equal lengths and
  left-padded (the sinusoid by index, as JAX: ROADMAP reference caveat 6);
  a decode cache of more encoder rows than frames (every row attended,
  as JAX: caveat 5);
* ``build_prefill_step``/``build_decode_step`` at one rank; two ``Trainer``
  steps of ``launch/train.py`` against JAX's train step;
* which attention regions reach ``ops.flash_attention`` (the encoder's,
  the cross-attention and the unmasked causal self-attention) and the
  refusals by name (the engine, the chunked and paged caches); a ranked
  context's encoder K/V cut as JAX's.
"""
import dataclasses
import functools
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
from repro.models import common as JC
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro.serving import stitch_prefill_cache as jstitch
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import specs as SP
from repro_torch.launch import train_step as TS
from repro_torch.models import lm
from repro_torch.models.common import (sinusoid_at, sinusoid_positions,
                                       tree_leaves)
from repro_torch.parallel import sharding as SH
from repro_torch.serving import stitch_prefill_cache

torch.set_num_threads(1)

ARCH = "whisper-small-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)
FRAMES = 24


def _configs(**kw):
    return (dataclasses.replace(get_config(ARCH), **kw),
            dataclasses.replace(jax_config(ARCH), **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    return jlm.init_params(jax_config(ARCH), jax.random.PRNGKey(seed))


def _weights(seed=0):
    """(JAX tree, the port's bridged copy); a fresh copy each call, as the
    port's steps update their tree in place."""
    jp = _jax_params(seed)
    return jp, bridge.from_jax(jax.tree.map(np.asarray, jp),
                               get_config(ARCH), "cpu")


def _inputs(seed, B=2, S=16, frames=FRAMES):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((B, frames, 128)) * 0.02).astype(np.float32),
            rng.integers(0, 512, (B, S)).astype(np.int32))


def _batches(frames, toks, mask=None, labels=None):
    """(the port's batch, JAX's) of the same arrays."""
    arrs = {"frames": frames, "tokens": toks}
    if mask is not None:
        arrs["mask"] = mask
    if labels is not None:
        arrs["labels"] = labels
    port = {k: (torch.from_numpy(v) if v.dtype != np.int32
                else torch.from_numpy(v).long()) for k, v in arrs.items()}
    return port, {k: jnp.asarray(v) for k, v in arrs.items()}


def _np(t):
    return np.asarray(t, np.float32)


def test_sinusoids_match_jax():
    np.testing.assert_allclose(sinusoid_positions(300, 128).numpy(),
                               _np(JC.sinusoid_positions(300, 128)), **TOL)
    pos = np.array([0, 7, 31, 447], np.int32)
    want = jax.vmap(lambda p: JC.sinusoid_at(p, 128))(jnp.asarray(pos))
    np.testing.assert_allclose(sinusoid_at(torch.from_numpy(pos), 128).numpy(),
                               _np(want), **TOL)


def _decls(tree):
    return {path: (tuple(d.shape), tuple(d.logical), d.init, d.scale)
            for path, d in tree_leaves(tree)}


@pytest.mark.parametrize("arch", ["whisper-small-smoke", "whisper-small"])
def test_schema_matches_jax(arch):
    got = _decls(lm.model_schema(get_config(arch)))
    want = _decls(jlm.model_schema(jax_config(arch), JAxisCtx()))
    assert got == want
    assert {p[0] for p in got} >= {"encoder", "ln_enc"}
    assert any("xattn" in p for p in got) and any("ln_x" in p for p in got)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_encode_matches_jax(remat):
    cfg, jcfg = _configs(remat=remat)
    jp, tp = _weights()
    frames, _ = _inputs(1, frames=40)
    got = lm.encode(cfg, tp, torch.from_numpy(frames))
    want = jax.jit(lambda p, f: jlm.encode(jcfg, p, f, JAxisCtx()))(
        jp, jnp.asarray(frames))
    assert got.shape == (2, 40, cfg.d_model)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_loss_and_grads_under_remat_match_jax():
    cfg, jcfg = _configs(remat="full")
    jp, tp = _weights(2)
    frames, toks = _inputs(2)
    labels = np.roll(toks, -1, axis=1)
    labels[0, 3] = -1
    tb, jb = _batches(frames, toks, labels=labels)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    for _, t in tree_leaves(tp):
        t.requires_grad_(True)
    loss, met = lm.loss_fn(cfg, tp, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert float(met["tokens"]) == 31
    want = dict(tree_leaves(jax.tree.map(np.asarray, jg)))
    assert {p[0] for p, _ in tree_leaves(tp)} >= {"encoder", "ln_enc"}
    for path, t in tree_leaves(tp):
        np.testing.assert_allclose(t.grad.numpy(), want[path],
                                   err_msg=str(path), **TOL)


@pytest.mark.parametrize("order", ["sequential", "overlap"])
def test_scheduled_forward_matches_forward_and_jax(order):
    cfg, jcfg = _configs(block_schedule=order)
    jp, tp = _weights(3)
    frames, toks = _inputs(3)
    tb, jb = _batches(frames, toks)
    with torch.no_grad():
        got, _, _ = lm.forward_scheduled(cfg, tp, tb)
        base, _, _ = lm.forward(get_config(ARCH), tp, tb)
    assert torch.equal(got, base)
    want = jax.jit(lambda p, b: jlm.forward(jcfg, p, b)[0])(jp, jb)
    # (JAX's forward_scheduled, the config's block_schedule set)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def _decode(cfg, tp, pre, toks_next, S, enc_len, Bz=2):
    cache = stitch_prefill_cache(
        cfg, lm.init_cache(cfg, Bz, S + 8, "cpu", enc_len=enc_len), pre, S)
    return lm.decode_step(cfg, tp, cache, torch.from_numpy(toks_next).long(),
                          torch.full((Bz,), S))[0].numpy()


def _jax_decode(jcfg, jp, jpre, toks_next, S, enc_len, Bz=2):
    cache = jstitch(jcfg, jlm.init_cache(jcfg, Bz, S + 8, enc_len=enc_len),
                    jpre, S)
    step = jax.jit(functools.partial(jlm.decode_step, jcfg))
    return _np(step(jp, cache, jnp.asarray(toks_next), jnp.int32(S))[0])


def _jax_prefill(jcfg, jp, jb):
    return jax.jit(functools.partial(jlm.prefill, jcfg))(jp, jb)


def test_prefill_decode_consistency():
    """``tests/test_archs.py:86``'s whisper case: prefill S tokens beside 64
    frames, stitch into a cache of 64 encoder rows, decode token S."""
    cfg, jcfg = _configs()
    jp, tp = _weights(1)
    Bz, S = 2, 32
    rng = np.random.default_rng(5)
    frames = (rng.standard_normal((Bz, 64, 128)) * 0.02).astype(np.float32)
    toks = rng.integers(0, 512, (Bz, S + 1)).astype(np.int32)
    tb, _ = _batches(frames, toks)
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, tp, tb)
    want = lm._logits(cfg, tp, h[:, S], per_row=True).numpy()
    tb, jb = _batches(frames, toks[:, :S])
    _, pre = lm.prefill(cfg, tp, tb)
    got = _decode(cfg, tp, pre, toks[:, S:], S, 64)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    _, jpre = _jax_prefill(jcfg, jp, jb)
    np.testing.assert_allclose(
        got, _jax_decode(jcfg, jp, jpre, toks[:, S:], S, 64), **TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_logits_and_cache_match_jax(padded):
    cfg, jcfg = _configs()
    jp, tp = _weights(4)
    frames, toks = _inputs(4, B=3)
    mask = None
    if padded:
        mask = np.ones(toks.shape, bool)
        mask[1, :7] = mask[2, :13] = False
        toks = np.where(mask, toks, 0).astype(np.int32)
    tb, jb = _batches(frames, toks, mask)
    logits, cache = lm.prefill(cfg, tp, tb)
    jl, jcache = _jax_prefill(jcfg, jp, jb)
    np.testing.assert_allclose(logits.numpy(), _np(jl), **TOL)
    for pos, (e, je) in enumerate(zip(cache, jcache)):
        assert e.keys() == je.keys() == {"k", "v", "xk", "xv"}
        assert tuple(e["xk"].shape) == (cfg.n_layers, 3, FRAMES, 4, 32)
        for k in e:
            np.testing.assert_allclose(e[k].numpy(), _np(je[k]),
                                       err_msg=f"{pos}/{k}", **TOL)


def test_decode_past_the_frames_matches_jax():
    """A decode cache of more encoder rows than frames: the cross-attention
    reads every row, the unwritten zero rows too, as JAX's does."""
    cfg, jcfg = _configs()
    jp, tp = _weights(5)
    frames, toks = _inputs(6)
    S = toks.shape[1] - 1
    tb, jb = _batches(frames, toks[:, :S])
    _, pre = lm.prefill(cfg, tp, tb)
    _, jpre = _jax_prefill(jcfg, jp, jb)
    nxt = toks[:, S:]
    wide = _decode(cfg, tp, pre, nxt, S, 3 * FRAMES)
    np.testing.assert_allclose(
        wide, _jax_decode(jcfg, jp, jpre, nxt, S, 3 * FRAMES), **TOL)
    # the zero keys dilute the softmax: not the decode of FRAMES rows
    assert np.abs(wide - _decode(cfg, tp, pre, nxt, S, FRAMES)).max() > 1e-3


def test_prefill_and_decode_step_builders_at_one_rank():
    cfg, jcfg = _configs()
    jp, tp = _weights(6)
    shape = ShapeConfig("prefill", 32, 2, "prefill")
    built = TS.build_prefill_step(cfg, shape)
    assert built["batch_structs"] == {"frames": (2, 32, 128),
                                      "tokens": (2, 64)}
    frames, toks = _inputs(7, S=64, frames=32)
    tb, _ = _batches(frames, toks)
    logits, pre = built["fn"](tp, tb)
    want, _ = lm.prefill(cfg, tp, tb)
    assert torch.equal(logits, want)
    dshape = ShapeConfig("serve_decode", 80, 2, "decode")
    cache_shapes, _, _ = SP.decode_inputs(cfg, dshape, None)
    jcache = JSP.decode_inputs(jcfg, JShape("serve_decode", 80, 2, "decode"),
                               JAxisCtx())[0]
    assert [{k: shp for k, (shp, _) in e.items()} for e in cache_shapes] == \
        [{k: tuple(v.shape) for k, v in e.items()} for e in jcache]
    assert cache_shapes[0]["xk"][0][2] == SP.WHISPER_ENC_LEN_DECODE
    dec = TS.build_decode_step(cfg, dshape)
    cache = stitch_prefill_cache(
        cfg, lm.init_cache(cfg, 2, 80, "cpu", enc_len=32), pre, 64)
    again = stitch_prefill_cache(
        cfg, lm.init_cache(cfg, 2, 80, "cpu", enc_len=32), pre, 64)
    nxt = torch.argmax(logits, -1)[:, None]
    tok, lg, _ = dec["fn"](tp, cache, nxt, torch.full((2,), 64))
    want, _ = lm.decode_step(cfg, tp, again, nxt, torch.full((2,), 64))
    assert torch.equal(lg, want) and torch.equal(tok[:, 0],
                                                 torch.argmax(want, -1))


def test_trainer_steps_of_the_cli_match_jax():
    """Two steps of ``launch/train.py --arch whisper-small-smoke`` (32
    frames, 64 tokens a row) against JAX's train step from the same
    weights and batches."""
    from repro_torch.launch import train
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg, jcfg = _configs()
    shape = ShapeConfig("train", 32, 2, "train")
    with tempfile.TemporaryDirectory() as t:
        out = train.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                          "--seq", "32", "--ckpt-dir", t], device="cpu")
        tr = Trainer(cfg, shape, None, TrainerConfig(ckpt_dir=t),
                     device="cpu")
        p0 = tr.init_state()["params"]
    assert tr.built["batch_structs"]["frames"] == (2, 32, 128)
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(p0))
    jopt = jadamw.AdamW()
    jb = jbuild(jcfg, JShape("train", 32, 2, "train"), None, jopt, accum=1)
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    jdata = JSyntheticLM(jcfg, jb["batch_structs"], seed=0)
    jfn = jax.jit(jb["fn"])
    want = []
    for s in range(2):
        jstate, jm = jfn(jstate,
                              jax.tree.map(jnp.asarray, jdata.batch_at(s)))
        want.append(float(jm["loss"]))
    got = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 2 and len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_flash_regions(monkeypatch):
    """The encoder's self-attention and the cross-attention (non-causal,
    Sq != Sk) and the unmasked decoder's causal self-attention go to
    ``ops.flash_attention``; a masked self-attention keeps the plain
    attention."""
    cfg, _ = _configs()
    _, tp = _weights()
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, causal=True):
        calls.append((q.shape[2], k.shape[2], causal))
        return real(q, k, v, causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    frames, toks = _inputs(8)
    tb, _ = _batches(frames, toks)
    with torch.no_grad():
        lm.forward(cfg, tp, tb)
    enc = [(FRAMES, FRAMES, False)] * cfg.n_enc_layers
    assert calls == enc + [(16, 16, True), (16, FRAMES, False)] * cfg.n_layers
    calls.clear()
    mask = np.ones(toks.shape, bool)
    mask[0, :5] = False
    tb, _ = _batches(frames, toks, mask)
    lm.prefill(cfg, tp, tb)
    assert calls == enc + [(16, FRAMES, False)] * cfg.n_layers


class _StubMesh:
    """A (1, 2) mesh's axis sizes and rank 0's coordinates: enough for a
    ranked context's specs and local shapes, no process group."""
    shape = {"data": 1, "model": 2}
    coords = {"data": 0, "model": 0}

    def model_subgroups(self, model_axis, etp):
        return None, None


def test_refusals_by_name():
    """The engine, the chunked prefill and the paged cache refuse an
    encoder-decoder by name, as the JAX package asserts. On a mesh the
    encoder-decoder is ported (it once raised by name here; its runs are
    the gloo cells of test_torch_mesh_serve.py and
    test_torch_mesh_train.py): a ranked context's cache holds this rank's
    slice of the encoder K/V, cut as JAX's ``cache_specs(enc_len=)``
    cuts it."""
    from repro.parallel import sharding as JSH
    cfg, jcfg = _configs()
    _, tp = _weights()
    frames, toks = _inputs(9)
    tb, _ = _batches(frames, toks)
    ctx = SH.make_ctx(cfg, _StubMesh(), seq_shard=False)
    cache = lm.init_cache(cfg, 2, 16, "cpu", ctx, enc_len=FRAMES)
    a = cfg.attn
    np_ = cfg.n_layers
    assert cache[0]["k"].shape == (np_, 2, 16, a.n_kv_heads // 2,
                                   a.head_dim)
    assert cache[0]["xk"].shape == (np_, 2, FRAMES, a.n_kv_heads // 2,
                                    a.head_dim)
    _, cspecs, _ = SP.decode_inputs(cfg, ShapeConfig("d", 16, 2, "decode"),
                                    ctx)
    jspecs = JSH.cache_specs(jcfg, JSH.make_ctx(jcfg, _StubMesh(),
                                                seq_shard=False), 2, 16,
                             enc_len=SP.WHISPER_ENC_LEN_DECODE)
    assert set(cspecs[0]) == set(jspecs[0]) == {"k", "v", "xk", "xv"}
    for k in ("xk", "xv"):
        assert tuple(cspecs[0][k])[2:] == tuple(jspecs[0][k])[2:]
    from repro_torch.serving import ServeEngine
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="lm.py:407"):
        lm.prefill_chunk(cfg, tp, None, tb["tokens"], 0, 16)
    with pytest.raises(NotImplementedError, match="lm.py:306"):
        lm.paged_cache_shapes(cfg, 2, 9, 8)
