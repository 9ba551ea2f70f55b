"""The port's monolithic prefill (``lm.forward(return_cache=True)``,
``lm.prefill``, ``launch/train_step.build_prefill_step``,
``serving.stitch_prefill_cache``) and the left-padded decode it feeds
(``lm.decode_step(rope_pos=, kv_start=)``), against the JAX package on
bridged weights.

* ``tests/test_serving.py:155``'s contract: a masked, left-padded batched
  prefill of mixed lengths, its cache stitched into a decode cache, then
  per-row-position decode (RoPE at the real position, the pads excluded)
  gives the greedy streams of the unpadded per-prompt full forward, and
  JAX's streams; the logits of every step within fp32 1e-4 of JAX's.
* ``tests/test_archs.py:86`` for every decoder-only family: prefill S
  tokens, then decode token S, against the full forward's logits at
  position S (``rtol = atol = 5e-3`` as there), no-drop MoE capacity.
* ``lm.prefill``'s logits and every cache leaf against JAX's at fp32
  1e-4, equal-length and left-padded.
* ``build_prefill_step`` at one rank; on a mesh it raises by name.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.serving import stitch_prefill_cache as jstitch
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import train_step as TS
from repro_torch.models import lm
from repro_torch.parallel import sharding as SH
from repro_torch.serving import stitch_prefill_cache

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(arch):
    """(port, JAX) configs of ``arch``; a MoE at no-drop capacity (the
    expert count): a prefill routes B*S tokens at once, a decode step B."""
    out = []
    for c in (get_config(arch), jax_config(arch)):
        if c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=float(c.moe.num_experts)))
        out.append(c)
    return out


def _weights(arch, seed=0):
    cfg, jcfg = _configs(arch)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jp, bridge.from_jax(jax.tree.map(np.asarray, jp),
                                          cfg, "cpu")


def _left_padded(prompts):
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    mask = np.zeros((len(prompts), plen), bool)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
        mask[i, plen - len(p):] = True
    return toks, mask


def _port_batch(toks, mask=None):
    b = {"tokens": torch.from_numpy(toks).long()}
    if mask is not None:
        b["mask"] = torch.from_numpy(mask)
    return b


def _jax_batch(toks, mask=None):
    b = {"tokens": jnp.asarray(toks)}
    if mask is not None:
        b["mask"] = jnp.asarray(mask)
    return b


# ---------------------------------------------------------------------------
# left-padded prefill + stitched per-row decode (test_serving.py:155)
# ---------------------------------------------------------------------------


STREAM_ARCHS = ["qwen2-0.5b-smoke", "granite-moe-3b-a800m-smoke",
                "mamba2-780m-smoke"]
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1], [8, 8, 3, 5, 1]]
STEPS = 4


def _port_greedy(cfg, params, prompt):
    """The next token of the unpadded per-prompt full forward."""
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, params, {"tokens": torch.tensor([prompt])})
    return int(torch.argmax(lm._logits(cfg, params, h[:, -1])[0]))


@pytest.mark.parametrize("arch", STREAM_ARCHS)
def test_padded_prefill_plus_stitched_decode_matches_jax(arch):
    cfg, jcfg, jp, tp = _weights(arch)
    toks, mask = _left_padded(PROMPTS)
    n, plen = toks.shape
    pads = plen - mask.sum(1)
    # the port
    logits, pre = lm.prefill(cfg, tp, _port_batch(toks, mask))
    cache = stitch_prefill_cache(cfg, lm.init_cache(cfg, n, 32, "cpu"), pre,
                                 plen)
    got, got_logits = [], [logits]
    nxt = torch.argmax(logits, -1)
    for t in range(STEPS):
        got.append(nxt.tolist())
        lg, cache = lm.decode_step(cfg, tp, cache, nxt[:, None],
                                   torch.full((n,), plen + t),
                                   rope_pos=torch.from_numpy(plen + t - pads),
                                   kv_start=torch.from_numpy(pads))
        got_logits.append(lg)
        nxt = torch.argmax(lg, -1)
    # JAX
    jl, jpre = jlm.prefill(jcfg, jp, _jax_batch(toks, mask))
    jcache = jstitch(jcfg, jlm.init_cache(jcfg, n, 32), jpre, plen)
    want, want_logits = [], [jl]
    jn = jnp.argmax(jl, -1)
    for t in range(STEPS):
        want.append(np.asarray(jn).tolist())
        lg, jcache = jlm.decode_step(
            jcfg, jp, jcache, jn[:, None].astype(jnp.int32),
            jnp.int32(plen + t), rope_pos=jnp.asarray(plen + t - pads),
            kv_start=jnp.asarray(pads))
        want_logits.append(lg)
        jn = jnp.argmax(lg, -1)
    assert got == want
    for a, b in zip(got_logits, want_logits):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the oracle: each prompt alone, unpadded, through the full forward
    seqs = [list(p) for p in PROMPTS]
    for t in range(STEPS):
        for i in range(n):
            assert got[t][i] == _port_greedy(cfg, tp, seqs[i]), (i, t)
            seqs[i].append(got[t][i])


# ---------------------------------------------------------------------------
# prefill then one decode step, against the full forward (test_archs.py:86)
# ---------------------------------------------------------------------------


def _arch_param(name):
    return (pytest.param(name, marks=pytest.mark.slow)
            if name == "jamba-v0.1-52b-smoke" else name)


FAMILY_ARCHS = [_arch_param(a) for a in (
    "qwen2-0.5b-smoke", "granite-moe-3b-a800m-smoke", "mamba2-780m-smoke",
    "jamba-v0.1-52b-smoke")]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_decode_consistency(arch):
    """prefill(S tokens) then decode token S matches the full forward's
    logits at position S, the port's and JAX's (5e-3, as the JAX test)."""
    cfg, jcfg, jp, tp = _weights(arch, seed=1)
    Bz, S = 2, 32
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (Bz, S + 1),
                                        0, cfg.vocab_size), np.int32)
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, tp, _port_batch(toks))
    want = lm._logits(cfg, tp, h[:, S], per_row=True).numpy()
    jh, _, _ = jlm.forward(jcfg, jp, _jax_batch(toks))
    jwant = np.asarray(jh[:, S].astype(jnp.float32)
                       @ jlm.output_head(jcfg, jp).astype(jnp.float32))
    _, pre = lm.prefill(cfg, tp, _port_batch(toks[:, :S]))
    cache = stitch_prefill_cache(cfg, lm.init_cache(cfg, Bz, S + 8, "cpu"),
                                 pre, S)
    got, _ = lm.decode_step(cfg, tp, cache,
                            torch.from_numpy(toks[:, S:S + 1]).long(),
                            torch.full((Bz,), S))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got.numpy(), jwant, rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# lm.prefill's logits and cache against JAX's
# ---------------------------------------------------------------------------


CACHE_ARCHS = [_arch_param(a) for a in (
    "qwen2-0.5b-smoke", "granite-moe-3b-a800m-smoke", "mamba2-780m-smoke",
    "jamba-v0.1-52b-smoke")]


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, padded):
    cfg, jcfg, jp, tp = _weights(arch, seed=3)
    rng = np.random.default_rng(4)
    if padded:
        toks, mask = _left_padded([list(rng.integers(1, cfg.vocab_size, n))
                                   for n in (16, 9, 3)])
    else:
        toks, mask = rng.integers(0, cfg.vocab_size, (3, 16)).astype(
            np.int32), None
    logits, cache = lm.prefill(cfg, tp, _port_batch(toks, mask))
    jl, jcache = jlm.prefill(jcfg, jp, _jax_batch(toks, mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert len(cache) == len(jcache) == lm.period_of(cfg)
    for pos, (e, je) in enumerate(zip(cache, jcache)):
        assert e.keys() == je.keys()
        for k in e:
            want = np.asarray(je[k]).astype(np.float32)
            assert tuple(e[k].shape) == want.shape, (pos, k)
            np.testing.assert_allclose(e[k].float().numpy(), want,
                                       err_msg=f"{pos}/{k}", **TOL)


def test_stitch_writes_the_decode_cache_in_place():
    cfg, jcfg, jp, tp = _weights("jamba-v0.1-52b-smoke")
    toks = np.arange(1, 13, dtype=np.int32).reshape(2, 6)
    _, pre = lm.prefill(cfg, tp, _port_batch(toks))
    dec = lm.init_cache(cfg, 2, 16, "cpu")
    ptrs = [t.data_ptr() for e in dec for t in e.values()]
    out = stitch_prefill_cache(cfg, dec, pre, 6)
    assert out is dec and ptrs == [t.data_ptr() for e in dec
                                   for t in e.values()]
    want = jstitch(jcfg, jlm.init_cache(jcfg, 2, 16),
                   jlm.prefill(jcfg, jp, _jax_batch(toks))[1], 6)
    for e, je in zip(dec, want):
        for k in e:
            np.testing.assert_allclose(e[k].float().numpy(),
                                       np.asarray(je[k], np.float32), **TOL)


# ---------------------------------------------------------------------------
# the step builder
# ---------------------------------------------------------------------------


def test_build_prefill_step_at_one_rank_and_its_mesh_raise():
    cfg, jcfg, jp, tp = _weights("qwen2-0.5b-smoke")
    shape = ShapeConfig("prefill", 16, 2, "prefill")
    built = TS.build_prefill_step(cfg, shape)
    assert built["batch_structs"] == {"tokens": (2, 16)}
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    logits, cache = built["fn"](tp, _port_batch(toks))
    want, _ = lm.prefill(cfg, tp, _port_batch(toks))
    assert torch.equal(logits, want)
    jl, _ = jlm.prefill(jcfg, jp, _jax_batch(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)

    class Mesh:                       # the axis sizes: enough to build
        shape = {"data": 2, "model": 2}

        def model_subgroups(self, model_axis, etp):
            return None, None

    # on a mesh (once refused by name; ported, its runs are the gloo
    # cells of test_torch_mesh_serve.py): the same batch, its rows cut
    # over dp as 2 decode slots are, the prefill's cache specs
    built = TS.build_prefill_step(cfg, shape, mesh=Mesh())
    assert built["batch_structs"] == {"tokens": (2, 16)}
    assert built["ctx"].seq_shard
    assert built["batch_pspecs"]["tokens"] == ("data", None)
    assert built["cache_specs"] == SH.prefill_cache_specs(cfg,
                                                          built["ctx"], 2)
    # an encoder-decoder's monolithic prefill: frames beside the tokens
    cfg, jcfg, jp, tp = _weights("whisper-small-smoke")
    frames = np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32) * 0.02
    logits, _ = lm.prefill(cfg, tp, {**_port_batch(toks),
                                     "frames": torch.from_numpy(frames)})
    jl, _ = jlm.prefill(jcfg, jp, {**_jax_batch(toks),
                                   "frames": jnp.asarray(frames)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
