"""The port's SSM serving path against the JAX package on mamba2-780m-smoke,
weights carried by ``bridge.from_jax`` and inputs from a seeded numpy RNG:
the block's three cache modes (single-step decode, chunk continuation with
a per-row valid_len and mask, prefill with ``return_cache``) in y, conv
window and state; ``ops.ssd_forward_state`` (CPU: the plain chunked form)
against the JAX ``ssd_chunked`` with an initial state; and the model's
``init_cache``, ``prefill_chunk`` (slots, the carry reset where
pos_off == 0) and ``decode_step`` in logits and every cache entry. fp32
1e-4. The engine still refuses an encoder-decoder config by name."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.models import ssm as JS
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models import ssm as S

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ARCH = "mamba2-780m-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               err_msg=msg, **TOL)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _layer(model):
    jcfg, cfg, jp, tp = model
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0]["ssm"])
    tl = {k: v[0] for k, v in tp["layers"][0]["ssm"].items()}
    return jcfg, cfg, jl, tl


def _carry(cfg, B, seed):
    """A non-zero cache of B rows, as a decode would leave it."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, s.conv_width - 1, d_in + 2 * s.d_state))
    state = rng.standard_normal((B, d_in // s.head_dim, s.d_state,
                                 s.head_dim)) * 0.5
    return conv.astype(np.float32), state.astype(np.float32)


def _compare_block(model, x, cache, **kw):
    jcfg, cfg, jl, tl = _layer(model)
    jcache = (None if cache is None else
              {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = None if cache is None else {k: _t(v) for k, v in cache.items()}
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jy, jc = JS.ssm_forward(jcfg, jcfg.ssm, jl, jnp.asarray(x),
                            cache=jcache, **jkw)
    ty, tc = S.ssm_forward(cfg, cfg.ssm, tl, _t(x), cache=tcache, **tkw)
    _close(ty, jy, "y")
    assert sorted(tc) == ["conv", "state"]
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k], k)
    if tcache is not None:                 # the cache passed in is kept
        for k, v in cache.items():
            np.testing.assert_array_equal(_np(tcache[k]), v)


def test_decode_step_of_the_block_matches_jax(model):
    cfg = model[1]
    x = np.random.default_rng(1).standard_normal((3, 1, cfg.d_model))
    conv, state = _carry(cfg, 3, 2)
    _compare_block(model, x.astype(np.float32),
                   {"conv": conv, "state": state})


def test_chunk_continuation_matches_jax(model):
    """A continuation chunk from a cached carry, rows at different fill
    levels: a per-row valid_len (one row a pure identity row, valid 0)
    with the matching mask."""
    cfg = model[1]
    C = 16
    x = np.random.default_rng(3).standard_normal((3, C, cfg.d_model))
    conv, state = _carry(cfg, 3, 4)
    valid = np.array([16, 9, 0], np.int32)
    mask = np.arange(C)[None, :] < valid[:, None]
    _compare_block(model, x.astype(np.float32),
                   {"conv": conv, "state": state}, mask=mask,
                   valid_len=valid)
    # a shared () valid_len, no mask
    _compare_block(model, x.astype(np.float32),
                   {"conv": conv, "state": state}, valid_len=C)


def test_prefill_with_return_cache_matches_jax(model):
    cfg = model[1]
    x = np.random.default_rng(5).standard_normal((2, 32, cfg.d_model))
    _compare_block(model, x.astype(np.float32), None, return_cache=True)


@pytest.mark.parametrize("S_len,chunk,with_h0", [(32, 16, True),
                                                 (16, 16, False),
                                                 (7, 16, True)])
def test_ssd_forward_state_matches_jax(S_len, chunk, with_h0):
    rng = np.random.default_rng(S_len)
    B, nh, hd, ds = 2, 3, 8, 4
    x = rng.standard_normal((B, S_len, nh, hd), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S_len, nh),
                                             dtype=np.float32)))
    A = -np.exp(rng.standard_normal(nh).astype(np.float32) * 0.3)
    Bm = rng.standard_normal((B, S_len, ds), dtype=np.float32)
    Cm = rng.standard_normal((B, S_len, ds), dtype=np.float32)
    D = np.full((nh,), 0.5, np.float32)
    h0 = (rng.standard_normal((B, nh, ds, hd)).astype(np.float32)
          if with_h0 else None)
    ins = (x, dt, A, Bm, Cm, D)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, ins), chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    ty, th = ops.ssd_forward_state(*map(_t, ins), chunk,
                                   None if h0 is None else _t(h0))
    _close(ty, jy, "y")
    _close(th, jh, "h_final")


def _compare_cache(tcache, jcache):
    for pos, (te, je) in enumerate(zip(tcache, jcache)):
        assert sorted(te) == sorted(je) == ["conv", "state"]
        for k in te:
            assert tuple(te[k].shape) == je[k].shape
            assert te[k].dtype == getattr(torch, str(je[k].dtype))
            _close(te[k], je[k], f"{pos}/{k}")


def test_model_prefill_and_decode_match_jax(model):
    """init_cache, then two admission rounds and decodes over 3 slots: a
    stacked chunk into slots (2, 0), all slots decode (the free slot 1
    too), a continuation chunk of slot 2 beside an identity row, and slot 0
    re-admitted from pos_off 0, whose carry restarts from zero."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(9)
    V, C = cfg.vocab_size, 16
    jcache, tcache = jlm.init_cache(jcfg, 3, 64), lm.init_cache(cfg, 3, 64,
                                                                "cpu")
    _compare_cache(tcache, jcache)

    def both_prefill(toks, pos_off, valid, slots):
        nonlocal jcache
        jl, jcache = jlm.prefill_chunk(jcfg, jp, jcache, jnp.asarray(toks),
                                       jnp.asarray(pos_off),
                                       jnp.asarray(valid),
                                       slot=jnp.asarray(slots))
        tl, _ = lm.prefill_chunk(cfg, tp, tcache, torch.from_numpy(toks),
                                 torch.from_numpy(pos_off),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(slots))
        _close(tl, jl, "prefill logits")
        _compare_cache(tcache, jcache)

    def both_decode(pos):
        nonlocal jcache
        toks = rng.integers(1, V, (3, 1))
        jl, jcache = jlm.decode_step(jcfg, jp, jcache, jnp.asarray(toks),
                                     jnp.asarray(pos))
        tl, _ = lm.decode_step(cfg, tp, tcache, torch.from_numpy(toks),
                               torch.from_numpy(pos))
        _close(tl, jl, "decode logits")
        _compare_cache(tcache, jcache)

    toks = rng.integers(1, V, (2, C))
    both_prefill(toks, np.array([0, 0]), np.array([16, 9]), np.array([2, 0]))
    both_decode(np.array([9, 0, 16]))
    toks = rng.integers(1, V, (2, C))
    both_prefill(toks, np.array([17, 16]), np.array([5, 0]),
                 np.array([2, 1]))
    both_decode(np.array([10, 1, 22]))
    toks = rng.integers(1, V, (1, C))
    both_prefill(toks, np.array([0]), np.array([11]), np.array([0]))
    both_decode(np.array([11, 2, 23]))


def test_encoder_decoder_serving_still_raises_by_name():
    """``init_cache`` gives JAX's layout, encoder K/V rows included; the
    engine, whose JAX counterpart has no encoder-decoder path, refuses."""
    cfg = get_config("whisper-small-smoke")
    got = lm.init_cache(cfg, 2, 16, "cpu", enc_len=24)
    want = jlm.init_cache(jax_config("whisper-small-smoke"), 2, 16,
                          enc_len=24)
    assert [{k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in e.items()}
            for e in got] == [{k: (tuple(t.shape), str(t.dtype))
                               for k, t in e.items()} for e in want]
    from repro_torch.serving import ServeEngine
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServeEngine(cfg, device="cpu")
