"""The paged block-table KV cache of the port against the JAX package's, at
one rank, on the CPU. Inputs from a seeded numpy RNG, weights carried by
``bridge.from_jax``.

(a) ``serving/paged_cache.py``: the port's ``BlockAllocator`` and JAX's
on seeded random sequences of allocate / free / check / export / import /
snapshot / restore hand out the same page ids, keep the same free lists
and raise the same errors (``AllocatorError`` for a double free and a
double ownership, ``ValueError`` for a budget that does not fit).

(b) The device oracles, fp32 at rel 1e-6 (the JAX tests' bound,
``tests/test_paged_cache.py:120-178``): ``paged_gather``,
``paged_update_cache`` (dead rows on the null page), ``paged_chunk_update``
(masked tokens on the null page) and ``decode_attention(block_table=)``
against JAX's on the same seeded pools and shuffled tables. Pools written
with duplicate rows (the null page) are compared on pages 1.. only: which
write wins there is undefined in both packages.

(c) ``lm.decode_step``/``prefill_chunk`` with block tables against JAX's:
logits rel 5e-5, pools on pages 1.. and the SSM entries at 1e-5.

(d) The paged engine's token streams, bit for bit, against JAX's paged
engine and the port's contiguous engine: qwen2-0.5b-smoke on a tight pool
under a Poisson trace with slot reuse; qwen2-moe-2.7b-smoke and
granite-moe-3b-a800m-smoke at no-drop capacity (capacity follows the token
count: the dead and pad rows that read the null page instead of a stale
region would change which live tokens a dropping capacity drops);
mamba2-780m-smoke; jamba-v0.1-52b-smoke at one period (8 layers).

(e) The page gate holds FIFO order, a budget beyond the pool is rejected
at ``submit`` (``OVER_CAPACITY``), ``admit_k`` gives JAX's admission
rounds and counts, and the serve CLI takes ``--page-size`` on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.launch import specs as JSP
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro.serving import RejectedRequest as JRejected
from repro.serving import ServeEngine as JaxEngine
from repro.serving import paged_cache as JPC
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import specs as SP
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.serving import (AllocatorError, BlockAllocator,
                                 RejectedRequest, RejectReason, ServeEngine,
                                 pages_for)

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

ORACLE_REL = 1e-6          # the JAX tests' bound on the paged oracles
LOGIT_REL, CACHE_REL = 5e-5, 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the allocator
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except (AllocatorError, JPC.AllocatorError, ValueError) as e:
        # the two packages' AllocatorError are different classes
        return (type(e).__name__, str(e))


def _state(al):
    return al.snapshot_state(), al.free_pages, al.used_pages


@pytest.mark.parametrize("seed", range(6))
def test_allocator_matches_jax_on_random_sequences(seed):
    """Both allocators through one seeded sequence of operations, valid and
    invalid: every outcome (page ids, counts or the error and its
    message) and the state after it are equal."""
    rng = np.random.default_rng(seed)
    n_pages, page, nb = int(rng.integers(5, 24)), int(rng.integers(1, 6)), \
        int(rng.integers(2, 8))
    ours, theirs = BlockAllocator(n_pages, page, nb), \
        JPC.BlockAllocator(n_pages, page, nb)
    exported = {}
    for _ in range(300):
        op = rng.choice(["alloc", "alloc", "free", "check", "export",
                         "import", "snapshot"])
        s = int(rng.integers(0, 8))
        if op == "alloc":
            toks = int(rng.integers(0, page * nb + 6))
            got = [_outcome(lambda a=a: (a.can_admit(toks),
                                         a.allocate(s, toks)))
                   for a in (ours, theirs)]
        elif op == "free":
            got = [_outcome(lambda a=a: a.free_slot(s))
                   for a in (ours, theirs)]
        elif op == "check":
            got = [_outcome(a.check) for a in (ours, theirs)]
        elif op == "export":
            got = [_outcome(lambda a=a: a.export_pages(s))
                   for a in (ours, theirs)]
            if got[0][0] == "ok":
                exported[s] = got[0][1]
        elif op == "import" and exported:
            src = list(exported)[int(rng.integers(0, len(exported)))]
            pages = exported[src]
            table = pages + [0] * (nb - len(pages))
            if rng.random() < 0.3:           # a torn handoff
                table = table[::-1]
            got = [_outcome(lambda a=a: a.import_pages(s, pages, table))
                   for a in (ours, theirs)]
        else:
            snap = ours.snapshot_state()
            got = [_outcome(lambda a=a: a.restore_state(snap))
                   for a in (ours, theirs)]
        assert got[0] == got[1], (op, got)
        assert _state(ours) == _state(theirs)
    ours.check()


@pytest.mark.parametrize("case", ["double_free", "double_ownership",
                                  "free_unknown", "corrupt_restore",
                                  "null_page_in_import"])
def test_allocator_raises_as_jax_does(case):
    """The defensive raises, with JAX's messages, before any state
    changes."""
    def run(cls):
        al = cls(9, 4, 4)
        al.allocate(1, 9)
        if case == "double_free":
            al.free_slot(1)
            return lambda: al.free_slot(1)
        if case == "double_ownership":
            return lambda: al.allocate(1, 4)
        if case == "free_unknown":
            return lambda: al.free_slot(5)
        if case == "corrupt_restore":
            st = al.snapshot_state()
            return lambda: al.restore_state(
                {**st, "free": st["free"] + st["owned"]["1"][:1]})
        return lambda: al.import_pages(2, [0, 3], [0, 3, 0, 0])

    errs = []
    for mod, cls in ((AllocatorError, BlockAllocator),
                     (JPC.AllocatorError, JPC.BlockAllocator)):
        with pytest.raises(mod) as ei:
            run(cls)()
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_pages_for_and_config_match_jax():
    for n in range(0, 40):
        for p in (1, 3, 8):
            assert pages_for(n, p) == JPC.pages_for(n, p)
    assert BlockAllocator(9, 4, 3).cfg.capacity_tokens == \
        JPC.BlockAllocator(9, 4, 3).cfg.capacity_tokens == 32


@pytest.mark.parametrize("page,n_pages", [(8, 0), (16, 9), (32, 0)])
def test_paged_shape_matches_jax(page, n_pages):
    """``ShapeConfig``'s paging and ``specs.decode_inputs``' paged cache
    shapes against JAX's (one rank)."""
    ours = ShapeConfig("d", 64, 4, "decode", page_size=page,
                       n_pages=n_pages)
    theirs = JShape("d", 64, 4, "decode", page_size=page, n_pages=n_pages)
    assert (ours.paged, ours.max_blocks, ours.pages_total()) == \
        (theirs.paged, theirs.max_blocks, theirs.pages_total())
    for arch in ("qwen2-moe-2.7b-smoke", "jamba-v0.1-52b-smoke"):
        cache, cspecs, tok_spec = SP.decode_inputs(get_config(arch), ours,
                                                   None)
        jcache = JSP.decode_inputs(jax_config(arch), theirs, JAxisCtx())[0]
        assert [{k: shp for k, (shp, _) in e.items()} for e in cache] == \
            [{k: v.shape for k, v in e.items()} for e in jcache]
    assert not ShapeConfig("d", 64, 4, "decode").paged


# ---------------------------------------------------------------------------
# (b) the device oracles
# ---------------------------------------------------------------------------


def _pool(rng, P, page=4, Hkv=2, hd=8):
    return rng.standard_normal((P, page, Hkv, hd)).astype(np.float32)


def _table(rng, B, nb, P, dead=()):
    """Shuffled distinct pages 1.. for B rows of nb blocks; ``dead`` rows
    all-zero (the null page)."""
    t = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    t = t.astype(np.int32)
    t[list(dead)] = 0
    return t


@pytest.mark.parametrize("seed", range(3))
def test_paged_gather_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pool, table = _pool(rng, 13), _table(rng, 3, 4, 13, dead=(1,))
    got = A.paged_gather(_t(pool), _t(table)).numpy()
    want = np.asarray(JA.paged_gather(jnp.asarray(pool), jnp.asarray(table)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_paged_update_cache_matches_jax(seed):
    """Decode writes at per-row positions, two dead rows (all-zero tables)
    steered into the null page; a position past the table clips into the
    last block (JAX's clip)."""
    rng = np.random.default_rng(seed)
    P, B, nb, page = 13, 4, 3, 4
    kp, vp = _pool(rng, P), _pool(rng, P)
    table = _table(rng, B, nb, P, dead=(1, 3))
    k, v = (rng.standard_normal((B, 1, 2, 8)).astype(np.float32)
            for _ in range(2))
    pos = np.array([5, 2, nb * page + 1, 0], np.int32)
    gk, gv = A.paged_update_cache(_t(kp), _t(vp), _t(k), _t(v), _t(pos),
                                  _t(table))
    wk, wv = JA.paged_update_cache(*map(jnp.asarray, (kp, vp, k, v, pos,
                                                      table)))
    for g, w in ((gk, wk), (gv, wv)):
        assert _rel(g.numpy()[1:], np.asarray(w)[1:]) <= ORACLE_REL
    # the dead rows landed in the null page only
    assert {(0, int(p) % page) for p in pos[[1, 3]]} <= {
        tuple(i) for i in np.argwhere((gk.numpy()[:, :, 0, 0]
                                       != kp[:, :, 0, 0]))}


@pytest.mark.parametrize("seed", range(3))
def test_paged_chunk_update_matches_jax(seed):
    """A stack of chunks at offsets, tail pads and an identity row masked
    into the null page."""
    rng = np.random.default_rng(seed)
    P, nb, page, C = 17, 4, 4, 4
    kp, vp = _pool(rng, P), _pool(rng, P)
    table = _table(rng, 3, nb, P)
    table[1, 2:] = 0                          # row 1 maps two blocks
    k, v = (rng.standard_normal((3, C, 2, 8)).astype(np.float32)
            for _ in range(2))
    off = np.array([4, 4, 8], np.int32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]], bool)
    gk, gv = A.paged_chunk_update(_t(kp), _t(vp), _t(k), _t(v), _t(off),
                                  _t(table), _t(mask))
    wk, wv = JA.paged_chunk_update(*map(jnp.asarray, (kp, vp, k, v, off,
                                                      table, mask)))
    for g, w in ((gk, wk), (gv, wv)):
        assert _rel(g.numpy()[1:], np.asarray(w)[1:]) <= ORACLE_REL
    # nothing but row 0 and row 1's two valid tokens moved off page 0
    moved = {int(p) for p, _ in np.argwhere(
        gk.numpy()[:, :, 0, 0] != kp[:, :, 0, 0]) if p}
    assert moved == {int(table[0, 1]), int(table[1, 1])}


@pytest.mark.parametrize("seed", range(3))
def test_paged_decode_attention_matches_jax(seed):
    """decode_attention through shuffled tables (a dead row reading the
    null page, per-row positions) against JAX's, and against the
    contiguous decode on the logically identical cache."""
    rng = np.random.default_rng(seed)
    B, S, H, Hkv, hd, page = 3, 16, 4, 2, 8, 4
    nb, P = S // page, 14
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp, vp = _pool(rng, P), _pool(rng, P)
    table = _table(rng, B, nb, P, dead=(2,))
    pos = np.array([13, 6, 3], np.int32)
    got = A.decode_attention(_t(q), _t(kp), _t(vp), _t(pos).long(),
                             block_table=_t(table)).numpy()
    want = np.asarray(JA.decode_attention(*map(jnp.asarray, (q, kp, vp,
                                                              pos)),
                                          block_table=jnp.asarray(table)))
    assert _rel(got, want) <= ORACLE_REL
    kc = kp[table].reshape(B, S, Hkv, hd)
    vc = vp[table].reshape(B, S, Hkv, hd)
    plain = A.decode_attention(_t(q), _t(kc), _t(vc), _t(pos).long())
    assert _rel(got, plain.numpy()) <= ORACLE_REL


# ---------------------------------------------------------------------------
# (c) the model's paged decode step and prefill chunk
# ---------------------------------------------------------------------------


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _configs(arch):
    """(JAX config, port config) at no-drop capacity; jamba at one period
    (8 layers)."""
    jc, tc = _no_drop(jax_config(arch)), _no_drop(get_config(arch))
    if arch.startswith("jamba"):
        jc = dataclasses.replace(jc, n_layers=8)
        tc = dataclasses.replace(tc, n_layers=8)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=5):
    """(JAX config, port config, JAX weights, the port's copy of them),
    drawn once per arch and seed."""
    jc, tc = _configs(arch)
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, bridge.from_jax(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")


STEP_ARCHS = ("qwen2-moe-2.7b-smoke", "granite-moe-3b-a800m-smoke",
              "mamba2-780m-smoke", "jamba-v0.1-52b-smoke")
PAGE, SEQ, SLOTS = 8, 32, 4
POOL = SLOTS * SEQ // PAGE + 1


def _paged_problem(tc, rng):
    cache = tuple({k: (rng.standard_normal(shp) * 0.5).astype(np.float32)
                   for k, (shp, _) in e.items()}
                  for e in lm.paged_cache_shapes(tc, SLOTS, POOL, PAGE))
    nb = SEQ // PAGE
    table = _table(rng, SLOTS, nb, POOL, dead=(2,))
    table[0, 3:] = 0                           # row 0 maps three blocks
    return cache, table


def _compare_cache(got, want):
    for e_got, e_want in zip(got, want):
        for k, t in e_got.items():
            g, w = t.numpy(), np.asarray(e_want[k])
            if k in ("k", "v"):                # pools on pages 1..
                g, w = g[:, 1:], w[:, 1:]
            assert _rel(g, w) < CACHE_REL, (k, _rel(g, w))


@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_paged_step_matches_jax(arch, kind):
    jc, tc, jp, tp = _weights(arch)
    rng = np.random.default_rng(len(arch))
    cache, table = _paged_problem(tc, rng)
    tcache = tuple({k: _t(v) for k, v in e.items()} for e in cache)
    jcache = tuple({k: jnp.asarray(v) for k, v in e.items()} for e in cache)
    if kind == "decode":
        tok = rng.integers(1, tc.vocab_size, (SLOTS, 1)).astype(np.int32)
        pos = np.array([21, 9, 30, 0], np.int32)
        got, tcache = lm.decode_step(tc, tp, tcache, _t(tok).long(),
                                     _t(pos).long(),
                                     block_tables=_t(table))
        want, jcache = jax.jit(lambda p, c, t, q, bt: jlm.decode_step(
            jc, p, c, t, q, JAxisCtx(), block_tables=bt))(
            jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(table))
    else:
        C = 8
        slots = np.array([3, 0, 1], np.int32)
        tok = rng.integers(1, tc.vocab_size, (3, C)).astype(np.int32)
        off = np.array([0, 16, 8], np.int32)
        valid = np.array([8, 5, 0], np.int32)
        bt = table[slots]
        got, tcache = lm.prefill_chunk(tc, tp, tcache, _t(tok).long(),
                                       _t(off), _t(valid), _t(slots),
                                       block_tables=_t(bt))
        want, jcache = jax.jit(lambda p, c, *a: jlm.prefill_chunk(
            jc, p, c, *a[:3], JAxisCtx(), slot=a[3], block_tables=a[4]))(
            jp, jcache, *map(jnp.asarray, (tok, off, valid, slots, bt)))
    assert _rel(got.numpy(), want) < LOGIT_REL, _rel(got.numpy(), want)
    _compare_cache(tcache, jcache)


# ---------------------------------------------------------------------------
# (d) the paged engine
# ---------------------------------------------------------------------------


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lens]


ENGINE_ARCHS = ("qwen2-moe-2.7b-smoke", "granite-moe-3b-a800m-smoke",
                "mamba2-780m-smoke", "jamba-v0.1-52b-smoke")


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_paged_engine_streams_match_jax_and_contiguous(arch):
    """Five requests of mixed lengths through 2 slots (slot and page
    reuse) on a pool of 6 usable pages, against JAX's paged engine and
    the port's contiguous engine; all pages back after the drain."""
    jc, tc, jp, tp = _weights(arch)
    geom = dict(max_seq=32, batch_size=2, chunk=8)
    prompts = _prompts(tc.vocab_size, [5, 13, 20, 3, 9])
    want = JaxEngine(jc, params=jp, page_size=PAGE, n_pages=7,
                     **geom).generate(prompts, max_new=5)
    eng = ServeEngine(tc, params=tp, device="cpu", page_size=PAGE,
                      n_pages=7, **geom)
    got = eng.generate(prompts, max_new=5)
    flat = ServeEngine(tc, params=tp, device="cpu", **geom).generate(
        prompts, max_new=5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.tokens, flat.tokens)
    assert got.statuses == want.statuses == ["ok"] * 5
    assert eng.free_pages == eng.n_pages - 1 == 6


def _poisson(eng, prompts, arrivals, max_new=5):
    """Submit each prompt once the engine has decoded ``arrivals[i]``
    steps (or at once when it would idle), step to the end."""
    nxt = 0
    while nxt < len(prompts) or eng.pending:
        while nxt < len(prompts) and arrivals[nxt] <= eng.decode_steps:
            eng.submit(prompts[nxt], max_new=max_new)
            nxt += 1
        if not eng.pending:
            eng.submit(prompts[nxt], max_new=max_new)
            nxt += 1
        eng.step()
    return eng


def test_paged_poisson_trace_with_slot_reuse():
    """JAX's acceptance trace (``test_paged_parity_poisson_trace_with_
    slot_reuse``): six mixed-length requests arriving by a Poisson
    process through 2 slots of a pool smaller than slots x max_seq: every
    request's tokens equal JAX's paged engine's and the port's contiguous
    engine's."""
    jc, tc, jp, tp = _weights("qwen2-0.5b-smoke", seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=int(rng.integers(2, 14))).tolist()
               for _ in range(6)]
    arrivals = np.cumsum(rng.exponential(2.0, size=6)).astype(int)
    geom = dict(max_seq=64, batch_size=2, chunk=4)
    want = _poisson(JaxEngine(jc, params=jp, page_size=8, n_pages=7,
                              **geom), prompts, arrivals)
    got = _poisson(ServeEngine(tc, params=tp, device="cpu", page_size=8,
                               n_pages=7, **geom), prompts, arrivals)
    flat = _poisson(ServeEngine(tc, params=tp, device="cpu", **geom),
                    prompts, arrivals)
    assert set(got.finished) == set(want.finished) == set(flat.finished)
    for rid, r in want.finished.items():
        assert got.finished[rid].tokens == r.tokens == \
            flat.finished[rid].tokens, rid
        assert got.finished[rid].length == r.length, rid
    assert got.admit_rounds == want.admit_rounds
    assert got.free_pages == got.n_pages - 1
    assert got.n_pages - 1 < got.B * got.max_blocks      # a tight pool


# ---------------------------------------------------------------------------
# (e) admission
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    return _weights("qwen2-0.5b-smoke", seed=0)


def test_page_gate_holds_fifo_order(small):
    """The queue's head waits for pages (not slots) and nothing is
    admitted around it; both are admitted in order once pages free
    (``test_page_budget_gates_admission``)."""
    jc, tc, jp, tp = small
    kw = dict(max_seq=32, batch_size=3, chunk=4, page_size=4, n_pages=5)
    engs = (ServeEngine(tc, params=tp, device="cpu", **kw),
            JaxEngine(jc, params=jp, **kw))
    for eng in engs:
        ra = eng.submit([1, 2, 3, 4, 5, 6], max_new=6)   # 3 pages
        rb = eng.submit([7, 8, 9], max_new=5)            # 2: waits
        rc = eng.submit([4], max_new=3)                  # 1: would fit
        eng.step()
        assert eng.slot_req[0].rid == ra
        assert [r.rid for r in eng.queue] == [rb, rc]
        assert not eng.live[1:].any() and eng.free_pages == 1
        eng.run()
        t = {r: eng.finished[r].first_token_t for r in (ra, rb, rc)}
        assert t[ra] < t[rb] <= t[rc]
        assert eng.free_pages == 4
    assert [engs[0].finished[i].tokens for i in range(3)] == \
        [engs[1].finished[i].tokens for i in range(3)]


@pytest.mark.parametrize("prompt_len,max_new,ok", [(20, 6, False),
                                                   (13, 3, True),
                                                   (13, 4, False)])
def test_over_capacity_rejected_at_submit(small, prompt_len, max_new, ok):
    """A budget needing more pages than the pool's usable 4 is rejected at
    ``submit`` with ``OVER_CAPACITY`` in both packages; one that fits is
    queued."""
    jc, tc, jp, tp = small
    kw = dict(max_seq=32, batch_size=2, chunk=4, page_size=4, n_pages=5)
    prompt = list(range(1, prompt_len + 1))
    for eng, err in ((ServeEngine(tc, params=tp, device="cpu", **kw),
                      RejectedRequest),
                     (JaxEngine(jc, params=jp, **kw), JRejected)):
        if ok:
            eng.submit(prompt, max_new=max_new)
            assert len(eng.queue) == 1
            continue
        with pytest.raises(err) as ei:
            eng.submit(prompt, max_new=max_new)
        assert ei.value.reason.value == RejectReason.OVER_CAPACITY.value
        assert ei.value.request.status.value == "rejected"
        assert not eng.queue


@pytest.mark.parametrize("admit_k", [1, 2, 0])
@pytest.mark.parametrize("page_size", [0, 8])
def test_admit_k_matches_jax(small, admit_k, page_size):
    """At most ``admit_k`` admissions per stacked call (0: every free
    slot), contiguous or paged: the streams, ``admit_rounds`` and
    ``admissions`` equal JAX's, and the streams equal sequential
    admission's."""
    jc, tc, jp, tp = small
    kw = dict(max_seq=64, batch_size=3, chunk=4, admit_k=admit_k,
              page_size=page_size)
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 10, 11, 12], [6, 6]]
    got_eng = ServeEngine(tc, params=tp, device="cpu", **kw)
    want_eng = JaxEngine(jc, params=jp, **kw)
    got = got_eng.generate(prompts, max_new=4)
    want = want_eng.generate(prompts, max_new=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert (got_eng.admit_rounds, got_eng.admissions) == \
        (want_eng.admit_rounds, want_eng.admissions)
    assert got_eng.admissions == 4
    seq = ServeEngine(tc, params=tp, device="cpu",
                      **{**kw, "admit_k": 1}).generate(prompts, max_new=4)
    np.testing.assert_array_equal(got.tokens, seq.tokens)


def test_serve_cli_pages_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "qwen2-moe-2.7b-smoke", "--device", "cpu",
                      "--requests", "5", "--batch", "2", "--max-seq", "32",
                      "--chunk", "8", "--prompt-min", "3",
                      "--prompt-max", "12", "--max-new", "3",
                      "--page-size", "8", "--pages", "6", "--admit-k", "1"])
    out = capsys.readouterr().out
    assert "paged cache: page 8 toks, 5 usable pages (5 free after drain)" \
        in out and "5 admissions" in out
    assert eng.paged and eng.admit_k == 1
    assert all(r.status.value == "ok" and len(r.tokens) == 3
               for r in eng.finished.values())


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_step_builders_take_tables_exactly_when_paged(paged, kind):
    """A paged shape's steps raise without block tables, a contiguous
    shape's with them: a pool read as a contiguous cache (or the reverse)
    would give wrong tokens silently."""
    from repro_torch.launch import train_step as TS
    shape = ShapeConfig("d", 32, 2, "decode", page_size=8 if paged else 0)
    cfg = get_config("qwen2-0.5b-smoke")
    if kind == "decode":
        fn = TS.build_decode_step(cfg, shape)["fn"]
        args = (None,) * 4 + ((None,) if paged else (None, torch.zeros(2)))
    else:
        fn = TS.build_prefill_chunk_step(cfg, shape)["fn"]
        args = (None,) * 6 + (() if paged else (torch.zeros(2),))
    with pytest.raises(ValueError, match="missing" if paged else "given"):
        fn(*args)
