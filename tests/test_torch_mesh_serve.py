"""Serving on a mesh: the port's decode step, prefill chunk and engine on
4 gloo CPU ranks against the JAX package's one-rank functions, fp32.

(a) No ranks: the split-KV partials (``decode_attention_partial``) over 4
hand-cut shards of the positions, merged (``merge_decode_partials``
without a group), against JAX ``decode_attention`` at rel 1e-5, as
``tests/test_decode_sharded.py`` holds JAX's own; a shard wholly past a
row's position gives l = acc = 0 and a finite m; the port's partials
against JAX's ``decode_attention_partial`` at 1e-5.

(b) ``build_decode_step`` on the mesh, distinct per-row positions and a
live mask, from a seeded cache: the logits (gathered over the dp group)
against JAX's one-rank ``lm.decode_step`` at rel 5e-5 (the JAX test's
bound), the next tokens equal, and every rank's cache leaf after the step
equal to its slice of JAX's new cache at 1e-5. The cells reach every arm
of ``sharded_decode_attention``: kv heads over the model axis
(qwen2-moe-2.7b-smoke, Hkv 4, with ep 4 on (1, 4) and ep 2 on (2, 2)),
split-KV (granite-moe-3b-a800m-smoke and qwen2-0.5b-smoke, Hkv 1), and
replicated (granite at a max_seq of 30, which 4 does not divide); slots
cut over dp (8 on (2, 2)) and whole on every dp rank (3 on (2, 2)); the
SSM (mamba2-780m-smoke) and the hybrid (jamba-v0.1-52b-smoke at one
period, 8 layers).

(c) ``build_prefill_chunk_step``: a stacked admission of 2 rows into
slots (3, 6) at nonzero offsets that straddle the split-KV position
slices, on (2, 2) and (1, 4): logits on every rank at rel 5e-5 and every
rank's cache leaf at 1e-5 (a K/V write landing on every rank's local
index would show there); also both rows on one dp rank's slots, so the
other runs its stand-in row.

(d) ``ServeEngine(mesh=)``: 8 requests of mixed lengths, max_new 8, 4
slots: every rank's token streams identical to JAX's one-rank
``ServeEngine``, for qwen2-moe on (2, 2) naive and on (1, 4) comet,
jamba at one period on (1, 4), and qwen2-moe at ep 4 with a plan cache
whose prefill and decode entries every MoE body must run.

(e) Every rank's cache leaf has the shape the port's ``cache_specs``
cuts, and the K/V entries are cut over the model axis where JAX's
``kv_spec`` cuts them.

(f) The paged cache (page 8): ``build_decode_step`` and
``build_prefill_chunk_step`` of a paged shape on seeded page pools and
shuffled block tables (dead rows with all-zero tables, partly mapped
rows), against JAX's one-rank ``decode_step``/``prefill_chunk`` with
``block_tables``: logits rel 5e-5, every rank's pool on pages 1.. (the
null page takes duplicate writes, whose winner is undefined in both
packages) and SSM leaves against its slice of JAX's at 1e-5. The pool's
two arms: kv heads over the model axis (qwen2-moe-2.7b-smoke, Hkv 4, on
(1, 4), and on (2, 2) with the slots cut over dp, where each dp rank
writes every slot's K/V) and replicated (granite, Hkv 1, on (1, 4));
mamba2 on (2, 2) and jamba at one period on (1, 4). The paged engine's
streams against JAX's paged engine, on those layouts and on a tight pool
with ``admit_k`` 2 on (2, 2) whose page gate stalls alike on every rank
(the same admission rounds as JAX's); a rank whose allocator hands out
its pages in another order makes every rank raise.

(g) The serving lifecycle on the mesh (``selftest.run_lifecycle``
scripts on ``ServeEngine(mesh=)``, every rank reading its own fake clock
skewed by rank, at another rate and offset): a live and a queued cancel,
the "reject" and "deadline" shed policies, poisoned rows (the injector's,
and real NaN logits on the one dp rank that holds the slot), a TTFT and
a total deadline, and crashes with snapshot recovery (paged, with a page
squeeze, and contiguous). Each on (1, 4) (kv heads) and (2, 2) (dp-cut
slots), paged on one and contiguous on the other (the crashes on both):
every rank's record (the ops' results; every request's tokens, status,
error and time stamps; the counters; the ``on_token`` emissions; the
free pages; the injector's events; the newest snapshot's scheduler blob)
equal to JAX's one-rank engine's under the same plan and an unskewed
clock. A rank given another fault plan makes every rank raise.

(h) The disaggregated topology on the mesh (``selftest.run_disagg``:
``EngineConfig(disagg=True).build(mesh=)``, every worker on the mesh, 2
prefill and 4 decode slots, the clocks skewed by rank): qwen2-moe on
(1, 4) and (2, 2), a decode-worker crash with snapshots on (2, 2), and
mamba2's SSM carry on (2, 2), whose dp-cut slot rows are gathered over dp
at export: every rank's streams, statuses, errors, ``summary()``,
emissions and injected crashes equal to JAX's one-rank Router's.

MoE capacity is the expert count (no drop): capacity follows the local
token count, so a mesh would drop other tokens than one rank does. The
ranks run ``selftest.mesh_cells``, one spawn per layout, on a thread
while this process computes the JAX references; weights, caches and
prompts cross through files.
"""
import dataclasses
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import lm as JL
from repro.parallel import sharding as JSH
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.launch import selftest as ST
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.parallel import sharding as SH

torch.set_num_threads(1)

SPAWN_TIMEOUT = 240.0          # seconds for one layout's 4 ranks
LOGIT_REL, CACHE_REL, PART_REL = 5e-5, 1e-5, 1e-5
LAYOUTS = {"dp1mp4": (1, 4), "dp2mp2": (2, 2)}
ENGINE = dict(max_seq=64, slots=4, chunk=16, max_new=8)
PROMPT_LENS = (5, 23, 40, 9, 17, 3, 30, 12)


def _no_drop(arch, over=None):
    over = dict(over or {})
    E = jax_config(arch).moe
    if E is not None:
        over["moe"] = {"capacity_factor": float(min(E.num_experts, 8)),
                       **over.get("moe", {})}
    return over


# reference problems: name -> (arch, the config's replacements)
REFS = {
    "qmoe": ("qwen2-moe-2.7b-smoke", _no_drop("qwen2-moe-2.7b-smoke")),
    "granite": ("granite-moe-3b-a800m-smoke",
                _no_drop("granite-moe-3b-a800m-smoke")),
    "q05b": ("qwen2-0.5b-smoke", {}),
    "mamba2": ("mamba2-780m-smoke", {}),
    "jamba": ("jamba-v0.1-52b-smoke",
              _no_drop("jamba-v0.1-52b-smoke", {"n_layers": 8})),
}
NAIVE = {"impl": "naive"}
COMET = {"impl": "comet", "ring_group": 1, "n_col_blocks": 2}
# decode cells: name -> (layout, ref, moe knobs, slots, max_seq, the arm)
DECODE = {
    "dec-qmoe-14": ("dp1mp4", "qmoe", COMET, 8, 32, "kv_group"),
    "dec-qmoe-22": ("dp2mp2", "qmoe", NAIVE, 8, 32, "kv_group"),
    "dec-qmoe-22-b3": ("dp2mp2", "qmoe", NAIVE, 3, 32, "kv_group"),
    "dec-granite-14": ("dp1mp4", "granite", COMET, 8, 32, "split_kv"),
    "dec-granite-22": ("dp2mp2", "granite", NAIVE, 8, 32, "split_kv"),
    "dec-q05b-14": ("dp1mp4", "q05b", None, 8, 32, "split_kv"),
    "dec-granite-s30-14": ("dp1mp4", "granite", NAIVE, 8, 30, "replicated"),
    "dec-mamba2-22": ("dp2mp2", "mamba2", None, 8, 32, None),
    "dec-jamba-14": ("dp1mp4", "jamba", COMET, 8, 32, "split_kv"),
}
# prefill-chunk cells: name -> (layout, ref, moe knobs, slots, pos_off)
CHUNK_C = 8
CHUNK_VALID = (8, 5)
CHUNK = {
    "chunk-granite-14": ("dp1mp4", "granite", NAIVE, (3, 6), (12, 4)),
    "chunk-granite-22": ("dp2mp2", "granite", NAIVE, (3, 6), (12, 4)),
    "chunk-qmoe-22": ("dp2mp2", "qmoe", NAIVE, (3, 6), (12, 4)),
    "chunk-qmoe-14": ("dp1mp4", "qmoe", COMET, (3, 6), (12, 4)),
    "chunk-qmoe-22-oneside": ("dp2mp2", "qmoe", NAIVE, (1, 2), (12, 4)),
    "chunk-mamba2-22": ("dp2mp2", "mamba2", None, (3, 6), (12, 4)),
    "chunk-jamba-14": ("dp1mp4", "jamba", COMET, (3, 6), (12, 4)),
}
CHUNK_SLOTS, CHUNK_SEQ = 8, 32
# engine cells: name -> (layout, ref, moe knobs, with a plan cache)
ENGINES = {
    "eng-qmoe-22-naive": ("dp2mp2", "qmoe", NAIVE, False),
    "eng-qmoe-14-comet": ("dp1mp4", "qmoe", COMET, False),
    "eng-jamba-14": ("dp1mp4", "jamba", COMET, False),
    "eng-qmoe-14-plan": ("dp1mp4", "qmoe", dict(NAIVE, ep=4), True),
}
# a rank whose submissions differ: every rank's engine raises
DIVERGE = ("dp2mp2", "qmoe", NAIVE, 3)
# paged cells: the page, the decode and chunk cells' pool (parity: 8 slots
# of 32 positions, 4 blocks each, and the null page)
PAGE, PAGED_SEQ, PAGED_SLOTS = 8, 32, 8
PAGED_POOL = PAGED_SLOTS * PAGED_SEQ // PAGE + 1
# the paged engine cells' parity pool (4 slots of 64 positions)
PAGED_POOL_ENGINE = ENGINE["slots"] * ENGINE["max_seq"] // PAGE + 1
# name -> (layout, ref, moe knobs, the pool's arm)
PDECODE = {
    "pdec-qmoe-14": ("dp1mp4", "qmoe", COMET, "kv_group"),
    "pdec-qmoe-22": ("dp2mp2", "qmoe", NAIVE, "kv_group"),
    "pdec-granite-14": ("dp1mp4", "granite", NAIVE, "replicated"),
    "pdec-mamba2-22": ("dp2mp2", "mamba2", None, None),
    "pdec-jamba-14": ("dp1mp4", "jamba", COMET, "replicated"),
}
# name -> (layout, ref, moe knobs, slots, pos_off), the chunk as CHUNK's
PCHUNK = {
    "pchunk-qmoe-14": ("dp1mp4", "qmoe", COMET, (3, 6), (12, 4)),
    "pchunk-qmoe-22": ("dp2mp2", "qmoe", NAIVE, (3, 6), (12, 4)),
    "pchunk-qmoe-22-oneside": ("dp2mp2", "qmoe", NAIVE, (1, 2), (12, 4)),
    "pchunk-granite-14": ("dp1mp4", "granite", NAIVE, (3, 6), (12, 4)),
    "pchunk-mamba2-22": ("dp2mp2", "mamba2", None, (3, 6), (12, 4)),
    "pchunk-jamba-14": ("dp1mp4", "jamba", COMET, (3, 6), (12, 4)),
}
# paged engines: name -> (layout, ref, moe knobs, n_pages (0: parity),
# admit_k); the tight pool's 10 usable pages hold 2-3 of the 8 requests'
# budgets (29 pages in all)
PENGINES = {
    "peng-qmoe-22": ("dp2mp2", "qmoe", NAIVE, 0, 0),
    "peng-qmoe-14": ("dp1mp4", "qmoe", COMET, 0, 0),
    "peng-granite-14": ("dp1mp4", "granite", NAIVE, 0, 0),
    "peng-mamba2-22": ("dp2mp2", "mamba2", None, 0, 0),
    "peng-jamba-14": ("dp1mp4", "jamba", COMET, 0, 0),
    "peng-tight-22": ("dp2mp2", "qmoe", NAIVE, 11, 2),
}
# a rank whose allocator hands out its pages in reverse order
PDIVERGE = ("dp2mp2", "qmoe", NAIVE, 1)
# lifecycle scripts (selftest.run_lifecycle) on the qmoe engine: name ->
# (engine knobs, fault plan, the script, its extra job keys)
def _sub(i, **kw):
    return ["submit", i, {"max_new": ENGINE["max_new"], **kw}]


SUBMIT_ALL = [_sub(i) for i in range(len(PROMPT_LENS))]
LIFECYCLE = {
    "cancel": ({}, None, SUBMIT_ALL + [
        ["step"], ["step"], ["cancel", 1], ["cancel", 6], ["cancel", 1],
        ["cancel", 99], ["run"]], {}),
    "shed-reject": ({"max_queue": 3}, None, [
        _sub(i) for i in range(5)] + [["step"]] + [
        _sub(i) for i in (5, 6, 7, 3)] + [["run"]], {}),
    "shed-deadline": ({"max_queue": 2, "shed_policy": "deadline"}, None, [
        _sub(i) for i in range(4)] + [
        ["step"], _sub(4, deadline_s=10.0), _sub(5, deadline_s=30.0),
        ["clock", 25.0], _sub(6, deadline_s=8.0), _sub(7), ["run"]], {}),
    "deadlines": ({}, None, [_sub(0, deadline_s=3.5)] + [
        _sub(i) for i in (1, 2, 3)] + [
        _sub(4, ttft_deadline_s=1.0), _sub(5, ttft_deadline_s=1.0),
        _sub(6, deadline_s=5.0), _sub(7),
        ["step"], ["clock", 0.8], ["step"], ["clock", 2.0], ["step"],
        ["clock", 4.0], ["step"], ["run"]], {}),
    "poison": ({}, {"seed": 3, "nan_rows": {"3": 1, "6": 2}},
               SUBMIT_ALL + [["run"]], {"nan_logits": [4, 2]}),
    "crash": ({"snapshot_every": 2, "max_restarts": 4},
              {"crash_steps": [1, 5], "page_squeeze": {"2": [3, 2]}},
              SUBMIT_ALL + [["run"]], {"snapshot": True}),
}
# name -> (layout, script, paged)
LIFE_CELLS = {}
for _i, _s in enumerate(LIFECYCLE):
    for _j, _lay in enumerate(LAYOUTS):
        for _paged in ((True, False) if _s == "crash"
                       else ((_i + _j) % 2 == 0,)):
            LIFE_CELLS[f"life-{_s}-{_lay}-{'p' if _paged else 'c'}"] = (
                _lay, _s, _paged)
# every rank but rank 1 runs without faults: the poisoned row retires on
# rank 1 only, and the next step's checksum makes every rank raise
LIFE_DIVERGE = ("dp2mp2", {"1": {"nan_rows": {"3": 1}}})
# the disaggregated topology (router 1x1, 2 prefill and 4 decode slots,
# both cut over dp on (2, 2)): name -> (layout, ref, the cell's extras)
DISAGG_EC = dict(max_seq=ENGINE["max_seq"], chunk=ENGINE["chunk"],
                 page_size=PAGE, prefill_slots=2, decode_slots=4)
DISAGG = {
    "disagg-qmoe-14": ("dp1mp4", "qmoe", {}),
    "disagg-qmoe-22": ("dp2mp2", "qmoe", {}),
    "disagg-qmoe-22-crash": ("dp2mp2", "qmoe", {
        "crash_workers": {"8": ["decode", 0]}, "snapshot": True,
        "ec": dict(DISAGG_EC, snapshot_every=2, max_restarts=4,
                   recover=True)}),
    "disagg-mamba2-22": ("dp2mp2", "mamba2", {}),
}
PLANS = {"prefill": dict(impl="naive", ring_group=1, n_col_blocks=1,
                         gemm_impl="xla", phase="prefill"),
         "decode": dict(impl="coarse", ring_group=1, n_col_blocks=1,
                        gemm_impl="xla", phase="decode")}


def _over(ref, moe):
    over = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in REFS[ref][1].items()}
    if moe:
        over["moe"] = {**over.get("moe", {}), **moe}
    return over


def _jax_cfg(ref):
    """The JAX reference's config: the naive transport at one rank."""
    arch, over = REFS[ref]
    over = dict(over)
    cfg = jax_config(arch)
    if "moe" in over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **{**over.pop("moe"), "impl": "naive"}))
    return dataclasses.replace(cfg, **over)


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(t)
            for p, t in tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           tree))}


def _cache(cfg, B, S, rng):
    """A seeded global one-rank cache (numpy), the layout both packages
    share (the port's ``lm.cache_shapes`` of the same config)."""
    pcfg = dataclasses.replace(get_config(cfg.name), n_layers=cfg.n_layers)
    return tuple({k: (rng.standard_normal(shp) * 0.5).astype(np.float32)
                  for k, (shp, _) in e.items()}
                 for e in lm.cache_shapes(pcfg, B, S))


def _paged_cache(cfg, B, rng):
    """A seeded global paged cache (numpy) of ``PAGED_POOL`` pages."""
    pcfg = dataclasses.replace(get_config(cfg.name), n_layers=cfg.n_layers)
    return tuple({k: (rng.standard_normal(shp) * 0.5).astype(np.float32)
                  for k, (shp, _) in e.items()}
                 for e in lm.paged_cache_shapes(pcfg, B, PAGED_POOL, PAGE))


def _tables(rng, rows, blocks):
    """Block tables of ``rows`` (B,) rows over ``PAGED_POOL`` pages, the
    pages shuffled, row b mapping its first blocks[b] blocks (0: a dead
    row, all null)."""
    nb = PAGED_SEQ // PAGE
    pages = iter(rng.permutation(np.arange(1, PAGED_POOL)).tolist())
    t = np.zeros((rows, nb), np.int32)
    for b in range(rows):
        for i in range(blocks[b]):
            t[b, i] = next(pages)
    return t


def _cache_arrays(cache):
    return {f"cache/{i}/{k}": v for i, e in enumerate(cache)
            for k, v in e.items()}


def _jcache(cache):
    return tuple({k: jnp.asarray(v) for k, v in e.items()} for e in cache)


def _inputs(in_dir):
    """Weights of every reference and each cell's inputs as npz files for
    the ranks; returns what the JAX references need."""
    params = {}
    for i, ref in enumerate(REFS):
        params[ref] = JL.init_params(_jax_cfg(ref), jax.random.PRNGKey(i))
    pflat = {ref: {f"params/{k}": v for k, v in _flat(p).items()}
             for ref, p in params.items()}
    todo = {}
    for j, (name, (_, ref, _, B, S, _)) in enumerate(DECODE.items()):
        cfg = _jax_cfg(ref)
        rng = np.random.default_rng(200 + j)
        cache = _cache(cfg, B, S, rng)
        tokens = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = rng.choice(S, size=B, replace=False).astype(np.int32)
        live = rng.random(B) < 0.75
        todo[name] = (ref, cache, tokens, pos, live)
        np.savez(Path(in_dir) / f"{name}.npz", **pflat[ref],
                 **_cache_arrays(cache), tokens=tokens, pos=pos, live=live)
    for j, (name, (_, ref, _, slots, offs)) in enumerate(CHUNK.items()):
        cfg = _jax_cfg(ref)
        rng = np.random.default_rng(300 + j)
        cache = _cache(cfg, CHUNK_SLOTS, CHUNK_SEQ, rng)
        tokens = rng.integers(1, cfg.vocab_size, (len(slots), CHUNK_C)
                              ).astype(np.int32)
        args = [np.array(v, np.int32) for v in (offs, CHUNK_VALID, slots)]
        todo[name] = (ref, cache, tokens, *args)
        np.savez(Path(in_dir) / f"{name}.npz", **pflat[ref],
                 **_cache_arrays(cache), tokens=tokens, pos_off=args[0],
                 valid_len=args[1], slots=args[2])
    for j, (name, (_, ref, _, _)) in enumerate(PDECODE.items()):
        cfg = _jax_cfg(ref)
        rng = np.random.default_rng(500 + j)
        B, nb = PAGED_SLOTS, PAGED_SEQ // PAGE
        cache = _paged_cache(cfg, B, rng)
        blocks = rng.integers(1, nb + 1, B)
        blocks[[2, 5]] = 0                              # dead rows
        tables = _tables(rng, B, blocks)
        pos = np.array([rng.integers(0, max(1, n) * PAGE) for n in blocks],
                       np.int32)
        tokens = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        live = blocks > 0
        todo[name] = (ref, cache, tokens, pos, live, tables)
        np.savez(Path(in_dir) / f"{name}.npz", **pflat[ref],
                 **_cache_arrays(cache), tokens=tokens, pos=pos, live=live,
                 tables=tables)
    for j, (name, (_, ref, _, slots, offs)) in enumerate(PCHUNK.items()):
        cfg = _jax_cfg(ref)
        rng = np.random.default_rng(600 + j)
        cache = _paged_cache(cfg, PAGED_SLOTS, rng)
        tables = _tables(rng, len(slots), (3, 2))
        tokens = rng.integers(1, cfg.vocab_size, (len(slots), CHUNK_C)
                              ).astype(np.int32)
        args = [np.array(v, np.int32) for v in (offs, CHUNK_VALID, slots)]
        todo[name] = (ref, cache, tokens, *args, tables)
        np.savez(Path(in_dir) / f"{name}.npz", **pflat[ref],
                 **_cache_arrays(cache), tokens=tokens, pos_off=args[0],
                 valid_len=args[1], slots=args[2], tables=tables)
    for ref in sorted({r for _, r, _, _ in ENGINES.values()}
                      | {r for _, r, _, _, _ in PENGINES.values()}):
        rng = np.random.default_rng(400)
        prompts = [rng.integers(1, _jax_cfg(ref).vocab_size, n).tolist()
                   for n in PROMPT_LENS]
        todo[f"engine-{ref}"] = (ref, prompts)
        np.savez(Path(in_dir) / f"engine-{ref}.npz", **pflat[ref],
                 prompts=json.dumps(prompts))
    for name, (_, ref, _, n_pages, admit_k) in PENGINES.items():
        todo[name] = (ref, todo[f"engine-{ref}"][1], n_pages, admit_k)
    return params, todo


def _references(params, todo):
    """The JAX package's one-rank results of every cell. The jitted steps
    are shared by the cells of one reference (each shape compiles once),
    and the engine runs by the cells of one reference and paging."""
    refs, fns, engines = {}, {}, {}

    def step(ref, kind):
        if (ref, kind) not in fns:
            cfg = _jax_cfg(ref)
            if kind == "decode":
                fns[ref, kind] = jax.jit(lambda p, c, t, q, bt: JL.decode_step(
                    cfg, p, c, t, q, JAxisCtx(), block_tables=bt))
            else:
                fns[ref, kind] = jax.jit(
                    lambda p, c, t, o, v, s, bt: JL.prefill_chunk(
                        cfg, p, c, t, o, v, JAxisCtx(), slot=s,
                        block_tables=bt))
        return fns[ref, kind]

    for name, (ref, *args) in todo.items():
        cfg, p = _jax_cfg(ref), params[ref]
        if name in DECODE or name in PDECODE:
            cache, tokens, pos, live, *bt = args
            logits, new = step(ref, "decode")(
                p, _jcache(cache), jnp.asarray(tokens), jnp.asarray(pos),
                jnp.asarray(bt[0]) if bt else None)
            logits = np.asarray(logits)
            refs[name] = {"logits": logits,
                          "next_tok": np.where(live, logits.argmax(-1), 0)}
        elif name in CHUNK or name in PCHUNK:
            cache, tokens, offs, valid, slots, *bt = args
            logits, new = step(ref, "chunk")(
                p, _jcache(cache), *map(jnp.asarray,
                                        (tokens, offs, valid, slots)),
                jnp.asarray(bt[0]) if bt else None)
            refs[name] = {"logits": np.asarray(logits)}
        else:
            prompts, *paging = args
            key = (ref,) + tuple(paging)
            if key not in engines:
                kw = ({} if not paging else
                      dict(page_size=PAGE, n_pages=paging[0],
                           admit_k=paging[1]))
                eng = JaxEngine(cfg, params=p, max_seq=ENGINE["max_seq"],
                                batch_size=ENGINE["slots"],
                                chunk=ENGINE["chunk"], **kw)
                out = eng.generate(prompts, max_new=ENGINE["max_new"])
                engines[key] = {"tokens": out.tokens,
                                "lengths": out.lengths,
                                "statuses": out.statuses,
                                "admit_rounds": eng.admit_rounds,
                                "free_pages": eng.free_pages,
                                "n_pages": eng.n_pages}
            refs[name] = engines[key]
            continue
        refs[name]["cache"] = [{k: np.asarray(v) for k, v in e.items()}
                               for e in new]
    return refs


def _lifecycle_refs(params, prompts):
    """JAX's one-rank engine through each lifecycle script, paged and
    contiguous, on an unskewed clock: {(script, paged): record}."""
    import tempfile

    from repro.serving import FaultInjector, FaultPlan
    out = {}
    for script, paged in sorted({(s, p) for _, s, p in
                                 LIFE_CELLS.values()}):
        kw, plan, ops, extra = LIFECYCLE[script]
        clock, emissions = ST.ScriptClock(), []
        with tempfile.TemporaryDirectory() as tmp:
            eng = JaxEngine(
                _jax_cfg("qmoe"), params=params["qmoe"],
                max_seq=ENGINE["max_seq"], batch_size=ENGINE["slots"],
                chunk=ENGINE["chunk"], clock=clock,
                on_token=lambda *e: emissions.append(e),
                faults=(FaultInjector(ST.plan_from_json(FaultPlan, plan))
                        if plan else None),
                snapshot_dir=tmp if extra.get("snapshot") else None,
                **({"page_size": PAGE} if paged else {}), **kw)
            if "nan_logits" in extra:
                at, slot = extra["nan_logits"]
                real = eng.decode["jit"]

                def poisoned(*a, _real=real, _eng=eng):
                    nxt, logits, cache = _real(*a)
                    if _eng.step_idx == at:
                        logits = logits.at[slot].set(jnp.nan)
                    return nxt, logits, cache

                eng.decode["jit"] = poisoned
            rec = ST.run_lifecycle(eng, ops, prompts, clock, emissions)
            if eng.ckpt is not None:
                rec["extra"] = eng.ckpt.load_extra()
        out[script, paged] = json.loads(json.dumps(rec))
    return out


def _disagg_refs(params, todo):
    """JAX's one-rank Router through each disagg cell, on an unskewed
    clock: {name: record}."""
    import tempfile

    from repro.serving import EngineConfig, FaultInjector, FaultPlan
    out = {}
    for name, (_, ref, extra) in DISAGG.items():
        clock, emissions = ST.ScriptClock(), []
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(extra.get("ec", DISAGG_EC))
            if extra.get("snapshot"):
                kw["snapshot_dir"] = tmp
            ec = EngineConfig(disagg=True, **kw)
            inj = None
            if extra.get("crash_workers"):
                plan = ST.plan_from_json(
                    FaultPlan, {"crash_workers": extra["crash_workers"]})
                inj = {t: FaultInjector(plan, role=t)
                       for t in ec.worker_targets()}
            router = ec.build(_jax_cfg(ref), params=params[ref], clock=clock,
                              on_token=lambda *e: emissions.append(e),
                              faults=inj)
            rec = ST.run_disagg(router, todo[f"engine-{ref}"][1],
                                ENGINE["max_new"], emissions, inj)
        out[name] = json.loads(json.dumps(rec))
    return out


def _plan_counts():
    """The MoE token counts of the plan cell's calls at ep 4 on (1, 4):
    a decode step routes the slots, a prefill chunk its stack (1 to
    ``slots`` rows) of ``chunk`` tokens."""
    B, C = ENGINE["slots"], ENGINE["chunk"]
    return {"prefill": [a * C for a in range(1, B + 1)], "decode": [B]}


def _jobs(layout, in_dir):
    jobs = []
    for name, (lay, ref, moe, B, S, _) in DECODE.items():
        if lay == layout:
            jobs.append(dict(name=name, kind="decode", arch=REFS[ref][0],
                             over=_over(ref, moe), data=name, slots=B,
                             max_seq=S))
    for name, (lay, ref, moe, _, _) in CHUNK.items():
        if lay == layout:
            jobs.append(dict(name=name, kind="chunk", arch=REFS[ref][0],
                             over=_over(ref, moe), data=name,
                             slots=CHUNK_SLOTS, max_seq=CHUNK_SEQ))
    counts = _plan_counts()
    for name, (lay, ref, moe, plan) in ENGINES.items():
        if lay == layout:
            job = dict(name=name, kind="engine", arch=REFS[ref][0],
                       over=_over(ref, moe), data=f"engine-{ref}", **ENGINE)
            if plan:
                job["plans"] = {ph: (p, counts[ph])
                                for ph, p in PLANS.items()}
                job["cache"] = str(Path(in_dir) / f"{name}.json")
            jobs.append(job)
    lay, ref, moe, rank = DIVERGE
    if lay == layout:
        jobs.append(dict(name="eng-diverge", kind="engine",
                         arch=REFS[ref][0], over=_over(ref, moe),
                         data=f"engine-{ref}", swap_on_rank=rank, **ENGINE))
    paged = dict(page_size=PAGE, n_pages=PAGED_POOL, slots=PAGED_SLOTS,
                 max_seq=PAGED_SEQ)
    for cells, kind in ((PDECODE, "decode"), (PCHUNK, "chunk")):
        for name, (lay, ref, moe, *_) in cells.items():
            if lay == layout:
                jobs.append(dict(name=name, kind=kind, arch=REFS[ref][0],
                                 over=_over(ref, moe), data=name, **paged))
    for name, (lay, ref, moe, n_pages, admit_k) in PENGINES.items():
        if lay == layout:
            jobs.append(dict(name=name, kind="engine", arch=REFS[ref][0],
                             over=_over(ref, moe), data=f"engine-{ref}",
                             page_size=PAGE, n_pages=n_pages,
                             admit_k=admit_k, **ENGINE))
    lay, ref, moe, rank = PDIVERGE
    if lay == layout:
        jobs.append(dict(name="peng-diverge", kind="engine",
                         arch=REFS[ref][0], over=_over(ref, moe),
                         data=f"engine-{ref}", page_size=PAGE,
                         reverse_free_on_rank=rank, **ENGINE))
    moe = {"dp1mp4": COMET, "dp2mp2": NAIVE}[layout]
    for name, (lay, script, paged) in LIFE_CELLS.items():
        if lay == layout:
            kw, plan, ops, extra = LIFECYCLE[script]
            jobs.append(dict(
                name=name, kind="lifecycle", arch=REFS["qmoe"][0],
                over=_over("qmoe", moe), data="engine-qmoe", script=ops,
                plan=plan, engine_kw=dict(
                    kw, **({"page_size": PAGE} if paged else {})),
                **extra, **ENGINE))
    for name, (lay, ref, extra) in DISAGG.items():
        if lay == layout:
            jobs.append(dict({"ec": DISAGG_EC, **extra}, name=name,
                             kind="disagg", arch=REFS[ref][0],
                             over=_over(ref, moe if ref == "qmoe" else None),
                             data=f"engine-{ref}",
                             max_new=ENGINE["max_new"]))
    lay, plans = LIFE_DIVERGE
    if lay == layout:
        jobs.append(dict(name="life-diverge", kind="lifecycle",
                         arch=REFS["qmoe"][0], over=_over("qmoe", moe),
                         data="engine-qmoe", script=SUBMIT_ALL + [["run"]],
                         plan=None, plan_on_rank=plans, **ENGINE))
    return jobs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawns both layouts on a thread, computes the JAX references
    meanwhile; returns (layout -> out dir, references)."""
    in_dir = tmp_path_factory.mktemp("in")
    params, todo = _inputs(in_dir)
    outs = {lay: tmp_path_factory.mktemp(lay) for lay in LAYOUTS}
    errors = []

    def spawn_all():
        try:
            for lay, shape in LAYOUTS.items():
                ST.spawn(4, ST.mesh_cells,
                         (shape, _jobs(lay, in_dir), str(in_dir),
                          str(outs[lay])), device="cpu",
                         timeout=SPAWN_TIMEOUT)
        except BaseException as e:        # re-raised in the test process
            errors.append(e)

    th = threading.Thread(target=spawn_all)
    th.start()
    refs = _references(params, todo)
    th.join()
    if errors:
        raise errors[0]
    # after the ranks end: a long run of small XLA calls beside them
    # starves the ranks of cores
    refs.update(_lifecycle_refs(params, todo["engine-qmoe"][1]))
    refs.update(_disagg_refs(params, todo))
    return outs, refs


def _load(run, layout, name):
    return np.load(run[0][layout] / f"{name}.npz")


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _ranks(got):
    return sorted({int(k.split("/")[0][4:]) for k in got.files})


def _slice(full, spec, sizes, coords):
    """The slice of ``full`` a rank at ``coords`` holds under ``spec``."""
    idx = []
    for n, e in zip(full.shape, spec):
        axes = [] if e is None else [e] if isinstance(e, str) else list(e)
        pieces, i = 1, 0
        for a in axes:
            pieces, i = pieces * sizes[a], i * sizes[a] + coords[a]
        idx.append(slice(i * n // pieces, (i + 1) * n // pieces))
    return full[tuple(idx)]


def _check_caches(got, want_cache, layout, paged=False):
    """Every rank's cache leaf against its slice of the JAX cache; a
    ``paged`` cache's pools on pages 1.. (the null page takes duplicate
    writes)."""
    sizes = dict(zip(("data", "model"), LAYOUTS[layout]))
    for r in _ranks(got):
        coords = dict(zip(("data", "model"),
                          got[f"rank{r}/coords"].tolist()))
        for i, e in enumerate(want_cache):
            for k, full in e.items():
                spec = json.loads(str(got[f"rank{r}/spec/{i}/{k}"]))
                leaf = got[f"rank{r}/cache/{i}/{k}"]
                want = _slice(full, spec, sizes, coords)
                assert leaf.shape == want.shape, (r, i, k, leaf.shape)
                if paged and k in ("k", "v"):
                    leaf, want = leaf[:, 1:], want[:, 1:]
                assert _rel(leaf, want) < CACHE_REL, (r, i, k,
                                                      _rel(leaf, want))


# ---------------------------------------------------------------------------
# (a) the split-KV partials, no ranks
# ---------------------------------------------------------------------------


def _decode_problem(seed=0, B=3, S=32, H=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    pos = np.array([5, 31, 17][:B], np.int32)
    return q, k, v, pos


def _partials(q, k, v, pos, n, kv_start=None):
    S = k.shape[1]
    Sl = S // n
    parts = [A.decode_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k[:, i * Sl:(i + 1) * Sl]),
        torch.from_numpy(v[:, i * Sl:(i + 1) * Sl]),
        torch.from_numpy(pos).long(), i * Sl,
        None if kv_start is None else torch.from_numpy(kv_start).long())
        for i in range(n)]
    return [torch.stack(t) for t in zip(*parts)]


@pytest.mark.parametrize("kv_start", [None, (0, 9, 3)])
def test_split_kv_merge_matches_jax_decode(kv_start):
    q, k, v, pos = _decode_problem()
    ks = None if kv_start is None else np.array(kv_start, np.int32)
    m, l, acc = _partials(q, k, v, pos, 4, ks)
    got = A.merge_decode_partials(m, l, acc).transpose(1, 2).numpy()
    want = np.asarray(JA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        None if ks is None else jnp.asarray(ks)))
    assert _rel(got, want) < PART_REL, _rel(got, want)


def test_shard_past_pos_is_empty():
    q, k, v, pos = _decode_problem()
    m, l, acc = _partials(q, k, v, pos, 4)
    # shard 3 holds positions 24..31: wholly past rows 0 (pos 5) and 2 (17)
    for row in (0, 2):
        assert torch.all(l[3, row] == 0) and torch.all(acc[3, row] == 0)
        assert torch.all(torch.isfinite(m[3, row]))
    assert torch.all(l[3, 1] > 0)                   # row 1 reaches it
    assert torch.all(torch.isfinite(m)) and torch.all(torch.isfinite(acc))


@pytest.mark.parametrize("shard", range(4))
def test_partials_match_jax(shard):
    q, k, v, pos = _decode_problem(seed=1)
    ks = np.array([0, 9, 3], np.int32)
    Sl = 8
    kv = [t[:, shard * Sl:(shard + 1) * Sl] for t in (k, v)]
    m, l, acc = (t.numpy() for t in A.decode_attention_partial(
        torch.from_numpy(q), *map(torch.from_numpy, kv),
        torch.from_numpy(pos).long(), shard * Sl,
        torch.from_numpy(ks).long()))
    jm, jl, jacc = (np.asarray(t) for t in JA.decode_attention_partial(
        jnp.asarray(q), *map(jnp.asarray, kv), jnp.asarray(pos),
        shard * Sl, jnp.asarray(ks)))
    reached = jl > 0
    np.testing.assert_array_equal(l > 0, reached)
    assert _rel(m[reached], jm[reached]) < PART_REL
    np.testing.assert_array_equal(m[~reached], jm[~reached])
    assert _rel(l, jl) < PART_REL and _rel(acc, jacc) < PART_REL


# ---------------------------------------------------------------------------
# (b) decode steps, (c) prefill chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(DECODE))
def test_decode_step_matches_jax(run, cell):
    layout = DECODE[cell][0]
    got = _load(run, layout, cell)
    want = run[1][cell]
    for r in _ranks(got):
        assert _rel(got[f"rank{r}/logits"], want["logits"]) < LOGIT_REL, (
            r, _rel(got[f"rank{r}/logits"], want["logits"]))
        np.testing.assert_array_equal(got[f"rank{r}/next_tok"][:, 0],
                                      want["next_tok"])
    _check_caches(got, want["cache"], layout)


@pytest.mark.parametrize("cell", list(CHUNK))
def test_prefill_chunk_matches_jax(run, cell):
    layout = CHUNK[cell][0]
    got = _load(run, layout, cell)
    want = run[1][cell]
    for r in _ranks(got):
        assert _rel(got[f"rank{r}/logits"], want["logits"]) < LOGIT_REL, (
            r, _rel(got[f"rank{r}/logits"], want["logits"]))
    _check_caches(got, want["cache"], layout)


def test_cells_reach_every_decode_arm():
    """The decode cells' configs at their layouts take each arm of
    ``sharded_decode_attention``, with the slots cut over dp and not."""
    arms, cut = set(), set()
    for layout, ref, moe, B, S, arm in DECODE.values():
        cfg = ST.cell_config(REFS[ref][0], _over(ref, moe))
        ctx = SH.make_ctx(cfg, _StubMesh(dict(zip(("data", "model"),
                                                  LAYOUTS[layout]))))
        if cfg.attn is not None:
            got = SH.kv_cut(ctx, cfg.attn.n_kv_heads, S)
            assert got == arm
            arms.add(got)
        cut.add(SH.slots_cut(ctx, B))
    assert arms == {"kv_group", "split_kv", "replicated"}
    assert cut == {True, False}


# ---------------------------------------------------------------------------
# (d) the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(ENGINES))
def test_engine_token_streams_match_jax(run, cell):
    layout, ref = ENGINES[cell][:2]
    got = _load(run, layout, cell)
    want = run[1][f"engine-{ref}"]
    assert want["statuses"] == ["ok"] * len(PROMPT_LENS)
    for r in _ranks(got):
        np.testing.assert_array_equal(got[f"rank{r}/tokens"],
                                      want["tokens"])
        np.testing.assert_array_equal(got[f"rank{r}/lengths"],
                                      want["lengths"])
        assert got[f"rank{r}/statuses"].tolist() == want["statuses"]


def test_engine_runs_the_cached_plans(run):
    """Every prefill chunk's MoE body ran the cache's prefill plan and
    every decode step's its decode plan, on every rank."""
    got = _load(run, "dp1mp4", "eng-qmoe-14-plan")
    for r in _ranks(got):
        impl = got[f"rank{r}/ran/impl"]
        seq = got[f"rank{r}/ran/seq"]
        gemm = got[f"rank{r}/ran/gemm_impl"]
        assert (seq > 1).any() and (seq == 1).any()
        assert set(impl[seq > 1]) == {"naive"}
        assert set(impl[seq == 1]) == {"coarse"}
        assert set(gemm) == {"xla"}
        counts = _plan_counts()
        assert set(got[f"rank{r}/ran/tokens"][seq > 1]) <= set(
            counts["prefill"])
        assert set(got[f"rank{r}/ran/tokens"][seq == 1]) == set(
            counts["decode"])


def test_engine_raises_when_a_rank_diverges(run):
    """One rank submits the first two prompts swapped: the step's
    checksum all-reduce makes every rank raise before the admission's
    collectives, instead of hanging."""
    got = _load(run, DIVERGE[0], "eng-diverge")
    ranks = _ranks(got)
    assert len(ranks) == 4
    for r in ranks:
        assert "schedulers diverged" in str(got[f"rank{r}/error"])


# ---------------------------------------------------------------------------
# (e) the cache's layout
# ---------------------------------------------------------------------------


class _StubMesh:
    """Just a mesh's axis sizes (and a rank's coordinates, all 0): enough
    for ``make_ctx``, the specs in both packages and ``local_shape``."""

    def __init__(self, shape):
        self.shape = shape
        self.coords = {a: 0 for a in shape}

    def model_subgroups(self, model_axis, etp):
        return None, None


def _cuts(spec, sizes):
    """Per dimension, the mesh axes of more than one rank it is cut over
    (a cut over an axis of one rank, as JAX's specs make at dp 1, is no
    cut)."""
    out = []
    for e in spec:
        axes = [] if e is None else [e] if isinstance(e, str) else list(e)
        out.append(tuple(a for a in axes if sizes[a] > 1))
    return out


@pytest.mark.parametrize("cell", list(DECODE) + list(CHUNK))
def test_cache_leaves_are_cut_as_the_specs_say(run, cell):
    """Every rank's leaf has the shape the port's ``cache_specs`` cuts
    from the global cache, and each K/V spec cuts the model axis where
    JAX's ``kv_spec`` does."""
    if cell in DECODE:
        layout, ref, moe, B, S, _ = DECODE[cell]
    else:
        layout, ref, moe = CHUNK[cell][:3]
        B, S = CHUNK_SLOTS, CHUNK_SEQ
    sizes = dict(zip(("data", "model"), LAYOUTS[layout]))
    cfg = ST.cell_config(REFS[ref][0], _over(ref, moe))
    ctx = SH.make_ctx(cfg, _StubMesh(sizes), seq_shard=False)
    specs = SH.cache_specs(cfg, ctx, B, S)
    jcfg = _jax_cfg(ref)
    jspecs = JSH.cache_specs(jcfg, JSH.make_ctx(jcfg, _StubMesh(sizes),
                                                seq_shard=False), B, S)
    shapes = lm.cache_shapes(cfg, B, S)
    got = _load(run, layout, cell)
    for i, e in enumerate(shapes):
        for k, (shp, _) in e.items():
            if k in ("k", "v"):
                assert _cuts(jspecs[i][k], sizes) == _cuts(specs[i][k],
                                                           sizes)
            local = SH.local_shape(shp, specs[i][k], _StubMesh(sizes))
            for r in _ranks(got):
                assert json.loads(str(got[f"rank{r}/spec/{i}/{k}"])) == \
                    [list(x) if isinstance(x, tuple) else x
                     for x in specs[i][k]]
                assert tuple(got[f"rank{r}/cache/{i}/{k}"].shape) == local


def test_kv_cache_per_rank_is_a_quarter_on_1x4():
    """qwen2-moe-2.7b's whole decode cache (8 slots of 1024) on a (1, 4)
    mesh: each rank's K/V bytes are a quarter of the one-rank cache's,
    from the shapes (16 kv heads over 4 ranks)."""
    cfg = get_config("qwen2-moe-2.7b")
    sizes = {"data": 1, "model": 4}
    ctx = SH.make_ctx(cfg, _StubMesh(sizes), seq_shard=False)
    specs = SH.cache_specs(cfg, ctx, 8, 1024)
    whole = local = 0
    for e, sp in zip(lm.cache_shapes(cfg, 8, 1024), specs):
        for k, (shp, dt) in e.items():
            size = torch.empty((), dtype=dt).element_size()
            whole += int(np.prod(shp)) * size
            local += int(np.prod(SH.local_shape(shp, sp[k],
                                                _StubMesh(sizes)))) * size
    assert local * 4 == whole


def test_unported_serving_paths_raise_by_name():
    """The monolithic prefill builds at one rank and runs there (logits
    (B, V), a cache entry per period position); on a mesh it raises,
    naming its ROADMAP item; the disaggregated topology builds its Router
    once its config validates;
    the paged arm of the sharded decode attention runs: through a block
    table it gives the decode over the gathered logical view, and a pool
    is never taken over positions."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import train_step as TS
    from repro_torch.models import blocks
    cfg = get_config("qwen2-moe-2.7b-smoke")
    shape = ShapeConfig("serve", 32, 4, "decode")
    built = TS.build_prefill_step(cfg, shape)
    assert built["batch_structs"] == {"tokens": (4, 32)}
    params = lm.init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 32),
                         generator=torch.Generator().manual_seed(1))
    logits, cache = built["fn"](params, {"tokens": toks})
    assert logits.shape == (4, cfg.vocab_size) and len(cache) == \
        lm.period_of(cfg)
    assert cache[0]["k"].shape[:3] == (cfg.n_layers // lm.period_of(cfg),
                                       4, 32)
    with pytest.raises(NotImplementedError, match="mesh monolithic prefill"):
        TS.build_prefill_step(cfg, shape, mesh=_StubMesh({"data": 1,
                                                          "model": 4}))
    from repro_torch.serving import EngineConfig, Router
    assert isinstance(EngineConfig(disagg=True, page_size=8).build(
        cfg, device="cpu"), Router)
    with pytest.raises(ValueError, match="paged KV cache"):
        EngineConfig(disagg=True)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, 4, 32), generator=gen)
    pool = torch.randn((5, 8, 4, 32), generator=gen)
    table = torch.tensor([[3, 1, 0, 0], [2, 4, 0, 0]])
    pos = torch.tensor([9, 12])
    got = blocks.sharded_decode_attention(None, q, pool, pool, pos,
                                          "replicated", block_table=table)
    view = A.paged_gather(pool, table)
    torch.testing.assert_close(got, A.decode_attention(q, view, view, pos),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="never cut over positions"):
        blocks.sharded_decode_attention(None, q, pool, pool, pos,
                                        "split_kv", block_table=table)


# ---------------------------------------------------------------------------
# (f) the paged cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(PDECODE))
def test_paged_decode_step_matches_jax(run, cell):
    layout = PDECODE[cell][0]
    got = _load(run, layout, cell)
    want = run[1][cell]
    for r in _ranks(got):
        assert _rel(got[f"rank{r}/logits"], want["logits"]) < LOGIT_REL, (
            r, _rel(got[f"rank{r}/logits"], want["logits"]))
        np.testing.assert_array_equal(got[f"rank{r}/next_tok"][:, 0],
                                      want["next_tok"])
    _check_caches(got, want["cache"], layout, paged=True)


@pytest.mark.parametrize("cell", list(PCHUNK))
def test_paged_prefill_chunk_matches_jax(run, cell):
    layout = PCHUNK[cell][0]
    got = _load(run, layout, cell)
    want = run[1][cell]
    for r in _ranks(got):
        assert _rel(got[f"rank{r}/logits"], want["logits"]) < LOGIT_REL, (
            r, _rel(got[f"rank{r}/logits"], want["logits"]))
    _check_caches(got, want["cache"], layout, paged=True)


@pytest.mark.parametrize("cell", list(PDECODE) + list(PCHUNK))
def test_paged_pools_are_cut_as_the_specs_say(run, cell):
    """Every rank's leaf has the shape the port's ``paged_cache_specs``
    cuts, each pool is cut over the model axis where JAX's
    ``paged_cache_specs`` cuts it (never over its pages), and the decode
    cells take the pool arm they name."""
    layout, ref, moe = (PDECODE.get(cell) or PCHUNK[cell])[:3]
    sizes = dict(zip(("data", "model"), LAYOUTS[layout]))
    cfg = ST.cell_config(REFS[ref][0], _over(ref, moe))
    ctx = SH.make_ctx(cfg, _StubMesh(sizes), seq_shard=False)
    specs = SH.paged_cache_specs(cfg, ctx, PAGED_SLOTS)
    jcfg = _jax_cfg(ref)
    jspecs = JSH.paged_cache_specs(jcfg, JSH.make_ctx(
        jcfg, _StubMesh(sizes), seq_shard=False), PAGED_SLOTS)
    got = _load(run, layout, cell)
    for i, e in enumerate(lm.paged_cache_shapes(cfg, PAGED_SLOTS,
                                                PAGED_POOL, PAGE)):
        for k, (shp, _) in e.items():
            if k in ("k", "v"):
                assert _cuts(jspecs[i][k], sizes) == _cuts(specs[i][k],
                                                           sizes)
                assert specs[i][k][1] is None and specs[i][k][2] is None
            local = SH.local_shape(shp, specs[i][k], _StubMesh(sizes))
            for r in _ranks(got):
                assert tuple(got[f"rank{r}/cache/{i}/{k}"].shape) == local
    if cell in PDECODE and cfg.attn is not None:
        assert SH.kv_cut(ctx, cfg.attn.n_kv_heads, PAGED_SEQ,
                         paged=True) == PDECODE[cell][3]


def test_paged_cells_reach_both_pool_arms():
    """The paged decode cells take both arms of a pool (kv heads and
    replicated), with the slots cut over dp and not; the unpaged kv_cut
    of the replicated cells' configs would have cut them over positions."""
    arms, cut = set(), set()
    for layout, ref, moe, arm in PDECODE.values():
        cfg = ST.cell_config(REFS[ref][0], _over(ref, moe))
        ctx = SH.make_ctx(cfg, _StubMesh(dict(zip(("data", "model"),
                                                  LAYOUTS[layout]))))
        cut.add(SH.slots_cut(ctx, PAGED_SLOTS))
        if arm is not None:
            arms.add(arm)
            if arm == "replicated":
                assert SH.kv_cut(ctx, cfg.attn.n_kv_heads,
                                 PAGED_SEQ) == "split_kv"
    assert arms == {"kv_group", "replicated"}
    assert cut == {True, False}


@pytest.mark.parametrize("cell", list(PENGINES))
def test_paged_engine_token_streams_match_jax(run, cell):
    """Every rank's streams, admission rounds and free pages after the
    drain equal JAX's one-rank paged engine's."""
    layout = PENGINES[cell][0]
    got = _load(run, layout, cell)
    want = run[1][cell]
    assert want["statuses"] == ["ok"] * len(PROMPT_LENS)
    assert want["free_pages"] == want["n_pages"] - 1
    for r in _ranks(got):
        np.testing.assert_array_equal(got[f"rank{r}/tokens"],
                                      want["tokens"])
        np.testing.assert_array_equal(got[f"rank{r}/lengths"],
                                      want["lengths"])
        assert got[f"rank{r}/statuses"].tolist() == want["statuses"]
        assert int(got[f"rank{r}/admit_rounds"]) == want["admit_rounds"]
        assert int(got[f"rank{r}/free_pages"]) == want["free_pages"]


def test_paged_tight_pool_stalls_the_gate():
    """The tight cell's usable pages hold the largest budget but not the
    first requests of every slot: under FIFO its page gate, not the
    slots, bounds admission (every rank's rounds equal JAX's, above)."""
    n_pages = PENGINES["peng-tight-22"][3]
    need = [-(-(n + ENGINE["max_new"]) // PAGE) for n in PROMPT_LENS]
    assert max(need) <= n_pages - 1 < sum(need[:ENGINE["slots"]])


def test_paged_engine_raises_when_an_allocator_diverges(run):
    """One rank's allocator hands out its pages in reverse order: the
    step's checksum (block tables and free list) makes every rank raise
    before the admission's collectives, instead of writing other pages."""
    got = _load(run, PDIVERGE[0], "peng-diverge")
    ranks = _ranks(got)
    assert len(ranks) == 4
    for r in ranks:
        assert "schedulers diverged" in str(got[f"rank{r}/error"])


# ---------------------------------------------------------------------------
# (g) the serving lifecycle
# ---------------------------------------------------------------------------


def _decisions(rec):
    """A record without its record-only stamps (first token, done), which
    each rank takes from its own clock; submit times stay (the shared
    clock's)."""
    rec = json.loads(json.dumps(rec))
    for v in rec["requests"].values():
        del v[5:]
    for d in (rec.get("extra") or {}).get("requests", {}).values():
        del d["first_token_t"], d["done_t"]
    return rec


@pytest.mark.parametrize("cell", list(LIFE_CELLS))
def test_lifecycle_matches_jax(run, cell):
    """Every rank's record of the script equals JAX's one-rank engine's:
    the same decisions on every rank under clocks skewed by rank. Rank 0
    reads the unskewed clock, so its record-only stamps equal JAX's too;
    the other ranks' are their own."""
    layout, script, paged = LIFE_CELLS[cell]
    got = _load(run, layout, cell)
    want = run[1][script, paged]
    assert len(_ranks(got)) == 4
    for r in _ranks(got):
        rec = json.loads(str(got[f"rank{r}/record"]))
        if r == 0:
            assert rec == want, cell
        assert _decisions(rec) == _decisions(want), (r, cell)


def test_lifecycle_scripts_reach_each_path(run):
    """The JAX references take each path the cells name: a live and a
    queued cancel, both shed policies, TTFT and total expiry, quarantine
    by the injector and by real NaN logits, crashes recovered from a
    snapshot and from none, the squeezed pages all home."""
    refs = run[1]

    def statuses(rec):
        return [v[2] for v in rec["requests"].values()]

    for paged in (True, False):
        if ("cancel", paged) in refs:
            rec = refs["cancel", paged]
            assert rec["ops"][-4:] == [True, True, False, False]
            assert statuses(rec).count("cancelled") == 2
            assert len(rec["requests"]["1"][0]) >= 1      # live: partial
            assert rec["requests"]["6"][0] == []          # queued
    rec = next(refs["shed-reject", p] for p in (True, False)
               if ("shed-reject", p) in refs)
    assert rec["ops"].count("queue_full") == 3 and rec["counters"][2] == 0
    rec = next(refs["shed-deadline", p] for p in (True, False)
               if ("shed-deadline", p) in refs)
    assert rec["counters"][2] == 2                        # two shed
    assert [rec["requests"][r][2] for r in ("4", "5")] == ["expired"] * 2
    rec = next(refs["deadlines", p] for p in (True, False)
               if ("deadlines", p) in refs)
    errs = {rid: v[3] for rid, v in rec["requests"].items()}
    assert "ttft" in errs["4"] and "ttft" in errs["5"]
    assert "after" in errs["0"]                           # expired live
    assert rec["requests"]["6"][2] == "ok" and rec["counters"][3] == 3
    rec = next(refs["poison", p] for p in (True, False)
               if ("poison", p) in refs)
    assert rec["counters"][4] == 4                        # 3 + 1 real NaN
    for paged in (True, False):
        rec = refs["crash", paged]
        assert rec["counters"][:2] == [2, 2]
        assert rec["injected"][0]["crash"] == 2
        assert set(statuses(rec)) == {"ok"}
        assert rec["extra"] is not None
        if paged:
            assert rec["injected"][0]["page_squeeze"] == 1
            assert rec["free_pages"] == PAGED_POOL_ENGINE - 1


# ---------------------------------------------------------------------------
# (h) the disaggregated topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(DISAGG))
def test_disagg_matches_jax(run, cell):
    """Every rank's router (every worker on the mesh, each rank's handoffs
    its slice of the pages, a dp-cut slot's SSM row gathered over dp)
    gives JAX's one-rank Router's record: the streams, statuses, errors,
    ``summary()`` (migrations, pages moved, re-migrations, duplicates, per
    worker), the emissions in order and the injected crashes."""
    layout = DISAGG[cell][0]
    got = _load(run, layout, cell)
    want = run[1][cell]
    assert len(_ranks(got)) == 4
    for r in _ranks(got):
        assert json.loads(str(got[f"rank{r}/record"])) == want, (r, cell)
    assert {v[2] for v in want["requests"].values()} == {"ok"}
    s = want["summary"]
    assert s["migrations"] >= len(PROMPT_LENS)
    if "crash" in cell:         # two rids migrated after the snapshot
        assert s["failures"] == s["recoveries"] == 1
        assert want["injected"]["decode0"]["crash"] == 1
        assert s["remigrations"] == 2
    keys = {(e[0], e[1]) for e in want["emissions"]}
    assert len(keys) == len(want["emissions"])            # each once


def test_lifecycle_raises_when_a_fault_plan_diverges(run):
    """Rank 1 alone quarantines a row: the next step's checksum (the live
    slots, the retired requests' statuses) makes every rank raise instead
    of hanging."""
    got = _load(run, LIFE_DIVERGE[0], "life-diverge")
    ranks = _ranks(got)
    assert len(ranks) == 4
    for r in ranks:
        assert "schedulers diverged" in str(got[f"rank{r}/error"])
