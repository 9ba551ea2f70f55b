"""The port's counterparts of the JAX package's last three tools:
per-bucket attribution of a step's count (``analysis/op_cost.py``'s
``count_cost(attribute=True)`` and ``analysis/attribute.py`` against
``tools/attribute.py``), the one-cell override climb
(``launch/hillclimb.py`` against ``tools/hillclimb.py``) and the dry-run
tables (``analysis/make_experiments.py``).

``tools/attribute.py`` and ``tools/hillclimb.py`` set ``XLA_FLAGS`` to
512 host devices when imported, which would leak into every later JAX
test of the same worker, so neither is imported: their ``KEYWORDS``,
``bucket_of`` and override code are read from the source with ``ast``.
The two CLI runs start first (a module fixture) and are collected by the
last test, so the JAX references run beside them.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo_cost import (_BODY, _CALLS, _COND, _TRIP_BC,
                                     HLOCostModel)
from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.analysis import make_experiments as MX
from repro_torch.analysis import roofline as RL
from repro_torch.analysis.op_cost import KEYWORDS, bucket_of, count_cost
from repro_torch.configs import LM_SHAPES, SMOKE_SHAPE, ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import hillclimb as HC
from repro_torch.launch.train_step import build_train_step
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, global_norm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
SUMS = ("flops", "mxu_flops", "bytes", "ici_bytes")


def _tool_ast(name):
    return ast.parse((TOOLS / name).read_text())


def _jax_bucket_of():
    """(KEYWORDS, bucket_of) of ``tools/attribute.py``, from its source."""
    tree = _tool_ast("attribute.py")
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign)
                and [getattr(t, "id", "") for t in n.targets]
                == ["KEYWORDS"])
            or (isinstance(n, ast.FunctionDef) and n.name == "bucket_of")]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "attribute.py",
                 "exec"), ns)
    return ns["KEYWORDS"], ns["bucket_of"]


JAX_KEYWORDS, jax_bucket_of = _jax_bucket_of()


# ---------------------------------------------------------------------------
# the two CLI runs: started first, collected by the last test
# ---------------------------------------------------------------------------

CELL = ("qwen2-0.5b", "decode_32k")


@pytest.fixture(scope="module", autouse=True)
def clis(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clis")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    runs = {
        "attribute": [sys.executable, "-m", "repro_torch.analysis.attribute",
                      *CELL, "--json", str(tmp / "rows.json")],
        "hillclimb": [sys.executable, "-m", "repro_torch.launch.hillclimb",
                      *CELL, "remat=none", "fsdp=0", "save=1"]}
    procs = {k: subprocess.Popen(cmd, cwd=tmp, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, cmd in runs.items()}
    yield tmp, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


# ---------------------------------------------------------------------------
# (a) bucket_of is the JAX tool's
# ---------------------------------------------------------------------------

PROBES = list(KEYWORDS[:-1]) + [
    "", "transpose", "jit(step)/transpose(jvp(loss))/dot_general",
    "jit(f)/while/body/closed_call/__fusable__flash/exp",
    "jit(f)/__fusable__flash/bhqk,bkhd->bqhd/transpose",
    "jit(topk_combine_diff)/while/body/tkd,tk->td/dot_general",
    # the false matches the port's keys keep out of their chains
    "property", "core.moe_layer.__torch_dispatch__", "token_embeds",
    "embeds", "global_norm", "adamw.global_norm", "optim.adamw/global_norm",
    "transpose(ops._topkcombine.backward)", "moe_ffn/routing.combine",
    "attn_apply/common.apply_rope", "decode_attention", "ssm_forward/ssd",
    "conv1d", "silu_and_gelu", "logsumexp/xent", "ROPE", "Flash"]


def test_keywords_are_the_jax_tools():
    assert KEYWORDS == JAX_KEYWORDS


@pytest.mark.parametrize("name", PROBES)
def test_bucket_of_equals_jax(name):
    assert bucket_of(name) == jax_bucket_of(name)


# ---------------------------------------------------------------------------
# (b) one train step: the same buckets on CPU and meta, summing to the count
# ---------------------------------------------------------------------------


def _cpu_step(cfg, shape=SMOKE_SHAPE, attribute=True):
    built = build_train_step(cfg, shape)
    params = lm.init_params(cfg, seed=0, device="cpu")
    state = {"params": params, "opt": AdamW().init(params), "step": 0}
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, v)
                                 .astype(np.int32))
             for k, v in built["batch_structs"].items()}
    with count_cost(attribute) as c:
        state, m = built["fn"](state, batch)
    assert state["step"] == 1 and np.isfinite(float(m["loss"]))
    return c


def _meta_step(cfg, shape=SMOKE_SHAPE, attribute=True, **build):
    run, _, _ = dryrun.build_cell(cfg, shape, None, **build)
    with dryrun.MetaOutputCache(), count_cost(attribute) as c:
        run()
    return c


def _assert_partition(c):
    """The buckets sum to the count's totals, and every call of a kernel
    region is filed under its name's bucket or that bucket's ``bwd:``."""
    assert c.by_bucket
    for key in SUMS:
        assert sum(r[key] for r in c.by_bucket.values()) == getattr(c, key), \
            key
    assert set(c.region_buckets) == set(c.regions)
    for k, filed in c.region_buckets.items():
        assert sum(filed.values()) == c.regions[k]["calls"], (k, filed)
        assert set(filed) <= {bucket_of(k), "bwd:" + bucket_of(k)}, \
            (k, filed)


@pytest.mark.parametrize("arch,remat", [("qwen2-moe-2.7b-smoke", "none"),
                                        ("qwen2-moe-2.7b-smoke", "full"),
                                        ("mamba2-780m-smoke", "none")])
def test_step_buckets_same_on_cpu_and_meta(arch, remat):
    """The buckets of one train step on CPU tensors and of its meta dry
    run are the same, their sums equal the count's totals exactly, and
    the count itself is the one without attribution. Under remat the
    checkpoint's recompute lands in the backward's buckets."""
    cfg = dataclasses.replace(get_config(arch), remat=remat)
    cpu, meta = _cpu_step(cfg), _meta_step(cfg)
    assert cpu.by_bucket == meta.by_bucket
    assert cpu.region_buckets == meta.region_buckets
    _assert_partition(cpu)
    plain = _meta_step(cfg, attribute=False)
    assert not plain.by_bucket
    assert (plain.flops, plain.mxu_flops, plain.bytes, plain.regions,
            plain.by_op) == (meta.flops, meta.mxu_flops, meta.bytes,
                             meta.regions, meta.by_op)
    b = meta.by_bucket
    kernel = "ssd" if arch.startswith("mamba2") else "flash"
    assert b[kernel]["calls"] and b[f"bwd:{kernel}"]["calls"]
    assert b["adamw"]["bytes"] > 0 and b["bwd:norm"]["calls"]
    assert not any(k.endswith("dispatch") for k in b)


def test_global_norm_is_adamw_not_norm():
    """``adamw.global_norm`` holds "norm" after "adamw": its ops file under
    adamw, as the optimizer's."""
    tree = {"a": torch.ones(4, 3), "b": torch.ones(5)}
    with count_cost(attribute=True) as c:
        global_norm(tree)
    assert set(c.by_bucket) == {"adamw"}


# ---------------------------------------------------------------------------
# (c) the smoke forward against JAX's HLO bucketed by op_name
# ---------------------------------------------------------------------------


def _jax_buckets(text):
    """tools/attribute.py's walk: each instruction's product FLOPs under
    the bucket of its op_name, with while-loop multiplicities."""
    import re
    opname = re.compile(r'op_name="([^"]*)"')
    m = HLOCostModel(text)
    mult = {m.entry: 1.0}

    def walk(cn, mul):
        comp = m.comps.get(cn)
        if comp is None:
            return
        for ins in comp.instrs:
            if ins.op == "while":
                mm = _TRIP_BC.search(ins.attrs)
                trip = int(mm.group(1)) if mm else 1
                for rx in (_COND, _BODY):
                    mb = rx.search(ins.attrs)
                    if mb:
                        mult[mb.group(1)] = mult.get(mb.group(1), 0) \
                            + mul * trip
                        walk(mb.group(1), mul * trip)
    walk(m.entry, 1.0)
    fl = {}
    for cn, mul in mult.items():
        comp = m.comps[cn]
        for ins in comp.instrs:
            mm = opname.search(ins.attrs)
            key = jax_bucket_of(mm.group(1)) if mm else "?"
            if ins.op == "fusion":
                cm = _CALLS.search(ins.attrs)
                if cm:
                    fl[key] = fl.get(key, 0.0) \
                        + m.comp_cost(cm.group(1)).mxu_flops * mul
            elif ins.op == "dot":
                fl[key] = fl.get(key, 0.0) + m._dot_flops(comp, ins) * mul
    return {k: v for k, v in fl.items() if v}


def test_forward_buckets_match_jax_op_names():
    """The fp32 forward (``loss_fn``) of qwen2-moe-2.7b-smoke on JAX's
    weights: JAX's op_names put products only under ``flash``
    (``__fusable__flash``), ``combine`` (``jit(topk_combine_diff)``) and
    ``other``. The port's ``flash`` products equal JAX's once the causal
    pricing is set alike (the port prices the causal pairs its kernel
    computes, the JAX jnp attention computes every pair); its
    ``combine`` FLOPs (an elementwise region) equal JAX's combine dot
    FLOPs; its other buckets' products sum to within 1% of JAX's
    ``other``."""
    arch = "qwen2-moe-2.7b-smoke"
    jcfg, cfg = jax_config(arch), get_config(arch)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    text = jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b)[0]).lower(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}).compile().as_text()
    want = _jax_buckets(text)
    assert set(want) == {"flash", "combine", "other"}, want
    with torch.no_grad(), count_cost(attribute=True) as c:
        lm.loss_fn(cfg, tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    got = c.by_bucket
    a = cfg.attn
    n_attn = sum(cfg.layer_kind(i) == "a" for i in range(cfg.n_layers))
    full = RL.flash_cost(2, a.n_heads, a.n_kv_heads, 32, 32, a.head_dim,
                         causal=False).flops
    causal = RL.flash_cost(2, a.n_heads, a.n_kv_heads, 32, 32, a.head_dim,
                           causal=True).flops
    assert got["flash"]["calls"] == c.regions["flash_attention"]["calls"] \
        == n_attn
    assert c.region_buckets["flash_attention"] == {"flash": n_attn}
    assert got["flash"]["mxu_flops"] == n_attn * causal
    assert n_attn * full == want["flash"]
    assert got["combine"]["flops"] == want["combine"]
    rest = sum(r["mxu_flops"] for k, r in got.items()
               if k not in ("flash", "combine"))
    assert rest == pytest.approx(want["other"], rel=1e-2), (got, want)
    assert not any(k.startswith("bwd:") for k in got)


def test_backward_buckets():
    """The backward of the same model's train loss (fp32, seeded): every
    op the autograd engine runs is under a ``bwd:`` bucket, and the flash
    attention's backward under ``bwd:flash``. The backward is compared
    with JAX only in part (here: which buckets it holds), because the
    port's flash backward is a plain recompute of the attention under
    autograd (``kernels/ops._Flash``), where JAX's differentiates its
    chunked jnp attention: the two do different products."""
    cfg = get_config("qwen2-moe-2.7b-smoke")
    params = lm.init_params(cfg, seed=0, device="cpu")
    from repro_torch.models.common import tree_leaves
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(params)]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    one = torch.ones(())
    with count_cost(attribute=True) as fwd:
        lm.loss_fn(cfg, params, batch)
    with count_cost(attribute=True) as both:
        lo, _ = lm.loss_fn(cfg, params, batch)
        torch.autograd.grad(lo, leaves, grad_outputs=one, allow_unused=True)
    fwd_only = {k: v for k, v in both.by_bucket.items()
                if not k.startswith("bwd:")}
    assert fwd_only == fwd.by_bucket
    bwd = {k for k in both.by_bucket if k.startswith("bwd:")}
    assert {"bwd:flash", "bwd:attn", "bwd:moe", "bwd:norm"} <= bwd
    # the flash backward's products: its recompute and its gradients
    assert both.by_bucket["bwd:flash"]["mxu_flops"] > \
        both.by_bucket["flash"]["mxu_flops"]
    _assert_partition(both)


# ---------------------------------------------------------------------------
# (d) the overrides are the JAX tool's
# ---------------------------------------------------------------------------


def _jax_overrides(arch, kw):
    """The JAX config ``tools/hillclimb.py``'s main builds for ``arch``
    and ``kw``: its statements from ``cfg = get_config(arch)`` to the
    ``dataclasses.replace`` of the overrides, run on the JAX package."""
    main = next(n for n in _tool_ast("hillclimb.py").body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = main.body
    start = next(i for i, n in enumerate(body)
                 if "get_config" in ast.unparse(n))
    stop = next(i for i, n in enumerate(body)
                if "make_production_mesh" in ast.unparse(n))
    ns = {"get_config": jax_config, "dataclasses": dataclasses,
          "arch": arch, "kw": dict(kw)}
    exec(compile(ast.Module(body=body[start:stop], type_ignores=[]),
                 "hillclimb.py", "exec"), ns)
    return ns["cfg"]


def _common(a, b, path=""):
    """(path, port value, JAX value) of every shared field that differs."""
    out = []
    for k in set(a) & set(b):
        if isinstance(a[k], dict) and isinstance(b[k], dict):
            out += _common(a[k], b[k], f"{path}{k}.")
        elif a[k] != b[k]:
            out.append((path + k, a[k], b[k]))
    return out


OVERRIDES = [
    ("qwen2-moe-2.7b", {"impl": "naive"}),
    ("qwen2-moe-2.7b", {"impl": "coarse"}),
    ("qwen2-moe-2.7b", {"ring_group": "4"}),
    ("qwen2-moe-2.7b", {"n_col": "2"}),
    ("qwen2-moe-2.7b", {"ep": "8"}), ("qwen2-moe-2.7b", {"cap": "1.5"}),
    ("mamba2-780m", {"chunk": "64"}), ("qwen2-moe-2.7b", {"remat": "none"}),
    ("qwen2-moe-2.7b", {"spres": "1"}), ("qwen2-0.5b", {"padheads": "1"}),
    ("qwen2-0.5b", {"dtype": "float32"}),
    ("jamba-v0.1-52b", {"impl": "comet", "ring_group": "2", "n_col": "2",
                        "ep": "4", "cap": "2.0", "chunk": "128",
                        "remat": "full", "spres": "0", "padheads": "0",
                        "dtype": "bfloat16", "multipod": "1", "accum": "2",
                        "fsdp": "0", "sp": "0", "save": "1"}),
    ("qwen2-0.5b", {"chunk": "64", "impl": "naive"}),   # keys that miss
]


@pytest.mark.parametrize("arch,kw", OVERRIDES,
                         ids=[f"{a}-{'-'.join(k)}" for a, k in OVERRIDES])
def test_apply_overrides_equals_jax(arch, kw):
    got = dataclasses.asdict(HC.apply_overrides(get_config(arch), kw))
    want = dataclasses.asdict(_jax_overrides(arch, kw))
    assert not _common(got, want)
    base = dataclasses.asdict(get_config(arch))
    touched = _common(got, base)
    if arch != "qwen2-0.5b" or "padheads" in kw or "dtype" in kw:
        assert touched, "the override changed nothing"


def test_build_knobs():
    assert HC.build_knobs({}) == {"accum": 0, "fsdp": True,
                                  "seq_shard": True}
    assert HC.build_knobs({"accum": "4", "fsdp": "0", "sp": "0"}) == \
        {"accum": 4, "fsdp": False, "seq_shard": False}
    assert HC.perf_path("a", "train_4k", {"n_col": "2", "ep": "4",
                                          "save": "1"}) == \
        "experiments/perf/a_train_4k_ep4_n_col2.json"


# ---------------------------------------------------------------------------
# (e) build_cell's accumulation
# ---------------------------------------------------------------------------


def test_build_cell_accum_counts_two_half_batches():
    """accum=2 runs two microbatches of half the batch: twice the
    products of one step at half the batch without accumulation."""
    cfg = get_config("qwen2-moe-2.7b-smoke")
    shape = ShapeConfig("smoke", 32, 4, "train")
    half = ShapeConfig("smoke", 32, 2, "train")
    built = build_train_step(cfg, shape, accum=2)
    assert built["batch_structs"]["tokens"] == (2, 2, 32)
    two = _meta_step(cfg, shape, attribute=False, accum=2)
    one = _meta_step(cfg, half, attribute=False, accum=1)
    assert two.mxu_flops == 2 * one.mxu_flops
    assert two.regions["flash_attention"]["calls"] == \
        2 * one.regions["flash_attention"]["calls"]


# ---------------------------------------------------------------------------
# (f) the tables
# ---------------------------------------------------------------------------


def test_make_experiments_tables(tmp_path):
    single, multi = tmp_path / "dryrun", tmp_path / "dryrun_multipod"
    multi.mkdir()
    cfg = get_config("qwen2-moe-2.7b-smoke")
    ok = dryrun.run_cell(cfg, ShapeConfig("train_4k", 32, 2, "train"), None,
                         1, "", out_dir=str(single), verbose=False)
    skip = dryrun.run_cell(get_config("qwen2-0.5b-smoke"),
                           LM_SHAPES["long_500k"], None, 1, "",
                           out_dir=str(single), verbose=False)
    assert ok["status"] == "ok" and skip["status"] == "skipped"
    assert sorted(p.name for p in single.iterdir()) == [
        "qwen2-0.5b-smoke_long_500k_1_-.json",
        f"qwen2-moe-2.7b-smoke_train_4k_1_{cfg.moe.impl}.json"]
    out = tmp_path / "tables.md"
    assert MX.main(["--dryrun", str(single), "--multipod", str(multi),
                    "--out", str(out)]) == 0
    text = out.read_text()
    assert text.count("\n### ") == 3
    assert "fits H100 80 GB" in text and "(H100 constants)" in text
    rows = [ln for ln in text.splitlines()
            if ln.startswith("| qwen2")]
    assert len(rows) == 4                  # two dry-run rows, two roofline
    train = [ln for ln in rows if "train_4k" in ln]
    assert f"| {ok['n_chips']} | {ok['op_flops_per_device']:.2e} |" \
        in train[0]
    assert MX.NEXT_STEP[ok["dominant"]][:58] in train[1]
    skipped = [ln for ln in rows if "long_500k" in ln]
    assert all("skipped: pure full-attention arch" in ln for ln in skipped)
    loaded = MX.load(str(single))
    assert set(loaded) == {("qwen2-moe-2.7b-smoke", "train_4k"),
                           ("qwen2-0.5b-smoke", "long_500k")}


# ---------------------------------------------------------------------------
# (g) the CLIs on a production cell (started by the ``clis`` fixture)
# ---------------------------------------------------------------------------


def test_clis_on_a_production_cell(clis):
    tmp, procs = clis
    outs = {}
    for name, p in procs.items():
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-3000:]
        outs[name] = out
    rows = json.loads((tmp / "rows.json").read_text())
    assert rows["n_chips"] == 256 and rows["rows"]
    for i, key in enumerate(SUMS, 1):
        assert sum(r[i] for r in rows["rows"]) == pytest.approx(
            rows["totals"][key], rel=1e-12)
    assert "bucket" in outs["attribute"] and "GFLOP" in outs["attribute"]
    assert "{'remat': 'none', 'fsdp': '0', 'save': '1'}" in outs["hillclimb"]
    saved = tmp / "experiments" / "perf" / \
        "qwen2-0.5b_decode_32k_fsdp0_rematnone.json"
    report = json.loads(saved.read_text())
    assert report["overrides"] == {"remat": "none", "fsdp": "0", "save": "1"}
    assert report["status"] == "ok" and report["run_s"] > 0
