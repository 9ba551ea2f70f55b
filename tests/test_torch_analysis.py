"""The port's analysis tools against the JAX package's: the cells'
vocabulary (``LM_SHAPES``, ``SMOKE_SHAPE``, ``shape_applicable``,
``ASSIGNED_ARCHS``, ``moe_flops``), the roofline's arch-level terms and
ring traffic (``analysis/roofline.py`` against ``repro.analysis.roofline``),
each kernel's cost function at PERF.md §6's shapes, and the op-level cost
counter (``analysis/op_cost.py``) against ``repro.analysis.hlo_cost`` on
jitted JAX programs: products, a smoke model's forward, the layer count,
the KV-cache write rule, and the same count on CPU and ``meta`` tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.analysis import hlo_cost as JH
from repro.analysis import roofline as JRL
from repro.configs import get_config as jax_config
from repro.core import routing as JR
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.analysis import roofline as RL
from repro_torch.analysis.op_cost import count_cost, top_ops
from repro_torch.configs import get_config, list_archs
from repro_torch.core import routing as TR
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import attention, lm

torch.set_num_threads(1)

ARCHS = list_archs(include_smoke=True)
SHAPES = list(JC.LM_SHAPES.values()) + [JC.SMOKE_SHAPE]


# ---------------------------------------------------------------------------
# the cells' vocabulary
# ---------------------------------------------------------------------------


def test_shapes_and_arch_lists_equal_jax():
    assert set(TC.LM_SHAPES) == set(JC.LM_SHAPES)
    for name, s in JC.LM_SHAPES.items():
        assert dataclasses.asdict(TC.LM_SHAPES[name]) == dataclasses.asdict(s)
    assert dataclasses.asdict(TC.SMOKE_SHAPE) == \
        dataclasses.asdict(JC.SMOKE_SHAPE)
    assert TC.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS
    assert TC.PAPER_ARCHS == JC.PAPER_ARCHS
    assert ARCHS == JC.list_archs(include_smoke=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_equals_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for s in SHAPES:
        ts = TC.LM_SHAPES.get(s.name, TC.SMOKE_SHAPE)
        assert TC.shape_applicable(cfg, ts) == JC.shape_applicable(jcfg, s)


@pytest.mark.parametrize("T,k,d,f,glu", [(1, 1, 1, 1, True),
                                         (4096, 2, 4096, 14336, True),
                                         (2048, 4, 2048, 1408, False),
                                         (37, 8, 128, 64, True)])
def test_moe_flops_equals_jax(T, k, d, f, glu):
    assert TR.moe_flops(T, k, d, f, glu) == JR.moe_flops(T, k, d, f, glu)


# ---------------------------------------------------------------------------
# the roofline's arch-level terms and ring traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_terms_equal_jax(arch):
    """flash_kernel_bytes, ssd_kernel_bytes and model_flops, exactly, at
    every LM shape and the smoke shape."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for s in SHAPES:
        ts = TC.LM_SHAPES.get(s.name, TC.SMOKE_SHAPE)
        assert RL.flash_kernel_bytes(cfg, ts) == \
            JRL.flash_kernel_bytes(jcfg, s)
        assert RL.ssd_kernel_bytes(cfg, ts) == JRL.ssd_kernel_bytes(jcfg, s)
        assert RL.model_flops(cfg, ts) == JRL.model_flops(jcfg, s)


HLO_OPS = {"all-reduce": "all-reduce", "all-gather": "all-gather",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("op", sorted(HLO_OPS))
def test_collective_traffic_equals_jax(op, n):
    """The ring factor of each kind against ``collective_bytes`` on a
    one-line HLO text of 1024 fp32 operand elements over n ranks."""
    text = (f"  %r = f32[1024]{{0}} {op}(f32[1024]{{0}} %p), "
            f"replica_groups=[{16 // n},{n}]<=[16], to_apply=%add")
    want = JRL.collective_bytes(text)
    assert want.counts == {op: 1}
    assert RL.collective_traffic(op, 4096, n) == pytest.approx(
        want.total_bytes, rel=1e-12)


# ---------------------------------------------------------------------------
# one definition of each kernel's cost: PERF.md §6's bound column
# ---------------------------------------------------------------------------

BOUNDS = [
    ("fused_mlp train", RL.fused_mlp_cost(64, 320, 2048, 1408, 2048),
     0.3806, "bytes"),
    ("fused_mlp prefill", RL.fused_mlp_cost(64, 160, 2048, 1408, 2048),
     0.3556, "bytes"),
    ("fused_mlp jamba prefill", RL.fused_mlp_cost(16, 320, 4096, 14336,
                                                  4096), 1.8239,
     "operations"),
    ("fused_mlp_dgrad", RL.fused_mlp_bwd_cost(
        "fused_mlp_dgrad", 64, 320, 2048, 1408, 2048), 0.5971, "operations"),
    ("fused_mlp_wgrad", RL.fused_mlp_bwd_cost(
        "fused_mlp_wgrad", 64, 320, 2048, 1408, 2048), 0.7166, "operations"),
    ("grouped_gemm gemm1 prefill", RL.grouped_gemm_cost(64, 160, 2048, 1408),
     0.1313, "bytes"),
    ("topk_combine", RL.topk_combine_cost(2048, 4, 2048), 0.0125, "bytes"),
    ("flash_attention", RL.flash_cost(4, 16, 16, 1024, 1024, 128), 0.0200,
     "bytes"),
    ("ssd_forward train", RL.ssd_cost(4, 2048, 48, 64, 128,
                                      tensor_cores=True), 0.0327,
     "operations"),
    ("rmsnorm", RL.rmsnorm_cost(2048, 1536), 0.0038, "bytes"),
]


@pytest.mark.parametrize("name,cost,ms,by", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_kernel_bounds_reproduce_perf_table(name, cost, ms, by):
    t, got_by = cost.bound_s()
    assert round(t * 1e3, 4) == ms
    assert got_by == by


# ---------------------------------------------------------------------------
# the op-level counter against hlo_cost
# ---------------------------------------------------------------------------


def _jax_cost(f, *args):
    return JH.analyze_text(jax.jit(f).lower(*args).compile().as_text())


def test_product_flops_equal_hlo_cost():
    """tanh(x @ w) @ w at 256: two products of 2 x 256^3, as
    ``tests/test_hlo_cost.py`` counts them."""
    x = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    want = _jax_cost(lambda a, b: jnp.tanh(a @ b) @ b, x, x).mxu_flops
    t = torch.from_numpy(x)
    with count_cost() as c:
        torch.tanh(t @ t) @ t
    assert c.mxu_flops == want == 2 * 2 * 256 ** 3
    assert c.mxu_by_dtype == {"fp32": want}


@pytest.mark.parametrize("arch", ["qwen2-0.5b-smoke", "qwen2-moe-2.7b-smoke"])
def test_forward_products_match_hlo_cost(arch):
    """The fp32 forward (``loss_fn``) of a smoke model: the port's product
    FLOPs within 1% of ``hlo_cost``'s ``mxu_flops`` for the jitted JAX
    forward, once two ops are priced alike. They differ in (1) the flash
    attention region, which the port prices at the causal query-key pairs
    the kernel computes, where the JAX package's jnp attention computes
    every pair of the score matrix, and (2) the top-k combine region, an
    elementwise weighted sum the port files outside the products, where
    the JAX Pallas kernel in interpret mode lowers to a dot."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    want = _jax_cost(lambda p, b: jlm.loss_fn(jcfg, p, b)[0], jp,
                     {k: jnp.asarray(v) for k, v in batch.items()}).mxu_flops
    with torch.no_grad(), count_cost() as c:
        lm.loss_fn(cfg, tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    a = cfg.attn
    n_attn = sum(cfg.layer_kind(i) == "a" for i in range(cfg.n_layers))
    full_pairs = RL.flash_cost(2, a.n_heads, a.n_kv_heads, 32, 32,
                               a.head_dim, causal=False).flops
    flash = c.regions["flash_attention"]
    assert flash["calls"] == n_attn
    adjusted = (c.mxu_flops - flash["flops"] + n_attn * full_pairs
                + c.regions.get("topk_combine", {}).get("flops", 0.0))
    assert adjusted == pytest.approx(want, rel=1e-2), (
        f"port {c.mxu_flops:.0f} (adjusted {adjusted:.0f}) against JAX "
        f"{want:.0f}; the port's products by op: "
        f"{top_ops(c, 'flops', 6)}; regions {c.regions}")


def _meta_train_cost(cfg):
    run, _, _ = dryrun.build_cell(cfg, TC.SMOKE_SHAPE, None)
    with dryrun.MetaOutputCache(), count_cost() as c:
        run()
    return c


def test_count_is_affine_in_layers():
    """The train step of 2, 3 and 4 layers: each layer adds the same
    FLOPs, products, bytes and regions."""
    base = get_config("qwen2-moe-2.7b-smoke")
    cs = [_meta_train_cost(dataclasses.replace(base, n_layers=n))
          for n in (2, 3, 4)]
    for key in ("flops", "mxu_flops", "bytes"):
        d1 = getattr(cs[1], key) - getattr(cs[0], key)
        d2 = getattr(cs[2], key) - getattr(cs[1], key)
        assert d1 > 0 and d1 == d2, key
    for name, r in cs[0].regions.items():
        calls = [c.regions[name]["calls"] for c in cs]
        assert calls[2] - calls[1] == calls[1] - calls[0], name


@pytest.mark.parametrize("S", [64, 4096])
def test_kv_write_counts_the_row(S):
    """A decode step's 1-row K/V write (``attention.update_cache``) costs
    O(row), not O(cache): the dynamic-update-slice rule."""
    B, H, hd = 2, 4, 32
    kc, vc = torch.zeros(B, S, H, hd), torch.zeros(B, S, H, hd)
    new = torch.ones(B, 1, H, hd)
    row = new.numel() * 4
    with count_cost() as c:
        attention.update_cache(kc, vc, new, new, torch.tensor([3, 5]))
        kc[:, 7:8] = new                       # a slice copy
        kc.index_copy_(1, torch.tensor([9]), new)
    assert c.bytes < 16 * row + 1024
    assert c.peak_bytes < 8 * row + 1024


def _kernel_calls(dev):
    """Every kernels/ops.py entry once, fp32 operands on ``dev``, seeded."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dev)
    E, R, d, f = 2, 8, 16, 24
    x, wg, wu, wd = r(E, R, d), r(E, d, f), r(E, d, f), r(E, f, d)
    w = {"w_gate": wg, "w_up": wu, "w_down": wd}
    dy, rows, tw = r(E, R, d), r(8, 2, d), r(8, 2).softmax(-1)
    q, k = r(1, 4, 8, 16), r(1, 2, 8, 16)
    xs, dt, A = r(1, 16, 2, 8), r(1, 16, 2).abs(), -r(2).abs()
    Bm, D, xn, sc = r(1, 16, 4), r(2), r(3, 5, d), r(d)
    return [
        lambda: ops.fused_mlp(x, w, "swiglu"),
        lambda: ops.fused_mlp_dgrad(x, w, dy, "swiglu"),
        lambda: ops.fused_mlp_wgrad(x, w, dy, "swiglu"),
        lambda: ops.grouped_gemm(x, wu),
        lambda: ops.topk_combine(rows, tw),
        lambda: ops.flash_attention(q, k, k),
        lambda: ops.ssd_forward(xs, dt, A, Bm, Bm, D, chunk=8),
        lambda: ops.ssd_forward_state(xs, dt, A, Bm, Bm, D, chunk=8),
        lambda: ops.rms_norm(xn, sc, 1e-5),
    ]


def test_regions_price_the_same_on_cpu_and_meta():
    """Each kernel call is one region priced by its cost function, on CPU
    tensors (plain versions inside) as on meta tensors."""
    names = ["fused_mlp", "fused_mlp_dgrad", "fused_mlp_wgrad",
             "grouped_gemm", "topk_combine", "flash_attention",
             "ssd_forward", "ssd_forward", "rmsnorm"]
    for name, on_cpu, on_meta in zip(names, _kernel_calls("cpu"),
                                     _kernel_calls("meta")):
        with torch.no_grad(), count_cost() as c:
            on_cpu()
        with torch.no_grad(), count_cost() as m:
            on_meta()
        assert c.regions == m.regions and set(c.regions) == {name}, name
        assert (c.flops, c.bytes, c.mxu_by_dtype, c.by_op) == \
            (m.flops, m.bytes, m.mxu_by_dtype, m.by_op), name


def test_mixed_devices_still_raise():
    with pytest.raises(ValueError, match="mixed devices"):
        ops.topk_combine(torch.zeros(2, 2, 4), torch.zeros(2, 2,
                                                           device="meta"))


def test_step_counts_the_same_on_cpu_and_meta():
    """The train step of a MoE smoke config on CPU tensors (seeded
    weights, a synthetic batch) and its world-1 dry run on meta: the same
    FLOPs, products, bytes and regions, no collective bytes, and the
    same argument bytes."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.optim.adamw import AdamW
    cfg = dataclasses.replace(get_config("qwen2-moe-2.7b-smoke"),
                              remat="full")
    shape = ShapeConfig("smoke", 32, 2, "train")
    built = build_train_step(cfg, shape)
    params = lm.init_params(cfg, seed=0, device="cpu")
    state = {"params": params, "opt": AdamW().init(params), "step": 0}
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, v)
                                 .astype(np.int32))
             for k, v in built["batch_structs"].items()}
    with count_cost() as c:
        state, m = built["fn"](state, batch)
    assert state["step"] == 1 and np.isfinite(float(m["loss"]))
    run, mem, assumed = dryrun.build_cell(cfg, shape, None)
    with dryrun.MetaOutputCache(), count_cost() as meta:
        run()
    assert (c.flops, c.mxu_by_dtype, c.bytes, c.regions) == \
        (meta.flops, meta.mxu_by_dtype, meta.bytes, meta.regions)
    assert c.ici_bytes == meta.ici_bytes == 0
    from repro_torch.models.common import tree_leaves
    want = sum(t.numel() * t.element_size() for _, t in tree_leaves(
        {"p": params, "m": state["opt"]["m"], "v": state["opt"]["v"]}))
    want += sum(t.numel() * t.element_size() for t in batch.values())
    assert mem["param_bytes"] + mem["opt_bytes"] + mem["batch_bytes"] == want
    assert assumed


def test_analyze_report_and_mfu():
    """analyze's keys (the JAX report's, hlo_ read as op_), the compute
    term from the products by dtype, and mfu from a profile."""
    cfg = get_config("qwen2-moe-2.7b-smoke")
    c = _meta_train_cost(cfg)
    prof = {"wall_ms": 100.0, "device_ms": 60.0, "idle_share": 0.4,
            "groups": {"library GEMMs": {"ms": 50.0, "calls": 3}}}
    r = RL.analyze(c, 1, cfg, TC.SMOKE_SHAPE, prof)
    for key in ("op_flops_per_device", "op_bytes_per_device",
                "collective_bytes_per_device", "collective_per_op",
                "collective_counts", "t_compute_s", "t_memory_s",
                "t_collective_s", "dominant", "bound_time_s",
                "model_flops_global", "model_flops_per_device",
                "useful_flops_ratio", "roofline_fraction", "wall_ms",
                "device_ms", "idle_share", "device_ms_by_group", "mfu"):
        assert key in r, key
    assert r["t_compute_s"] == pytest.approx(
        c.mxu_by_dtype.get("fp32", 0) / 67e12
        + c.mxu_by_dtype.get("bf16", 0) / 989e12)
    assert r["t_memory_s"] == pytest.approx(c.bytes / 3.35e12)
    assert r["mfu"] == pytest.approx(
        RL.model_flops(cfg, TC.SMOKE_SHAPE) / 0.1 / 989e12)
    assert "dominant" in RL.fmt_report("smoke", r)


# ---------------------------------------------------------------------------
# the card-side check of the kernel models (kernel_check.check_attributes)
# ---------------------------------------------------------------------------


def _source_labels():
    """(model names, dtype) of every instance label the ``csrc/*.cu``
    attribute queries report: the string literals, and rmsnorm's format
    at each of its input dtypes."""
    import re
    from repro_torch.kernels import build
    labels = []
    for p in sorted(build.CSRC.glob("*.cu")):
        text = p.read_text()
        assert f"repro_attrs_{p.stem}(" in text, p.name
        labels += re.findall(r'"([^"|]+)\|(bfloat16|float32)\|', text)
        if '"rmsnorm|%s|' in text:
            labels += [("rmsnorm", "bfloat16"), ("rmsnorm", "float32")]
    return labels


def _fake_attrs(models):
    """Attributes that agree with ``models``: one instance a label."""
    out = []
    for names, dt in _source_labels():
        mine = [m for m in models if m.name in names.split(",")
                and m.in_dtypes[0] == dt]
        out.append({"source": "x.cu", "label": f"{names}|{dt}|",
                    "regs": 32, "static_smem": mine[0].static_smem
                    if mine else 0, "local_bytes": 0, "max_threads": 1024})
    return out


def test_attribute_labels_cover_the_models():
    """Every instance a ``.cu`` query reports runs a launch model, and
    every launch model is run by an instance: a clean check."""
    from repro_torch.analysis.verify import kernel_check as KC
    models = KC.attribute_models()
    assert KC.check_attributes(_fake_attrs(models), models) == []


@pytest.mark.parametrize("field,value,rule", [
    ("static_smem", 4096, "attr-static-smem"),
    ("max_threads", 128, "attr-threads"),
    ("regs", 255, "attr-registers"),
    ("label", "no-such-kernel|float32|", "attr-no-model")])
def test_attribute_check_catches(field, value, rule):
    from repro_torch.analysis.verify import kernel_check as KC
    models = KC.attribute_models()
    attrs = _fake_attrs(models)
    i = next(i for i, a in enumerate(attrs)
             if a["label"].startswith("fused_mlp[wgmma]/"))
    attrs[i] = {**attrs[i], field: value}
    rules = {d.rule for d in KC.check_attributes(attrs, models)}
    assert rule in rules
