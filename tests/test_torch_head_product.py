"""The head's fp32 product of bf16 operands (``models/common.py``):
``split3_bf16`` rebuilds every fp32 value bit for bit from its three bf16
pieces; ``bf16_exact_mm`` on the CPU gives the widened operands' product
bit for bit, and gradients within 1e-6 of the largest entry of the fp64
product, a limit that a single bf16 piece of the gradient misses by three
orders; ``chunked_xent`` on the CPU keeps the present fp32 product, loss
and gradients bit for bit, and counts it; the dry run on ``meta`` tensors
counts the card's path (the tensor-core passes and the split region). The
tensor-core pass itself runs only on the card (``chip_smoke.py --only
build,head_product``)."""
import dataclasses

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.op_cost import count_cost
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels import ref
from repro_torch.launch import dryrun
from repro_torch.models import common, lm

torch.set_num_threads(1)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _rebuild(p):
    p = p.float()
    return (p[0] - p[1]) - p[2]


@pytest.mark.parametrize("exp", range(-30, 26, 5))
def test_split_rebuilds_fp32_bit_for_bit(exp):
    """Five decades of magnitudes from 10^exp, both signs, each case."""
    gen = torch.Generator().manual_seed(exp + 100)
    mant = torch.rand(4096, generator=gen, dtype=torch.float64) + 1.0
    sign = torch.randint(0, 2, (4096,), generator=gen) * 2 - 1
    scale = 10.0 ** (exp + torch.randint(0, 5, (4096,), generator=gen))
    g = (sign * mant * scale).float()
    assert bool(torch.isfinite(g).all()) and bool((g != 0).all())
    p = ref.split3_bf16_ref(g)
    assert p.shape == (3, 4096) and p.dtype == torch.bfloat16
    assert torch.equal(_bits(_rebuild(p)), _bits(g))


def test_split_keeps_signed_zeros_and_exact_bf16_values():
    g = torch.tensor([0.0, -0.0, 1.0, -1.0, 3.0e-30, -2.5e30,
                      1.0 + 2.0 ** -23, -(1.0 - 2.0 ** -24)])
    assert torch.equal(_bits(_rebuild(ref.split3_bf16_ref(g))), _bits(g))
    # a value bf16 holds is its first piece alone
    p = ref.split3_bf16_ref(torch.tensor([1.0, -0.0]))
    assert torch.equal(p[0].float(), torch.tensor([1.0, -0.0]))
    assert not bool(p[1:].float().abs().sum())


def _operands(rows, d, V, seed, tied=False):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(rows, d, generator=gen).bfloat16()
    if tied:            # a tied head: the embedding's transpose, a view
        b = torch.randn(V, d, generator=gen).bfloat16().t()
    else:
        b = torch.randn(d, V, generator=gen).bfloat16()
    # a softmax-like gradient: entries spread over many magnitudes
    g = torch.randn(rows, V, generator=gen) * torch.exp(
        4 * torch.randn(rows, V, generator=gen))
    return a, b, g


@pytest.mark.parametrize("tied", [False, True])
def test_exact_mm_forward_is_the_widened_product(tied):
    a, b, _ = _operands(48, 64, 320, 1, tied)
    got = common.bf16_exact_mm(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(a.float() @ b.float()))


def _grads(a, b, g):
    a, b = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    common.bf16_exact_mm(a, b).backward(g)
    return a.grad, b.grad


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("shape", [(64, 128, 512), (40, 96, 1000)])
def test_exact_mm_grads_match_fp64(shape, tied):
    rows, d, V = shape
    a, b, g = _operands(rows, d, V, 2, tied)
    da, db = _grads(a, b, g)
    assert da.dtype == db.dtype == torch.bfloat16
    assert da.shape == a.shape and db.shape == b.shape
    # the products before the cast to the operands' dtype
    da32, db32 = common.split_grads_f32(a, b, g)
    assert da32.dtype == db32.dtype == torch.float32
    want_da = g.double() @ b.double().t()
    want_db = a.double().t() @ g.double()
    assert _rel(da32, want_da) < 1e-6 and _rel(db32, want_db) < 1e-6
    # what leaves is those products rounded once to bf16
    for got, p32 in ((da, da32), (db, db32)):
        assert bool(((got.float() - p32).abs()
                     <= p32.abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("which", ["da", "db"])
def test_one_bf16_piece_misses_the_limit(which):
    """The control: the gradient rounded once to bf16, as a plain bf16
    head's backward would take it, is some 1e-3 off the fp64 product."""
    a, b, g = _operands(64, 128, 512, 3)
    g1 = g.bfloat16().float()
    if which == "da":
        got, want = g1 @ b.float().t(), g.double() @ b.double().t()
    else:
        got, want = a.float().t() @ g1, a.double().t() @ g.double()
    assert _rel(got, want) > 1e-4


def _old_chunk(hc, w_out, lc, logit_dtype):
    """The chunk as it was computed before ``head_logits``."""
    logits = hc.to(logit_dtype) @ w_out.to(logit_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).to(logit_dtype)
    return ((lse - tgt) * mask).sum(), mask.sum()


def _old_xent(h, w_out, labels, chunk=1024, logit_dtype=torch.float32):
    S = h.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=logit_dtype)
    cnt = torch.zeros((), dtype=logit_dtype)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        l, c = checkpoint(_old_chunk, h[:, sl], w_out, labels[:, sl],
                          logit_dtype, use_reentrant=False)
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp(cnt, min=1.0), cnt


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("S,chunk", [(24, 8), (20, 8), (16, 1024)])
def test_chunked_xent_on_cpu_unchanged_and_counted(dtype, tied, S, chunk):
    gen = torch.Generator().manual_seed(S + chunk)
    B, d, V = 2, 32, 96
    h0 = torch.randn(B, S, d, generator=gen).to(dtype)
    # a tied head is the embedding's transpose (V, d), a view
    w0 = torch.randn((V, d) if tied else (d, V), generator=gen).to(dtype)
    labels = torch.randint(-1, V, (B, S), generator=gen)
    runs = []
    for fn in (_old_xent, common.chunked_xent):
        h, w = h0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        head = w.t() if tied else w
        before = dict(common.HEAD_PRODUCT_CALLS)
        loss, cnt = fn(h, head, labels, chunk=chunk)
        loss.backward()
        calls = {k: v - before[k]
                 for k, v in common.HEAD_PRODUCT_CALLS.items()}
        runs.append((loss, cnt, h.grad, w.grad, calls))
    (l0, c0, dh0, dw0, _), (l1, c1, dh1, dw1, calls) = runs
    n_chunks = -(-S // min(chunk, S))
    # forward and the checkpoint's recompute, each chunk
    assert calls == {"bf16_exact": 0, "fp32": 2 * n_chunks}
    assert torch.equal(l0, l1) and torch.equal(c0, c1)
    assert torch.equal(dh0, dh1) and torch.equal(dw0, dw1)


def test_loss_fn_on_cpu_counts_the_fp32_product():
    cfg = get_config("qwen2-moe-2.7b-smoke")
    params = lm.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    before = dict(common.HEAD_PRODUCT_CALLS)
    loss, _ = lm.loss_fn(cfg, params, batch)
    assert bool(torch.isfinite(loss))
    calls = {k: v - before[k] for k, v in common.HEAD_PRODUCT_CALLS.items()}
    assert calls == {"bf16_exact": 0, "fp32": 1}


@pytest.mark.parametrize("dtype,path,passes", [("bfloat16", "bf16_exact", 8),
                                               ("float32", "fp32", 4)])
def test_dry_run_counts_the_cards_head_product(dtype, path, passes):
    """The dry run on meta tensors counts the path the card takes: a bf16
    model's head on tensor-core passes, 8 products a chunk (the forward,
    its recompute, three pieces each for dh and dW) and a split region a
    chunk filed under a backward bucket; an fp32 model's the widened
    product, 4 a chunk and no split."""
    cfg = dataclasses.replace(get_config("qwen2-moe-2.7b-smoke"),
                              param_dtype=dtype, compute_dtype=dtype)
    B, S = 2, 2 * 1024 + 64                     # chunks of 1024, 1024, 64
    run, _, _ = dryrun.build_cell(cfg, ShapeConfig("smoke", S, B, "train"),
                                  None)
    before = dict(common.HEAD_PRODUCT_CALLS)
    with dryrun.MetaOutputCache(), count_cost(attribute=True) as c:
        run()
    calls = {k: v - before[k] for k, v in common.HEAD_PRODUCT_CALLS.items()}
    want = {"bf16_exact": 0, "fp32": 0}
    want[path] = 2 * 3
    assert calls == want
    V, d = cfg.vocab_size, cfg.d_model
    head = c.by_bucket["xent"]["mxu_flops"] + \
        c.by_bucket["bwd:xent"]["mxu_flops"]
    assert head == passes * 2 * B * S * d * V
    if path == "fp32":
        assert "split3" not in c.regions
    else:
        assert c.regions["split3"]["calls"] == 3
        assert c.regions["split3"]["bytes"] == 10.0 * B * S * V
        assert c.region_buckets["split3"] == {"bwd:other": 3}
