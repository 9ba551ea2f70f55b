#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py              # all five phases, one card
  python3 chip_smoke.py --only build,kernels

Phases:
  1 build    nvidia-smi's card and power limit; build the CUDA kernels from
             ``src/repro_torch/kernels/csrc`` (nvcc, at first use).
  2 kernels  each kernel against its plain PyTorch version on the card, at
             the main path's shapes and one ragged shape, bf16 (tol 2e-2)
             and fp32 (tol 1e-4, TF32 off); median time by CUDA events
             beside the plain version's, one library call's and the bound.
  3 serve    ServeEngine on the full qwen2-moe-2.7b (24 layers, bf16,
             seeded weights on the card), gemm_impl="pallas_fused", 8 slots,
             max_seq 1024, chunk 256: after a warm-up round on an engine of
             its own, 16 requests with prompts of 64-512 tokens and max_new
             32. Launch counters are zeroed before and read after; the plain
             versions must see no CUDA tensor.
  4 logits   the same weights: one stacked prefill_chunk plus 4
             teacher-forced decode_steps through the kernels and through
             the plain versions; fp32 logits compared (first 4 layers in
             fp32, and all 24 in bf16 beside a second plain path).
  5 pallas   a short serve with gemm_impl="pallas" (the grouped-GEMM
             kernel), then one full-width MoE layer, prefill and decode
             shapes, "pallas" against "xla".

With ``--only build,serve,profile`` a sixth phase runs one admission round
and 8 decode steps of the serve configuration under torch.profiler and
writes the device time by kernel to chiprun_out/profile_serve.txt.

Prints the card line, one JSON line of kernel records, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is available, when the repo's package is missing, or when
any phase fails. Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen2-moe-2.7b"
# H100 SXM data-sheet peaks (dense tensor-core rates, HBM3 bandwidth)
PEAK_BW = 3.35e12                       # bytes/s
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
TOL = {"bf16": 2e-2, "fp32": 1e-4}
PHASES = ("build", "kernels", "serve", "logits", "pallas")
EXTRA_PHASES = ("profile",)      # run only when named in --only
REPLACES = {
    "fused_mlp": "src/repro/kernels/fused_mlp.py:90",
    "grouped_gemm": "src/repro/kernels/grouped_gemm.py:49",
    "topk_combine": "src/repro/kernels/topk_combine.py:57",
}


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def median_ms(fn, iters=10, warmup=2):
    """Median of per-call CUDA-event times after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(nbytes, flops, dt):
    t_bytes = nbytes / PEAK_BW
    t_ops = flops / PEAK_FLOPS[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got, want, tol):
    """max |got - want|, and whether every element is within
    tol + tol * |want| (numpy's allclose with rtol = atol = tol)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(((diff <= tol + tol * w.abs()) & g.isfinite()).all())
    return float(diff.max()), ok


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(shape, dt, scale, gen):
    import torch
    return (torch.randn(shape, device="cuda", dtype=torch.float32,
                        generator=gen) * scale).to(dt)


def kernel_cases():
    """(kernel, label, dtype, spec) at the main path's shapes of
    qwen2-moe-2.7b (E = 64, d = 2048, f = 1408, top-4) and ragged ones."""
    cases = []
    for dt in ("bf16", "fp32"):
        for R in (160, 4, 37):
            cases.append(("fused_mlp", f"R={R} expert_major", dt,
                          dict(R=R, order="expert_major", col=None)))
        cases.append(("fused_mlp", "R=160 n_major", dt,
                      dict(R=160, order="n_major", col=None)))
        cases.append(("fused_mlp", "R=37 n_major col_slice=(512,1024)", dt,
                      dict(R=37, order="n_major", col=(512, 1024))))
        cases.append(("grouped_gemm", "gemm1 expert_major", dt,
                      dict(M=160, K=2048, N=1408, order="expert_major")))
        cases.append(("grouped_gemm", "gemm2 n_major", dt,
                      dict(M=160, K=1408, N=2048, order="n_major")))
        cases.append(("grouped_gemm", "ragged M=37 n_major", dt,
                      dict(M=37, K=2048, N=1408, order="n_major")))
        for T in (2048, 8, 1000):
            cases.append(("topk_combine", f"T={T}", dt, dict(T=T)))
    return cases


def run_kernel_case(kernel, dt_name, spec, gen, timed):
    import torch

    from repro_torch.kernels import fused_mlp, grouped_gemm, ref, \
        topk_combine
    from repro_torch.models.common import activate
    dt = torch.bfloat16 if dt_name == "bf16" else torch.float32
    isz = 2 if dt_name == "bf16" else 4
    E, d, f, N = 64, 2048, 1408, 2048
    if kernel == "fused_mlp":
        R = spec["R"]
        x = _randn((E, R, d), dt, 1.0, gen)
        wg = _randn((E, d, f), dt, d ** -0.5, gen)
        wu = _randn((E, d, f), dt, d ** -0.5, gen)
        wd_full = _randn((E, f, N), dt, f ** -0.5, gen)
        wd = wd_full
        if spec["col"] is not None:
            s, w = spec["col"]
            wd = wd_full[:, :, s:s + w]
        n_out = wd.shape[2]

        def k():
            return fused_mlp.fused_mlp(x, wg, wu, wd, "swiglu",
                                       order=spec["order"])

        def p():
            return ref.fused_mlp_ref(x, wg, wu, wd, "swiglu")

        def lib():   # bmm -> silu * up -> bmm, the library yardstick
            return torch.bmm(activate("swiglu", torch.bmm(x, wg),
                                      torch.bmm(x, wu)), wd)

        nbytes = (E * R * d + 2 * E * d * f + E * f * n_out
                  + E * R * n_out) * isz
        flops = 2 * E * R * d * f * 2 + 2 * E * R * f * n_out
    elif kernel == "grouped_gemm":
        M, K, Nn = spec["M"], spec["K"], spec["N"]
        lhs = _randn((E, M, K), dt, 1.0, gen)
        rhs = _randn((E, K, Nn), dt, K ** -0.5, gen)

        def k():
            return grouped_gemm.grouped_gemm(lhs, rhs, order=spec["order"])

        def p():
            return ref.grouped_gemm_ref(lhs, rhs)

        def lib():
            return torch.bmm(lhs, rhs)

        nbytes = (E * M * K + E * K * Nn + E * M * Nn) * isz
        flops = 2 * E * M * K * Nn
    else:
        T, kk = spec["T"], 4
        rows = _randn((T, kk, d), dt, 1.0, gen)
        w = torch.softmax(torch.randn((T, kk), device="cuda",
                                      generator=gen), dim=-1)
        w_lib = w.to(dt)

        def k():
            return topk_combine.topk_combine(rows, w)

        def p():
            return ref.topk_combine_ref(rows, w)

        def lib():
            return torch.einsum("tkd,tk->td", rows, w_lib)

        nbytes = T * kk * d * isz + T * kk * 4 + T * d * isz
        flops = 2 * T * kk * d
    got = k()
    torch.cuda.synchronize()
    want = p()
    err, ok = max_err(got, want, TOL[dt_name])
    rec = {"max_abs_err": err, "within_tol": ok, "tol": TOL[dt_name]}
    b_ms, b_by = bound_ms(nbytes, flops, dt_name)
    rec.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
    if timed:
        iters = 10 if dt_name == "bf16" else 3
        rec["ms"] = median_ms(k, iters=iters)
        rec["plain_ms"] = median_ms(p, iters=iters)
        rec["library_ms"] = median_ms(lib, iters=iters)
    return rec


def phase_kernels(out):
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = []
    for kernel, label, dt, spec in kernel_cases():
        rec = run_kernel_case(kernel, dt, spec, gen, timed=True)
        rec.update(kernel=kernel, case=label, dtype=dt)
        results.append(rec)
        times = (f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
                 f"library {rec['library_ms']:.4f}, bound "
                 f"{rec['bound_ms']:.4f} by {rec['bound_by']})")
        log(f"  {kernel:13s} {dt} {label:34s} max_abs_err "
            f"{rec['max_abs_err']:.3e} "
            f"{'ok' if rec['within_tol'] else 'FAIL'}  {times}")
        torch.cuda.empty_cache()
    out["kernel_cases"] = results
    bad = [f"{r['kernel']} {r['dtype']} {r['case']}" for r in results
           if not r["within_tol"]]
    check(not bad, f"kernels outside tolerance: {bad}")


# ---------------------------------------------------------------------------
# phases 3-5: the serving path
# ---------------------------------------------------------------------------


class PlainGuard:
    """Counts calls of the plain versions with CUDA tensors while active."""

    NAMES = ("fused_mlp_ref", "grouped_gemm_ref", "topk_combine_ref")

    def __init__(self):
        from repro_torch.kernels import ref
        self.ref = ref
        self.cuda_calls = 0
        self.saved = {}

    def __enter__(self):
        for n in self.NAMES:
            real = getattr(self.ref, n)
            self.saved[n] = real

            def wrapped(*args, _real=real, **kw):
                import torch
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args):
                    self.cuda_calls += 1
                return _real(*args, **kw)

            setattr(self.ref, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, real in self.saved.items():
            setattr(self.ref, n, real)


def reset_counts():
    from repro_torch.kernels import fused_mlp, grouped_gemm, topk_combine
    for m in (fused_mlp, grouped_gemm, topk_combine):
        m.reset()


def read_counts():
    from repro_torch.kernels import fused_mlp, grouped_gemm, topk_combine
    return {"fused_mlp": fused_mlp.launches,
            "grouped_gemm": grouped_gemm.launches,
            "topk_combine": topk_combine.launches}


def with_gemm(cfg, gemm_impl):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, gemm_impl=gemm_impl))


def serve(cfg, params, n_req, max_new, seed, out_key, out, batch=8,
          max_seq=1024, chunk=256):
    import numpy as np
    import torch

    from repro_torch.launch.serve import make_trace
    from repro_torch.serving import ServeEngine
    # warm-up on an engine of its own (first-call set-up of the CUDA
    # libraries and the kernels' module), so the timed run is a warm server
    warm = ServeEngine(cfg, params=params, max_seq=max_seq, batch_size=batch,
                       chunk=chunk, device="cuda")
    for p in make_trace(cfg.vocab_size, batch, 64, 512, seed + 100):
        warm.submit(p, max_new=2)
    warm.run()
    del warm
    eng = ServeEngine(cfg, params=params, max_seq=max_seq, batch_size=batch,
                      chunk=chunk, device="cuda")
    prompts = make_trace(cfg.vocab_size, n_req, 64, 512, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with PlainGuard() as guard:
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new=max_new) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    reqs = [eng.finished[r] for r in rids]
    ttft = [r.ttft_s * 1e3 for r in reqs]
    rec = {
        "gemm_impl": cfg.moe.gemm_impl, "requests": n_req,
        "max_new": max_new, "slots": batch, "max_seq": max_seq,
        "chunk": chunk, "prompt_tokens": eng.prefill_tokens,
        "decode_steps": eng.decode_steps, "decode_tokens": eng.decode_tokens,
        "admit_rounds": eng.admit_rounds, "wall_s": wall,
        "prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
        "prefill_tok_s": eng.prefill_tokens / max(eng.prefill_s, 1e-9),
        "decode_tok_s": eng.decode_tokens / max(eng.decode_s, 1e-9),
        "decode_ms_per_step": eng.decode_s / max(eng.decode_steps, 1) * 1e3,
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "plain_calls_on_cuda": guard.cuda_calls,
    }
    out[out_key] = rec
    log("  " + json.dumps(rec))
    bad = [r.rid for r in reqs if r.status.value != "ok"
           or len(r.tokens) != max_new
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    check(not bad, f"requests not ok with {max_new} valid tokens: {bad}")
    check(guard.cuda_calls == 0,
          f"plain versions saw CUDA tensors {guard.cuda_calls} times")
    return eng, rec


def phase_serve(state, out):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out["init_params_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {ARCH}: {n_params / 1e9:.2f} B parameters in bf16 on the card, "
        f"init {out['init_params_s']:.1f} s")
    state["cfg"], state["params"] = cfg, params
    _, rec = serve(cfg, params, 16, 32, 0, "serve", out)
    check(rec["launches"]["fused_mlp"] > 0 and
          rec["launches"]["topk_combine"] > 0,
          f"main path did not launch the kernels: {rec['launches']}")


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return [t for _, t in tree_leaves(tree)]


@contextlib.contextmanager
def plain_ops():
    """While active, ops' three entry points call the plain versions,
    explicitly by name, on CUDA tensors."""
    from repro_torch.kernels import ops, ref
    saved = (ops.topk_combine, ops.grouped_gemm, ops.fused_mlp)

    def plain_gg(lhs, rhs, order="expert_major"):
        return ref.grouped_gemm_ref(lhs, rhs)

    def plain_mlp(rows, w, activation, col_slice=None, order=""):
        wd = w["w_down"]
        if col_slice is not None:
            wd = wd[:, :, col_slice[0]:col_slice[0] + col_slice[1]]
        return ref.fused_mlp_ref(rows, w.get("w_gate"), w["w_up"], wd,
                                 activation)

    ops.topk_combine, ops.grouped_gemm, ops.fused_mlp = (
        ref.topk_combine_ref, plain_gg, plain_mlp)
    try:
        yield
    finally:
        ops.topk_combine, ops.grouped_gemm, ops.fused_mlp = saved


def teacher_forced_logits(cfg, params, toks, plens, nxt, S=512):
    """One stacked prefill_chunk, then one decode_step per row of ``nxt``
    (teacher-forced tokens): the fp32 logits of every step, stacked."""
    import torch

    from repro_torch.models import lm
    A = toks.shape[0]
    cache = lm.init_cache(cfg, A, S, "cuda")
    lg, cache = lm.prefill_chunk(
        cfg, params, cache, torch.from_numpy(toks).cuda(),
        torch.zeros(A, dtype=torch.long, device="cuda"),
        torch.from_numpy(plens).cuda())
    logits = [lg]
    pos = torch.from_numpy(plens).cuda()
    for row in nxt:
        lg, cache = lm.decode_step(cfg, params, cache,
                                   torch.from_numpy(row[:, None]).cuda(),
                                   pos)
        logits.append(lg)
        pos = pos + 1
    return torch.cat(logits)


def compare_logits(got, want):
    check(bool(got.isfinite().all()) and bool(want.isfinite().all()),
          "non-finite logits")
    row_rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
    return {"rows": got.shape[0],
            "rel_l2_err": float((got - want).norm() / want.norm()),
            "row_rel_l2_max": max(row_rel),
            "row_rel_l2_median": statistics.median(row_rel),
            "max_abs_err": float((got - want).abs().max()),
            "logit_absmax": float(want.abs().max()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())}


def phase_logits(state, out):
    """The same weights through the kernels and through the plain versions:
    one stacked prefill_chunk (4 rows x 256 tokens, valid lengths 97-256)
    plus 4 teacher-forced decode_steps.

    fp32, the first 4 layers (the bf16 weights cast up): here the two paths
    differ only in fp32 summation order, so the logits are held to the
    repo's fp32 tolerance in norm and the argmax to 95% of rows.

    bf16, all 24 layers: the two paths round to bf16 at other points, and
    with random-init routers (near-uniform probabilities) a 1-ulp difference
    flips the top-4 choice of near-tied tokens, which compounds over the
    layers. So the kernel path is held to the distance between two plain
    implementations of the same model, the plain versions and the "xla"
    backend (bf16 products, gate/up rounded to bf16): at most 3x that
    floor, and at least the repo's bf16 2e-2 in norm."""
    import numpy as np
    import torch

    from repro_torch.models.common import tree_map
    cfg, params = state["cfg"], state["params"]
    rng = np.random.default_rng(1)
    plens = np.array([256, 200, 97, 160])
    toks = rng.integers(1, cfg.vocab_size, (4, 256))
    nxt = rng.integers(1, cfg.vocab_size, (4, 4))

    def run(c, p, plain=False):
        if not plain:
            return teacher_forced_logits(c, p, toks, plens, nxt)
        with plain_ops():
            return teacher_forced_logits(c, p, toks, plens, nxt)

    n32 = min(4, cfg.n_layers)
    c32 = dataclasses.replace(cfg, n_layers=n32, param_dtype="float32",
                              compute_dtype="float32")
    p32 = {k: tree_map(lambda a: a.float(), v) for k, v in params.items()
           if k != "layers"}
    p32["layers"] = [tree_map(lambda a: a[:n32].float(), v)
                     for v in params["layers"]]
    fp32 = compare_logits(run(c32, p32), run(c32, p32, plain=True))
    del p32
    torch.cuda.empty_cache()
    plain = run(cfg, params, plain=True)
    bf16 = compare_logits(run(cfg, params), plain)
    floor = compare_logits(run(with_gemm(cfg, "xla"), params, plain=True),
                           plain)
    rec = {"fp32_4_layers": fp32, "bf16_24_layers": bf16,
           "bf16_24_layers_xla_vs_plain": floor}
    out["logits"] = rec
    log("  " + json.dumps(rec))
    check(fp32["rel_l2_err"] <= TOL["fp32"],
          f"fp32 logits rel L2 error {fp32['rel_l2_err']:.3e} > 1e-4")
    check(fp32["argmax_agree"] >= 0.95,
          f"fp32 argmax agreement {fp32['argmax_agree']:.2f} < 0.95")
    bound = max(TOL["bf16"], 3 * floor["rel_l2_err"])
    check(bf16["rel_l2_err"] <= bound,
          f"bf16 logits rel L2 error {bf16['rel_l2_err']:.3e} > {bound:.3e}")


def phase_pallas(state, out):
    import torch

    from repro_torch.core import moe_layer
    cfg, params = with_gemm(state["cfg"], "pallas"), state["params"]
    _, rec = serve(cfg, params, 8, 8, 2, "serve_pallas", out)
    check(rec["launches"]["grouped_gemm"] > 0,
          f"pallas serve did not launch grouped_gemm: {rec['launches']}")
    moe = {k: v[0] for k, v in params["layers"][0]["moe"].items()
           if k != "experts"}
    moe["experts"] = {k: v[0] for k, v in
                      params["layers"][0]["moe"]["experts"].items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    res = {}
    for name, shape in (("prefill", (8, 256, cfg.d_model)),
                        ("decode", (8, 1, cfg.d_model))):
        x = torch.randn(shape, device="cuda", generator=gen).to(
            moe["experts"]["w_up"].dtype)
        ys = {}
        reset_counts()
        for impl in ("pallas", "xla"):
            c = with_gemm(cfg, impl)
            ys[impl], _ = moe_layer.moe_ffn(c, c.moe, moe, x)
        err, ok = max_err(ys["pallas"], ys["xla"], TOL["bf16"])
        res[name] = {"max_abs_err": err, "within_tol": ok,
                     "grouped_gemm_launches": read_counts()["grouped_gemm"],
                     "y_absmean": float(ys["xla"].float().abs().mean())}
        check(res[name]["grouped_gemm_launches"] > 0,
              f"the pallas MoE layer did not launch grouped_gemm ({name})")
    out["moe_layer_pallas_vs_xla"] = res
    log("  " + json.dumps(res))
    check(all(r["within_tol"] for r in res.values()),
          f"pallas MoE layer disagrees with xla: {res}")


def phase_profile(state, out):
    """Device time by kernel name over one admission round (prefill) and 8
    decode steps of the serve configuration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_trace
    from repro_torch.serving import ServeEngine
    cfg, params = state["cfg"], state["params"]
    eng = ServeEngine(cfg, params=params, max_seq=1024, batch_size=8,
                      chunk=256, device="cuda")
    for p in make_trace(cfg.vocab_size, 8, 64, 512, 5):
        eng.submit(p, max_new=32)
    res = {}
    for name, work in (("prefill", lambda: eng._admit_batch(
            eng._gather_admissions())),
                       ("decode", lambda: [eng._decode_once()
                                           for _ in range(8)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}                 # device kernels and copies, by name
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                   n + 1)
        dev_ms = sum(ms for ms, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
        res[name] = {
            "wall_ms": wall * 1e3, "device_ms": dev_ms,
            "idle_share": max(0.0, 1 - dev_ms / (wall * 1e3)),
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, (ms, n) in top]}
        log(f"  {name}: wall {wall * 1e3:.1f} ms, device {dev_ms:.1f} ms")
        for r in res[name]["top"]:
            log(f"    {r['ms']:9.3f} ms {r['calls']:6d}x  {r['kernel']}")
    out["profile"] = res
    check(all(r["device_ms"] > 0 for r in res.values()),
          "the profiler recorded no device time")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def kernel_records(out):
    """One record per kernel: times and error at the prefill step's bf16
    shape, launches from the serving run that exercises it."""
    head = {"fused_mlp": "R=160 expert_major",
            "grouped_gemm": "gemm1 expert_major",
            "topk_combine": "T=2048"}
    src = {"fused_mlp": "serve", "grouped_gemm": "serve_pallas",
           "topk_combine": "serve"}
    recs = []
    for name, case in head.items():
        c = next((r for r in out.get("kernel_cases", [])
                  if r["kernel"] == name and r["dtype"] == "bf16"
                  and r["case"] == case), {})
        run = out.get(src[name], {})
        recs.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": run.get("launches", {}).get(name, 0),
            "max_abs_err": c.get("max_abs_err"), "ms": c.get("ms"),
            "plain_ms": c.get("plain_ms"), "bound_ms": c.get("bound_ms"),
            "bound_by": c.get("bound_by"), "library_ms": c.get("library_ms"),
            "at": f"bf16 {case}"})
    return recs


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.only.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.device import resolve_device
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the repo's package is missing ({e})",
              file=sys.stderr)
        return 2
    resolve_device("cuda")                     # TF32 off for fp32 products
    card = card_line()
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "phases": {}}
    state = {}
    t_all = time.perf_counter()
    failed = []
    for name in PHASES + EXTRA_PHASES:
        if name not in phases:
            continue
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            if name == "build":
                log(f"  card: {card}")
                lib = build.load()
                out["build_s"] = lib.build_s
                log(f"  kernels built in {lib.build_s:.1f} s -> {lib.path}")
                log("\n".join(line for line in lib.log.splitlines()
                              if "registers" in line or "==" in line))
            elif name == "kernels":
                phase_kernels(out)
            elif name == "serve":
                phase_serve(state, out)
            elif name == "logits":
                check("params" in state, "needs the serve phase")
                phase_logits(state, out)
            elif name == "pallas":
                check("params" in state, "needs the serve phase")
                phase_pallas(state, out)
            elif name == "profile":
                check("params" in state, "needs the serve phase")
                phase_profile(state, out)
            status = "ok"
        except Exception as e:                 # report, then fail the run
            import traceback
            traceback.print_exc()
            status = f"failed: {type(e).__name__}: {e}"
            failed.append(name)
        out["phases"][name] = {"status": status,
                               "s": time.perf_counter() - t0}
        log(f"  phase {name}: {status} ({time.perf_counter() - t0:.1f} s)")
    out["wall_s"] = time.perf_counter() - t_all
    out["kernels"] = kernel_records(out)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    tag = "" if phases == list(PHASES) else "_" + "_".join(phases)
    (dest / f"chip_smoke{tag}.json").write_text(json.dumps(out, indent=1))
    if failed:
        log(f"chip_smoke: phases failed: {failed}")
        return 1
    print(json.dumps({"kernels": out["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
