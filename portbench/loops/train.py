"""The training loop: the program's own step, called step after step.

Set-up builds the one training state (weights from the seed, AdamW's
moments) and the step (``launch/train_step.build_train_step``), and drives
the first three steps through that same step on batches whose rows all
differ: they warm every shape the window uses, and their losses, the
first gradient (as AdamW's first moment holds it) and each leaf's change
over the three are what the reference is held to. The window then runs
the same step on further batches until ``seconds`` have passed. Once it
has closed and the program's state is freed, the reference takes the same
three steps from the same weights, regenerated from the seed, in fp32.
The set-up time leaves out what set-up spends on the check's readings
(the first gradient's and the parameters' host copies and norms).
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, Optional

import torch

from portbench import adapter
from portbench import weights as W
from portbench.reference import compare as RC
from portbench.reference import model as RM
from portbench.reference import train as RT
from portbench.trace import Trace
from portbench.yardstick import kernels as K
from portbench.yardstick import costs
from portbench.yardstick import traffic as TR

N_CHECK = 3


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault: Optional[Callable] = None, control: bool = False) -> Dict:
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.optim.adamw import AdamW

    model, tr_spec, opt = cell.conf["model"], cell.traffic, cell.spec["optimizer"]
    B, S, V = tr_spec["batch"], tr_spec["seq_len"], model["vocab_size"]
    cuda = str(device).startswith("cuda")
    cfg = adapter.program_config(cell.conf)
    layout = RM.param_layout(model)
    pdt = adapter.param_dtype(cell.conf)
    init_std = cell.conf.get("init_std")
    params = adapter.program_params(W.make(layout, seed, device, pdt,
                                           init_std))
    lr = float(opt["lr"])
    optim = AdamW(lr=lambda step: lr, b1=opt["b1"], b2=opt["b2"],
                  eps=opt["eps"], weight_decay=opt["weight_decay"],
                  clip_norm=opt["clip_norm"])
    fn = build_train_step(cfg, ShapeConfig("portbench", S, B, "train"),
                          optim=optim)["fn"]
    if fault is not None:
        fn = fault(fn)
    state = {"params": params, "opt": optim.init(params), "step": 0}

    def batch(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in TR.train_batch(seed, i, B, S, V).items()}

    # the first steps: warm-up, and what the reference is held to
    prog: Dict = {"loss": [], "grad_norm": {}, "change": {}}
    host: Dict = {"grad": {}, "param": {}}     # the program's, set aside
    t_steps = []
    t_check = 0.0          # set-up spent on the check's readings, not counted
    for i in range(N_CHECK):
        ts = time.perf_counter()
        state, met = fn(state, batch(i))
        prog["loss"].append(float(met["loss"]))
        t_steps.append(time.perf_counter() - ts)
        if i == 0:
            tc = time.perf_counter()
            for path, m in RM.leaves(state["opt"]["m"]):
                g = m / (1 - opt["b1"])
                prog["grad_norm"][path] = float(g.norm())
                host["grad"][path] = g.to("cpu")
                del g
            t_check += time.perf_counter() - tc
    tc = time.perf_counter()
    for path, p in RM.leaves(state["params"]):
        host["param"][path] = p.detach().to("cpu", copy=True)
        p0 = W.make_leaf(W.decl_at(layout, path), seed, path, device,
                         pdt, init_std)
        prog["change"][path] = float(
            (p.detach().float().reshape(p0.shape) - p0.float()).norm())
        del p0
    t_check += time.perf_counter() - tc
    # the window's batches, made in set-up
    n_win = int(min(256, math.ceil(1.5 * seconds / max(min(t_steps[1:]),
                                                       1e-3)) + 2))
    win = [batch(N_CHECK + i) for i in range(n_win)]
    _sync(device)
    pre_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tr = Trace(trace)
    steps = skipped = 0
    with tr.window_ctx():
        tw0 = time.perf_counter()
        while True:
            with tr.span("train_step"):
                state, met = fn(state, win[steps % n_win])
            skipped += int(met["skipped"])
            steps += 1
            if time.perf_counter() - tw0 >= seconds:
                break
        _sync(device)
        tw1 = time.perf_counter()
    window_s = tw1 - tw0
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    peak_bytes = max(pre_peak, peak_window)
    tokens = steps * B * S
    out: Dict = {
        "attempted": steps, "failed": skipped,
        "end_to_end": {"setup_s": tw0 - t0 - t_check,
                       "train_tokens_per_s": tokens / window_s},
        "peak_bytes": peak_bytes}
    if trace:
        rec = tr.record()
        rec.update(loop="train", model=model, chips=cell.chips,
                   host_window_s=window_s, tokens=tokens,
                   model_flops=steps * costs.train_flops(model, B, S),
                   mem_peak_window_bytes=peak_window)
        out["record"] = rec
        out["breakdown"] = tr.breakdown(rec)
        bounds = K.moe_bounds(rec)
        out["moe"] = {"bounds": bounds, "device_s": K.moe_device_s(rec)}
        if "fused_mlp" in bounds:
            # the rows an expert holds against the (token, choice) pairs
            m = model["moe"]
            rows = bounds["fused_mlp"]["rows"]
            share = rows * m["num_experts"] / (B * S * m["top_k"])
            out["moe"]["routing"] = rec["routing"] = {
                "rows_an_expert": rows, "routed_share": share,
                "drop_share": 1.0 - share}
    # the program's state goes before the reference runs
    del state, params, fn, met, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_batches = [batch(i) for i in range(N_CHECK)]
    ref_w = W.make(layout, seed, device, pdt, init_std)
    ref = RT.steps(model, ref_w, ref_batches, opt, against=host,
                   keep=control)
    del host
    numbers = RC.train_numbers(prog, ref, ref)
    limits = cell.spec["limits"]
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    out["correct"] = RC.judge(numbers, limits) and skipped == 0
    out["detail"] = {k: v for k, v in numbers.items() if k not in limits}
    if control:
        kept = {"grad": ref.pop("grad_host"), "param": ref.pop("param_host")}
        ctl = RT.steps(model, ref_w, ref_batches, opt, RM.Prec("fp8"),
                       against=kept)
        ctl = RC.train_numbers(ctl, ref, ctl)
        out["control"] = {**ctl, "correct": RC.judge(ctl, limits)}
    return out
