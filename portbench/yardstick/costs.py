"""The benchmark's own arithmetic of work: the H100's published peaks, each
MoE kernel's bytes and operations, and a model's FLOPs.

A frozen copy. The cost functions are those of the port's
``analysis/roofline.py`` (``fused_mlp_cost``, ``fused_mlp_bwd_cost``,
``grouped_gemm_cost``, ``topk_combine_cost``) and the parameter count of its
``configs/base.py``; they live here so that a change to the program cannot
move its own yardstick. Two departures, both on purpose:

* ``train_flops`` and ``serve_flops`` (the original's ``model_flops``)
  add attention's score and value products over the (causal) query-key
  pairs, which ``6 N_active D`` leaves out.
* The MoE bounds are priced on the work the inputs need: the routed rows
  of each expert, not the empty capacity rows, and the weights of the
  experts that receive a row (``moe_call_bound``).

Everything takes plain numbers or the configuration file's ``model``
section (a dict), never the program's objects.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from portbench.reference.model import is_moe_layer, layer_kind

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BW = 3.35e12                 # bytes/s


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One kernel call: ``bytes`` (each operand read once, each output
    written once), ``flops`` and the peak they run at."""
    bytes: float
    flops: float
    peak: str

    def bound_s(self) -> float:
        """The least time the card takes: the larger of bytes over the HBM
        bandwidth and FLOPs over the peak of their type."""
        return max(self.bytes / HBM_BW, self.flops / PEAK_FLOPS[self.peak])


def _peak(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "fp32"


def fused_mlp_cost(E: int, R: int, d: int, f: int, n_out: int,
                   glu: bool = True, itemsize: int = 2) -> KernelCost:
    """act(x Wg, x Wu) Wd over R rows of each of E experts."""
    n_w1 = 2 if glu else 1
    nbytes = (E * R * d + n_w1 * E * d * f + E * f * n_out
              + E * R * n_out) * itemsize
    flops = 2 * E * R * d * f * n_w1 + 2 * E * R * f * n_out
    return KernelCost(nbytes, flops, _peak(itemsize))


def fused_mlp_bwd_cost(kernel: str, E: int, R: int, d: int, f: int,
                       n_out: int, glu: bool = True,
                       itemsize: int = 2) -> KernelCost:
    """dX (``fused_mlp_dgrad``) or dWg, dWu, dWd (``fused_mlp_wgrad``) for
    a cotangent of ``n_out`` columns; the FLOPs count the recompute of the
    hidden that the kernels' interface forces."""
    if kernel not in ("fused_mlp_dgrad", "fused_mlp_wgrad"):
        raise ValueError(f"not a backward kernel: {kernel!r}")
    n_w1 = 2 if glu else 1
    dgrad = kernel == "fused_mlp_dgrad"
    ins = E * R * d + n_w1 * E * d * f + E * f * n_out + E * R * n_out
    outs = E * R * d if dgrad else n_w1 * E * d * f + E * f * n_out
    flops = (2 * E * R * f * (2 * n_w1 * d + n_out) if dgrad
             else 2 * E * R * f * (2 * n_w1 * d + 2 * n_out))
    return KernelCost((ins + outs) * itemsize, flops, _peak(itemsize))


def grouped_gemm_cost(E: int, M: int, K: int, N: int,
                      itemsize: int = 2) -> KernelCost:
    return KernelCost((E * M * K + E * K * N + E * M * N) * itemsize,
                      2 * E * M * K * N, _peak(itemsize))


def topk_combine_cost(T: int, k: int, d: int, itemsize: int = 2,
                      w_itemsize: int = 4) -> KernelCost:
    return KernelCost(T * k * d * itemsize + T * k * w_itemsize
                      + T * d * itemsize, 2 * T * k * d, _peak(itemsize))


def moe_call_bound(kernel: str, rows_per_expert: Sequence[int], d: int,
                   f: int, n_out: int, glu: bool, itemsize: int) -> float:
    """The bound of one expert-MLP call (forward, dgrad or wgrad) priced on
    what its inputs need: each expert with R_e routed rows costs what a
    call on R_e rows costs, and an expert with none costs nothing (its
    weights need not be read). The sum over experts of per-expert costs,
    bytes and FLOPs added before the max."""
    nbytes = flops = 0.0
    peak = _peak(itemsize)
    for r in rows_per_expert:
        if r <= 0:
            continue
        c = (fused_mlp_cost(1, r, d, f, n_out, glu, itemsize)
             if kernel == "fused_mlp"
             else fused_mlp_bwd_cost(kernel, 1, r, d, f, n_out, glu,
                                     itemsize))
        nbytes += c.bytes
        flops += c.flops
    return KernelCost(nbytes, flops, peak).bound_s()


# ---------------------------------------------------------------------------
# Model FLOPs
# ---------------------------------------------------------------------------


def _glu(model: Dict) -> bool:
    return model.get("activation", "swiglu") in ("swiglu", "geglu")


def _ffn_params(model: Dict, hidden: int) -> int:
    return (3 if _glu(model) else 2) * model["d_model"] * hidden


def active_params(model: Dict) -> int:
    """Parameters a token's products touch: every matrix of its layers,
    its top-k experts of each MoE layer and the output head. The
    embedding (a lookup), the norms and the SSM's depthwise convolution,
    A_log and D (elementwise) are left out."""
    d = model["d_model"]
    total = d * model["vocab_size"]                          # output head
    for i in range(model["n_layers"]):
        if layer_kind(model, i) == "a":
            a = model["attn"]
            total += d * a["n_heads"] * a["head_dim"] * 2    # q, o
            total += d * a["n_kv_heads"] * a["head_dim"] * 2  # k, v
        else:
            s = model["ssm"]
            d_in = s["expand"] * d
            nh = d_in // s["head_dim"]
            total += d * (2 * d_in + 2 * s["d_state"] + nh) + d_in * d
        if is_moe_layer(model, i):
            m = model["moe"]
            total += d * m["num_experts"]                    # router
            total += (m["top_k"] + m.get("num_shared_experts", 0)) * \
                _ffn_params(model, m["d_expert"])
        elif model.get("d_ff", 0) > 0:
            total += _ffn_params(model, model["d_ff"])
    return total


def attention_pair_flops(model: Dict) -> float:
    """FLOPs of one query-key pair, forward, summed over the attention
    layers: QK^T and PV, 2 FLOPs a multiply-add each."""
    n_attn = sum(1 for i in range(model["n_layers"])
                 if layer_kind(model, i) == "a")
    if not n_attn:
        return 0.0
    a = model["attn"]
    return n_attn * 2 * 2 * a["n_heads"] * a["head_dim"]


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def train_flops(model: Dict, batch: int, seq: int) -> float:
    """One training step of ``batch`` sequences of ``seq`` tokens: 6 FLOPs a
    parameter a token (forward and backward) plus 3x the forward attention
    over the causal pairs. Recompute under remat is not counted."""
    tokens = batch * seq
    return (6.0 * active_params(model) * tokens
            + 3.0 * attention_pair_flops(model) * batch * causal_pairs(seq))


def serve_flops(model: Dict, tokens: int, pairs: int) -> float:
    """Forward FLOPs of ``tokens`` processed tokens whose attention covers
    ``pairs`` query-key pairs in all."""
    return 2.0 * active_params(model) * tokens + \
        attention_pair_flops(model) * pairs


def mfu_percent(flops: float, seconds: float, chips: int) -> float:
    return 100.0 * flops / (seconds * chips * PEAK_FLOPS["bf16"])
