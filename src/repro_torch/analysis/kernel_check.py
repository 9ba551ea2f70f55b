"""The plan-knob gate of ``core/adaptive.candidate_plans``
(``repro.analysis.verify.kernel_check``'s ``fused_mlp_vmem_bytes``,
``plan_vmem_ok`` and ``check_candidate_plans``).

The fused backend (``gemm_impl="pallas_fused"``) runs one column-sliced
fused expert-MLP call per comet column block: each call tiles ``N/n_col``
output columns over a hidden of ``K``. The JAX package gates every preset
on a TPU's VMEM, where the Pallas kernel holds full-width blocks; the port
keeps that rule for TPU presets, so a TPU-keyed cache resolves as in the
JAX package. A GPU preset is gated on the kernel the port runs: the
``wgmma`` forward (``kernels/fused_mlp.py``) keeps ``F_s`` hidden columns
of one f-split in a block's shared memory beside its TMA ring and streams
d and N, so a plan passes when the split ``fused_mlp_plan`` picks for it
fits one block. ``Hardware.vmem_bytes == 0`` turns the gate off for every
preset, as in the JAX package.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.verify.diagnostics import Diagnostic
from repro_torch.kernels import fused_mlp as FM

# the Pallas grid pipeline keeps the current and the next operand block in
# VMEM (double buffering); scratch is single-buffered
PIPELINE_BUFFERS = 2


def _d(rule: str, loc: str, msg: str, hint: str = "") -> Diagnostic:
    return Diagnostic("kernel", rule, "error", loc, msg, hint)


def fused_mlp_vmem_bytes(N: int, K: int, n_col: int, *, glu: bool = True,
                         bm: int = 128, bf: int = 512,
                         bytes_per_elt: int = 2) -> int:
    """VMEM footprint of one comet col-sliced Pallas fused_mlp call under a
    plan (the TPU rule): the call tiles ``N/n_col`` output columns
    full-width."""
    bn = max(1, N // max(1, n_col))
    bfe = min(bf, K)
    n_l0 = 2 if glu else 1
    io = (bm * N                       # x block (1, bm, d)
          + n_l0 * N * bfe             # w_gate/w_up blocks (1, d, bf)
          + bfe * bn                   # w_down block (1, bf, bn)
          + bm * bn) * bytes_per_elt   # out block (1, bm, bn)
    return PIPELINE_BUFFERS * io + bm * bn * 4   # + fp32 scratch


def fused_mlp_block_plan(s, n_col: int) -> dict:
    """The port's fused forward under a plan at shape ``s``: the
    ``fused_mlp_plan`` of one col-sliced call (E / ep local experts, the
    layer's rows per expert, d = s.N, f = s.K, N = s.N / n_col) and the
    shared memory of one block of it (``smem_bytes``)."""
    E_loc = max(1, s.E // max(1, s.ep))
    rows = max(1, -(-s.M * s.topk // max(1, s.E)))
    plan = FM.fused_mlp_plan(E_loc, rows, s.N, s.K,
                             max(1, s.N // max(1, n_col)))
    return {**plan, "smem_bytes": FM.hopper_smem_bytes(plan["fs"])}


def plan_vmem_ok(s, plan, hw) -> bool:
    """Whether ``plan``'s fused kernel tiling fits ``hw``: a TPU preset's
    VMEM (the JAX rule), a GPU preset's block of shared memory (the port's
    kernel). Non-fused backends are never rejected."""
    budget = getattr(hw, "vmem_bytes", 0)
    if not budget or plan.gemm_impl != "pallas_fused":
        return True
    n_col = (max(1, plan.n_col_blocks)
             if plan.impl in ("comet", "comet_hier") else 1)
    if hw.name.startswith("tpu"):
        return fused_mlp_vmem_bytes(
            s.N, s.K, n_col, glu=s.glu,
            bytes_per_elt=s.bytes_per_elt) <= budget
    return FM.hopper_fits(fused_mlp_block_plan(s, n_col)["fs"])


def check_candidate_plans(shapes=None, hw=None) -> List[Diagnostic]:
    """Property check: ``candidate_plans`` must never emit a tiling that
    ``plan_vmem_ok`` rejects."""
    from repro_torch.core import adaptive as A
    hw = hw or A.H100_NVL
    if shapes is None:
        shapes = [
            A.MoEShape(M=8192, N=4096, K=14336, E=8, topk=2, ep=8, etp=1),
            A.MoEShape(M=8192, N=2048, K=1408, E=64, topk=4, ep=8, etp=1),
            A.MoEShape(M=4096, N=16384, K=4096, E=16, topk=2, ep=8, etp=1),
        ]
    diags: List[Diagnostic] = []
    for s in shapes:
        for p in A.candidate_plans(s, hw=hw):
            if not plan_vmem_ok(s, p, hw):
                diags.append(_d(
                    "vmem-overflow", f"plan:N{s.N}:K{s.K}",
                    f"candidate_plans emitted {p.impl}/{p.gemm_impl} "
                    f"n_col={p.n_col_blocks} whose tiling does not fit "
                    f"{hw.name}",
                    hint="candidate_plans must filter through "
                         "plan_vmem_ok"))
    return diags
