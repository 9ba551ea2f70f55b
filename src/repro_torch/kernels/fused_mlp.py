"""Wrappers of the fused expert-MLP CUDA kernels: the forward and its two
backward kernels, dgrad and wgrad.

Each has two CUDA paths, chosen by the operands before the launch
(``hopper_path``): bf16 operands with 16-byte aligned bases and row
strides and d, f, N multiples of 8 (every main-path call) take the wgmma
kernels (``csrc/fused_mlp_hopper.cu``, ``csrc/fused_mlp_dgrad_hopper.cu``,
``csrc/fused_mlp_wgrad_hopper.cu``; the backward pair shares its
recompute, ``csrc/fused_mlp_recompute.cuh``); fp32 and other shapes the
general kernels (``csrc/fused_mlp.cu``, ``csrc/fused_mlp_dgrad.cu``,
``csrc/fused_mlp_wgrad.cu``).

The plain versions are ``kernels/ref.fused_mlp_ref``,
``fused_mlp_dgrad_ref`` and ``fused_mlp_wgrad_ref``; ``kernels/ops.py``
picks between kernel and plain version by the tensors' device. Each kernel
counts its own launches (``launches``, ``dgrad_launches``,
``wgrad_launches``: both paths), and the wgmma paths their own beside them
(``hopper_launches``, ``dgrad_hopper_launches``,
``wgrad_hopper_launches``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_gemm import ORDERS
from repro_torch.kernels.ref import is_glu

ACTIVATIONS = {"swiglu": 0, "geglu": 1, "gelu": 2, "relu2": 3}
# kernel launches since the last reset(), one count per kernel, and the
# wgmma paths' share of each
launches = 0
dgrad_launches = 0
wgrad_launches = 0
hopper_launches = 0
dgrad_hopper_launches = 0
wgrad_hopper_launches = 0

# The wgmma forward's tiling (csrc/fused_mlp_hopper.cu): 64 rows per block;
# a block keeps F_s hidden columns of one f-split in shared memory, F_s a
# multiple of 128 up to 768.
HOPPER_BM, HOPPER_FC, HOPPER_FS_MAX = 64, 128, 768
# csrc/fused_mlp.cu and csrc/fused_mlp_dgrad.cu: hidden columns per
# partial plane
GENERAL_CHUNK = 128


def reset() -> None:
    global launches, dgrad_launches, wgrad_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    global hopper_launches, dgrad_hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    global wgrad_hopper_launches  # verify: ignore[mutable-global] -- launch counter chip_smoke.py reads
    launches = dgrad_launches = wgrad_launches = 0
    hopper_launches = dgrad_hopper_launches = wgrad_hopper_launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def hopper_path(rows, w_gate, w_up, w_down, dy=None) -> bool:
    """Whether a forward (dy None) or backward call takes the wgmma
    kernels:
    every operand bf16 with a 16-byte aligned base, a unit last stride and
    leading strides that are multiples of 8 elements, and d, f, N positive
    multiples of 8. Decided from the operands alone, before any launch;
    the other calls take the general kernels."""
    ts = [t for t in (rows, w_gate, w_up, w_down, dy) if t is not None]
    d, f, N = rows.shape[2], w_up.shape[2], w_down.shape[2]
    if min(d, f, N) <= 0 or d % 8 or f % 8 or N % 8:
        return False
    return all(t.dtype == torch.bfloat16 and t.stride(-1) == 1
               and t.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in t.stride()[:-1]) for t in ts)


def fused_mlp_plan(E: int, R: int, d: int, f: int, N: int,
                   sm_count: int = 132) -> dict:
    """The wgmma forward's split of the hidden: F_s as large as shared
    memory allows (768), lowered by 128 while E * ceil(R / 64) * S blocks
    would fill fewer than two waves of ``sm_count`` SMs, S = ceil(f / F_s).
    -> fs, splits, blocks, and scratch_bytes: the fp32 partial planes,
    S * E * R * N * 4 (written once and read once by the reduce pass)."""
    mt = _cdiv(R, HOPPER_BM)
    fs = min(HOPPER_FS_MAX, _cdiv(f, HOPPER_FC) * HOPPER_FC)
    while fs > HOPPER_FC and E * mt * _cdiv(f, fs) < 2 * sm_count:
        fs -= HOPPER_FC
    S = _cdiv(f, fs)
    return {"fs": fs, "splits": S, "blocks": E * mt * S,
            "scratch_bytes": S * E * R * N * 4}


# csrc/fused_mlp_hopper.cu's shared memory: the split's hidden in 8 KB
# panels (64 rows of 128 bytes per 64 hidden columns) and a ring of 40 KB
# TMA stages (x, Wg, Wu | Wd), at least 3 and at most 8 of them, beside 1 KB
# of alignment and the ring's barriers, within what a block may use.
HOPPER_PANEL = 64 * 128
HOPPER_SLOT = 5 * HOPPER_PANEL
HOPPER_MIN_STAGES, HOPPER_MAX_STAGES = 3, 8
HOPPER_BAR_BYTES = 2 * HOPPER_MAX_STAGES * 8
HOPPER_SMEM_MAX = 232448


def hopper_stages(fs: int) -> int:
    """The TMA ring's stages beside a split of ``fs`` hidden columns
    (``stages_for`` in csrc/fused_mlp_hopper.cu)."""
    left = HOPPER_SMEM_MAX - 1024 - HOPPER_BAR_BYTES - fs // 64 * HOPPER_PANEL
    return min(left // HOPPER_SLOT, HOPPER_MAX_STAGES)


def hopper_smem_bytes(fs: int) -> int:
    """Dynamic shared memory of one wgmma forward block at a split of
    ``fs`` hidden columns (``smem_for`` in csrc/fused_mlp_hopper.cu)."""
    return (1024 + hopper_stages(fs) * HOPPER_SLOT
            + fs // 64 * HOPPER_PANEL + HOPPER_BAR_BYTES)


def hopper_fits(fs: int) -> bool:
    """Whether a split of ``fs`` hidden columns leaves the ring its
    minimum stages within one block's shared memory."""
    return (0 < fs <= HOPPER_FS_MAX and hopper_stages(fs) >= HOPPER_MIN_STAGES
            and hopper_smem_bytes(fs) <= HOPPER_SMEM_MAX)


def general_scratch_bytes(E: int, R: int, f: int, N: int) -> int:
    """The general forward's fp32 partial planes, one (E, R, N) per 128
    hidden columns; the general dgrad's with d for N."""
    return _cdiv(f, GENERAL_CHUNK) * E * R * N * 4


def _dgrad_scratch_shape(E: int, R: int, f: int, glu: bool):
    """The wgmma dgrad's scratch: the recomputed dup (and dgate), each
    (E, R, f) in bf16."""
    return (2 if glu else 1, E, R, f)


def dgrad_scratch_bytes(E: int, R: int, f: int, glu: bool) -> int:
    n, E, R, f = _dgrad_scratch_shape(E, R, f, glu)
    return n * E * R * f * 2


def _wgrad_scratch_shape(E: int, R: int, f: int, glu: bool):
    """The wgmma wgrad's scratch: the recomputed h, dup (and dgate), each
    (E, R, f) in bf16."""
    return (3 if glu else 2, E, R, f)


def wgrad_scratch_bytes(E: int, R: int, f: int, glu: bool) -> int:
    n, E, R, f = _wgrad_scratch_shape(E, R, f, glu)
    return n * E * R * f * 2


def _check(name, rows, w_gate, w_up, w_down, activation, dy=None):
    """Check the operands every fused-MLP kernel takes; returns
    (dtype code, E, R, d, f, N)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"{name}: unknown activation {activation!r}")
    if is_glu(activation) != (w_gate is not None):
        raise ValueError(f"{name}: {activation} needs w_gate "
                         f"{'' if is_glu(activation) else 'to be None'}")
    ws = [w for w in (w_gate, w_up) if w is not None]
    extra = [] if dy is None else [dy]
    build.require_cuda(name, rows, w_down, *ws, *extra)
    code = build.dtype_code(name, rows, w_down, *ws, *extra)
    if rows.dim() != 3 or w_down.dim() != 3 or any(
            w.shape != w_up.shape or w.dim() != 3 for w in ws):
        raise ValueError(f"{name}: expected 3-d rows and weights")
    E, R, d = rows.shape
    f = w_up.shape[2]
    N = w_down.shape[2]
    if w_up.shape[:2] != (E, d) or w_down.shape[:2] != (E, f):
        raise ValueError(f"{name}: shapes rows {tuple(rows.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)} do not chain")
    if dy is not None and tuple(dy.shape) != (E, R, N):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} is not "
                         f"{(E, R, N)}")
    if any(t.stride(2) != 1 for t in [rows, w_down] + extra):
        raise ValueError(f"{name}: rows, w_down and dy need a unit last "
                         f"stride")
    if not all(w.is_contiguous() for w in ws):
        raise ValueError(f"{name}: w_gate and w_up must be contiguous")
    return code, E, R, d, f, N


def fused_mlp(rows: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_up: torch.Tensor, w_down: torch.Tensor, activation: str,
              order: str = "expert_major") -> torch.Tensor:
    """rows: (E, R, d); w_gate/w_up: (E, d, f) (w_gate None for non-GLU
    activations); w_down: (E, f, N), which may be a column slice of the
    full weight -> (E, R, N) in the inputs' dtype. The hidden stays in
    shared memory; products accumulate in fp32. Scratch for the fp32
    partial sums of the f-chunks is allocated here."""
    global launches, hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    name = "fused_mlp"
    if order not in ORDERS:
        raise ValueError(f"{name}: unknown order {order!r}")
    code, E, R, d, f, N = _check(name, rows, w_gate, w_up, w_down, activation)
    out = torch.empty((E, R, N), dtype=rows.dtype, device=rows.device)
    if out.numel() == 0:
        return out
    if f == 0:
        return out.zero_()
    lib = build.load()
    if hopper_path(rows, w_gate, w_up, w_down):
        plan = fused_mlp_plan(E, R, d, f, N, build.sm_count(rows.device.index
                                                            or 0))
        part = torch.empty((plan["splits"], E, R, N), dtype=torch.float32,
                           device=rows.device)
        err = lib.lib.repro_fused_mlp_hopper(
            rows.data_ptr(), rows.stride(0), rows.stride(1),
            None if w_gate is None else w_gate.data_ptr(), w_up.data_ptr(),
            w_up.stride(0), w_up.stride(1),
            w_down.data_ptr(), w_down.stride(0), w_down.stride(1),
            part.data_ptr(), out.data_ptr(), E, R, d, f, N,
            ACTIVATIONS[activation], ORDERS[order], plan["fs"],
            build.stream_ptr(rows))
        lib.check(name, err)
        launches += 1
        hopper_launches += 1
        return out
    # fp32 partial sums, one (E, R, N) plane per f-chunk (split-f design)
    n_chunks = -(-f // lib.lib.repro_fused_mlp_chunk())
    part = torch.empty((n_chunks, E, R, N), dtype=torch.float32,
                       device=rows.device)
    err = lib.lib.repro_fused_mlp(
        rows.data_ptr(), rows.stride(0), rows.stride(1),
        None if w_gate is None else w_gate.data_ptr(), w_up.data_ptr(),
        w_up.stride(0), w_up.stride(1),
        w_down.data_ptr(), w_down.stride(0), w_down.stride(1),
        part.data_ptr(), out.data_ptr(), E, R, d, f, N,
        ACTIVATIONS[activation],
        ORDERS[order], code, build.stream_ptr(rows))
    lib.check(name, err)
    launches += 1
    return out


def fused_mlp_dgrad(rows: torch.Tensor, w_gate: Optional[torch.Tensor],
                    w_up: torch.Tensor, w_down: torch.Tensor,
                    dy: torch.Tensor, activation: str) -> torch.Tensor:
    """dX (E, R, d) of the fused expert MLP for the cotangent dy (E, R, N),
    in the inputs' dtype. w_down and dy may be the same column slice of the
    full output (dX is then that block's part). Scratch is allocated here:
    on the wgmma path the bf16 dup (and dgate) of the recompute; on the
    general path the fp32 partial sums of the f-chunks."""
    global dgrad_launches, dgrad_hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    name = "fused_mlp_dgrad"
    code, E, R, d, f, N = _check(name, rows, w_gate, w_up, w_down,
                                 activation, dy)
    out = torch.empty((E, R, d), dtype=rows.dtype, device=rows.device)
    if out.numel() == 0:
        return out
    if f == 0 or N == 0:
        return out.zero_()
    lib = build.load()
    if hopper_path(rows, w_gate, w_up, w_down, dy):
        scratch = torch.empty(
            _dgrad_scratch_shape(E, R, f, w_gate is not None),
            dtype=rows.dtype, device=rows.device)
        err = lib.lib.repro_fused_mlp_dgrad_hopper(
            rows.data_ptr(), rows.stride(0), rows.stride(1),
            None if w_gate is None else w_gate.data_ptr(), w_up.data_ptr(),
            w_up.stride(0), w_up.stride(1),
            w_down.data_ptr(), w_down.stride(0), w_down.stride(1),
            dy.data_ptr(), dy.stride(0), dy.stride(1), scratch.data_ptr(),
            out.data_ptr(), E, R, d, f, N, ACTIVATIONS[activation],
            build.stream_ptr(rows))
        lib.check(name, err)
        dgrad_launches += 1
        dgrad_hopper_launches += 1
        return out
    n_chunks = -(-f // lib.lib.repro_fused_mlp_dgrad_chunk())
    part = torch.empty((n_chunks, E, R, d), dtype=torch.float32,
                       device=rows.device)
    err = lib.lib.repro_fused_mlp_dgrad(
        rows.data_ptr(), rows.stride(0), rows.stride(1),
        None if w_gate is None else w_gate.data_ptr(), w_up.data_ptr(),
        w_up.stride(0), w_up.stride(1),
        w_down.data_ptr(), w_down.stride(0), w_down.stride(1),
        dy.data_ptr(), dy.stride(0), dy.stride(1),
        part.data_ptr(), out.data_ptr(), E, R, d, f, N,
        ACTIVATIONS[activation], code, build.stream_ptr(rows))
    lib.check(name, err)
    dgrad_launches += 1
    return out


def fused_mlp_wgrad(rows: torch.Tensor, w_gate: Optional[torch.Tensor],
                    w_up: torch.Tensor, w_down: torch.Tensor,
                    dy: torch.Tensor, activation: str
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                               torch.Tensor]:
    """(dw_gate | None, dw_up, dw_down) of the fused expert MLP for the
    cotangent dy (E, R, N): (E, d, f), (E, d, f), (E, f, N) in the inputs'
    dtype. With a column-sliced w_down/dy, dw_down is that column block and
    dw_up/dw_gate are the block's partials. Scratch is allocated here: on
    the wgmma path the bf16 h, dup (and dgate) of the recompute; on the
    general path the fp32 running sums of the row-tile loop, padded to
    whole tiles, when R spans more than one tile."""
    global wgrad_launches, wgrad_hopper_launches  # verify: ignore[mutable-global] -- launch counters chip_smoke.py reads
    name = "fused_mlp_wgrad"
    code, E, R, d, f, N = _check(name, rows, w_gate, w_up, w_down,
                                 activation, dy)
    dev, dt = rows.device, rows.dtype
    glu = w_gate is not None
    dwg = torch.empty((E, d, f), dtype=dt, device=dev) if glu else None
    dwu = torch.empty((E, d, f), dtype=dt, device=dev)
    dwd = torch.empty((E, f, N), dtype=dt, device=dev)
    outs = [t for t in (dwg, dwu, dwd) if t is not None]
    if all(t.numel() == 0 for t in outs):
        return dwg, dwu, dwd
    if R == 0:
        return tuple(None if t is None else t.zero_()
                     for t in (dwg, dwu, dwd))
    lib = build.load()
    if hopper_path(rows, w_gate, w_up, w_down, dy):
        scratch = torch.empty(_wgrad_scratch_shape(E, R, f, glu), dtype=dt,
                              device=dev)
        err = lib.lib.repro_fused_mlp_wgrad_hopper(
            rows.data_ptr(), rows.stride(0), rows.stride(1),
            None if w_gate is None else w_gate.data_ptr(), w_up.data_ptr(),
            w_up.stride(0), w_up.stride(1),
            w_down.data_ptr(), w_down.stride(0), w_down.stride(1),
            dy.data_ptr(), dy.stride(0), dy.stride(1), scratch.data_ptr(),
            None if dwg is None else dwg.data_ptr(), dwu.data_ptr(),
            dwd.data_ptr(), E, R, d, f, N, ACTIVATIONS[activation],
            build.stream_ptr(rows))
        lib.check(name, err)
        wgrad_launches += 1
        wgrad_hopper_launches += 1
        return dwg, dwu, dwd
    bm, bfs, bo = (lib.lib.repro_fused_mlp_wgrad_tile(i) for i in range(3))
    run_g = run_u = run_d = None
    if R > bm:
        def up(n, b):
            return -(-n // b) * b
        Fp, Np, Dp = up(f, bfs), up(N, bo), up(d, bo)
        run_u = torch.empty((E, Dp, Fp), dtype=torch.float32, device=dev)
        run_d = torch.empty((E, Fp, Np), dtype=torch.float32, device=dev)
        if glu:
            run_g = torch.empty((E, Dp, Fp), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.lib.repro_fused_mlp_wgrad(
        rows.data_ptr(), rows.stride(0), rows.stride(1), ptr(w_gate),
        w_up.data_ptr(), w_up.stride(0), w_up.stride(1),
        w_down.data_ptr(), w_down.stride(0), w_down.stride(1),
        dy.data_ptr(), dy.stride(0), dy.stride(1),
        ptr(run_g), ptr(run_u), ptr(run_d), ptr(dwg), dwu.data_ptr(),
        dwd.data_ptr(), E, R, d, f, N, ACTIVATIONS[activation], code,
        build.stream_ptr(rows))
    lib.check(name, err)
    wgrad_launches += 1
    return dwg, dwu, dwd
