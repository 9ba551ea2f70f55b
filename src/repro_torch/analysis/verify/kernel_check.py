"""The kernel resource checker: the port's CUDA launches under an H100's
limits (the JAX package's ``repro.analysis.verify.kernel_check``, whose
models are Pallas grids under a TPU's VMEM).

A launch is a contract that nothing checks until the card refuses it or
returns garbage: (a) a block's dynamic plus static shared memory within
the 232,448 bytes a block may opt into; (b) at most 1,024 threads a
block, and whole warpgroups (128 threads) for a ``wgmma`` kernel; (c)
every output tile written once over the whole grid, each tile starting
inside its array; (d) bf16 inputs accumulated in fp32; (e) on the
``wgmma`` paths, every operand a TMA copy reads (or a 16-byte vector load,
on the SSD's tensor-core path) with a 16-byte aligned base and 16-byte
strides, for every shape the wrapper's ``hopper_path`` accepts.

The checker works on :class:`KernelModel`, one per launch: its grid,
threads, shared memory, the output tiles each block writes (a mirror of
the ``.cu`` file's block-index arithmetic), the input and accumulator
dtypes and the TMA operands. ``builtin_kernel_models`` builds them for
all eight kernels on both paths at PERF.md §6's shapes from the
wrappers' own plan functions (``fused_mlp_plan``, ``hopper_smem_bytes``,
``grouped_gemm.hopper_plan``, ``rmsnorm.launch_plan``,
``topk_combine.launch_plan``) and ``hopper_path`` predicates; a tile or
layout that only a ``.cu`` file holds is in ``CU_CONSTANTS``, which
``tests/test_torch_verify.py`` reads back out of the sources. The tuner's
plan gate (``plan_vmem_ok``, ``check_candidate_plans``) stays in
``analysis/kernel_check.py`` and runs in this pass.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import kernel_check as plan_gate
from repro_torch.analysis.verify.diagnostics import Diagnostic
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels import grouped_gemm as GG
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import topk_combine as TK

_PASS = "kernel"

SMEM_PER_BLOCK = FM.HOPPER_SMEM_MAX     # the opt-in limit of an H100 block
MAX_THREADS = 1024
WARPGROUP = 128
SM_COUNT = 132                          # H100 SXM
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
MAX_GRID = 1 << 24                      # blocks a model's grid may hold
_REDUCED = ("bfloat16", "float16")

# What only the .cu files hold: (file, name) -> value. The models below
# are built from these; the CPU test parses each out of its source.
CU_CONSTANTS: Dict[Tuple[str, str], int] = {
    ("common.cuh", "kThreads"): 256,
    ("common.cuh", "kSlab"): 1024,
    ("hopper.cuh", "kWarpgroup"): 128,
    ("hopper.cuh", "kMaxStages"): 8,
    ("fused_mlp_hopper.cu", "BM"): 64,
    ("fused_mlp_hopper.cu", "SMEM_MAX"): 232448,
    ("fused_mlp.cu", "BFS"): 128,
    ("fused_mlp.cu", "BK"): 64,
    ("fused_mlp_recompute.cuh", "BM"): 64,
    ("fused_mlp_recompute.cuh", "BF"): 128,
    ("fused_mlp_recompute.cuh", "STAGES1"): 5,
    ("fused_mlp_dgrad_hopper.cu", "TM"): 64,
    ("fused_mlp_dgrad_hopper.cu", "TN"): 256,
    ("fused_mlp_dgrad_hopper.cu", "STAGES2"): 3,
    ("fused_mlp_dgrad.cu", "BM"): 32,
    ("fused_mlp_dgrad.cu", "BFS"): 128,
    ("fused_mlp_dgrad.cu", "BK"): 64,
    ("fused_mlp_dgrad.cu", "BD"): 128,
    ("fused_mlp_wgrad_hopper.cu", "TM"): 64,
    ("fused_mlp_wgrad_hopper.cu", "STAGES2"): 3,
    ("fused_mlp_wgrad.cu", "BM"): 64,
    ("fused_mlp_wgrad.cu", "BFS"): 64,
    ("fused_mlp_wgrad.cu", "BK"): 64,
    ("fused_mlp_wgrad.cu", "BO"): 64,
    ("grouped_gemm.cu", "BK"): 64,
    ("grouped_gemm_hopper.cu", "FRAG"): 64,
    ("grouped_gemm_hopper.cu", "MAX_FRAGS"): 4,
    ("flash_attention.cu", "BQ"): 64,
    ("flash_attention.cu", "BKV"): 64,
    ("flash_attention_hopper.cu", "BQ"): 128,
    ("flash_attention_hopper.cu", "BKV"): 64,
    ("flash_attention_hopper.cu", "STAGES"): 4,
    ("ssd.cu", "kQ"): 64,
    ("ssd.cu", "kDS"): 128,
    ("ssd.cu", "kHD"): 64,
    ("ssd_hopper.cu", "kQ"): 64,
    ("ssd_hopper.cu", "kBlock"): 128,
    ("ssd_hopper.cu", "kP"): 32,
    ("ssd_hopper.cu", "kTerms"): 2,
    ("rmsnorm.cu", "kMaxThreads"): 512,
}


def _c(source: str, name: str) -> int:
    return CU_CONSTANTS[(source, name)]


def cu_constant(text: str, name: str) -> int:
    """The value of ``constexpr int name = ...;`` in a source's text: an
    integer expression (+ - * / and parentheses) over the constants
    defined before it."""
    env: Dict[str, int] = {}
    for m in re.finditer(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);", text):
        key, expr = m.group(1), m.group(2)
        if not re.fullmatch(r"[\w\s+\-*/()]+", expr):
            continue
        try:
            env[key] = int(eval(expr.replace("/", "//"),
                                {"__builtins__": {}}, dict(env)))
        except (NameError, SyntaxError, TypeError, ZeroDivisionError):
            continue               # an expression over non-constants
        if key == name:
            return env[key]
    raise KeyError(f"no constexpr int {name} in the source")


def csrc_dir() -> str:
    """``kernels/csrc`` of this checkout."""
    return os.path.join(os.path.dirname(os.path.abspath(FM.__file__)),
                        "csrc")


def read_source(name: str) -> str:
    with open(os.path.join(csrc_dir(), name), encoding="utf-8") as f:
        return f.read()


def check_cu_constants(read: Callable[[str], str] = read_source
                       ) -> List[Diagnostic]:
    """Every value of ``CU_CONSTANTS`` against its source (``read(file)``
    gives a file's text): a kernel edited without its model fails."""
    diags: List[Diagnostic] = []
    texts: Dict[str, str] = {}
    for (src, name), want in CU_CONSTANTS.items():
        if src not in texts:
            texts[src] = read(src)
        try:
            got = cu_constant(texts[src], name)
        except KeyError:
            got = None
        if got != want:
            diags.append(_d(
                "cu-constant", f"csrc/{src}:{name}",
                f"the source gives {name} = {got}, the kernel models {want}",
                hint="update CU_CONSTANTS (and the model using it) with "
                     "the kernel"))
    return diags


def _a128(b: int) -> int:
    return -(-b // 128) * 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _d(rule: str, loc: str, msg: str, hint: str = "") -> Diagnostic:
    return Diagnostic(_PASS, rule, "error", loc, msg, hint)


# ---------------------------------------------------------------------------
# the model of one launch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Output:
    """An output array, cut into tiles of ``tile``; ``tiles(ids)`` maps
    the grid's block coordinates (one int64 array per grid dimension, every
    block once) to the tile indices the blocks write, an (n, ndim) array
    (a block may write several, a persistent block many)."""
    name: str
    shape: Tuple[int, ...]
    tile: Tuple[int, ...]
    tiles: Callable[..., np.ndarray]


@dataclasses.dataclass(frozen=True)
class TmaOperand:
    """An operand a TMA copy (or a 16-byte vector load) reads: the byte
    offset of its base and its byte strides past the first dimension."""
    name: str
    base: int
    strides: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class KernelModel:
    name: str                  # "<kernel>[<path>]/<launch>"
    source: str                # the csrc file of the launch
    grid: Tuple[int, ...]
    threads: int
    dyn_smem: int
    outputs: Tuple[Output, ...]
    in_dtypes: Tuple[str, ...]
    accum_dtype: str = "float32"
    static_smem: int = 0
    wgmma: bool = False
    tma: Tuple[TmaOperand, ...] = ()


def check_smem(m: KernelModel,
               limit: int = SMEM_PER_BLOCK) -> List[Diagnostic]:
    used = m.dyn_smem + m.static_smem
    if used > limit:
        return [_d("smem-overflow", f"kernel:{m.name}",
                   f"{used} bytes of shared memory a block ({m.dyn_smem} "
                   f"dynamic + {m.static_smem} static) exceed the {limit} a "
                   f"block may use", hint="fewer ring stages or a smaller "
                   "tile (the wrapper's plan function)")]
    return []


def check_threads(m: KernelModel) -> List[Diagnostic]:
    if not 0 < m.threads <= MAX_THREADS:
        return [_d("threads-per-block", f"kernel:{m.name}",
                   f"{m.threads} threads a block (1..{MAX_THREADS})")]
    if m.wgmma and m.threads % WARPGROUP:
        return [_d("threads-per-block", f"kernel:{m.name}",
                   f"a wgmma kernel of {m.threads} threads: not whole "
                   f"warpgroups of {WARPGROUP}",
                   hint="producer and consumers are whole warpgroups")]
    return []


def _grid_ids(grid: Sequence[int]) -> Tuple[np.ndarray, ...]:
    axes = [np.arange(n, dtype=np.int64) for n in grid]
    return tuple(a.reshape(-1) for a in np.meshgrid(*axes, indexing="ij"))


def check_tiles(m: KernelModel) -> List[Diagnostic]:
    """Every block's tiles start inside their array; every tile of every
    output is written exactly once over the grid."""
    if int(np.prod(m.grid)) > MAX_GRID or min(m.grid) < 1:
        return [_d("grid-size", f"kernel:{m.name}",
                   f"grid {m.grid} is empty or over {MAX_GRID} blocks")]
    ids = _grid_ids(m.grid)
    diags: List[Diagnostic] = []
    for o in m.outputs:
        loc = f"kernel:{m.name}:{o.name}"
        t = np.asarray(o.tiles(*ids), dtype=np.int64).reshape(-1, len(o.shape))
        counts = np.array([_cdiv(n, s) for n, s in zip(o.shape, o.tile)])
        bad = np.any((t < 0) | (t >= counts), axis=1)
        if bad.any():
            first = tuple(int(v) for v in t[bad][0])
            diags.append(_d(
                "index-out-of-bounds", loc,
                f"{int(bad.sum())} tile write(s) start outside "
                f"{o.shape} (first: tile {first} of {o.tile})",
                hint="mirror of the kernel's block-index arithmetic"))
        flat = np.ravel_multi_index(t[~bad].T, counts)
        seen = np.bincount(flat, minlength=int(np.prod(counts)))
        if (seen == 0).any():
            first = np.unravel_index(int(np.argmax(seen == 0)), counts)
            diags.append(_d(
                "uncovered-output-tile", loc,
                f"{int((seen == 0).sum())} output tile(s) never written "
                f"(first: {tuple(int(v) for v in first)}): they return "
                f"what the allocation held",
                hint="the grid must enumerate every output tile"))
        if (seen > 1).any():
            first = np.unravel_index(int(np.argmax(seen > 1)), counts)
            diags.append(_d(
                "uncovered-output-tile", loc,
                f"{int((seen > 1).sum())} output tile(s) written more than "
                f"once (first: {tuple(int(v) for v in first)})",
                hint="two blocks race on one tile"))
    return diags


def check_accum(m: KernelModel) -> List[Diagnostic]:
    reduced = [d for d in m.in_dtypes if d in _REDUCED]
    if reduced and m.accum_dtype != "float32":
        return [_d("accum-dtype", f"kernel:{m.name}",
                   f"{reduced[0]} inputs accumulate in {m.accum_dtype}",
                   hint="fp32 accumulators (wgmma's fp32 d, fp32 sums)")]
    return []


def check_tma(m: KernelModel) -> List[Diagnostic]:
    diags = []
    for op in m.tma:
        odd = [s for s in op.strides if s % 16]
        if op.base % 16 or odd:
            diags.append(_d(
                "tma-alignment", f"kernel:{m.name}:{op.name}",
                f"base offset {op.base} B, strides {op.strides} B: TMA "
                f"needs 16-byte aligned bases and strides",
                hint="hopper_path must send such operands to the general "
                     "kernel"))
    return diags


def check_model(m: KernelModel) -> List[Diagnostic]:
    return (check_smem(m) + check_threads(m) + check_tiles(m)
            + check_accum(m) + check_tma(m))


# ---------------------------------------------------------------------------
# tile maps: mirrors of the kernels' block-index arithmetic
# ---------------------------------------------------------------------------


def _tile_of(ids, E: int, MT: int, NT: int, order: int):
    """common.cuh ``tile_of``: (e, m, n) of linear block ids."""
    if order == 0:
        return ids // (NT * MT), (ids // NT) % MT, ids % NT
    return (ids // MT) % E, ids % MT, ids // (MT * E)


def _stack(*cols) -> np.ndarray:
    n = max(np.size(c) for c in cols)
    return np.stack([np.broadcast_to(np.asarray(c, dtype=np.int64), (n,))
                     for c in cols], axis=1)


def _persistent(tiles: int):
    """The tiles a persistent grid's blocks walk (``t = blockIdx.x; t <
    tiles; t += gridDim.x``), as one array over every block."""
    def walk(ids):
        return np.concatenate([np.arange(b, tiles, len(ids), dtype=np.int64)
                               for b in range(len(ids))])
    return walk


def _sum_out(name: str, rows: int, N: int, order: int) -> Output:
    """common.cuh ``sum_partials_kernel``: one block per (row, slab of
    kSlab columns)."""
    slab = _c("common.cuh", "kSlab")
    slabs = _cdiv(N, slab)

    def tiles(ids):
        if order == 0:
            return _stack(ids // slabs, ids % slabs)
        return _stack(ids % rows, ids // rows)
    return Output(name, (rows, N), (1, slab), tiles)


def _sum_launch(kernel: str, src: str, rows: int, N: int, order: int,
                dtype: str) -> KernelModel:
    slabs = _cdiv(N, _c("common.cuh", "kSlab"))
    return KernelModel(f"{kernel}[general]/sum_partials", src,
                       (rows * slabs,), _c("common.cuh", "kThreads"), 0,
                       (_sum_out("out", rows, N, order),), ("float32",))


# ---------------------------------------------------------------------------
# probe tensors: the operands a launch sees, without memory
# ---------------------------------------------------------------------------


def _meta(shape, dtype="bfloat16", strides=None, offset: int = 0):
    dt = getattr(torch, dtype)
    if strides is None:
        strides, acc = [], 1
        for n in reversed(shape):
            strides.insert(0, acc)
            acc *= n
    t = torch.empty(offset + sum((n - 1) * s for n, s in zip(shape, strides))
                    + 1, dtype=dt, device="meta")
    return t.as_strided(shape, strides, offset)


def tma_operand(name: str, t: torch.Tensor) -> TmaOperand:
    """A probe tensor's TMA view: its base offset and outer byte
    strides."""
    isz = t.element_size()
    return TmaOperand(name, t.data_ptr(),
                      tuple(s * isz for s in t.stride()[:-1]))


# ---------------------------------------------------------------------------
# the eight kernels' launches
# ---------------------------------------------------------------------------


def fused_mlp_models(E: int, R: int, d: int, f: int, N: int,
                     order: str = "expert_major", dtype: str = "bfloat16",
                     sm_count: int = SM_COUNT) -> List[KernelModel]:
    """The forward's launches at (E, R, d, f, N) on the path
    ``fused_mlp.hopper_path`` picks for contiguous operands of ``dtype``."""
    x, wg, wu = _meta((E, R, d), dtype), _meta((E, d, f), dtype), \
        _meta((E, d, f), dtype)
    wd = _meta((E, f, N), dtype)
    o = GG.ORDERS[order]
    if FM.hopper_path(x, wg, wu, wd):
        plan = FM.fused_mlp_plan(E, R, d, f, N, sm_count)
        S, MT = plan["splits"], _cdiv(R, FM.HOPPER_BM)

        def part_tiles(ids):
            e, m, s = _tile_of(ids, E, MT, S, o)
            return _stack(s, e, m, 0)
        main = KernelModel(
            f"fused_mlp[wgmma]/{order}", "fused_mlp_hopper.cu",
            (plan["blocks"],), 3 * WARPGROUP, FM.hopper_smem_bytes(plan["fs"]),
            (Output("part", (S, E, R, N), (1, 1, FM.HOPPER_BM, N),
                    part_tiles),), (dtype,) * 4, wgmma=True,
            tma=tuple(tma_operand(n, t) for n, t in
                      (("x", x), ("w_gate", wg), ("w_up", wu),
                       ("w_down", wd))))
        rows, C8 = E * R, N // 8
        n_thr = rows * C8 if o == 0 else rows * 128 * _cdiv(C8, 128)

        def sum_tiles(ids):
            t = (ids[:, None] * 256 + np.arange(256)).reshape(-1)
            if o == 0:
                row, c = t // C8, t % C8
            else:
                per = rows * 128
                row, c = (t % per) // 128, (t // per) * 128 + t % 128
                keep = c < C8
                row, c = row[keep], c[keep]
            keep = row < rows
            return _stack(row[keep], c[keep])
        red = KernelModel(
            "fused_mlp[wgmma]/sum_splits", "fused_mlp_hopper.cu",
            (_cdiv(n_thr, 256),), 256, 0,
            (Output("out", (rows, N), (1, 8), sum_tiles),), ("float32",))
        return [main, red]
    sz = DTYPE_BYTES[dtype]
    BM = 16 if R <= 16 else 32
    BN = 256 if dtype == "bfloat16" else 128
    BFS, BK = _c("fused_mlp.cu", "BFS"), _c("fused_mlp.cu", "BK")
    Gb = _a128(sz * BM * (BK + 8))
    Ub = Gb + _a128(sz * BK * (BFS + 8))
    Fb = Ub + _a128(sz * BK * (BFS + 8))
    Hb = Fb + _a128(4 * BM * (BFS + 4))
    Db = Hb + _a128(sz * BM * (BFS + 8))
    smem = Db + _a128(sz * BK * (BN + 8))
    MT, NF = _cdiv(R, BM), _cdiv(f, BFS)

    def part_tiles(ids):
        return _stack((ids // MT) % NF, ids // (MT * NF), ids % MT, 0)
    main = KernelModel(
        f"fused_mlp[general]/{order}", "fused_mlp.cu", (E * NF * MT,),
        _c("common.cuh", "kThreads"), smem,
        (Output("part", (NF, E, R, N), (1, 1, BM, N), part_tiles),),
        (dtype,) * 4)
    return [main, _sum_launch("fused_mlp", "fused_mlp.cu", E * R, N, o,
                              dtype)]


def _recompute_model(kernel: str, E: int, R: int, f: int, dtype: str,
                     planes: Sequence[str], tma: Tuple[TmaOperand, ...]
                     ) -> KernelModel:
    """csrc/fused_mlp_recompute.cuh: one block per (expert, 64 rows, 128
    hidden columns), f-tile fastest; writes the bf16 planes it is given."""
    BM = _c("fused_mlp_recompute.cuh", "BM")
    BF = _c("fused_mlp_recompute.cuh", "BF")
    MT, FT = _cdiv(R, BM), _cdiv(f, BF)
    smem = 1024 + _c("fused_mlp_recompute.cuh", "STAGES1") * 5 * \
        FM.HOPPER_PANEL + FM.HOPPER_BAR_BYTES

    def tiles(ids):
        return _stack(ids // (FT * MT), (ids // FT) % MT, ids % FT)
    return KernelModel(
        f"{kernel}[wgmma]/recompute", "fused_mlp_recompute.cuh",
        (E * MT * FT,), 3 * WARPGROUP, smem,
        tuple(Output(p, (E, R, f), (1, BM, BF), tiles) for p in planes),
        (dtype,) * 5, wgmma=True, tma=tma)


def _product_smem() -> int:
    """The dgrad and wgrad product kernels' SMEM2: three stages of six
    panels and two 64-row output stages of 256 bf16 (+16 bytes)."""
    out_stage = 64 * (256 * 2 + 16)
    return (1024 + 3 * 6 * FM.HOPPER_PANEL + 2 * out_stage
            + FM.HOPPER_BAR_BYTES)


def _product_model(name: str, src: str, E: int, M: int, Nc: int, tn: int,
                   outs: Sequence[str], sms: int,
                   tma: Tuple[TmaOperand, ...]) -> KernelModel:
    """A persistent product over (E, M rows in 128s, Nc in tn columns),
    N tile fastest."""
    TM = 2 * 64
    MT, NT = _cdiv(M, TM), _cdiv(Nc, tn)
    tiles = E * MT * NT
    walk = _persistent(tiles)

    def out_tiles(ids):
        t = walk(ids)
        return _stack(t // (NT * MT), (t // NT) % MT, t % NT)
    return KernelModel(
        name, src, (min(tiles, sms),), 3 * WARPGROUP, _product_smem(),
        tuple(Output(o, (E, M, Nc), (1, TM, tn), out_tiles) for o in outs),
        ("bfloat16",) * 2, wgmma=True, tma=tma)


def fused_mlp_bwd_models(kernel: str, E: int, R: int, d: int, f: int,
                         N: int, dtype: str = "bfloat16",
                         sm_count: int = SM_COUNT) -> List[KernelModel]:
    """``fused_mlp_dgrad`` or ``fused_mlp_wgrad`` (``kernel``) at (E, R, d,
    f, N), GLU, on the path ``hopper_path`` picks."""
    x, wg, wu = _meta((E, R, d), dtype), _meta((E, d, f), dtype), \
        _meta((E, d, f), dtype)
    wd, dy = _meta((E, f, N), dtype), _meta((E, R, N), dtype)
    ops = tuple(tma_operand(n, t) for n, t in (
        ("x", x), ("w_gate", wg), ("w_up", wu), ("w_down", wd), ("dy", dy)))
    if FM.hopper_path(x, wg, wu, wd, dy):
        plane = tma_operand("scratch", _meta((E, R, f), dtype))
        if kernel == "fused_mlp_dgrad":
            src = "fused_mlp_dgrad_hopper.cu"
            TN = _c(src, "TN")
            return [_recompute_model(kernel, E, R, f, dtype, ("dup", "dgate"),
                                     ops),
                    _product_model(f"{kernel}[wgmma]/product", src, E, R, d,
                                   TN, ("dx",), sm_count, (plane, ops[1],
                                                           ops[2]))]
        src = "fused_mlp_wgrad_hopper.cu"
        return [_recompute_model(kernel, E, R, f, dtype, ("h", "dup",
                                                          "dgate"), ops),
                _product_model(f"{kernel}[wgmma]/dw_down", src, E, f, N, 256,
                               ("dw_down",), sm_count, (plane, ops[4])),
                _product_model(f"{kernel}[wgmma]/dw_up_gate", src, E, d, f,
                               128, ("dw_up", "dw_gate"), sm_count,
                               (ops[0], plane))]
    sz = DTYPE_BYTES[dtype]
    kt = _c("common.cuh", "kThreads")
    if kernel == "fused_mlp_dgrad":
        src = "fused_mlp_dgrad.cu"
        BM, BFS, BK, BD = (_c(src, k) for k in ("BM", "BFS", "BK", "BD"))
        LDA, LDW, LDT, LDH, LDF = BK + 8, BFS + 8, BK + 8, BFS + 8, BFS + 4
        p12 = (_a128(sz * BM * LDA) + 2 * _a128(sz * BK * LDW)
               + _a128(sz * BM * LDA) + _a128(sz * BFS * LDT))
        p3 = 2 * _a128(sz * BD * LDT) + _a128(4 * BM * (BD + 4))
        smem = (max(p12, p3) + _a128(4 * BM * LDF)
                + 2 * _a128(sz * BM * LDH))
        MT, NF = _cdiv(R, BM), _cdiv(f, BFS)

        def tiles(ids):
            return _stack((ids // MT) % NF, ids // (MT * NF), ids % MT, 0)
        return [KernelModel(
            f"{kernel}[general]/partial", src, (E * NF * MT,), kt, smem,
            (Output("part", (NF, E, R, d), (1, 1, BM, d), tiles),),
            (dtype,) * 5),
            _sum_launch(kernel, src, E * R, d, 0, dtype)]
    src = "fused_mlp_wgrad.cu"
    BM, BFS, BK, BO = (_c(src, k) for k in ("BM", "BFS", "BK", "BO"))
    L = BK + 8
    smem = (2 * _a128(sz * BM * L) + 2 * _a128(sz * BK * (BFS + 8))
            + _a128(sz * BFS * L) + _a128(4 * BM * (BFS + 4))
            + 3 * _a128(sz * BM * (BFS + 8)))
    NF = _cdiv(f, BFS)

    def dwd_tiles(ids):
        return _stack(ids // NF, ids % NF, 0)

    def dwu_tiles(ids):
        return _stack(ids // NF, 0, ids % NF)
    return [KernelModel(
        f"{kernel}[general]/fused", src, (E * NF,), kt, smem,
        (Output("dw_down", (E, f, N), (1, BFS, N), dwd_tiles),
         Output("dw_up", (E, d, f), (1, d, BFS), dwu_tiles),
         Output("dw_gate", (E, d, f), (1, d, BFS), dwu_tiles)),
        (dtype,) * 5)]


def grouped_gemm_models(E: int, M: int, K: int, N: int,
                        order: str = "expert_major", dtype: str = "bfloat16",
                        sm_count: int = SM_COUNT) -> List[KernelModel]:
    lhs, rhs = _meta((E, M, K), dtype), _meta((E, K, N), dtype)
    o = GG.ORDERS[order]
    if GG.hopper_path(lhs, rhs):
        p = GG.hopper_plan(E, M, N, sm_count)
        bm = _c("grouped_gemm_hopper.cu", "FRAG") * \
            _c("grouped_gemm_hopper.cu", "MAX_FRAGS")
        walk = _persistent(p["tiles"])

        def tiles(ids):
            e, m, n = _tile_of(walk(ids), E, p["m_tiles"], p["n_tiles"], o)
            return _stack(e, m, n)
        return [KernelModel(
            f"grouped_gemm[wgmma]/{order}", "grouped_gemm_hopper.cu",
            (p["blocks"],), 3 * WARPGROUP, p["smem_bytes"],
            (Output("out", (E, M, N), (1, bm, p["bn"]), tiles),),
            (dtype,) * 2, wgmma=True,
            tma=(tma_operand("lhs", lhs), tma_operand("rhs", rhs)))]
    sz = DTYPE_BYTES[dtype]
    BM, BN = (64, 128) if dtype == "bfloat16" else (64, 64)
    BK = _c("grouped_gemm.cu", "BK")
    loop = _a128(sz * BM * (BK + 8)) + _a128(sz * BK * (BN + 8))
    smem = max(loop, _a128(4 * BM * (BN + 4)))
    MT, NT = _cdiv(M, BM), _cdiv(N, BN)

    def tiles(ids):
        return _stack(*_tile_of(ids, E, MT, NT, o))
    return [KernelModel(
        f"grouped_gemm[general]/{order}", "grouped_gemm.cu",
        (E * MT * NT,), _c("common.cuh", "kThreads"), smem,
        (Output("out", (E, M, N), (1, BM, BN), tiles),), (dtype,) * 2)]


def topk_combine_models(T: int, k: int, d: int, dtype: str = "bfloat16",
                        sm_count: int = SM_COUNT) -> List[KernelModel]:
    isz = DTYPE_BYTES[dtype]
    vec = (d * isz) % 16 == 0
    p = TK.launch_plan(T, k, d, isz, vec, sm_count)
    lanes = 16 // isz if vec else 1
    span = p["threads"] * p["per"] * lanes

    def tiles(t, c):
        return _stack(t, c)
    return [KernelModel(
        f"topk_combine[{p['instance']}]", "topk_combine.cu",
        (T, p["col_blocks"]), p["threads"], 0,
        (Output("out", (T, d), (1, span), tiles),), (dtype, "float32"))]


def rmsnorm_models(T: int, d: int, dtype: str = "bfloat16",
                   sm_count: int = SM_COUNT) -> List[KernelModel]:
    isz = DTYPE_BYTES[dtype]
    p = RN.launch_plan(T, d, isz, d % (16 // isz) == 0, sm_count)
    groups, blocks = p["rows_per_block"], p["blocks"]

    def tiles(ids):
        # block b's group g walks rows b * groups + g, + blocks * groups
        rows = np.concatenate([np.arange(b * groups + g, T, blocks * groups,
                                         dtype=np.int64)
                               for b in ids.tolist() for g in range(groups)])
        return _stack(rows, 0)
    static = 2 * (_c("rmsnorm.cu", "kMaxThreads") // 32) * 4
    return [KernelModel(
        "rmsnorm", "rmsnorm.cu", (blocks,), p["threads"], p["smem_bytes"],
        (Output("out", (T, d), (1, d), tiles),), (dtype,),
        static_smem=static)]


def _ssd_hopper_smem(ds: int) -> int:
    """csrc/ssd_hopper.cu ``layout(ds).bytes``."""
    kQ, kP = _c("ssd_hopper.cu", "kQ"), _c("ssd_hopper.cu", "kP")
    lds, ldx = ds + 8, kP + 8
    stage = _a128(kQ * lds * 2) + _a128(kQ * ldx * 2) + _a128(kQ * 4)
    h = _a128(kQ * lds * 2) + 2 * stage
    return (h + _c("ssd_hopper.cu", "kTerms") * _a128(ds * ldx * 2)
            + 3 * _a128(kQ * 4))


def ssd_models(B: int, S: int, nh: int, hd: int, ds: int,
               dtype: str = "bfloat16", final: bool = False
               ) -> List[KernelModel]:
    x = _meta((B, S, nh, hd), dtype)
    Bm = _meta((B, S, ds), dtype)
    f32 = "float32"
    dt, A, D = _meta((B, S, nh), f32), _meta((nh,), f32), _meta((nh,), f32)
    ins = (dtype, f32, f32, dtype, dtype, f32)
    if SSD.hopper_path(x, dt, A, Bm, Bm, D):
        kP = _c("ssd_hopper.cu", "kP")
        slabs = hd // kP

        def y_tiles(ids):
            return _stack(ids // (slabs * nh), 0, (ids // slabs) % nh,
                          ids % slabs)

        def h_tiles(ids):
            return _stack(ids // (slabs * nh), (ids // slabs) % nh, 0,
                          ids % slabs)
        outs = [Output("y", (B, S, nh, hd), (1, S, 1, kP), y_tiles)]
        if final:
            outs.append(Output("h_final", (B, nh, ds, hd), (1, 1, ds, kP),
                               h_tiles))
        return [KernelModel(
            "ssd_forward[mma]", "ssd_hopper.cu", (B * nh * slabs,),
            _c("ssd_hopper.cu", "kBlock"), _ssd_hopper_smem(ds),
            tuple(outs), ins, tma=tuple(tma_operand(n, t) for n, t in
                                        (("x", x), ("B", Bm), ("C", Bm))))]
    kQ, kDS, kHD = (_c("ssd.cu", k) for k in ("kQ", "kDS", "kHD"))
    smem = (_a128(4 * kDS * kHD) + 2 * _a128(4 * kQ * kHD)
            + 2 * _a128(4 * kQ * (kDS + 1)) + _a128(4 * kQ * (kQ + 1))
            + 2 * _a128(4 * kQ))

    def tiles(ids):
        return _stack(ids // nh, 0, ids % nh, 0)
    return [KernelModel(
        "ssd_forward[general]", "ssd.cu", (B * nh,),
        _c("common.cuh", "kThreads"), smem,
        (Output("y", (B, S, nh, hd), (1, S, 1, hd), tiles),), ins)]


def flash_models(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, hd: int,
                 dtype: str = "bfloat16") -> List[KernelModel]:
    # the kernels read (B, S, H, hd) tensors through transposed views
    q = _meta((B, Sq, Hq, hd), dtype).transpose(1, 2)
    k = _meta((B, Sk, Hkv, hd), dtype).transpose(1, 2)
    out_shape = (B, Sq, Hq, hd)
    if FA.hopper_path(q, k, k):
        src = "flash_attention_hopper.cu"
        BQ, BKV, ST = (_c(src, n) for n in ("BQ", "BKV", "STAGES"))
        P = hd // 64
        smem = (1024 + P * BQ * 128 + ST * 2 * P * BKV * 128
                + FM.HOPPER_BAR_BYTES + 16)
        nq = _cdiv(Sq, BQ)

        def tiles(bx, by):
            return _stack(bx // Hq, nq - 1 - by, bx % Hq, 0)
        return [KernelModel(
            "flash_attention[wgmma]", src, (B * Hq, nq), 3 * WARPGROUP,
            smem, (Output("out", out_shape, (1, BQ, 1, hd), tiles),),
            (dtype,) * 3, wgmma=True,
            tma=tuple(tma_operand(n, t) for n, t in
                      (("q", q), ("k", k), ("v", k))))]
    src = "flash_attention.cu"
    BQ, BKV = _c(src, "BQ"), _c(src, "BKV")
    sz, HD = DTYPE_BYTES[dtype], 64 if hd <= 64 else 128
    smem = (_a128(sz * BQ * (HD + 8)) + 2 * _a128(sz * BKV * (HD + 8))
            + _a128(4 * BQ * (BKV + 4)) + _a128(4 * 3 * BQ))
    nq = _cdiv(Sq, BQ)

    def tiles(bx, by):
        return _stack(by // Hq, nq - 1 - bx, by % Hq, 0)
    return [KernelModel(
        "flash_attention[general]", src, (nq, B * Hq),
        _c("common.cuh", "kThreads"), smem,
        (Output("out", out_shape, (1, BQ, 1, hd), tiles),), (dtype,) * 3)]


def builtin_kernel_models() -> List[KernelModel]:
    """Every kernel's launches on both paths at PERF.md §6's shapes: the
    bf16 rows on the wgmma (or tensor-core) path, the same shapes in fp32
    on the general path."""
    out: List[KernelModel] = []
    for dt in ("bfloat16", "float32"):
        out += fused_mlp_models(64, 160, 2048, 1408, 2048, dtype=dt)
        out += fused_mlp_models(64, 160, 2048, 1408, 1024, "n_major",
                                dtype=dt)             # a comet column block
        out += fused_mlp_models(16, 320, 4096, 14336, 4096, dtype=dt)
        for kern in ("fused_mlp_dgrad", "fused_mlp_wgrad"):
            out += fused_mlp_bwd_models(kern, 64, 320, 2048, 1408, 2048,
                                        dtype=dt)
        out += grouped_gemm_models(64, 160, 2048, 1408, dtype=dt)
        out += grouped_gemm_models(64, 160, 1408, 2048, "n_major", dtype=dt)
        out += grouped_gemm_models(64, 37, 1408, 2048, "n_major", dtype=dt)
        out += topk_combine_models(2048, 4, 2048, dtype=dt)
        out += topk_combine_models(8, 4, 2048, dtype=dt)
        out += flash_models(4, 16, 16, 1024, 1024, 128, dtype=dt)
        out += flash_models(8, 12, 12, 1500, 1500, 64, dtype=dt)
        out += flash_models(8, 12, 12, 375, 1500, 64, dtype=dt)
        out += ssd_models(4, 2048, 48, 64, 128, dtype=dt)
        out += ssd_models(8, 256, 128, 64, 16, dtype=dt, final=True)
        out += rmsnorm_models(2048, 1536, dtype=dt)
        out += rmsnorm_models(8, 1536, dtype=dt)
        out += rmsnorm_models(2048, 8192, dtype=dt)
    return out


def attribute_models() -> List[KernelModel]:
    """``builtin_kernel_models`` and, for the instances no main-path shape
    launches, a model at a shape that launches each: the general kernels
    in bf16 (a width that is not a multiple of 8, a head_dim of 96 or 48
    keeps them off the wgmma paths) and ``topk_combine``'s other k
    templates and its scalar form."""
    out = builtin_kernel_models()
    bf = "bfloat16"
    out += fused_mlp_models(4, 24, 100, 136, 100, dtype=bf)
    out += fused_mlp_bwd_models("fused_mlp_dgrad", 4, 24, 100, 136, 100,
                                dtype=bf)
    out += fused_mlp_bwd_models("fused_mlp_wgrad", 4, 24, 100, 136, 100,
                                dtype=bf)
    out += grouped_gemm_models(4, 24, 100, 136, dtype=bf)
    out += flash_models(2, 4, 4, 64, 64, 96, dtype=bf)
    out += ssd_models(1, 64, 2, 48, 16, dtype=bf)
    for dt in (bf, "float32"):
        for k in (2, 3, 8):
            out += topk_combine_models(2048, k, 2048, dtype=dt)
        out += topk_combine_models(64, 4, 2047, dtype=dt)     # scalar
    return out


def check_attributes(attrs: Sequence[Dict], models: Optional[
        Sequence[KernelModel]] = None, optin: int = SMEM_PER_BLOCK,
        regs_per_sm: int = 65536) -> List[Diagnostic]:
    """Every compiled instance (``kernels/build.kernel_attributes``: its
    label names the models it runs and their input dtype) against each of
    those models (``attribute_models``): the model's threads at most the
    instance's ``maxThreadsPerBlock``, its ``static_smem`` the compiled
    ``sharedSizeBytes``, its dynamic plus the static shared memory within
    the opt-in limit, registers x threads within one SM's file. An
    instance with no model, and a model family no instance runs, are
    errors too: the check covers every launch."""
    models = attribute_models() if models is None else list(models)
    diags: List[Diagnostic] = []
    covered = set()
    for a in attrs:
        names, dtype, _ = a["label"].split("|")
        loc = f"kernel:{a['source']}:{a['label']}"
        mine = [m for m in models if m.name in names.split(",")
                and m.in_dtypes[0] == dtype]
        if not mine:
            diags.append(_d("attr-no-model", loc,
                            "no launch model runs this instance"))
        for m in mine:
            covered.add((m.name, dtype))
            if m.threads > a["max_threads"]:
                diags.append(_d("attr-threads", loc,
                                f"model {m.name} launches {m.threads} "
                                f"threads, the instance takes at most "
                                f"{a['max_threads']}"))
            if m.static_smem != a["static_smem"]:
                diags.append(_d("attr-static-smem", loc,
                                f"model {m.name} has {m.static_smem} bytes "
                                f"of static shared memory, the instance "
                                f"{a['static_smem']}"))
            if m.dyn_smem + a["static_smem"] > optin:
                diags.append(_d("attr-smem", loc,
                                f"model {m.name}: {m.dyn_smem} dynamic + "
                                f"{a['static_smem']} static bytes exceed "
                                f"the {optin} a block may opt into"))
            if a["regs"] * m.threads > regs_per_sm:
                diags.append(_d("attr-registers", loc,
                                f"model {m.name}: {a['regs']} registers x "
                                f"{m.threads} threads exceed the "
                                f"{regs_per_sm} of an SM"))
    for key in sorted({(m.name, m.in_dtypes[0]) for m in models} - covered):
        diags.append(_d("attr-no-instance", f"kernel:{key[0]}",
                        f"no compiled instance runs model {key[0]} on "
                        f"{key[1]}"))
    return diags


def check_builtin_kernels() -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for m in builtin_kernel_models():
        diags.extend(check_model(m))
    return diags


# ---------------------------------------------------------------------------
# the hopper_path gates against TMA's alignment
# ---------------------------------------------------------------------------

# probe layouts: (leading strides in elements of a row, base offset in
# elements); the gates must send every misaligned one to the general path
PROBE_STRIDES = (8, 4, 2, 1)
PROBE_OFFSETS = (0, 8, 4, 1)


def _probes(dims: Tuple[int, ...], dtype: str = "bfloat16"):
    """Operands of ``dims`` whose row stride is the last dim padded by
    each of PROBE_STRIDES' steps, at each of PROBE_OFFSETS."""
    for pad in PROBE_STRIDES:
        for off in PROBE_OFFSETS:
            ld = dims[-1] + pad
            strides = []
            acc = ld
            for n in reversed(dims[:-1]):
                strides.insert(0, acc)
                acc *= n
            yield _meta(dims, dtype, tuple(strides) + (1,), off)


def check_hopper_gates(gates: Optional[Dict[str, Callable]] = None
                       ) -> List[Diagnostic]:
    """For each kernel with a TMA path, every probe operand its gate
    (``hopper_path``, or the replacement in ``gates``) accepts must meet
    TMA's alignment: an accepted misaligned operand is a launch the card
    refuses, or a wrong sum."""
    gates = dict(gates or {})
    fm = gates.get("fused_mlp", FM.hopper_path)
    gg = gates.get("grouped_gemm", GG.hopper_path)
    fa = gates.get("flash_attention", FA.hopper_path)
    ss = gates.get("ssd_forward", SSD.hopper_path)
    E, R, d, f = 2, 16, 64, 128
    calls = []
    for x in _probes((E, R, d)):
        w = _meta((E, d, f))
        calls.append(("fused_mlp", fm(x, w, w, _meta((E, f, d))),
                      {"x": x}))
        calls.append(("grouped_gemm", gg(x, _meta((E, d, f))), {"lhs": x}))
    for q in _probes((2, 4, 16, 64)):
        calls.append(("flash_attention", fa(q, q, q), {"q": q}))
    f32 = "float32"
    for x in _probes((1, 64, 2, 32)):
        B = _meta((1, 64, 16))
        calls.append(("ssd_forward", ss(x, _meta((1, 64, 2), f32),
                                        _meta((2,), f32), B, B,
                                        _meta((2,), f32)), {"x": x}))
    diags: List[Diagnostic] = []
    for kernel, accepted, ops in calls:
        if not accepted:
            continue
        m = KernelModel(f"{kernel}[gate]", "", (1,), WARPGROUP, 0, (),
                        ("bfloat16",),
                        tma=tuple(tma_operand(n, t) for n, t in ops.items()))
        for dg in check_tma(m):
            diags.append(dataclasses.replace(
                dg, message=f"hopper_path accepts {tuple(ops.values())[0]}"
                            f".stride() = {tuple(ops.values())[0].stride()}"
                            f": {dg.message}"))
    return diags


# ---------------------------------------------------------------------------
# the tuner's plan gate and knob legalization
# ---------------------------------------------------------------------------


def check_legalize_fixed_point(d_models=(1536, 2048, 4096, 7168, 18432),
                               eps=(1, 2, 4, 8, 16),
                               max_knob: int = 12) -> List[Diagnostic]:
    """legalize(legalize(plan)) == legalize(plan) over the knob grid, and
    legalized knobs divide (d_model, ep): the tuner's cached knobs and the
    transport's executed ones must agree."""
    from repro_torch.core import adaptive as A
    diags: List[Diagnostic] = []
    for d_model in d_models:
        for ep in eps:
            for n_col in range(1, max_knob + 1):
                for rg in range(1, max_knob + 1):
                    p1 = A.legalize_plan(A.Plan("comet", rg, n_col, "xla"),
                                         d_model, ep)
                    p2 = A.legalize_plan(p1, d_model, ep)
                    loc = f"plan:d{d_model}:ep{ep}"
                    if p2 != p1:
                        diags.append(_d(
                            "legalize-not-fixed-point", loc,
                            f"legalize({n_col},{rg}) -> ({p1.n_col_blocks},"
                            f"{p1.ring_group}) -> ({p2.n_col_blocks},"
                            f"{p2.ring_group})"))
                    if (p1.n_col_blocks < 1 or d_model % p1.n_col_blocks
                            or p1.ring_group < 1
                            or max(1, ep) % p1.ring_group):
                        diags.append(_d(
                            "illegal-knob", loc,
                            f"legalized knobs ({p1.n_col_blocks},"
                            f"{p1.ring_group}) do not divide (d_model="
                            f"{d_model}, ep={ep})"))
    return diags


def check_all() -> List[Diagnostic]:
    """The pass as ``python -m repro_torch.analysis.verify --kernels``
    runs it."""
    return (check_cu_constants() + check_builtin_kernels()
            + check_hopper_gates()
            + plan_gate.check_candidate_plans()
            + check_legalize_fixed_point())
