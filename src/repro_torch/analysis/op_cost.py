"""Op-level cost counter: the FLOPs, bytes and collective traffic of a
step as it runs (the port's counterpart of ``repro.analysis.hlo_cost``,
which walks XLA's post-SPMD HLO text).

``count_cost()`` is a context manager around a ``TorchDispatchMode``: every
aten op and every ``c10d`` collective that PyTorch dispatches while it is
active is priced as it runs, on CUDA, CPU or ``meta`` tensors alike. Its
rules mirror ``hlo_cost.py``'s:

* (a) a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, a convolution)
  counts 2 M N K FLOPs, filed by its operands' dtype (``mxu_by_dtype``:
  "bf16" for the tensor cores, "fp32" for fp32 products), and its
  operand and result bytes (``dot``/``convolution``);
* (b) every other op counts its operand and result bytes (an elementwise
  op also its output's elements as FLOPs, a reduction its input's); views,
  reshapes, ``empty``, ``detach`` and the like count nothing (the
  counterpart of ``_FREE_OPS``);
* (c) an in-place write into part of a larger buffer counts the update,
  not the buffer: ``copy_`` into a slice its source and the slice,
  ``index_copy_``/``index_put_``/``index_add_``/``scatter_`` the operands
  other than the buffer and the written rows (the dynamic-update-slice
  rule, e.g. a KV-cache write);
* (d) a ``c10d`` collective counts the ring traffic of its process
  group's size (``roofline.collective_traffic``) under its kind, and the
  bytes it touches;
* (e) a call of ``kernels/ops.py`` (a kernel's forward, or the fused MLP's
  dgrad and wgrad) is one region: priced by its kernel's cost function
  (``roofline.region_cost``: FLOPs and boundary bytes), and nothing that
  runs inside it is counted (the ``__fusable__`` rule). So a step counts
  the same on CPU tensors (plain versions inside), on CUDA tensors (a
  ctypes launch the dispatcher never sees) and on ``meta`` tensors.

``hlo_cost.py``'s other half has no counterpart: PyTorch runs Python loops
unrolled, so every layer's ops are dispatched and counted, and there is no
``while`` body to multiply by a trip count (nor a fusion, conditional or
async pair to resolve).

The counter also tracks the peak of the bytes held by storages created
while it is active (each op's and region's outputs, held through weak
references and dropped when freed): the counterpart of XLA's
``temp_size_in_bytes``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import roofline as RL

# products: packet -> how to read the contraction length K
_PRODUCTS = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
             "aten.addbmm", "aten.mv", "aten.addmv", "aten.dot",
             "aten.convolution", "aten._convolution"}
# ops that move no device bytes of their own (besides views); a Python
# scalar made a 0-d tensor (``scalar_tensor``, HLO's ``constant``) is one
# on the card and meta and none on the CPU, which wraps it without a call
_FREE_OPS = {"aten.empty", "aten.empty_strided", "aten.empty_like",
             "aten.scalar_tensor",
             "aten.new_empty", "aten.new_empty_strided", "aten.detach",
             "aten.alias", "aten.lift_fresh", "aten._unsafe_view",
             "aten._local_scalar_dense", "aten.sym_size", "aten.sym_stride",
             "aten.sym_numel", "aten.sym_storage_offset",
             "aten.is_same_size", "aten.set_", "aten.record_stream"}
# in-place writes of selected rows: the buffer itself is not read whole
_INDEXED_WRITES = {"aten.index_copy_", "aten.index_put_",
                   "aten._index_put_impl_", "aten.index_add_",
                   "aten.scatter_", "aten.scatter_add_",
                   "aten.scatter_reduce_"}
# c10d op -> (collective kind, index of the argument whose bytes are the
# operand)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "broadcast_": ("collective-broadcast", 0),
    "send": ("collective-permute", 0),
}


@dataclasses.dataclass
class Cost:
    """A step's count on one rank. ``mxu_flops``: the products' FLOPs
    (``hlo_cost``'s dot/convolution FLOPs), ``mxu_by_dtype`` the same by
    operand type; ``flops`` adds the elementwise and reduction work;
    ``ici_bytes`` the ring traffic, by kind in ``coll_per_op`` and
    ``coll_counts``; ``regions`` each kernel's calls, FLOPs and bytes;
    ``by_op`` each aten op overload's [calls, FLOPs, bytes];
    ``peak_bytes`` the peak of the storages the step created and still
    held."""
    flops: float = 0.0
    mxu_flops: float = 0.0
    mxu_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    ici_bytes: float = 0.0
    coll_per_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    regions: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    by_op: Dict[object, List[float]] = dataclasses.field(
        default_factory=dict)
    peak_bytes: int = 0


def _flat(xs, acc: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of ``xs`` (an argument list, nested lists and tuples)
    appended to ``acc``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            acc.append(x)
        elif isinstance(x, (list, tuple)):
            _flat(x, acc)
    return acc


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, dict):
        x = list(x.values())
    return _flat(x if isinstance(x, (list, tuple)) else (x,), [])


def nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements occupy: a broadcast (stride-0)
    dimension counts once."""
    if t.is_contiguous():
        return t.numel() * t.element_size()
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _all_bytes(x) -> int:
    return sum(nbytes(t) for t in _tensors(x))


def product_class(dtype: torch.dtype) -> str:
    """The rate a product of ``dtype`` operands runs at on the card: the
    tensor cores for 16-bit floats ("bf16"), the fp32 units for fp32
    (TF32 off)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "fp32"
    return str(dtype).replace("torch.", "")


def _product_flops(name: str, args, out) -> float:
    o = _tensors(out)[0]
    if name in ("aten.convolution", "aten._convolution"):
        w = args[1]
        return 2.0 * o.numel() * w.numel() / max(1, w.shape[0])
    if name == "aten.dot":
        return 2.0 * args[0].numel()
    # the contraction is the last dim of the first matrix operand
    a = args[1] if name in ("aten.addmm", "aten.baddbmm", "aten.addbmm",
                            "aten.addmv") else args[0]
    K = a.shape[-1]
    if name == "aten.addbmm":          # sums over the batch of products
        K *= a.shape[0]
    return 2.0 * o.numel() * K


def _group_size(func, args) -> int:
    from torch._C._distributed_c10d import ProcessGroup
    for a, spec in zip(args, func._schema.arguments):
        if "ProcessGroup" in str(spec.type):
            return ProcessGroup.unbox(a).size()
    return 1


def _kind(func) -> Tuple[str, bool]:
    """How the counter prices ``func``: ("c10d" | "free" | "alloc" (an
    empty allocation: no bytes, but a live storage) | "indexed" | "copy" |
    "product" | "pointwise" | "reduction" | "op", whether it writes an
    argument in place)."""
    mutable = func._schema.is_mutable
    if func.namespace == "c10d":
        return "c10d", mutable
    name = str(func.overloadpacket)
    if func.is_view or name in _FREE_OPS:
        return ("alloc" if name.startswith(("aten.empty", "aten.new_empty"))
                else "free"), mutable
    if name in _INDEXED_WRITES:
        return "indexed", mutable
    if name == "aten.copy_":
        return "copy", mutable
    if name in _PRODUCTS:
        return "product", mutable
    if torch.Tag.pointwise in func.tags:
        return "pointwise", mutable
    if torch.Tag.reduction in func.tags:
        return "reduction", mutable
    return "op", mutable


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.depth = 0                     # > 0 inside a kernel region
        self.live: Dict[int, weakref.finalize] = {}
        self.cur = 0
        self.kinds: Dict = {}              # func -> _kind(func)

    # -- peak of the storages created under the count -------------------
    def _free(self, key: int, n: int) -> None:
        self.live.pop(key, None)
        self.cur -= n

    def _track(self, out, skip=()) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self.live or key in skip:
                continue
            n = st.nbytes()
            self.live[key] = weakref.finalize(st, self._free, key, n)
            self.cur += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self.cur)

    def close(self) -> None:
        for f in list(self.live.values()):
            f.detach()
        self.live.clear()

    # -- kernel regions (rule e) ----------------------------------------
    def kernel_region(self, name: str, operands, fn: Callable):
        if self.depth:
            return fn()
        kc = RL.region_cost(name, *operands)
        c = self.cost
        c.flops += kc.flops
        c.bytes += kc.bytes
        if kc.products:
            c.mxu_flops += kc.flops
            c.mxu_by_dtype[kc.peak] = c.mxu_by_dtype.get(kc.peak, 0.0) \
                + kc.flops
        r = c.regions.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        r["calls"] += 1
        r["flops"] += kc.flops
        r["bytes"] += kc.bytes
        self.depth += 1
        try:
            out = fn()
        finally:
            self.depth -= 1
        self._track(out, {id(t.untyped_storage())
                          for t in _tensors(operands)})
        return out

    # -- every dispatched op --------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth:
            return out
        kind = self.kinds.get(func)
        if kind is None:
            kind = self.kinds[func] = _kind(func)
        kind, mutable = kind
        if kind == "free":
            return out
        if kind == "alloc":
            self._track(out)
            return out
        if kind == "c10d":
            self._collective(func, args)
            return out
        c = self.cost
        flops = 0.0
        ins = _flat(args, [])
        if kwargs:
            _flat(kwargs.values(), ins)
        if kind == "indexed":
            rest = ins[1:]
            b = sum(nbytes(t) for t in rest) \
                + rest[-1].numel() * args[0].element_size()
        elif kind == "copy":
            b = nbytes(args[0]) + nbytes(args[1])
        else:
            outs = _tensors(out)
            b = sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
            if kind == "product":
                flops = _product_flops(str(func.overloadpacket), args, out)
                cls = product_class(ins[0].dtype)
                c.mxu_flops += flops
                c.mxu_by_dtype[cls] = c.mxu_by_dtype.get(cls, 0.0) + flops
            elif kind == "pointwise":
                flops = float(sum(t.numel() for t in outs))
            elif kind == "reduction":
                flops = float(ins[0].numel())
            if not mutable:
                self._track(outs)
        c.flops += flops
        c.bytes += b
        r = c.by_op.get(func)
        if r is None:
            r = c.by_op[func] = [0, 0.0, 0.0]
        r[0] += 1
        r[1] += flops
        r[2] += b
        return out

    def _collective(self, func, args) -> None:
        c = self.cost
        op = func.overloadpacket.__name__
        touched = _all_bytes(args)
        if op not in _COLLECTIVES:          # recv_, barrier: bytes only
            c.bytes += touched
            return
        kind, i = _COLLECTIVES[op]
        ob = _all_bytes(args[i])
        traffic = RL.collective_traffic(kind, ob, _group_size(func, args))
        c.ici_bytes += traffic
        c.coll_per_op[kind] = c.coll_per_op.get(kind, 0.0) + traffic
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        # in place (all-reduce, broadcast): the operand is read and written
        c.bytes += touched + (ob if i == 0 and kind != "collective-permute"
                              else 0)


@contextlib.contextmanager
def count_cost() -> Iterator[Cost]:
    """Count every op dispatched inside the block; yields the ``Cost``,
    complete when the block exits."""
    cost = Cost()
    mode = _Counter(cost)
    try:
        with mode:
            yield cost
    finally:
        mode.close()


def top_ops(cost: Cost, key: str = "bytes", n: int = 10) -> List[tuple]:
    """The ``n`` aten ops with the most ``key`` ("calls", "flops" or
    "bytes") in a count: (op, calls, flops, bytes)."""
    col = ("calls", "flops", "bytes").index(key)
    rows = sorted(cost.by_op.items(), key=lambda kv: -kv[1][col])[:n]
    return [(str(k), int(v[0]), v[1], v[2]) for k, v in rows]
