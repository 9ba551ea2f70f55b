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
  ctypes launch the dispatcher never sees) and on ``meta`` tensors. The
  one part of a step that differs by device is a bf16 model's training
  head (``models/common.head_logits``): on the card and on ``meta`` its
  tensor-core passes, on the CPU the widened fp32 product.

``hlo_cost.py``'s other half has no counterpart: PyTorch runs Python loops
unrolled, so every layer's ops are dispatched and counted, and there is no
``while`` body to multiply by a trip count (nor a fusion, conditional or
async pair to resolve).

``count_cost(attribute=True)`` also files every count under a bucket
(``Cost.by_bucket``, the counterpart of ``tools/attribute.py``'s): the
buckets partition the count (their FLOPs, products and bytes sum to the
totals exactly; the ring traffic's fractions to rounding). An op's key
is the port's ``op_name``: inside a kernel region the region's name;
elsewhere the chain of the port's own functions on the Python stack,
outermost first, each as ``<module>.<qualified name>`` in lower case
(frames of ``analysis/`` and of any ``__torch_dispatch__`` or
``__torch_function__`` left out, so the counter's own names match no
keyword; the module keeps ``adamw.global_norm`` out of ``norm``). An
op the autograd engine runs is keyed ``transpose(<key>)``, ``<key>``
that of the forward op that made its node: a ``TorchFunctionMode``
stamps each new node's metadata with its key in the forward (a custom
``autograd.Function``'s node, its ``ctx``, from its ``forward``'s first
count), and the dispatch mode reads ``torch._C._current_autograd_node()``.
A node the stamp never saw is keyed by the port's frames that run it:
a ``torch.utils.checkpoint`` recompute by the recomputed function, a
graph that a backward differentiates itself (the flash attention's
recompute) by that backward. ``bucket_of`` (a copy of the JAX tool's)
turns a key into its bucket: the first keyword in it, "bwd:" before it
for a backward op. Only the autograd engine's frames cut the chain, so
a step keys alike on CUDA (whose backward runs on the engine's device
thread) and on CPU and ``meta`` tensors.

The counter also tracks the peak of the bytes held by storages created
while it is active (each op's and region's outputs, held through weak
references and dropped when freed): the counterpart of XLA's
``temp_size_in_bytes``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd.function import BackwardCFunction
from torch.overrides import TorchFunctionMode
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


# the port's copy of ``tools/attribute.py``'s op_name buckets: the first
# keyword a key holds names its bucket ("transpose" marks the backward)
KEYWORDS = ("flash", "attn", "rope", "moe", "dispatch", "combine", "xent",
            "logsumexp", "embed", "silu", "gelu", "ssd", "ssm", "conv",
            "adamw", "norm", "transpose")


def bucket_of(name: str) -> str:
    bwd = "bwd:" if "transpose" in name else ""
    for kw in KEYWORDS[:-1]:
        if kw in name:
            return bwd + kw
    return bwd + "other"


@dataclasses.dataclass
class Cost:
    """A step's count on one rank. ``mxu_flops``: the products' FLOPs
    (``hlo_cost``'s dot/convolution FLOPs), ``mxu_by_dtype`` the same by
    operand type; ``flops`` adds the elementwise and reduction work;
    ``ici_bytes`` the ring traffic, by kind in ``coll_per_op`` and
    ``coll_counts``; ``regions`` each kernel's calls, FLOPs and bytes;
    ``by_op`` each aten op overload's [calls, FLOPs, bytes];
    ``peak_bytes`` the peak of the storages the step created and still
    held; ``by_bucket`` (with ``attribute``) each bucket's "flops",
    "mxu_flops", "bytes", "ici_bytes" and "calls", and
    ``region_buckets`` the calls of each kernel region by the bucket
    they were filed under."""
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
    by_bucket: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    region_buckets: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)


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


# -- attribution: the key of the op being counted ---------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS = os.path.join(_PKG, "analysis") + os.sep
_MODE_HOOKS = ("__torch_dispatch__", "__torch_function__")
_CHECKPOINT = os.path.join("torch", "utils", "checkpoint.py")
# a frame's part in a key: left out, the port's, the autograd engine's
# entry, a ``torch.utils.checkpoint`` frame, a ``forward`` not yet known
# to be a custom Function's, one known to be
_SKIP, _PORT, _ENGINE, _CKPT, _FWD, _CTX_FWD = range(6)
_STAMP = "op_cost.key"         # a node's metadata entry: its forward key


class _Keys:
    """Each counted op's key (the module docstring: attribution), from
    the Python stack and the autograd node the engine is running."""

    def __init__(self):
        self.part: Dict = {}               # code -> its part (_SKIP ...)
        self.names: Dict[tuple, str] = {}  # port codes, innermost first
        # the code object that enters the autograd engine from Python
        self.engine = {torch.autograd.graph._engine_run_backward.__code__}

    def _part(self, code) -> int:
        if code in self.engine:
            return _ENGINE
        fn = code.co_filename
        if fn.endswith(_CHECKPOINT):
            return _CKPT
        if (not fn.startswith(_PKG) or fn.startswith(_ANALYSIS)
                or code.co_name in _MODE_HOOKS):
            return _SKIP
        if code.co_name == "forward" and code.co_argcount:
            return _FWD
        return _PORT

    def name(self, codes) -> str:
        """The key of a chain of port codes (innermost first)."""
        codes = tuple(codes)
        key = self.names.get(codes)
        if key is None:
            key = self.names[codes] = "/".join(
                (os.path.splitext(os.path.basename(c.co_filename))[0]
                 + "." + c.co_qualname).lower() for c in reversed(codes))
        return key

    def _walk(self, f):
        """(the port's codes on the stack from ``f`` out, innermost first;
        the (index, part) of each engine or checkpoint frame among them;
        the node of the innermost custom ``Function.forward``)."""
        part, codes, cuts, ctx = self.part, [], [], None
        while f is not None:
            c = f.f_code
            k = part.get(c)
            if k is None:
                k = part[c] = self._part(c)
            if k in (_ENGINE, _CKPT):
                cuts.append((len(codes), k))
            elif k:
                if k == _FWD:
                    arg = f.f_locals.get(c.co_varnames[0])
                    k = part[c] = (_CTX_FWD if isinstance(
                        arg, BackwardCFunction) else _PORT)
                if k == _CTX_FWD and ctx is None:
                    ctx = f.f_locals.get(c.co_varnames[0])
                codes.append(c)
            f = f.f_back
        return codes, cuts, ctx

    def key(self, f, region: str = "") -> str:
        """The key of an op counted with the stack at ``f``: ``region``'s
        name inside a kernel region, else the port's chain; in the
        backward ``transpose(<the forward op's key>)``."""
        node = torch._C._current_autograd_node()
        if node is not None and region:
            return f"transpose({region})"
        codes, cuts, ctx = self._walk(f)
        if node is None:
            key = region or self.name(codes)
            if ctx is not None and _STAMP not in ctx.metadata:
                ctx.metadata[_STAMP] = key
            return key
        inner = codes[:cuts[0][0]] if cuts else codes
        stamp = node.metadata.get(_STAMP)
        if cuts and cuts[0][1] == _CKPT and inner:
            base = self.name(inner)            # a checkpoint's recompute
        elif isinstance(node, BackwardCFunction):
            base = stamp or self.name(inner)
        else:
            base = stamp or self._differentiating(codes, cuts)
        return f"transpose({base or type(node).__name__})"

    def _differentiating(self, codes, cuts) -> str:
        """The port's frames between the innermost engine entry and the
        next: the backward whose own ``autograd.grad`` runs this node."""
        eng = [i for i, k in cuts if k == _ENGINE] + [len(codes)]
        return self.name(codes[eng[0]:eng[1]])


def _stamp(node, key: str) -> None:
    """Stamp ``key`` into ``node`` and every unstamped node it reaches
    (a composite op's inner nodes)."""
    todo = [node]
    while todo:
        n = todo.pop()
        md = n.metadata
        if _STAMP in md:
            continue
        md[_STAMP] = key
        todo.extend(m for m, _ in n.next_functions if m is not None)


class _Stamper(TorchFunctionMode):
    """Stamps each autograd node that a forward op makes with the op's
    key (a dispatch mode sits below autograd and never sees a node)."""

    def __init__(self, counter: "_Counter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            key = None
            for t in _tensors(out):
                fn = t.grad_fn
                if fn is not None and _STAMP not in fn.metadata:
                    if key is None:
                        key = self.counter.keys.key(sys._getframe(1),
                                                    self.counter.region)
                    _stamp(fn, key)
        return out


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost, attribute: bool = False):
        super().__init__()
        self.cost = cost
        self.depth = 0                     # > 0 inside a kernel region
        self.region = ""                   # the outermost region's name
        self.keys: Optional[_Keys] = _Keys() if attribute else None
        self.buckets: Dict[str, str] = {}  # key -> bucket_of(key)
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

    def _file(self, key: str, flops: float, mxu: float, nbytes: float,
              ici: float) -> str:
        """Add one count to ``key``'s bucket; returns the bucket."""
        b = self.buckets.get(key)
        if b is None:
            b = self.buckets[key] = bucket_of(key)
        r = self.cost.by_bucket.get(b)
        if r is None:
            r = self.cost.by_bucket[b] = {"flops": 0.0, "mxu_flops": 0.0,
                                          "bytes": 0.0, "ici_bytes": 0.0,
                                          "calls": 0}
        r["flops"] += flops
        r["mxu_flops"] += mxu
        r["bytes"] += nbytes
        r["ici_bytes"] += ici
        r["calls"] += 1
        return b

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
        if self.keys is not None:
            b = self._file(self.keys.key(sys._getframe(1), name), kc.flops,
                           kc.flops if kc.products else 0.0, kc.bytes, 0.0)
            rb = c.region_buckets.setdefault(name, {})
            rb[b] = rb.get(b, 0) + 1
        self.depth += 1
        self.region = name
        try:
            out = fn()
        finally:
            self.depth -= 1
            self.region = ""
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
        flops = mxu = 0.0
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
                mxu = flops
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
        if self.keys is not None:
            self._file(self.keys.key(sys._getframe(1)), flops, mxu, b, 0.0)
        return out

    def _collective(self, func, args) -> None:
        c = self.cost
        op = func.overloadpacket.__name__
        touched = _all_bytes(args)
        traffic = 0.0
        if op not in _COLLECTIVES:          # recv_, barrier: bytes only
            nb = touched
        else:
            kind, i = _COLLECTIVES[op]
            ob = _all_bytes(args[i])
            traffic = RL.collective_traffic(kind, ob,
                                            _group_size(func, args))
            c.ici_bytes += traffic
            c.coll_per_op[kind] = c.coll_per_op.get(kind, 0.0) + traffic
            c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
            # in place (all-reduce, broadcast): the operand is read and
            # written
            nb = touched + (ob if i == 0 and kind != "collective-permute"
                            else 0)
        c.bytes += nb
        if self.keys is not None:
            self._file(self.keys.key(sys._getframe(2)), 0.0, 0.0, nb,
                       traffic)


@contextlib.contextmanager
def count_cost(attribute: bool = False) -> Iterator[Cost]:
    """Count every op dispatched inside the block; yields the ``Cost``,
    complete when the block exits. ``attribute`` also fills
    ``Cost.by_bucket`` (the module docstring)."""
    cost = Cost()
    mode = _Counter(cost, attribute)
    try:
        with contextlib.ExitStack() as modes:
            if attribute:
                modes.enter_context(_Stamper(mode))
            modes.enter_context(mode)
            yield cost
    finally:
        mode.close()


def bucket_rows(cost: Cost) -> List[tuple]:
    """(bucket, flops, mxu_flops, bytes, ici_bytes, calls) of an
    attributed count, by bytes plus collective bytes, the most first (the
    JAX tool's order)."""
    rows = sorted(cost.by_bucket.items(),
                  key=lambda kv: (-(kv[1]["bytes"] + kv[1]["ici_bytes"]),
                                  kv[0]))
    return [(k, v["flops"], v["mxu_flops"], v["bytes"], v["ici_bytes"],
             int(v["calls"])) for k, v in rows]


def top_ops(cost: Cost, key: str = "bytes", n: int = 10) -> List[tuple]:
    """The ``n`` aten ops with the most ``key`` ("calls", "flops" or
    "bytes") in a count: (op, calls, flops, bytes)."""
    col = ("calls", "flops", "bytes").index(key)
    rows = sorted(cost.by_op.items(), key=lambda kv: -kv[1][col])[:n]
    return [(str(k), int(v[0]), v[1], v[2]) for k, v in rows]
