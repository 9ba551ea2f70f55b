"""The collectives of the MoE transports, over ``torch.distributed``.

The JAX package calls ``lax`` primitives inside ``shard_map`` and
differentiates through them. Here the ones the transports differentiate
through are ``torch.autograd.Function``s with the transposes JAX uses
(``check_vma=False``): a tiled all-to-all's backward is the reverse
all-to-all, a psum's is a psum, an all-gather's is a psum followed by the
take of this rank's piece. ``ppermute`` carries no autograd: the comet
ring's backward is scheduled by hand. It posts its send and receive as
asynchronous work and returns a ``Pending`` that waits only when the data
is used, the counterpart of XLA's asynchronous collective-permute.

The model around the MoE layer keeps another convention, Megatron's:
every rank of a model group computes the same loss, so the cotangent a
rank holds for a replicated value is already the whole gradient. There
the conjugate pairs below take the place of the JAX transposes (which
would multiply such a gradient by the group size): ``copy_to`` (identity
forward, all-reduce backward) with ``reduce_from`` (all-reduce forward,
identity backward), ``scatter_to`` (this rank's slice forward, all-gather
backward) with ``gather_from`` (all-gather forward, this rank's slice
backward), and ``fsdp_gather`` (all-gather forward, reduce-scatter
backward) for parameters stored sharded over the data axes.
``grad_share`` (identity forward, cotangent / n backward) hands a value
that n ranks hold alike to code of the JAX convention, whose rank losses
sum to the loss.

A communicator and a tensor must agree: gloo takes CPU tensors, NCCL CUDA
tensors. A mismatch raises by name; nothing is staged through the host.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import Group

# the device type each single-device backend takes
_BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}


def check_device(op: str, group: Group, *tensors: torch.Tensor) -> None:
    want = _BACKEND_DEVICE.get(group.backend)
    for t in tensors:
        if want is not None and t.device.type != want:
            raise ValueError(
                f"{op}: the {group.backend} communicator takes {want} "
                f"tensors, got a {t.device.type} tensor")


def _all_to_all0(x: torch.Tensor, group: Group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group.pg)
    return out


def _all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group.pg)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all0(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all0(ct, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group.size)]
        dist.all_gather(parts, x, group=group.pg)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group)[ctx.group.index], None


def all_to_all(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Tiled all-to-all on ``dim`` (``lax.all_to_all(x, ax, dim, dim,
    tiled=True)``): piece j of ``dim`` goes to member j, and the pieces
    received are concatenated in member order."""
    check_device("all_to_all", group, x)
    if group.size == 1:
        return x
    if x.shape[dim] % group.size:
        raise ValueError(f"all_to_all: dim {dim} of {tuple(x.shape)} does "
                         f"not split over {group.size} ranks")
    if dim == 0:
        return _AllToAll.apply(x, group)
    return _AllToAll.apply(x.movedim(dim, 0), group).movedim(0, dim)


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    check_device("psum", group, x)
    if group.size == 1:
        return x
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    return psum(x, group) / group.size


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """(size, *x.shape): member t's x at index t (``lax.all_gather``)."""
    check_device("all_gather", group, x)
    if group.size == 1:
        return x[None]
    return _AllGather.apply(x, group)


def _gather_cat(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    return torch.cat(parts, dim=dim)


def _my_slice(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.index * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _my_slice(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _gather_cat(ct, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _my_slice(ct, ctx.group, ctx.dim), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        # reduce-scatter: the sum over the group, this rank's slice
        return _my_slice(_all_reduce(ct, ctx.group), ctx.group,
                         ctx.dim), None, None


class _GradShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None


def _split_check(op: str, x: torch.Tensor, group: Group, dim: int) -> None:
    if x.shape[dim] % group.size:
        raise ValueError(f"{op}: dim {dim} of {tuple(x.shape)} does not "
                         f"split over {group.size} ranks")


def copy_to(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Identity forward, all-reduce of the cotangent backward: a value
    every member holds alike, entering code where each member computes
    its own part of what follows (Megatron's f)."""
    if group is None or group.size == 1:
        return x
    check_device("copy_to", group, x)
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward: the members' partial
    results become the value each holds alike (Megatron's g)."""
    if group is None or group.size == 1:
        return x
    check_device("reduce_from", group, x)
    return _ReduceFrom.apply(x, group)


def scatter_to(x: torch.Tensor, group: Optional[Group],
               dim: int) -> torch.Tensor:
    """This member's slice of ``dim`` forward (slices in member order),
    all-gather of the cotangent slices backward."""
    if group is None or group.size == 1:
        return x
    check_device("scatter_to", group, x)
    _split_check("scatter_to", x, group, dim)
    return _ScatterTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, group: Optional[Group],
                dim: int) -> torch.Tensor:
    """The members' slices concatenated on ``dim`` forward, this member's
    slice of the cotangent backward: the inverse of ``scatter_to``, for
    code after which every member computes the same thing."""
    if group is None or group.size == 1:
        return x
    check_device("gather_from", group, x)
    return _GatherFrom.apply(x, group, dim)


def fsdp_gather(x: torch.Tensor, group: Optional[Group],
                dim: int) -> torch.Tensor:
    """A parameter stored sharded over ``group`` (the data axes), gathered
    whole on ``dim`` forward; its gradient summed over the group and cut
    to this member's slice backward (reduce-scatter). The members compute
    on different tokens, so the sum is the gradient of the global loss."""
    if group is None or group.size == 1:
        return x
    check_device("fsdp_gather", group, x)
    return _FsdpGather.apply(x, group, dim)


def grad_share(x: torch.Tensor, n: int) -> torch.Tensor:
    """Identity forward, cotangent / n backward: a value ``n`` ranks hold
    alike, each with the whole cotangent, handed to code whose backward
    sums the ranks' shares (the JAX transposes of the MoE body)."""
    if n == 1:
        return x
    return _GradShare.apply(x, n)


def all_reduce_(x: torch.Tensor, group: Optional[Group], op: str = "sum"
                ) -> torch.Tensor:
    """In-place all-reduce without autograd (``op`` "sum" or "max")."""
    if group is None or group.size == 1:
        return x
    check_device("all_reduce_", group, x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group.pg)
    return x


class Pending:
    """A received tensor still in flight: ``wait()`` returns it."""

    def __init__(self, buf: torch.Tensor, works: List, sent: torch.Tensor):
        # the send buffer stays referenced until its send completes
        self.buf, self.works, self.sent = buf, works, sent

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        self.works, self.sent = [], None
        return self.buf


def check_permutation(pairs: Sequence[Tuple[int, int]], n: int) -> None:
    srcs = sorted(s for s, _ in pairs)
    dsts = sorted(d for _, d in pairs)
    if srcs != list(range(n)) or dsts != list(range(n)) or any(
            s == d for s, d in pairs):
        raise ValueError(f"ppermute: {list(pairs)} is not a full permutation "
                         f"of {n} ranks without a self-pair")


def ppermute(x: torch.Tensor, ctx, pairs: Sequence[Tuple[int, int]]
             ) -> Pending:
    """Collective permute over the model axis of ``ctx`` (an AxisCtx):
    model rank s sends ``x`` to d for each (s, d) in ``pairs``. Posts the
    send and the receive and returns at once; the received tensor is the
    ``Pending``'s ``wait()``."""
    group = ctx.model_group
    check_device("ppermute", group, x)
    check_permutation(pairs, group.size)
    me = group.index
    dst = next(d for s, d in pairs if s == me)
    src = next(s for s, d in pairs if d == me)
    x = x.contiguous()
    # fp8 travels as its bytes: one byte an element on every backend
    wire = (x.view(torch.uint8)
            if x.is_floating_point() and x.element_size() == 1 else x)
    buf = torch.empty_like(wire)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, wire, group.ranks[dst], group.pg),
        dist.P2POp(dist.irecv, buf, group.ranks[src], group.pg)])
    return Pending(buf.view(x.dtype), works, wire)


def wait(p) -> torch.Tensor:
    """A tensor as it is, or a ``Pending``'s received tensor."""
    return p.wait() if isinstance(p, Pending) else p
