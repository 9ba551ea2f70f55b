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

A communicator and a tensor must agree: gloo takes CPU tensors, NCCL CUDA
tensors. A mismatch raises by name; nothing is staged through the host.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

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
    buf = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, group.ranks[dst], group.pg),
        dist.P2POp(dist.irecv, buf, group.ranks[src], group.pg)])
    return Pending(buf, works, x)


def wait(p) -> torch.Tensor:
    """A tensor as it is, or a ``Pending``'s received tensor."""
    return p.wait() if isinstance(p, Pending) else p
