"""Mesh construction and the axis context, over ``torch.distributed``.

The JAX package lays its devices out on a named ``Mesh`` and runs the MoE
body under ``shard_map``. Here every rank is one process of an initialised
default process group, and the mesh is a layout of the global ranks:
row-major over the named axes, as ``compat.make_mesh`` lays out devices
(rank = data_index * model_size + model_index for ("data", "model")). The
process groups of every axis (and of every set of axes) are built when the
mesh is built, and the expert-tensor-parallel subgroups when the first
context with that ``etp`` is built. ``new_group`` is collective: every rank
builds every group in the same order, including groups it is not in.

A mesh covers the first n ranks of the default group, n the product of its
shape: fewer than the world after a run has lost ranks (the elastic path,
``training.trainer.Trainer.rescale``). The ranks after them are outside
it (``member`` False): they still take part in building its groups, and
hold none of them.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """One process group as a collective sees it: the torch group, its
    members' global ranks in axis order (ascending, as ``new_group`` orders
    them) and its backend ("gloo", "nccl")."""
    pg: object
    ranks: Tuple[int, ...]
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This rank's position in the group."""
        return self.ranks.index(dist.get_rank())


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape``: axis name -> size, in layout order (the last axis varies
    fastest). ``group(axes)`` is the group of ranks that share this rank's
    coordinates on every other axis. A rank outside the mesh has no
    coordinates and no groups."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialised default "
                               "process group (torch.distributed)")
        n = math.prod(shape)
        if n > dist.get_world_size():
            raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the "
                               f"process group has {dist.get_world_size()}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.size = n
        self.rank = dist.get_rank()
        self.member = self.rank < n
        self.backend = str(dist.get_backend())
        self.coords = self.coords_of(self.rank) if self.member else None
        self._groups: Dict[Tuple[str, ...], Group] = {}
        self._subgroups: Dict[Tuple[str, int], Tuple[Group, Group]] = {}
        for k in range(1, len(axes) + 1):
            for sub in itertools.combinations(self.axis_names, k):
                self._groups[sub] = self._build(
                    [self._members(sub, other) for other in
                     itertools.product(*(range(self.shape[a]) for a in
                                         self.axis_names if a not in sub))])

    def coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return out

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _members(self, sub: Tuple[str, ...], other: Tuple[int, ...]):
        """Global ranks whose coordinates off ``sub`` are ``other``."""
        rest = [a for a in self.axis_names if a not in sub]
        fixed = dict(zip(rest, other))
        return sorted(self._rank_of({**fixed, **dict(zip(sub, c))})
                      for c in itertools.product(
                          *(range(self.shape[a]) for a in sub)))

    def _build(self, blocks: List[List[int]]) -> Group:
        """new_group for every block, in order, on every rank; returns the
        block holding this rank."""
        mine = None
        for ranks in blocks:
            if len(ranks) == dist.get_world_size():
                pg = dist.group.WORLD
            else:
                pg = dist.new_group(ranks)
            if self.rank in ranks:
                mine = Group(pg, tuple(ranks), self.backend)
        return mine

    def group(self, axes: Sequence[str]) -> Group:
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(tuple(axes)):
            raise KeyError(f"axes {tuple(axes)} not all in {self.axis_names}")
        return self._groups[key]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def model_subgroups(self, model_axis: str,
                        etp: int) -> Tuple[Group, Optional[Group]]:
        """(tp group, etp group) of this rank for an ``etp`` split of the
        model axis: ranks sharing the tp index (size ep, the EP
        collectives) and ranks sharing the expert group (size etp, the ETP
        psum; None when etp == 1). Built on first use, which every rank
        reaches together."""
        key = (model_axis, etp)
        if key not in self._subgroups:
            model = self.group((model_axis,))
            if etp == 1:
                self._subgroups[key] = (model, None)
                return self._subgroups[key]
            # the model axis's groups, one per coordinate off it
            rows = [self._members((model_axis,), o)
                    for o in itertools.product(
                        *(range(self.shape[a]) for a in self.axis_names
                          if a != model_axis))]
            ep = self.shape[model_axis] // etp

            def blocks(idx_lists):
                return [[row[i] for i in idx] for row in rows
                        for idx in idx_lists]

            self._subgroups[key] = (
                self._build(blocks(tp_index_groups(ep, etp))),
                self._build(blocks(etp_index_groups(ep, etp))))
        return self._subgroups[key]


def tp_index_groups(ep: int, etp: int) -> List[List[int]]:
    """Model-axis indices sharing a tp index (EP collectives), size ep."""
    return [[g * etp + t for g in range(ep)] for t in range(etp)]


def etp_index_groups(ep: int, etp: int) -> List[List[int]]:
    """Model-axis indices sharing an expert group (ETP psum), size etp."""
    return [[g * etp + t for t in range(etp)] for g in range(ep)]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    return Mesh(shape, axes)


@dataclass(frozen=True)
class AxisCtx:
    """How the model maps onto mesh axes. ep * etp equals the model-axis
    size. With no mesh (the default) every transport takes its one-rank
    arm."""
    mesh: Optional[Mesh] = None
    dp_axes: Tuple[str, ...] = ()      # batch axes, e.g. ("pod", "data")
    model_axis: str = ""               # TP / EP / SP axis
    ep: int = 1                        # expert-parallel group size
    etp: int = 1                       # expert-tensor-parallel (d_ff) size
    seq_shard: bool = False            # sequence-parallel activations

    def __post_init__(self):
        if self.active:
            if self.ep * self.etp != self.model_size:
                raise ValueError(f"ep {self.ep} x etp {self.etp} != model "
                                 f"axis size {self.model_size}")
            self.mesh.model_subgroups(self.model_axis, self.etp)

    @property
    def active(self) -> bool:
        return self.mesh is not None and self.model_axis != ""

    @property
    def world(self) -> int:
        return self.ep * self.etp

    @property
    def dp_size(self) -> int:
        if self.mesh is None or not self.dp_axes:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def model_size(self) -> int:
        if self.mesh is None or not self.model_axis:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def model_rank(self) -> int:
        """This rank's index on the model axis (``lax.axis_index``)."""
        return self.mesh.axis_index(self.model_axis)

    @property
    def model_group(self) -> Group:
        return self.mesh.group((self.model_axis,))

    @property
    def data_group(self) -> Optional[Group]:
        """The ranks holding the same expert shard: every mesh axis but the
        model axis (None on a mesh with the model axis only)."""
        rest = tuple(a for a in self.mesh.axis_names if a != self.model_axis)
        return self.mesh.group(rest) if rest else None

    @property
    def tp_group(self) -> Group:
        """This rank's group of the JAX package's ``tp_groups()``: the EP
        collectives' group (the model group when etp == 1)."""
        return self.mesh.model_subgroups(self.model_axis, self.etp)[0]

    @property
    def etp_group(self) -> Optional[Group]:
        """This rank's group of ``etp_groups()``: the ETP psum's group
        (None when etp == 1)."""
        return self.mesh.model_subgroups(self.model_axis, self.etp)[1]


def choose_ep(num_experts: int, model_size: int,
              requested: int = 0) -> Tuple[int, int]:
    """Pick (ep, etp) with ep*etp == model_size, ep | num_experts,
    maximizing ep."""
    if requested:
        if model_size % requested or num_experts % requested:
            raise ValueError(f"requested ep={requested} incompatible with "
                             f"E={num_experts}, model={model_size}")
        return requested, model_size // requested
    ep = 1
    for cand in range(1, model_size + 1):
        if model_size % cand == 0 and num_experts % cand == 0:
            ep = cand
    return ep, model_size // ep


def local_ctx() -> AxisCtx:
    return AxisCtx()
