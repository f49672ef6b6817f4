"""Device meshes over ``torch.distributed``.

Port of the JAX package's ``parallel/mesh.py``.  Rank ``r`` of the
default process group plays device ``r`` of the JAX mesh: a
:class:`Mesh` is an array of ranks with one name per axis, as a JAX mesh
is an array of devices.  Two axes carry the work:

  * "dp" — the QPD *variant* axis (each rank simulates a slice of the
    6^g * 8^w instantiations, or scans its own label blocks);
  * "tp" (the knit step's mesh) or "amp" (a fragment's mesh) — the
    *amplitude* axis of a fragment statevector.

Every rank of the world builds the same meshes in the same order: each
axis gets one subgroup per line of ranks along it (``dist.new_group``,
which every rank of the world must call, member or not), cached by its
ranks so a second mesh over the same lines makes no new group.  The JAX
collectives become the group's: ``lax.psum`` is :meth:`Mesh.all_reduce`,
``lax.ppermute`` over the pairs ``(s, s ^ mask)`` is
:meth:`Mesh.exchange` (one ``isend`` and one ``irecv`` with the partner,
in ``dist.batch_isend_irecv``), ``lax.axis_index`` is
:meth:`Mesh.index` (a Python int), and the host pull of a dp-sharded
result is :meth:`Mesh.all_gather`.

Without an initialised process group a mesh is a world of one (every
axis of size 1) and every collective is the identity, as JAX on one
device.  A mesh's tensors live on ``mesh.device``: ``"cuda"`` by
default, ``cuda:{LOCAL_RANK}`` in a world of several processes, or
what the caller passes (``device="cpu"`` with the ``gloo`` backend).
"""
from __future__ import annotations

import os
import weakref
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..convert import resolve_device

# default group -> {axis line of global ranks: its process group}; held
# weakly by the default group, so ``dist.destroy_process_group()`` lets
# the subgroups go with it and a new default group starts anew
_GROUPS = weakref.WeakKeyDictionary()


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """``(world size, this rank)``; ``(1, 0)`` without a process group."""
    if not _initialised():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def every_rank(flag: bool, device) -> bool:
    """Whether ``flag`` holds on every rank of the world: a MIN
    ``all_reduce`` over the default group, on ``device`` (the backend's:
    the CPU for ``gloo``, the rank's card for NCCL).  Every rank must
    call it, and none returns before all have called it.  ``flag``
    itself without a process group."""
    if not _initialised() or dist.get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _group(line: tuple[int, ...]):
    """The process group over ``line`` (global ranks), made once per
    default group.  Every rank of the world must call this for every
    line, in the same order."""
    if not _initialised():
        return None
    groups = _GROUPS.setdefault(dist.group.WORLD, {})
    if line not in groups:
        groups[line] = dist.new_group(list(line))
    return groups[line]


def mesh_device(device=None) -> torch.device:
    """The device a mesh's tensors live on: ``device`` if given, else
    ``cuda:{LOCAL_RANK}`` in a process group (``LOCAL_RANK`` from the
    environment, else the rank modulo the cards present), else
    ``"cuda"``.  Raises without a card unless ``device="cpu"``."""
    if device is not None:
        return resolve_device(device)
    if _initialised():
        count = max(1, torch.cuda.device_count())
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % count))
        return resolve_device(f"cuda:{local}")
    return resolve_device(None)


class Mesh:
    """An array of global ranks with one name per axis (the JAX
    ``Mesh(devices, axis_names)``).  ``shape`` maps axis name -> size in
    axis order, as JAX's does; ``coords`` maps axis name -> this rank's
    coordinate (None when this rank is not in the mesh); ``device`` is
    where this rank's tensors live."""

    def __init__(self, ranks, axis_names, device=None):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a {ranks.ndim}-d rank array for axes "
                             f"{axis_names}")
        size, rank = world()
        if ranks.size and (ranks.min() < 0 or ranks.max() >= size):
            raise ValueError(f"mesh ranks {ranks.ravel().tolist()} outside "
                             f"a world of {size}")
        self.devices = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.rank = rank
        where = np.argwhere(ranks == rank)
        self.coords = (dict(zip(axis_names, (int(c) for c in where[0])))
                       if len(where) else None)
        self.groups: dict = {}
        self.lines: dict[str, tuple[int, ...]] = {}
        for i, name in enumerate(axis_names):
            lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            for line in lines:
                line = tuple(int(r) for r in line)
                grp = _group(line)
                if rank in line:
                    self.groups[name] = grp
                    self.lines[name] = line
        self.device = mesh_device(device)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def member(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def _live(self, axis: str) -> bool:
        return self.groups.get(axis) is not None

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` over ``axis`` in place (``lax.psum``); returns it."""
        if self._live(axis):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ``t`` of every rank on ``axis`` concatenated along dim 0 in
        coordinate order (every rank's ``t`` has the same shape)."""
        if not self._live(axis):
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self.groups[axis])
        return torch.cat(parts)

    def exchange(self, t: torch.Tensor, axis: str, mask: int) -> torch.Tensor:
        """The ``t`` of the rank whose ``axis`` coordinate is this rank's
        XOR ``mask`` (``lax.ppermute`` over the pairs ``(s, s ^ mask)``):
        one ``isend`` of ``t`` and one ``irecv`` into a buffer of the same
        shape and dtype, batched.  The bytes on the wire are ``t``'s."""
        peer_coord = self.index(axis) ^ mask
        if not self._live(axis) or peer_coord == self.index(axis):
            raise ValueError(f"no partner at coordinate {peer_coord} on "
                             f"axis {axis!r} of size {self.shape[axis]}")
        peer = self.lines[axis][peer_coord]
        t = t.contiguous()
        out = torch.empty_like(t)
        grp = self.groups[axis]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, peer, grp),
            dist.P2POp(dist.irecv, out, peer, grp),
        ])
        for req in reqs:
            req.wait()
        return out

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` from the mesh's first rank on every rank of the world
        (a rank outside the mesh passes a buffer of the same shape and
        dtype): how ranks that the mesh leaves out (the largest power of
        two of a world, :func:`..ops.sharded_fragment.fragment_mesh`) get
        its result."""
        if _initialised() and self.size < world()[0]:
            t = t.contiguous()
            dist.broadcast(t, src=int(self.devices.flat[0]))
        return t

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")


def dp_slice(count: int, mesh: Mesh, axis: str = "dp") -> tuple[int, int]:
    """``(lo, hi)``: this rank's contiguous share of ``count`` rows split
    over ``axis`` in chunks of ``ceil(count / size)`` (the last ranks may
    hold fewer rows, or none)."""
    per = -(-count // mesh.shape[axis])
    lo = min(count, mesh.index(axis) * per)
    return lo, min(count, lo + per)


class _GatherRows(torch.autograd.Function):
    """Every rank's slice of the rows, concatenated in coordinate order;
    backward hands each rank its own slice of the gradient (every rank
    runs the same computation on the gathered rows, so their gradients
    agree)."""

    @staticmethod
    def forward(ctx, local, mesh, axis, count):
        per = -(-count // mesh.shape[axis])
        lo, hi = dp_slice(count, mesh, axis)
        ctx.span = (lo, hi)
        pad = local.new_zeros((per - (hi - lo),) + tuple(local.shape[1:]))
        full = mesh.all_gather(torch.cat([local, pad]), axis)
        return full[:count]

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.span
        return grad[lo:hi], None, None, None


class _SumGrads(torch.autograd.Function):
    """The identity on tensors whose gradients are partial on each rank
    (each rank used them on its own slice of the rows): backward sums
    the gradients over ``axis`` in one ``all_reduce``."""

    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.shapes = [t.shape for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([
            (g if g is not None else torch.zeros(s, device=ctx.mesh.device))
            .reshape(-1).to(torch.float32)
            for g, s in zip(grads, ctx.shapes)
        ])
        ctx.mesh.all_reduce(flat, ctx.axis)
        out, at = [], 0
        for g, s in zip(grads, ctx.shapes):
            n = int(np.prod(s))
            out.append(flat[at:at + n].reshape(s).to(
                g.dtype if g is not None else torch.float32))
            at += n
        return (None, None) + tuple(out)


def gather_rows(local: torch.Tensor, mesh: Mesh, count: int,
                axis: str = "dp") -> torch.Tensor:
    """The ``[count, ...]`` rows whose slice :func:`dp_slice` gave this
    rank, gathered from every rank on ``axis`` (differentiable: see
    :class:`_GatherRows`).  Every rank of the axis must call it."""
    return _GatherRows.apply(local, mesh, axis, count)


def sum_grads(tensors, mesh: Mesh, axis: str = "dp") -> list:
    """``tensors`` unchanged, their gradients summed over ``axis`` in the
    backward pass: wrap what every rank computes alike but uses on its
    own slice of the rows only.  The identity when none needs a
    gradient."""
    tensors = list(tensors)
    if not any(t.requires_grad for t in tensors):
        return tensors
    return list(_SumGrads.apply(mesh, axis, *tensors))


@dataclass(frozen=True)
class NamedSharding:
    """A layout over a mesh, by axis name per array dimension (the JAX
    ``NamedSharding(mesh, PartitionSpec(...))``): ``spec[i]`` names the
    mesh axis dimension ``i`` is split over, None where it is not."""

    mesh: Mesh
    spec: tuple = ()


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None, device=None) -> Mesh:
    """The (dp, tp) mesh over the first ``n_devices`` ranks of the world
    (all by default), favouring the variant axis: amplitude sharding only
    when dp saturates."""
    n = n_devices or world()[0]
    if dp is None and tp is None:
        tp = 1
        dp = n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    return Mesh(np.arange(n).reshape(dp, tp), ("dp", "tp"), device)


def variant_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis = variants, sharded over dp."""
    return NamedSharding(mesh, ("dp",))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
