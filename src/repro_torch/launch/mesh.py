"""Meshes: the 1-axis ``"shard"`` mesh of the sharded graph traversal, and
the LM's ``("data", "model")`` / ``("pod", "data", "model")`` mesh.

The reference traces one ``shard_map`` program over a 1-axis device mesh.
The port runs the same program SPMD over ``torch.distributed``: one
process a shard, every rank calling the same driver with the same
arguments.  A :class:`GraphMesh` is one process's view of that mesh: the
shard count, its rank, the process group, its device, and the two
collectives the sharded advance is built from:

==============================  =========================================
reference (``jax.lax``)         port
==============================  =========================================
``all_gather(x, tiled=True)``   :meth:`GraphMesh.all_gather`
                                (``dist.all_gather_into_tensor``)
``psum`` of partials            :meth:`GraphMesh.all_reduce`
                                (``all_reduce(SUM)``)
``pmin`` / ``pmax`` of          :meth:`GraphMesh.all_gather`, then
partials                        ``torch.amin``/``amax`` on each rank
                                (gloo's and NCCL's MIN/MAX drop a NaN
                                that is not on the first rank)
``psum`` / ``pmin`` of an       one :meth:`GraphMesh.all_gather` of all
iteration's integer scalars     of them, reduced on each rank
==============================  =========================================

One shard needs no process group: the mesh is local and its collectives
return their operand.  The backend is the caller's: four ranks can share
one card through a ``gloo`` group on CUDA tensors (NCCL refuses two ranks
on one card), and the same code takes NCCL where each rank has its own
card.

Every collective is counted in :attr:`GraphMesh.stats`: calls, bytes, and
the host time between a device synchronize before it and one after it
(so the time is the collective's, waiting for the slowest rank included,
not the queued work that produces its operand), in all and by kind and
group size (:data:`KINDS`), which the roofline's ring factors read.
Besides the collectives above, an axis sends to its neighbours
(:meth:`GraphMesh.shift`, the reference's ``ppermute``) and broadcasts
(:meth:`GraphMesh.broadcast`); under gloo those two stage CUDA tensors
through host memory.

The LM's mesh (:class:`LMMesh`, from :func:`make_host_mesh` or
:func:`make_production_mesh`, or of any shape from :func:`make_mesh`: the
reference's ``launch/mesh.py``) lays the
ranks of a process group out row-major over its axes: ``data`` is the FSDP
and batch axis, ``model`` the tensor-parallel one, ``pod`` a second batch
axis.  Each axis is a :class:`GraphMesh` over the sub-group of the ranks
that share every other coordinate; all of them count into one
:class:`CollectiveStats`.  A :class:`NamedSharding` (the reference's
``NamedSharding(mesh, PartitionSpec)``) places one tensor on that mesh:
:meth:`NamedSharding.shard` cuts this rank's block out of a full tensor,
:meth:`NamedSharding.gather` puts the full tensor back together.  Nothing
here runs at import: the meshes are built when the functions are called.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import time
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

__all__ = ["KINDS", "CollectiveStats", "GraphMesh", "LMMesh",
           "NamedSharding", "launcher_backend", "launcher_mesh",
           "make_graph_mesh", "make_host_mesh", "make_mesh",
           "make_production_mesh", "sharded"]


#: The collective kinds :class:`CollectiveStats` records, as the
#: reference's roofline names them (``broadcast`` is the port's own: the
#: pipeline's output from its last stage).
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


@dataclasses.dataclass
class CollectiveStats:
    """Running totals of one mesh's collectives, and by kind: ``kinds[(kind,
    group size)] = [calls, bytes, seconds]``, the bytes each call returned
    (what a collective-permute sent; the roofline's ring factors apply to
    them: ``repro_torch.launch.roofline.stats_wire_bytes``)."""

    calls: int = 0
    bytes: int = 0              # bytes each collective returned
    seconds: float = 0.0        # host clock, synchronized on both sides
    kinds: Dict[Tuple[str, int], list] = dataclasses.field(
        default_factory=dict)

    def reset(self) -> None:
        self.calls = self.bytes = 0
        self.seconds = 0.0
        self.kinds.clear()

    def record(self, kind: str, group_size: int, nbytes: int,
               seconds: float) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        self.calls += 1
        self.bytes += nbytes
        self.seconds += seconds
        row = self.kinds.setdefault((kind, group_size), [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += seconds


@dataclasses.dataclass(frozen=True)
class GraphMesh:
    """One rank's view of a 1-axis mesh of ``num_shards`` shards."""

    num_shards: int
    rank: int
    device: torch.device
    group: Optional[object] = None     # a torch.distributed ProcessGroup
    axis: str = "shard"
    stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats, compare=False, repr=False)

    @property
    def backend(self) -> str:
        """``"local"`` for one shard, else the process group's backend."""
        if self.group is None:
            return "local"
        return str(dist.get_backend(self.group))

    def __str__(self) -> str:
        return (f"GraphMesh({self.axis}={self.num_shards}, rank {self.rank}, "
                f"backend {self.backend}, device {self.device})")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order
        (``[S * n, ...]`` from ``[n, ...]``): the reference's tiled
        ``all_gather``."""
        if self.num_shards == 1:
            return x
        x = x.contiguous()
        as_bytes = x.dtype == torch.bool
        src = x.view(torch.uint8) if as_bytes else x
        out = src.new_empty((self.num_shards * src.shape[0],)
                            + tuple(src.shape[1:]))
        self._sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            # newer torch prefers another name for the same collective
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, src, group=self.group)
        self._sync()
        self._count(t0, out, "all-gather")
        return out.view(torch.bool) if as_bytes else out

    def all_reduce(self, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` combined over the ranks with ``op`` (a new tensor)."""
        if self.num_shards == 1:
            return x
        out = x.contiguous().clone()
        self._sync()
        t0 = time.perf_counter()
        dist.all_reduce(out, op=op, group=self.group)
        self._sync()
        self._count(t0, out, "all-reduce")
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``x`` (``[S * n, ...]``), of which this
        rank keeps rows ``[rank * n, (rank + 1) * n)``."""
        if self.num_shards == 1:
            return x
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.num_shards,)
                          + tuple(x.shape[1:]))
        self._sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, x, group=self.group)
        self._sync()
        self._count(t0, out, "reduce-scatter")
        return out

    def _global(self, coord: int) -> int:
        """The default group's rank of coordinate ``coord`` on this axis
        (point-to-point calls name their peer so)."""
        return dist.get_process_group_ranks(self.group)[coord]

    def _host_staged(self, x: torch.Tensor) -> bool:
        """Whether ``x`` goes through host memory: a CUDA tensor under
        gloo, whose point-to-point calls and broadcast are used here on
        host buffers only (NCCL takes the CUDA tensor)."""
        return x.device.type == "cuda" and self.backend == "gloo"

    def shift(self, x: torch.Tensor, step: int = 1) -> torch.Tensor:
        """A collective-permute: coordinate ``r`` sends ``x`` to ``r +
        step`` and returns what ``r - step`` sent, zeros where no rank
        sends (the reference's ``ppermute`` with pairs ``(r, r + step)``).
        Every rank of the axis calls it; the sends and receives are posted
        together, then waited for, so neighbours cannot deadlock."""
        x = x.contiguous()
        if self.num_shards == 1:
            return torch.zeros_like(x)
        dst, src = self.rank + step, self.rank - step
        send_to = dst if 0 <= dst < self.num_shards else None
        recv_from = src if 0 <= src < self.num_shards else None
        staged = self._host_staged(x)
        out = torch.zeros_like(x)
        buf = torch.empty_like(x, device="cpu") if staged else out
        payload = x.cpu() if staged and send_to is not None else x
        self._sync()
        t0 = time.perf_counter()
        works = []
        if send_to is not None:
            works.append(dist.isend(payload, self._global(send_to),
                                    group=self.group))
        if recv_from is not None:
            works.append(dist.irecv(buf, self._global(recv_from),
                                    group=self.group))
        for w in works:
            w.wait()
        if staged and recv_from is not None:
            out.copy_(buf)
        self._sync()
        sent = x if send_to is not None else x[:0]
        self._count(t0, sent, "collective-permute")
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Coordinate ``src``'s ``x`` on every rank of the axis (a new
        tensor; the others' ``x`` gives only its shape and type)."""
        if self.num_shards == 1:
            return x
        out = x.contiguous().clone()
        staged = self._host_staged(out)
        buf = out.cpu() if staged else out
        self._sync()
        t0 = time.perf_counter()
        dist.broadcast(buf, self._global(src), group=self.group)
        if staged:
            out.copy_(buf)
        self._sync()
        self._count(t0, out, "broadcast")
        return out

    def _count(self, t0: float, out: torch.Tensor, kind: str) -> None:
        self.stats.record(kind, self.num_shards,
                          out.numel() * out.element_size(),
                          time.perf_counter() - t0)


def _mesh_device(device, rank: int) -> torch.device:
    """``None``/``"cuda"``: card ``rank % device_count``; anything else as
    given (``"cpu"`` when the caller asks for it)."""
    if device is None or str(device) == "cuda":
        resolve_device("cuda")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(device)


def make_graph_mesh(num_shards: int, *, group=None,
                    device=None) -> GraphMesh:
    """The 1-axis ``("shard",)`` mesh of the sharded traversal, for this
    process.

    One shard is a local mesh.  More than one needs a process group
    (``group``, default: the default group once
    ``torch.distributed.init_process_group`` has run) of exactly
    ``num_shards`` ranks; the rank is this process's rank in it.  The
    mesh's device is card ``rank % torch.cuda.device_count()``, or the one
    ``device`` names (``"cpu"``, as the tests ask).
    """
    num_shards = int(num_shards)
    if group is None and num_shards > 1 and dist.is_initialized():
        group = dist.group.WORLD
    n = dist.get_world_size(group) if group is not None else 1
    if num_shards < 1 or num_shards > n or (num_shards > 1 and
                                            num_shards != n):
        raise ValueError(
            f"num_shards={num_shards} must be in [1, {n}] and equal the "
            f"process group's size above 1 ({n} ranks available)")
    if num_shards == 1:
        return GraphMesh(1, 0, _mesh_device(device, 0))
    rank = dist.get_rank(group)
    return GraphMesh(num_shards, rank, _mesh_device(device, rank), group)


# ---------------------------------------------------------------------------
# the LM's mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMMesh:
    """One rank's view of the LM's mesh: ``axis_names`` in order, one
    :class:`GraphMesh` an axis (its size, this rank's coordinate on it and
    the sub-group along it), and the whole mesh's group.  ``shape`` maps
    each name to its size, as the reference's ``Mesh.shape``; an axis the
    mesh lacks has size 1 and coordinate 0."""

    axis_names: Tuple[str, ...]
    axes: Tuple[GraphMesh, ...]
    rank: int
    device: torch.device
    group: Optional[object] = None
    stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {n: a.num_shards for n, a in zip(self.axis_names, self.axes)}

    @property
    def size(self) -> int:
        return math.prod(a.num_shards for a in self.axes)

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def coord(self, name: str) -> int:
        for n, a in zip(self.axis_names, self.axes):
            if n == name:
                return a.rank
        return 0

    @property
    def backend(self) -> str:
        """``"local"`` for one rank, else the process group's backend."""
        if self.group is None:
            return "local"
        return str(dist.get_backend(self.group))

    def __str__(self) -> str:
        dims = ", ".join(f"{n}={a.num_shards}"
                         for n, a in zip(self.axis_names, self.axes))
        return (f"LMMesh({dims}, rank {self.rank}, backend {self.backend}, "
                f"device {self.device})")

    def _axis(self, name: str) -> Optional[GraphMesh]:
        for n, a in zip(self.axis_names, self.axes):
            if n == name and a.num_shards > 1:
                return a
        return None

    def axis(self, name: str) -> GraphMesh:
        """The 1-axis mesh along ``name``: its size, this rank's coordinate
        and the sub-group of the ranks that share every other coordinate
        (for the point-to-point calls of :mod:`repro_torch.train.pipeline`);
        counted in this mesh's :attr:`stats`."""
        for n, a in zip(self.axis_names, self.axes):
            if n == name:
                return a
        raise ValueError(f"the mesh has no axis {name!r} "
                         f"({self.axis_names})")

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in
        coordinate order; ``x`` itself on an axis of size 1."""
        ax = self._axis(axis)
        if ax is None:
            return x
        if dim == 0:
            return ax.all_gather(x)
        return ax.all_gather(x.movedim(dim, 0)).movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int = 0) -> torch.Tensor:
        """The sum of the ranks' ``x`` along ``axis``, cut on ``dim`` into
        as many blocks as ranks; this rank's block."""
        ax = self._axis(axis)
        if ax is None:
            return x
        if dim == 0:
            return ax.reduce_scatter(x)
        return ax.reduce_scatter(x.movedim(dim, 0)).movedim(0, dim)

    def all_reduce(self, x: torch.Tensor, axes,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` combined with ``op`` over every axis of ``axes`` (a name
        or a tuple of names), one axis after another."""
        for name in (axes,) if isinstance(axes, str) else axes:
            ax = self._axis(name)
            if ax is not None:
                x = ax.all_reduce(x, op)
        return x

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def _world(group) -> Tuple[Optional[object], int]:
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    return group, (dist.get_world_size(group) if group is not None else 1)


def _lm_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], group,
             device) -> LMMesh:
    """The mesh of ``shape`` over ``group``'s ranks, row-major.  Every rank
    creates every axis's sub-groups in the same order, as
    ``torch.distributed.new_group`` asks; this rank keeps its own."""
    rank = dist.get_rank(group) if group is not None else 0
    members = (dist.get_process_group_ranks(group) if group is not None
               else [0])
    coords = [int(c) for c in _unravel(rank, shape)]
    stats = CollectiveStats()
    dev = _mesh_device(device, rank)
    axes = []
    for i, name in enumerate(names):
        sub = None
        if shape[i] > 1:
            others = [range(s) if j != i else range(1)
                      for j, s in enumerate(shape)]
            for fixed in itertools.product(*others):
                ranks = []
                for k in range(shape[i]):
                    c = list(fixed)
                    c[i] = k
                    ranks.append(_ravel(c, shape))
                g = dist.new_group([members[r] for r in ranks])
                if rank in ranks:
                    sub = g
        axes.append(GraphMesh(shape[i], coords[i], dev, sub, axis=name,
                              stats=stats))
    return LMMesh(tuple(names), tuple(axes), rank, dev, group, stats)


def _unravel(rank: int, shape) -> list:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return out[::-1]


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def make_mesh(shape, axis_names, *, group=None, device=None) -> LMMesh:
    """The mesh of ``shape`` with axes ``axis_names`` over every rank of
    the process group (default: the default group, or this process alone),
    row-major (the reference's ``make_mesh``; the pipeline's ``("pod",
    "data")`` mesh, for one)."""
    shape, names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} must "
                         f"pair up, the names distinct")
    group, n = _world(group)
    if min(shape, default=1) < 1 or math.prod(shape) != n:
        raise ValueError(f"the mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {n}")
    return _lm_mesh(shape, names, group, device)


def make_host_mesh(model_axis: int = 1, *, group=None,
                   device=None) -> LMMesh:
    """Every rank of the process group (default: the default group, or
    this process alone) as ``(data, model)`` of shape ``(world //
    model_axis, model_axis)``; the device as :func:`make_graph_mesh`
    picks it."""
    group, n = _world(group)
    if model_axis <= 0 or n % model_axis != 0:
        raise ValueError(
            f"model_axis={model_axis} must evenly divide the process "
            f"group's size ({n} ranks available)")
    return _lm_mesh((n // model_axis, model_axis), ("data", "model"), group,
                    device)


def make_production_mesh(multi_pod: bool = False, *, group=None,
                         device=None) -> LMMesh:
    """The reference's production mesh: ``(data, model) = (16, 16)``, or
    ``(pod, data, model) = (2, 16, 16)`` with ``multi_pod``, over a
    process group of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    group, n = _world(group)
    if n != math.prod(shape):
        raise ValueError(
            f"the production mesh {shape} needs {math.prod(shape)} ranks; "
            f"the process group has {n}")
    return _lm_mesh(shape, names, group, device)


def sharded(mesh: Optional[LMMesh]) -> Optional[LMMesh]:
    """``mesh`` when it has more than one rank, else ``None``: a one-rank
    mesh takes the one-device path, with no collective and no copy."""
    return mesh if mesh is not None and mesh.size > 1 else None


def launcher_backend(world: int, device=None) -> str:
    """The backend a launcher joins ``world`` ranks over: NCCL when each
    rank has a card of its own, else ``gloo`` (ranks that share a card, or
    CPU ranks; NCCL refuses two ranks on one card)."""
    on_card = device is None or str(device).startswith("cuda")
    if (on_card and torch.cuda.is_available()
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


def launcher_mesh(kind: str, model_axis: int = 1, device=None) -> LMMesh:
    """The mesh a launcher's ``--mesh kind`` names (``host``, ``single``,
    ``multi``), over the default process group, which is joined here when
    ``torchrun`` started more than one process (``WORLD_SIZE`` above 1),
    over :func:`launcher_backend`'s pick."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and world > 1:
        backend = launcher_backend(world, device)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
    if kind == "host":
        return make_host_mesh(model_axis, device=device)
    return make_production_mesh(multi_pod=kind == "multi", device=device)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How one tensor lies on an :class:`LMMesh`: ``spec[i]`` names the
    axis (or the tuple of axes, major first) that dimension ``i`` is cut
    over, ``None`` (or a missing entry) leaves it whole."""

    mesh: LMMesh
    spec: tuple

    def dim_axes(self, i: int) -> Tuple[str, ...]:
        """The axes dimension ``i`` is cut over, major first."""
        if i >= len(self.spec) or self.spec[i] is None:
            return ()
        a = self.spec[i]
        return tuple(a) if isinstance(a, tuple) else (a,)

    def _parts(self, i: int) -> Tuple[int, int]:
        """(blocks, this rank's block) of dimension ``i``."""
        n, idx = 1, 0
        for a in self.dim_axes(i):
            n *= self.mesh.axis_size(a)
            idx = idx * self.mesh.axis_size(a) + self.mesh.coord(a)
        return n, idx

    @property
    def primary(self) -> bool:
        """Whether this rank is the first (coordinate 0 on every axis the
        tensor is not cut over) of the ranks that hold the same block."""
        cut = {a for i in range(len(self.spec)) for a in self.dim_axes(i)}
        return all(self.mesh.coord(a) == 0
                   for a in self.mesh.axis_names if a not in cut)

    def local_shape(self, shape) -> Tuple[int, ...]:
        out = []
        for i, d in enumerate(shape):
            n, _ = self._parts(i)
            if d % n:
                raise ValueError(
                    f"dimension {i} of {tuple(shape)} does not split over "
                    f"{self.dim_axes(i)} ({n} blocks; spec {self.spec})")
            out.append(d // n)
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (``full`` itself when nothing is
        cut)."""
        local = self.local_shape(full.shape)
        if local == tuple(full.shape):
            return full
        out = full
        for i, d in enumerate(local):
            if d != full.shape[i]:
                _, idx = self._parts(i)
                out = out.narrow(i, idx * d, d)
        return out.contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (a collective: every
        rank of the axes involved calls it)."""
        out = local
        for i in range(local.dim()):
            for a in reversed(self.dim_axes(i)):     # minor axis first
                out = self.mesh.all_gather(out, a, dim=i)
        return out
