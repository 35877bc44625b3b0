"""The 1-axis ``"shard"`` mesh of the sharded graph traversal.

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
not the queued work that produces its operand).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

__all__ = ["CollectiveStats", "GraphMesh", "make_graph_mesh"]


@dataclasses.dataclass
class CollectiveStats:
    """Running totals of one mesh's collectives."""

    calls: int = 0
    bytes: int = 0              # bytes each collective returned
    seconds: float = 0.0        # host clock, synchronized on both sides

    def reset(self) -> None:
        self.calls = self.bytes = 0
        self.seconds = 0.0


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
        self._count(t0, out)
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
        self._count(t0, out)
        return out

    def _count(self, t0: float, out: torch.Tensor) -> None:
        self.stats.seconds += time.perf_counter() - t0
        self.stats.calls += 1
        self.stats.bytes += out.numel() * out.element_size()


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
