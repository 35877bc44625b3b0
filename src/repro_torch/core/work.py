"""Work definition: atoms, tiles and tile sets (paper §3.1).

* **work atom** — one schedulable unit of work (one non-zero, one edge).
* **work tile** — a logical set of atoms (one matrix row, one vertex).
* **tile set** — the whole problem.

The encoding is one *segment-offset array*: ``tile_offsets[t]`` is the
first atom of tile ``t``, so tile ``t`` owns atoms
``[tile_offsets[t], tile_offsets[t+1])``.  Every sparse format lowers to
it, after which every schedule (:mod:`repro_torch.core.schedules`) applies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import as_int32


@dataclasses.dataclass(frozen=True)
class WorkSpec:
    """A tile set: ``num_tiles`` tiles over ``num_atoms`` atoms.

    ``tile_offsets`` is an int32 tensor ``[num_tiles + 1]`` with
    ``tile_offsets[0] == 0`` and ``tile_offsets[-1] == num_atoms``; empty
    tiles (repeated offsets) are legal.  ``num_atoms``/``num_tiles`` are
    Python ints: schedules size grids and windows from them.
    """

    tile_offsets: torch.Tensor  # int32 [num_tiles + 1]
    num_atoms: int
    num_tiles: int

    @property
    def device(self) -> torch.device:
        return self.tile_offsets.device

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_segment_offsets(cls, offsets, *, num_atoms: int,
                             num_tiles: Optional[int] = None,
                             device=None) -> "WorkSpec":
        offsets = as_int32(offsets, device)
        if num_tiles is None:
            num_tiles = int(offsets.shape[0]) - 1
        return cls(tile_offsets=offsets, num_atoms=int(num_atoms),
                   num_tiles=int(num_tiles))

    @classmethod
    def from_csr(cls, row_offsets, nnz: int) -> "WorkSpec":
        """CSR: atoms = non-zeros, tiles = rows (paper Listing 1)."""
        return cls.from_segment_offsets(row_offsets, num_atoms=nnz)

    @classmethod
    def from_segment_sizes(cls, sizes, *, num_atoms: int,
                           device=None) -> "WorkSpec":
        """E.g. MoE: ``sizes[e]`` = number of tokens routed to expert ``e``."""
        sizes = as_int32(sizes, device)
        offsets = torch.cat([sizes.new_zeros(1),
                             torch.cumsum(sizes, 0, dtype=torch.int32)])
        return cls.from_segment_offsets(offsets, num_atoms=num_atoms,
                                        num_tiles=int(sizes.shape[0]))

    @classmethod
    def from_sorted_tile_ids(cls, tile_ids, *, num_tiles: int,
                             num_atoms: int, device=None) -> "WorkSpec":
        """COO-style: per-atom tile ids (must be sorted ascending)."""
        tile_ids = as_int32(tile_ids, device)
        sizes = torch.bincount(tile_ids, minlength=num_tiles)[:num_tiles]
        return cls.from_segment_sizes(sizes, num_atoms=num_atoms)

    # -- derived quantities ---------------------------------------------------
    def atoms_per_tile(self) -> torch.Tensor:
        return self.tile_offsets[1:] - self.tile_offsets[:-1]

    def atom_tile_ids(self) -> torch.Tensor:
        """Atom -> owning tile id, int32 ``[num_atoms]``:
        ``max { t : tile_offsets[t] <= a }``."""
        atoms = torch.arange(self.num_atoms, dtype=torch.int32,
                             device=self.device)
        return torch.searchsorted(self.tile_offsets, atoms, right=True,
                                  out_int32=True) - 1

    def total_work(self) -> int:
        """Merge-path work measure: one unit per atom + one per tile."""
        return self.num_atoms + self.num_tiles


def validate_workspec(spec: WorkSpec) -> None:
    """Host-side structural validation (tests and data loaders)."""
    off = spec.tile_offsets.cpu().numpy()
    if off.ndim != 1 or off.shape[0] != spec.num_tiles + 1:
        raise ValueError("offset shape")
    if off[0] != 0:
        raise ValueError("offsets must start at 0")
    if off[-1] != spec.num_atoms:
        raise ValueError("offsets must end at num_atoms")
    if not np.all(np.diff(off) >= 0):
        raise ValueError("offsets must be non-decreasing")
