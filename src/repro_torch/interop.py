"""Carry the reference's state into the port.

This system has no weights: its state is the matrix or graph plus the
inspector's partitions.  These helpers take that state as numpy arrays
(what ``np.asarray`` gives for the reference's arrays) and build the
port's objects, so both sides can compute on the same partition.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.schedules import Partition, Schedule
from repro_torch.core.work import WorkSpec
from repro_torch.sparse.formats import CSR

#: Partition fields that hold arrays (the rest are Python scalars).
PARTITION_ARRAYS = ("atom_starts", "tile_starts", "block_map",
                    "block_chunks", "block_chunk_counts")
#: Partition fields that hold Python scalars.
PARTITION_SCALARS = ("schedule", "num_blocks", "items_per_block",
                     "tile_aligned", "num_physical_blocks", "atom_span",
                     "tile_span")


def _tensor(array, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(array, np.int32)).to(device)


def csr_from_arrays(row_offsets, col_indices, values,
                    shape: Tuple[int, int], *, device=None) -> CSR:
    """A reference CSR's arrays -> the port's CSR on ``device``."""
    return CSR.from_numpy(row_offsets, col_indices, values, shape,
                          device=device)


def workspec_from_arrays(tile_offsets, *, num_atoms: int | None = None,
                         device=None) -> WorkSpec:
    """A reference WorkSpec's offsets -> the port's WorkSpec."""
    offsets = np.asarray(tile_offsets)
    if num_atoms is None:
        num_atoms = int(offsets[-1]) if offsets.size else 0
    return WorkSpec.from_segment_offsets(
        _tensor(offsets, resolve_device(device)), num_atoms=num_atoms)


def partition_from_arrays(fields: Mapping[str, object], *,
                          device=None) -> Partition:
    """A reference Partition's fields (arrays as numpy, scalars as Python
    values; ``None`` where absent) -> the port's Partition, span hints and
    queue view included."""
    dev = resolve_device(device)
    kwargs = {name: fields.get(name) for name in PARTITION_SCALARS}
    kwargs["schedule"] = Schedule(str(kwargs["schedule"]))
    for name in PARTITION_ARRAYS:
        value = fields.get(name)
        kwargs[name] = None if value is None else _tensor(value, dev)
    return Partition(**kwargs)


def partition_to_arrays(part) -> dict:
    """Any Partition (the reference's or the port's) -> the field dict
    :func:`partition_from_arrays` takes."""
    out = {}
    for name in PARTITION_SCALARS:
        value = getattr(part, name)
        out[name] = str(value) if name == "schedule" else value
    for name in PARTITION_ARRAYS:
        value = getattr(part, name)
        if isinstance(value, torch.Tensor):
            value = value.cpu().numpy()
        out[name] = None if value is None else np.asarray(value)
    return out
