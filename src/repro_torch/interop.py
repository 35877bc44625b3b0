"""Carry the reference's state into the port.

The load-balancing core has no weights: its state is the matrix or graph
plus the inspector's partitions.  The models (the MoE layer, the TreeLSTM,
the decoder LM) have weights.  These helpers take that state as numpy arrays (what
``np.asarray`` gives for the reference's arrays) and build the port's
objects, so both sides compute on the same partition and the same weights.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

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


def _weights(params: Mapping[str, object], names, optional,
             device) -> Dict[str, torch.Tensor]:
    missing = [n for n in names if n not in params]
    if missing:
        raise KeyError(f"parameter dict lacks {missing}")
    dev = resolve_device(device)
    out = {}
    for name in (*names, *optional):
        if name in params:
            out[name] = torch.from_numpy(np.array(params[name])).to(dev)
    return out


def moe_params_from_arrays(params: Mapping[str, object], *,
                           device=None) -> Dict[str, torch.Tensor]:
    """A reference ``moe_init`` parameter dict (arrays as numpy) -> the
    port's MoE parameters on ``device``, dtypes kept (shared-expert
    weights where present)."""
    return _weights(params, ("router", "w1", "w3", "w2"),
                    ("sw1", "sw3", "sw2"), device)


def treelstm_params_from_arrays(params: Mapping[str, object], *,
                                device=None) -> Dict[str, torch.Tensor]:
    """A reference ``init_treelstm`` dict (``w`` ``[O, F, F]``, ``b``
    ``[O, F]``) -> the port's TreeLSTM parameters on ``device``."""
    return _weights(params, ("w", "b"), (), device)


#: Top-level entries every LM parameter tree has.
LM_REQUIRED = ("embed", "lm_head", "ln_f", "layers")


def lm_params_from_arrays(params: Mapping[str, object], *,
                          device=None) -> Dict[str, object]:
    """A reference ``lm.init_params`` tree (nested dicts, arrays as numpy,
    layer parameters stacked ``[L, ...]``) -> the port's tree on
    ``device``, the same nesting, shapes and dtypes."""
    missing = [n for n in LM_REQUIRED if n not in params]
    if missing:
        raise KeyError(f"LM parameter tree lacks {missing}")
    dev = resolve_device(device)

    def convert(tree):
        if isinstance(tree, Mapping):
            return {name: convert(value) for name, value in tree.items()}
        return torch.from_numpy(np.array(tree)).to(dev)

    return convert(params)
