"""Wrappers of the five CUDA kernels, each beside its plain version.

========================  ==========================  =====================
launch counter            CUDA source                 replaces (reference)
========================  ==========================  =====================
``spmv_merge_stream``     ``csrc/merge_path.cu``      ``spmv_merge_stream``
``chunk_walk_tiles``      ``csrc/chunk_walk.cu``      ``chunk_walk_reduce``
                                                      ``emit="tiles"``
``chunk_walk_atoms``      ``csrc/chunk_walk.cu``      ``emit="atoms"``
``chunk_walk_compact``    ``csrc/chunk_walk.cu``      ``emit="compact"``
``segment_sum_sorted``    ``csrc/segsum.cu``          none: the ordered
                                                      float segment sum of
                                                      ``core.segops`` on
                                                      the card
========================  ==========================  =====================

A wrapper checks its operands, allocates the output with ``torch.empty``,
and for CUDA tensors launches the kernel on the current stream and adds one
to :data:`LAUNCHES`; for CPU tensors it runs the plain version (the
``*_ref`` function beside it), which is also what the kernel is tested
against.  Other devices raise.  The plain versions reduce with
``core.segops.segment_reduce`` into flattened bins, in ``O(operands +
output)`` memory; on the card its float sums go through
:func:`segment_sum_sorted`.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core.segops import (IDENTITY, segment_reduce, segment_sum,
                                     window_slots)
from repro_torch.kernels import _build
from repro_torch.kernels.spmv_merge import ref as _ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

#: Every CUDA source of this package, built in parallel by :func:`build`.
SOURCES = (CSRC / "merge_path.cu", CSRC / "chunk_walk.cu",
           CSRC / "segsum.cu")

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"spmv_merge_stream": 0, "chunk_walk_tiles": 0,
            "chunk_walk_atoms": 0, "chunk_walk_compact": 0,
            "segment_sum_sorted": 0}

_COMBINER_CODE = {"sum": 0, "min": 1, "max": 2}
_EMITS = ("tiles", "atoms", "compact")
_SUM_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spmv_merge_csr": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "spmv_merge_csr_tile": [],
    "chunk_walk_tiles": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P, _P],
    "chunk_walk_atoms": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "chunk_walk_compact": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "segment_sum_sorted": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "segment_sum_sorted_tile": [],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> dict:
    """Compile every source now (in parallel); ``{stem: ptxas report}``."""
    return _build.build(SOURCES)


def _function(stem: str, name: str):
    fn = getattr(_build.load(CSRC / f"{stem}.cu"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(stem: str, name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = _function(stem, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _int32(x: int, what: str) -> int:
    if not 0 <= x < 2 ** 31:
        raise ValueError(f"{what}={x} does not fit the kernel's int32")
    return x


def _check(t, name: str, dtype: torch.dtype, device: torch.device,
           length: int | None = None, *, batched: bool = False) -> None:
    """Type, device, length and contiguity; ``batched`` also takes a 2-D
    ``[length, B]`` tensor (B columns per entry)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dims = (1, 2) if batched else (1,)
    if t.dim() not in dims or not t.is_contiguous():
        shape = "1-D or 2-D" if batched else "1-D"
        raise ValueError(f"{name} must be a contiguous {shape} tensor")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name} has {t.shape[0]} entries, expected "
                         f"{length}")


def _on_card(device: torch.device) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


# ---------------------------------------------------------------------------
# K1: merge-path SpMV.
# ---------------------------------------------------------------------------

@functools.cache
def merge_path_tile() -> int:
    """Merge items (rows + non-zeros) per CTA of the card's K1."""
    return int(_function("merge_path", "spmv_merge_csr_tile")())


def spmv_merge_csr(row_offsets: torch.Tensor, col_indices: torch.Tensor,
                   values: torch.Tensor, x: torch.Tensor, *, num_rows: int,
                   num_cols: int, block_items: int = 512) -> torch.Tensor:
    """``y = A @ x`` for the CSR ``(row_offsets, col_indices, values)``
    of shape ``(num_rows, num_cols)``: f32 ``[num_rows]``.

    ``row_offsets`` int32 ``[num_rows + 1]`` (``row_offsets[-1]`` equal to
    the non-zero count), ``col_indices`` int32 and ``values`` f32
    ``[nnz]``, ``x`` f32 with at least ``num_cols`` entries.  On the card
    the kernel cuts the merge path into its own tiles
    (:func:`merge_path_tile`); ``block_items`` sets the blocks of the plain
    version (:func:`spmv_merge_csr_ref`) only.
    """
    device = row_offsets.device
    nnz = int(values.shape[0])
    _check(row_offsets, "row_offsets", torch.int32, device, num_rows + 1)
    _check(col_indices, "col_indices", torch.int32, device, nnz)
    _check(values, "values", torch.float32, device, nnz)
    _check(x, "x", torch.float32, device)
    if x.shape[0] < num_cols:
        raise ValueError(f"x has {x.shape[0]} entries, fewer than the "
                         f"{num_cols} columns")
    if block_items < 1:
        raise ValueError(f"block_items={block_items} must be positive")
    total = _int32(num_rows + nnz, "num_rows + nnz")
    if not _on_card(device):
        return spmv_merge_csr_ref(row_offsets, col_indices, values, x,
                                  num_rows=num_rows, block_items=block_items)
    y = torch.empty(num_rows, dtype=torch.float32, device=device)
    if total == 0:
        return y
    grid = -(-total // merge_path_tile())
    carry_row = torch.empty(grid, dtype=torch.int32, device=device)
    carry_val = torch.empty(grid, dtype=torch.float32, device=device)
    _launch("merge_path", "spmv_merge_csr", row_offsets.data_ptr(),
            col_indices.data_ptr(), values.data_ptr(), x.data_ptr(),
            num_rows, nnz, carry_row.data_ptr(), carry_val.data_ptr(),
            y.data_ptr())
    LAUNCHES["spmv_merge_stream"] += 1
    return y


def spmv_merge_csr_ref(row_offsets: torch.Tensor, col_indices: torch.Tensor,
                       values: torch.Tensor, x: torch.Tensor, *,
                       num_rows: int, block_items: int = 512) -> torch.Tensor:
    """Plain version of :func:`spmv_merge_csr`: the reference's blocked
    formulation — the merged stream cut into ``block_items`` windows, per
    block row partials, and the segment-sum fixup."""
    nnz = int(values.shape[0])
    total = _round_up(max(num_rows + nnz, 1), block_items)
    stream_vals, stream_rows = _ref.merge_stream_ref(
        row_offsets, col_indices, values, x, num_rows, nnz, total)
    # a block may begin on padding (row == num_rows): clamp its base so its
    # bins stay in range (its values are all zero regardless)
    row_base = torch.clamp(stream_rows[::block_items],
                           max=max(num_rows - 1, 0)).contiguous()
    return spmv_merge_stream_ref(stream_vals, stream_rows, row_base,
                                 num_rows=num_rows, block_items=block_items)


def merge_block_partials_ref(stream_vals: torch.Tensor,
                             stream_rows: torch.Tensor,
                             row_base: torch.Tensor, *,
                             block_items: int) -> torch.Tensor:
    """Per-block row partials ``[G, r_loc]`` of the merged stream, as the
    reference's block kernel writes them.

    ``stream_vals`` f32 ``[G * block_items]``, ``stream_rows`` int32 (the
    global row of each item, non-decreasing), ``row_base`` int32 ``[G]``
    (block ``b``'s first row).  Bin ``r - row_base[b]`` of row ``b`` sums
    the block's items of row ``r``; ``r_loc = round_up(block_items + 1,
    128)``.
    """
    total = int(stream_vals.shape[0])
    grid = total // block_items
    r_loc = _round_up(block_items + 1, 128)
    block = torch.arange(total, device=stream_vals.device) // block_items
    local = stream_rows.long() - row_base.long()[block]
    ok = (local >= 0) & (local < r_loc)
    bins = torch.where(ok, block * r_loc + local, grid * r_loc)
    return segment_sum(stream_vals, bins, grid * r_loc + 1)[:-1].view(
        grid, r_loc)


def spmv_merge_stream_ref(stream_vals, stream_rows, row_base, *,
                          num_rows: int, block_items: int = 512):
    """The reference's ``spmv_merge_stream`` over a pre-built merge stream:
    block partials, then the rows that cross blocks fixed up; returns ``y``
    ``[num_rows]``."""
    partials = merge_block_partials_ref(stream_vals, stream_rows, row_base,
                                        block_items=block_items)
    return _merge_fixup(partials, row_base, num_rows)


def _merge_fixup(partials: torch.Tensor, row_base: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    r_loc = int(partials.shape[1])
    gids = row_base[:, None].long() + torch.arange(
        r_loc, device=partials.device)[None, :]
    gids = torch.where(gids < num_rows, gids, num_rows)
    return segment_sum(partials.reshape(-1), gids.reshape(-1),
                       num_rows + 1)[:-1]


# ---------------------------------------------------------------------------
# K2-K4: the chunk walk.
# ---------------------------------------------------------------------------

def chunk_walk_reduce(vals_padded: torch.Tensor,
                      tids_padded: torch.Tensor | None,
                      atom_starts: torch.Tensor, tile_starts: torch.Tensor,
                      block_chunks_flat: torch.Tensor,
                      chunk_counts: torch.Tensor,
                      mask_padded: torch.Tensor | None = None,
                      idx_padded: torch.Tensor | None = None,
                      *, window: int, local_tiles: int, max_chunks: int,
                      combiner: str = "sum",
                      emit: str = "tiles") -> torch.Tensor:
    """Per-chunk partials (``emit="tiles"``, ``[C, local_tiles]``) or value
    windows (``"atoms"``/``"compact"``, ``[C, window]``) by walking each
    physical block's chunk queue.

    ``vals_padded`` f32 ``[A + window]`` (identity-padded); in tiles mode
    also ``[A + window, B]``, B columns per atom (the reference's ``vmap``
    over columns as a batch dimension), giving ``[C, local_tiles, B]``
    partials whose column ``j`` equals the 1-D call on column ``j`` (on
    the card bitwise where the combine is exact: min/max, integer-valued
    sums; real sums are added in another fixed order).  ``tids_padded``
    int32 ``[A + window]`` (tiles mode only), ``atom_starts``/
    ``tile_starts`` int32 ``[C + 1]``, ``block_chunks_flat`` int32
    ``[P * max_chunks]`` (row ``p`` is block ``p``'s queue),
    ``chunk_counts`` int32 ``[P]``, ``mask_padded`` int32 ``[A + window]``
    (optional; 0 = atom dropped), ``idx_padded`` int32 ``[capacity +
    window]`` (compact mode only: the compacted atom ids, whose chunk
    bounds ``atom_starts`` then cover).  Same contract as the reference's
    ``chunk_walk_reduce``; cross-chunk tiles are left to the caller's
    fixup.  On the card only the rows of chunks that some queue pops are
    written (the output is ``torch.empty``); the plain version fills the
    others with the identity, and the reference leaves them undefined.
    Every partition the port builds pops every chunk.
    """
    if combiner not in _COMBINER_CODE:
        raise ValueError(f"unknown combiner: {combiner!r}")
    if emit not in _EMITS:
        raise ValueError(f"unknown emit mode: {emit!r}")
    if emit == "compact" and (idx_padded is None or mask_padded is not None):
        raise ValueError("emit='compact' needs idx_padded and no "
                         "mask_padded (compaction already applied the mask)")
    if emit == "tiles" and tids_padded is None:
        raise ValueError("emit='tiles' needs tids_padded")
    device = vals_padded.device
    num_chunks = int(atom_starts.shape[0]) - 1
    num_physical = int(chunk_counts.shape[0])
    a_pad = int(vals_padded.shape[0])
    _check(vals_padded, "vals_padded", torch.float32, device,
           batched=emit == "tiles")
    _check(atom_starts, "atom_starts", torch.int32, device)
    _check(tile_starts, "tile_starts", torch.int32, device, num_chunks + 1)
    _check(block_chunks_flat, "block_chunks_flat", torch.int32, device,
           num_physical * max_chunks)
    _check(chunk_counts, "chunk_counts", torch.int32, device)
    if emit == "tiles":
        _check(tids_padded, "tids_padded", torch.int32, device, a_pad)
    if mask_padded is not None:
        _check(mask_padded, "mask_padded", torch.int32, device, a_pad)
    if idx_padded is not None:
        _check(idx_padded, "idx_padded", torch.int32, device)
    args = (vals_padded, tids_padded, atom_starts, tile_starts,
            block_chunks_flat, chunk_counts, mask_padded, idx_padded)
    kw = dict(window=window, local_tiles=local_tiles, max_chunks=max_chunks,
              combiner=combiner, emit=emit)
    if not _on_card(device):
        return chunk_walk_reduce_ref(*args, **kw)
    batch = tuple(vals_padded.shape[1:])
    shape = ((num_chunks, local_tiles) + batch if emit == "tiles"
             else (num_chunks, window))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if num_physical == 0 or num_chunks == 0 or out.numel() == 0:
        return out
    code = _COMBINER_CODE[combiner]
    queue = (_int32(num_physical, "num_physical"),
             _int32(max_chunks, "max_chunks"), _int32(window, "window"))
    if emit == "tiles":
        _launch("chunk_walk", "chunk_walk_tiles", vals_padded.data_ptr(),
                tids_padded.data_ptr(), _ptr(mask_padded),
                atom_starts.data_ptr(), tile_starts.data_ptr(),
                block_chunks_flat.data_ptr(), chunk_counts.data_ptr(),
                *queue, _int32(local_tiles, "local_tiles"),
                _int32(batch[0] if batch else 1, "columns"),
                _int32(a_pad, "padded atoms"), code, out.data_ptr())
    elif emit == "atoms":
        _launch("chunk_walk", "chunk_walk_atoms", vals_padded.data_ptr(),
                _ptr(mask_padded), atom_starts.data_ptr(),
                block_chunks_flat.data_ptr(), chunk_counts.data_ptr(),
                *queue, code, out.data_ptr())
    else:
        _launch("chunk_walk", "chunk_walk_compact", vals_padded.data_ptr(),
                idx_padded.data_ptr(), atom_starts.data_ptr(),
                block_chunks_flat.data_ptr(), chunk_counts.data_ptr(),
                *queue, code, out.data_ptr())
    LAUNCHES[f"chunk_walk_{emit}"] += 1
    return out


def _owned_chunks(block_chunks_flat: torch.Tensor, chunk_counts: torch.Tensor,
                  max_chunks: int, num_chunks: int) -> torch.Tensor:
    """Bool ``[C]``: chunks some block's queue pops (its row is written)."""
    slot = torch.arange(max(max_chunks, 1), device=chunk_counts.device)
    popped = slot[None, :] < chunk_counts.long()[:, None]
    owned = torch.zeros(num_chunks, dtype=torch.bool,
                        device=chunk_counts.device)
    queues = block_chunks_flat.long().view(-1, max(max_chunks, 1))
    owned[queues[popped]] = True
    return owned


def _chunk_slots(starts: torch.Tensor, n: int, window: int,
                 owned: torch.Tensor):
    """For items ``0..n-1`` of a chunked range: ``(chunk, offset, inside)``
    — ``inside`` when the item lies in an owned chunk, within ``window``
    of its start."""
    chunk, offset, inside = window_slots(starts, n, window)
    return chunk, offset, inside & owned[chunk]


def chunk_walk_reduce_ref(vals_padded, tids_padded, atom_starts, tile_starts,
                          block_chunks_flat, chunk_counts, mask_padded=None,
                          idx_padded=None, *, window: int, local_tiles: int,
                          max_chunks: int, combiner: str = "sum",
                          emit: str = "tiles") -> torch.Tensor:
    """Plain version of :func:`chunk_walk_reduce` (rows of chunks no queue
    pops hold the identity)."""
    identity = IDENTITY[combiner]
    num_chunks = int(atom_starts.shape[0]) - 1
    owned = _owned_chunks(block_chunks_flat, chunk_counts, max_chunks,
                          num_chunks)
    if emit == "compact":
        n = int(idx_padded.shape[0])
        chunk, offset, inside = _chunk_slots(atom_starts, n, window, owned)
        values = vals_padded[idx_padded.long()]
    else:
        n = int(vals_padded.shape[0])
        chunk, offset, inside = _chunk_slots(atom_starts, n, window, owned)
        values = vals_padded
        if mask_padded is not None:
            inside &= mask_padded != 0
    if emit == "tiles":
        L = local_tiles
        local = tids_padded.long() - tile_starts.long()[chunk]
        inside &= (local >= 0) & (local < L)
        bins = torch.where(inside, chunk * L + local, num_chunks * L)
        return segment_reduce(combiner, values, bins,
                              num_chunks * L + 1)[:-1].view(
                                  num_chunks, L, *values.shape[1:])
    out = torch.full((num_chunks, window), identity, dtype=torch.float32,
                     device=vals_padded.device)
    flat = (chunk * window + offset)[inside]
    out.view(-1)[flat] = values[inside]
    return out


# ---------------------------------------------------------------------------
# The ordered segment sum (port glue: no TPU kernel).
# ---------------------------------------------------------------------------

@functools.cache
def segment_sum_tile() -> int:
    """Path items (segments + items) per CTA of the card's ordered sum."""
    return int(_function("segsum", "segment_sum_sorted_tile")())


def segment_sum_sorted(values: torch.Tensor, keys: torch.Tensor,
                       num_segments: int,
                       order: torch.Tensor) -> torch.Tensor:
    """``out[s]`` = the sum of the items whose key is ``s``, added in item
    order; 0 for an empty segment.  ``[num_segments]`` (or ``[num_segments,
    B]``) in ``values.dtype``.

    ``keys`` int32 ``[n]``, non-decreasing, in ``[0, num_segments)``;
    item ``i``'s value is ``values[order[i]]`` (``order`` int64 ``[n]``:
    the indices of a stable sort of the unsorted ids that gave ``keys``).
    ``values`` float32 or float64, ``[n]`` or ``[n, B]``: each of the B
    columns is summed with the tile cuts and order of the 1-D call, so
    column ``j`` has the bits of the call on column ``j`` alone.  On the
    card the sum has the same bits on every run (no atomics); the plain
    version (:func:`segment_sum_sorted_ref`) is ``index_add_``, which on
    the CPU adds in item order.
    """
    device = keys.device
    n = int(keys.shape[0])
    _check(keys, "keys", torch.int32, device)
    if values.dtype not in _SUM_DTYPE_CODE:
        raise TypeError(f"values must be float32 or float64, got "
                        f"{values.dtype}")
    _check(values, "values", values.dtype, device, batched=True)
    _check(order, "order", torch.int64, device, n)
    if num_segments < 0:
        raise ValueError(f"num_segments={num_segments} is negative")
    _int32(num_segments + n, "num_segments + n")
    if not _on_card(device):
        return segment_sum_sorted_ref(values, keys, num_segments, order)
    batch = tuple(values.shape[1:])
    out = torch.empty((num_segments,) + batch, dtype=values.dtype,
                      device=device)
    if out.numel() == 0:
        return out
    cols = batch[0] if batch else 1
    grid = -(-(num_segments + n) // segment_sum_tile())
    _int32(grid * cols, "tiles x columns")
    carry_row = torch.empty(grid, dtype=torch.int32, device=device)
    carry_val = torch.empty(grid * cols, dtype=values.dtype, device=device)
    _launch("segsum", "segment_sum_sorted", keys.data_ptr(), order.data_ptr(),
            values.data_ptr(), _SUM_DTYPE_CODE[values.dtype], n,
            num_segments, cols, carry_row.data_ptr(), carry_val.data_ptr(),
            out.data_ptr())
    LAUNCHES["segment_sum_sorted"] += 1
    return out


def segment_sum_sorted_ref(values: torch.Tensor, keys: torch.Tensor,
                           num_segments: int,
                           order: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`segment_sum_sorted`."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, keys.long(), values[order])
