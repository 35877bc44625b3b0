"""Sparse matrix containers + the synthetic SuiteSparse-like corpus.

Formats lower to :class:`~repro_torch.core.work.WorkSpec` (paper §3.1):
CSR maps rows -> tiles and non-zeros -> atoms; COO sorts by row (stably)
and builds offsets with one bincount + cumsum; CSC is CSR of the
transpose.  The generators draw from numpy's RNG exactly as the reference
does, so the same seed gives the same matrix bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.work import WorkSpec


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed Sparse Row.  ``shape``/``nnz`` are Python metadata."""

    row_offsets: torch.Tensor   # int32 [rows + 1]
    col_indices: torch.Tensor   # int32 [nnz]
    values: torch.Tensor        # [nnz]
    shape: Tuple[int, int]
    nnz: int

    @property
    def device(self) -> torch.device:
        return self.row_offsets.device

    def workspec(self) -> WorkSpec:
        return WorkSpec.from_csr(self.row_offsets, nnz=self.nnz)

    @classmethod
    def from_numpy(cls, row_offsets, col_indices, values,
                   shape: Tuple[int, int], *, device=None) -> "CSR":
        """Host arrays -> CSR on ``device`` (``None``: the card)."""
        dev = resolve_device(device)
        offsets = np.array(row_offsets, np.int32)
        cols = np.array(col_indices, np.int32)
        vals = np.array(values, np.float32)
        return cls(torch.from_numpy(offsets).to(dev),
                   torch.from_numpy(cols).to(dev),
                   torch.from_numpy(vals).to(dev),
                   (int(shape[0]), int(shape[1])), int(vals.shape[0]))

    @classmethod
    def from_dense(cls, dense, *, device=None) -> "CSR":
        dense = np.asarray(dense)
        rows, cols = dense.shape
        r, c = np.nonzero(dense)
        offsets = np.zeros(rows + 1, np.int64)
        np.add.at(offsets, r + 1, 1)
        return cls.from_numpy(np.cumsum(offsets), c, dense[r, c],
                              (rows, cols), device=device)

    def to_dense(self) -> np.ndarray:
        rows, cols = self.shape
        out = np.zeros((rows, cols), np.float64)
        row = np.repeat(np.arange(rows),
                        np.diff(self.row_offsets.cpu().numpy()))
        np.add.at(out, (row, self.col_indices.cpu().numpy()),
                  self.values.cpu().numpy().astype(np.float64))
        return out

    def transpose(self) -> "CSR":
        coo = self.to_coo()
        return COO(coo.col_indices, coo.row_indices, coo.values,
                   (self.shape[1], self.shape[0]), self.nnz).to_csr()

    def to_coo(self) -> "COO":
        return COO(self.workspec().atom_tile_ids(), self.col_indices,
                   self.values, self.shape, self.nnz)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate format (row order not required on input)."""

    row_indices: torch.Tensor
    col_indices: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, int]
    nnz: int

    def to_csr(self) -> CSR:
        # stable: atoms of one row keep their input order (the pull view's
        # atom order depends on it)
        order = torch.argsort(self.row_indices, stable=True)
        sizes = torch.bincount(self.row_indices.long(),
                               minlength=self.shape[0])[:self.shape[0]]
        offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
        return CSR(offsets.to(torch.int32),
                   self.col_indices[order].to(torch.int32),
                   self.values[order], self.shape, self.nnz)

    def workspec(self) -> WorkSpec:
        return self.to_csr().workspec()


@dataclasses.dataclass(frozen=True)
class CSC:
    """CSR over the transpose; tiles are columns."""

    col_offsets: torch.Tensor
    row_indices: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, int]
    nnz: int

    def workspec(self) -> WorkSpec:
        return WorkSpec.from_csr(self.col_offsets, nnz=self.nnz)

    def to_csr_of_transpose(self) -> CSR:
        return CSR(self.col_offsets, self.row_indices, self.values,
                   (self.shape[1], self.shape[0]), self.nnz)


# ---------------------------------------------------------------------------
# Synthetic corpus: the structural axes that drive load balancing — scale,
# row-degree skew, density, empty-row fraction, the single-column vector.
# ---------------------------------------------------------------------------

def _random_csr_arrays(rows: int, cols: int, nnz_target: int, skew: float,
                       empty_frac: float, seed: int):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, rows + 1, dtype=np.float64)
    weights = ranks ** (-skew)
    rng.shuffle(weights)
    if empty_frac > 0:
        weights[rng.random(rows) < empty_frac] = 0.0
    total = weights.sum()
    if total == 0:
        weights[:] = 1.0
        total = weights.sum()
    raw = weights / total * nnz_target
    sizes = np.floor(raw + rng.random(rows)).astype(np.int64)  # stochastic
    sizes = np.minimum(sizes, cols)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    cols_out = np.empty(int(offsets[-1]), np.int32)
    for r in np.flatnonzero(sizes):   # the reference's draw order, row by row
        cols_out[offsets[r]:offsets[r + 1]] = np.sort(
            rng.choice(cols, size=sizes[r], replace=False))
    vals = rng.standard_normal(cols_out.shape[0]).astype(np.float32)
    return offsets, cols_out, vals


def random_csr(rows: int, cols: int, nnz_target: int, *, skew: float,
               empty_frac: float = 0.0, seed: int = 0, device=None) -> CSR:
    """Random CSR with Zipf-like row degrees (``skew=0`` -> uniform)."""
    offsets, cols_out, vals = _random_csr_arrays(rows, cols, nnz_target,
                                                 skew, empty_frac, seed)
    return CSR.from_numpy(offsets, cols_out, vals, (rows, cols),
                          device=device)


def suite_like_corpus(seed: int = 0, *, smoke: bool = False,
                      device=None) -> List[Tuple[str, CSR]]:
    """~13 matrices spanning the structural axes of SuiteSparse
    (``smoke=True``: three tiny ones)."""
    out: List[Tuple[str, CSR]] = []
    if smoke:
        cases = [
            ("uniform_small", 120, 120, 600, 0.0, 0.0),
            ("zipf_small", 120, 120, 900, 1.4, 0.1),
            ("tiny", 39, 39, 340, 0.3, 0.0),
        ]
        for i, (name, r, c, nnz, skew, ef) in enumerate(cases):
            out.append((name, random_csr(r, c, nnz, skew=skew, empty_frac=ef,
                                         seed=seed + i, device=device)))
        return out
    cases = [
        # name, rows, cols, nnz, skew, empty_frac
        ("uniform_small", 300, 300, 1_500, 0.0, 0.0),
        ("uniform_mid", 4_000, 4_000, 40_000, 0.0, 0.0),
        ("uniform_wide", 1_000, 20_000, 30_000, 0.0, 0.0),
        ("zipf_mild", 4_000, 4_000, 60_000, 0.6, 0.0),
        ("zipf_heavy", 4_000, 4_000, 80_000, 1.1, 0.05),
        ("zipf_extreme", 2_000, 2_000, 60_000, 1.6, 0.10),
        ("scalefree_web", 8_000, 8_000, 120_000, 1.3, 0.30),
        ("banded_fem", 6_000, 6_000, 0, 0.0, 0.0),          # built below
        ("single_col_vec", 5_000, 1, 2_500, 0.0, 0.5),       # Fig 2 edge case
        ("empty_heavy", 3_000, 3_000, 9_000, 0.9, 0.60),
        ("tall_skinny", 20_000, 64, 60_000, 0.4, 0.0),
        ("short_fat", 64, 20_000, 60_000, 0.4, 0.0),
        ("tiny", 39, 39, 340, 0.3, 0.0),                     # ~chesapeake
    ]
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    for i, (name, r, c, nnz, skew, ef) in enumerate(cases):
        if name == "banded_fem":
            # tridiagonal-ish FEM band: perfectly regular rows
            rows_idx = np.repeat(np.arange(r), 3)
            cols_idx = rows_idx + rng.integers(-1, 2, size=rows_idx.size)
            keep = (cols_idx >= 0) & (cols_idx < c)
            vals = rng.standard_normal(keep.sum()).astype(np.float32)
            as_dev = lambda a: torch.from_numpy(a).to(dev)
            coo = COO(as_dev(rows_idx[keep].astype(np.int32)),
                      as_dev(cols_idx[keep].astype(np.int32)), as_dev(vals),
                      (r, c), int(keep.sum()))
            out.append((name, coo.to_csr()))
        else:
            out.append((name, random_csr(r, c, nnz, skew=skew, empty_frac=ef,
                                         seed=seed + i, device=dev)))
    return out
