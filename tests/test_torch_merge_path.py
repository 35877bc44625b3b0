"""Port parity: the merge-path SpMV (K1) against the live reference.

On the CPU the K1 wrapper ``spmv_merge_csr`` runs its plain version, the
reference's blocked formulation (merged stream, per-block row partials,
segment-sum fixup).  Each case goes through it and through the
reference's ``spmv_merge_path(..., interpret=True)`` (the Pallas kernel in
interpret mode) on the same integer-valued CSR made from a numpy seed, so
the results must agree bitwise: every partial sum is an exactly
representable integer.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmv_merge import ops as JO
from repro_torch.interop import csr_from_arrays
from repro_torch.kernels.spmv_merge import kernel as TK
from repro_torch.kernels.spmv_merge import ops as TO

from _torch_parity import assert_bitwise, t32

NUM_COLS = 40

#: Row sizes of the hazards: no rows, rows but no non-zeros, one hub row
#: longer than several of the card kernel's 2,048-item tiles, only the last
#: row non-empty, rows + non-zeros not a multiple of 128, power-law rows.
CASES = {
    "no_rows": [],
    "no_nonzeros": [0] * 300,
    "hub_row": [2] * 5 + [7000] + [0] * 3 + [1] * 20,
    "last_row_only": [0] * 600 + [90],
    "odd_total": [5, 0, 3] * 41 + [1],
    "power_law": (np.random.default_rng(3).zipf(1.5, 400) % 60).tolist(),
}


def _csr(sizes, seed=0, *, negative_zero=False):
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    nnz = int(offsets[-1])
    cols = rng.integers(0, NUM_COLS, nnz).astype(np.int32)
    vals = rng.integers(-4, 5, nnz).astype(np.float32)
    x = rng.integers(-3, 4, NUM_COLS).astype(np.float32)
    if negative_zero:                  # every product is -0.0
        vals[:] = -1.0
        x[:] = 0.0
    return offsets, cols, vals, x


def _reference(offsets, cols, vals, x, **kw):
    A = types.SimpleNamespace(
        row_offsets=jnp.asarray(offsets), col_indices=jnp.asarray(cols),
        values=jnp.asarray(vals), shape=(len(offsets) - 1, NUM_COLS),
        nnz=int(vals.shape[0]))
    return JO.spmv_merge_path(A, jnp.asarray(x), interpret=True, **kw)


@pytest.mark.parametrize("split", [dict(block_items=128),
                                   dict(block_items=512),
                                   dict(num_blocks=7)], ids=str)
@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_matches_reference(name, split):
    offsets, cols, vals, x = _csr(CASES[name])
    num_rows = len(offsets) - 1
    block_items = split.get("block_items")
    if block_items is None:
        A = types.SimpleNamespace(shape=(num_rows, NUM_COLS),
                                  nnz=int(vals.shape[0]))
        block_items = TO.merge_block_items(A, split["num_blocks"])
    before = dict(TK.LAUNCHES)
    got = TK.spmv_merge_csr(t32(offsets), t32(cols), t32(vals), t32(x),
                            num_rows=num_rows, num_cols=NUM_COLS,
                            block_items=block_items)
    assert TK.LAUNCHES == before           # the CPU runs the plain version
    assert got.shape == (num_rows,) and got.dtype == torch.float32
    assert_bitwise(got, _reference(offsets, cols, vals, x, **split), name)


def test_negative_zero_products_give_positive_zero():
    offsets, cols, vals, x = _csr([2, 0, 1] * 50 + [300],
                                  negative_zero=True)
    num_rows = len(offsets) - 1
    got = TK.spmv_merge_csr(t32(offsets), t32(cols), t32(vals), t32(x),
                            num_rows=num_rows, num_cols=NUM_COLS,
                            block_items=128)
    assert (got.view(torch.int32) == 0).all()
    assert_bitwise(got, _reference(offsets, cols, vals, x, block_items=128))


@pytest.mark.parametrize("num_blocks", [None, 5])
def test_spmv_merge_path_matches_reference(num_blocks):
    """The slice's entry point, ``schedule=None``, through the wrapper."""
    sizes = CASES["power_law"] + CASES["hub_row"]
    offsets, cols, vals, x = _csr(sizes, seed=4)
    A = csr_from_arrays(offsets, cols, vals, (len(sizes), NUM_COLS),
                        device="cpu")
    got = TO.spmv_merge_path(A, t32(x), num_blocks=num_blocks)
    assert_bitwise(got, _reference(offsets, cols, vals, x,
                                   num_blocks=num_blocks))


def test_wrapper_checks_operands():
    offsets, cols, vals, x = (t32(a) for a in _csr([3, 0, 2]))
    kw = dict(num_rows=3, num_cols=NUM_COLS)
    with pytest.raises(TypeError, match="int32"):
        TK.spmv_merge_csr(offsets.long(), cols, vals, x, **kw)
    with pytest.raises(TypeError, match="float32"):
        TK.spmv_merge_csr(offsets, cols, vals.double(), x, **kw)
    with pytest.raises(TypeError, match="float32"):
        TK.spmv_merge_csr(offsets, cols, vals, x.half(), **kw)
    with pytest.raises(ValueError, match="row_offsets has 4 entries"):
        TK.spmv_merge_csr(offsets, cols, vals, x, num_rows=2,
                          num_cols=NUM_COLS)
    with pytest.raises(ValueError, match="col_indices"):
        TK.spmv_merge_csr(offsets, cols[:-1], vals, x, **kw)
    with pytest.raises(ValueError, match="fewer than"):
        TK.spmv_merge_csr(offsets, cols, vals, x[:-1], **kw)
    with pytest.raises(ValueError, match="expected cpu"):
        TK.spmv_merge_csr(offsets, cols, vals.to("meta"), x, **kw)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        TK.spmv_merge_csr(*[t.to("meta") for t in (offsets, cols, vals, x)],
                          **kw)
    with pytest.raises(ValueError, match="block_items"):
        TK.spmv_merge_csr(offsets, cols, vals, x, block_items=0, **kw)
    # rows + non-zeros must stay below 2**31 (meta tensors hold no memory)
    nnz = 2 ** 31 - 3
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="num_rows \\+ nnz"):
        TK.spmv_merge_csr(torch.empty(4, dtype=torch.int32, **meta),
                          torch.empty(nnz, dtype=torch.int32, **meta),
                          torch.empty(nnz, **meta),
                          torch.empty(NUM_COLS, **meta), **kw)
