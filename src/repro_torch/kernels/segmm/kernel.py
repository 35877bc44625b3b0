"""Wrappers of the two segmented-matmul CUDA kernels, each beside its plain
version.

============================  ==================  ==========================
launch counter                CUDA source         replaces (reference)
============================  ==================  ==========================
``segmented_matmul``          ``csrc/segmm.cu``   ``segmented_matmul``
``segmented_matmul_chunked``  ``csrc/segmm.cu``   ``segmented_matmul_chunked``
``segmm_mma``                 ``csrc/segmm.cu``   (either, bf16 x bf16)
============================  ==================  ==========================

Both kernels share one tile routine for each pair of operand types, and
the pair alone picks it (:func:`kernel_for`): bf16 x bf16 runs on the
tensor cores (``mma.sync`` m16n8k16, f32 accumulators) and adds one to
``segmm_mma`` on top of the kernel's own counter; float32 x float32 and
the mixed pairs run a float32 FMA chain on the CUDA cores.  On the H100
the bf16 pair is bound by its bytes (bf16 operands read once, the f32
output written once) at the MoE widths, and the CUDA-core pairs by
float32 operations (67 TFLOP/s); ``csrc/segmm.cu``'s header says what each
design does about its bound.

A wrapper checks its operands as the reference does (``m_pad % bm == 0``,
``bk = min(bk, K)``, ``bn = min(bn, N)``, ``K % bk == 0``, ``N % bn ==
0``), allocates the output, and for CUDA tensors launches the kernel on the
current stream and adds one to :data:`LAUNCHES`; for CPU tensors it runs
the plain version beside it (``*_plain``), which is also what the kernel is
tested against.  For ``meta`` tensors (the dry run) it returns an empty
output, launches nothing and adds the kernel's flop and bytes to
:data:`repro_torch.kernels.tally.TALLY`.  Other devices raise.
``bn``/``bk`` only have to pass the checks: the kernels pick their own
tiles.  Every output element is one ascending-k float32 chain whatever
``bm``, ``bn``, ``bk``, the policy and the queue are: of FMAs on the CUDA
cores, of ``mma`` k-steps of 16 exact bf16 products on the tensor cores.
So K6 is bitwise equal to K5 for every pair of types, and the tensor-core
result differs from the plain version (``torch.matmul`` in float32) only
in the order of its float32 additions: within ``2 K 2**-24 sum|a b|``,
bitwise on integer-valued operands.

Launch geometry (plain Python, so the CPU tests reach it): both kernels
compute 128 x 128 output tiles from groups of :func:`block_group` M-blocks.
K5 runs one CTA per (group of consecutive M-blocks, N tile).  K6 keeps the
schedule's physical queues and their pop order, and drains each (queue, N
tile) pair with a team of CTAs (:func:`queue_team`), CTA ``t`` popping slot
group ``t`` (:func:`queue_pops`), so that the queues fill the card instead
of running one CTA each.

An M-block whose expert id lies outside ``[0, E)`` gets zero rows, and so
do the rows of M-blocks that no queue pops in the chunked variant.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build, tally

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

#: Every CUDA source of this package, built in parallel by :func:`build`.
SOURCES = (CSRC / "segmm.cu",)

#: Kernel launches since the last :func:`reset_launch_counts`:
#: ``segmented_matmul`` (K5) and ``segmented_matmul_chunked`` (K6) count
#: every launch, ``segmm_mma`` those of either that ran on the tensor cores.
LAUNCHES = {"segmented_matmul": 0, "segmented_matmul_chunked": 0,
            "segmm_mma": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: Output tile of both kernels (``kTM`` x ``kTN`` in ``csrc/segmm.cu``).
TILE_M = TILE_N = 128

#: CUDA's limit on a 1-D grid (``gridDim.x``).
MAX_GRID = 2 ** 31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "segmm_blocks": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                     _P],
    "segmm_queues": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> dict:
    """Compile every source now; ``{stem: ptxas report}``."""
    return _build.build(SOURCES)


def _fn(name: str):
    fn = getattr(_build.load(CSRC / "segmm.cu"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, *args) -> None:
    rc = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# Launch geometry.
# ---------------------------------------------------------------------------

def block_group(bm: int) -> int:
    """M-blocks a CTA takes at once: enough to fill a ``TILE_M``-row tile
    when ``bm < TILE_M`` (16 at the wavefront's ``bm = 8``), else one."""
    return max(1, TILE_M // bm)


def column_tiles(n_dim: int) -> int:
    """N tiles of ``TILE_N`` columns."""
    return -(-n_dim // TILE_N)


def blocks_grid(num_blocks: int, bm: int, n_dim: int) -> int:
    """K5's 1-D grid: one CTA per (group of consecutive M-blocks, N
    tile)."""
    return -(-num_blocks // block_group(bm)) * column_tiles(n_dim)


def queue_team(max_chunks: int, bm: int) -> int:
    """K6's CTAs per (queue, N tile): one per slot group of
    :func:`block_group` slots, ``ceil(max_chunks / group)``.  Every slot
    group costs the same (one segmm: the same bm, K and N), so the team
    balances as a work queue would."""
    return -(-max_chunks // block_group(bm))


def queues_grid(num_physical: int, max_chunks: int, bm: int,
                n_dim: int) -> tuple[int, int]:
    """``(team, CTAs)`` of K6's 1-D grid, as ``segmm_queues`` sizes it."""
    team = queue_team(max_chunks, bm)
    return team, num_physical * team * column_tiles(n_dim)


def queue_pops(cta: int, *, num_physical: int, n_tiles: int, counts,
               max_chunks: int, bm: int) -> tuple:
    """``(queue, N tile, slots)`` that K6's CTA ``cta`` pops, in order:
    the same decode as ``segmm_kernel``'s (N tile fastest, then queue,
    then team member ``t``, which takes slot group ``t`` of ``group``
    slots below ``min(counts[queue], max_chunks)``)."""
    group = block_group(bm)
    tile, rest = cta % n_tiles, cta // n_tiles
    queue, member = rest % num_physical, rest // num_physical
    count = min(int(counts[queue]), max_chunks)
    slots = list(range(member * group, min(member * group + group, count)))
    return queue, tile, slots


def kernel_for(lhs_dtype: torch.dtype, rhs_dtype: torch.dtype) -> str:
    """The tile routine that K5 and K6 run on operands of these types:
    ``"segmm_mma"`` (bf16 x bf16: the tensor cores, counted in
    :data:`LAUNCHES` under that name) or ``"segmm_fma"`` (float32 x
    float32 and the mixed pairs: the CUDA cores' float32 FMA chain).  The
    pair of types alone decides."""
    if lhs_dtype == torch.bfloat16 and rhs_dtype == torch.bfloat16:
        return "segmm_mma"
    return "segmm_fma"


def _vector_copies(lhs: torch.Tensor, rhs: torch.Tensor) -> int:
    """1 when the kernel may copy its operands in 16-byte chunks, else 0
    (smaller loads and copies, scalar stores: the same arithmetic).  The
    CUDA-core routine copies quads and stores float4s: K % 4 == 0, N % 4
    == 0 and every float32 operand 16-byte aligned.  The tensor-core
    routine copies 8 bf16 at a time and stores float2s: K % 8 == 0, N % 8
    == 0 and both operands 16-byte aligned."""
    if kernel_for(lhs.dtype, rhs.dtype) == "segmm_mma":
        aligned = lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0
        return int(lhs.shape[1] % 8 == 0 and rhs.shape[2] % 8 == 0
                   and aligned)
    aligned = all(t.dtype != torch.float32 or t.data_ptr() % 16 == 0
                  for t in (lhs, rhs))
    return int(lhs.shape[1] % 4 == 0 and rhs.shape[2] % 4 == 0 and aligned)


def _count(name: str, lhs: torch.Tensor, rhs: torch.Tensor) -> None:
    """One launch of ``name``, and of ``segmm_mma`` on the tensor cores."""
    LAUNCHES[name] += 1
    if kernel_for(lhs.dtype, rhs.dtype) == "segmm_mma":
        LAUNCHES["segmm_mma"] += 1


def _int32(x: int, what: str) -> int:
    if not 0 <= x < 2 ** 31:
        raise ValueError(f"{what}={x} does not fit the kernel's int32")
    return x


def _grid(ctas: int) -> int:
    if ctas > MAX_GRID:
        raise ValueError(f"{ctas} CTAs exceed CUDA's 1-D grid limit "
                         f"{MAX_GRID}")
    return ctas


def _on_card(device: torch.device) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def _meta_out(name: str, lhs_padded: torch.Tensor, rhs: torch.Tensor,
              *operands: torch.Tensor) -> torch.Tensor:
    """The ``meta`` path of both kernels: an empty f32 ``[M_pad, N]``, no
    launch, and ``2 M_pad K N`` flop in :data:`tally.TALLY` (each
    M-block's rows against one expert's ``[K, N]``)."""
    m_pad, k_dim = lhs_padded.shape
    n_dim = rhs.shape[2]
    out = torch.empty((m_pad, n_dim), dtype=torch.float32,
                      device=lhs_padded.device)
    tally.add(name, 2 * m_pad * k_dim * n_dim,
              tally.nbytes(lhs_padded, rhs, out, *operands))
    return out


def _check_int32(t, name: str, device: torch.device,
                 length: int | None = None) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name} has {t.shape[0]} entries, expected "
                         f"{length}")


def _check_operands(lhs_padded: torch.Tensor, rhs: torch.Tensor,
                    block_expert: torch.Tensor, bm: int, bn: int,
                    bk: int) -> tuple[int, int, int, int]:
    """The reference's shape assertions plus type/device/layout checks;
    returns ``(m_pad, K, N, E)``."""
    device = lhs_padded.device
    for t, name, dim in ((lhs_padded, "lhs_padded", 2), (rhs, "rhs", 3)):
        if not isinstance(t, torch.Tensor) or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be a float32 or bfloat16 tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
    m_pad, k_dim = lhs_padded.shape
    e_dim, rk, n_dim = rhs.shape
    if rk != k_dim:
        raise ValueError(f"rhs depth {rk} != lhs width {k_dim}")
    if bm < 1 or m_pad % bm:
        raise ValueError(f"m_pad={m_pad} is not a multiple of bm={bm}")
    bk, bn = min(bk, k_dim), min(bn, n_dim)
    if bk < 1 or bn < 1 or k_dim % bk or n_dim % bn:
        raise ValueError(f"K={k_dim} and N={n_dim} must be multiples of "
                         f"bk={bk} and bn={bn}")
    _check_int32(block_expert, "block_expert", device, m_pad // bm)
    return m_pad, k_dim, n_dim, e_dim


# ---------------------------------------------------------------------------
# K5: one CTA per (group of consecutive M-blocks, N tile).
# ---------------------------------------------------------------------------

def segmented_matmul(lhs_padded: torch.Tensor, rhs: torch.Tensor,
                     block_expert: torch.Tensor, *, bm: int = 128,
                     bn: int = 128, bk: int = 512) -> torch.Tensor:
    """``out[i*bm:(i+1)*bm] = lhs[i*bm:(i+1)*bm] @ rhs[block_expert[i]]``.

    ``lhs_padded``: ``[M_pad, K]`` f32/bf16, tokens sorted by expert and
    group-padded so every M-block maps to one expert.  ``rhs``: ``[E, K,
    N]`` f32/bf16.  ``block_expert``: int32 ``[M_pad // bm]``.  Returns f32
    ``[M_pad, N]``.
    """
    m_pad, k_dim, n_dim, e_dim = _check_operands(lhs_padded, rhs,
                                                 block_expert, bm, bn, bk)
    if lhs_padded.device.type == "meta":
        return _meta_out("segmented_matmul", lhs_padded, rhs, block_expert)
    if not _on_card(lhs_padded.device):
        return segmented_matmul_plain(lhs_padded, rhs, block_expert, bm=bm,
                                      bn=bn, bk=bk)
    out = torch.empty((m_pad, n_dim), dtype=torch.float32,
                      device=lhs_padded.device)
    _int32(m_pad, "M_pad")
    _grid(blocks_grid(m_pad // bm, bm, n_dim))
    _launch("segmm_blocks", lhs_padded.data_ptr(),
            _DTYPE_CODE[lhs_padded.dtype], rhs.data_ptr(),
            _DTYPE_CODE[rhs.dtype], block_expert.data_ptr(),
            _int32(m_pad // bm, "M-blocks"), _int32(bm, "bm"),
            block_group(bm), _int32(k_dim, "K"), _int32(n_dim, "N"),
            _int32(e_dim, "E"), _vector_copies(lhs_padded, rhs),
            out.data_ptr())
    _count("segmented_matmul", lhs_padded, rhs)
    return out


def _block_products(lhs_padded: torch.Tensor, rhs: torch.Tensor,
                    block_expert: torch.Tensor, blocks: torch.Tensor,
                    bm: int) -> torch.Tensor:
    """f32 ``[M_pad, N]``: the product rows of the M-blocks ``blocks``
    (int64), zero elsewhere; one matmul per expert that holds blocks."""
    m_pad, k_dim = lhs_padded.shape
    e_dim, _, n_dim = rhs.shape
    nblk = m_pad // bm
    out = torch.zeros((nblk, bm, n_dim), dtype=torch.float32,
                      device=lhs_padded.device)
    lhs_blocks = lhs_padded.view(nblk, bm, k_dim)
    experts = block_expert.long()[blocks]
    valid = (experts >= 0) & (experts < e_dim)
    for e in torch.unique(experts[valid]).tolist():
        sel = blocks[experts == e]
        out[sel] = torch.matmul(lhs_blocks[sel].float(), rhs[e].float())
    return out.view(m_pad, n_dim)


def segmented_matmul_plain(lhs_padded: torch.Tensor, rhs: torch.Tensor,
                           block_expert: torch.Tensor, *, bm: int = 128,
                           bn: int = 128, bk: int = 512) -> torch.Tensor:
    """Plain version of :func:`segmented_matmul`."""
    m_pad, *_ = _check_operands(lhs_padded, rhs, block_expert, bm, bn, bk)
    blocks = torch.arange(m_pad // bm, device=lhs_padded.device)
    return _block_products(lhs_padded, rhs, block_expert, blocks, bm)


# ---------------------------------------------------------------------------
# K6: a team of CTAs per (physical queue, N tile), one slot group each.
# ---------------------------------------------------------------------------

def _check_queue(block_chunks_flat, chunk_counts, device,
                 max_chunks: int) -> int:
    _check_int32(chunk_counts, "chunk_counts", device)
    num_physical = int(chunk_counts.shape[0])
    if max_chunks < 1:
        raise ValueError(f"max_chunks must be >= 1, got {max_chunks}")
    _check_int32(block_chunks_flat, "block_chunks_flat", device,
                 num_physical * max_chunks)
    return num_physical


def segmented_matmul_chunked(lhs_padded: torch.Tensor, rhs: torch.Tensor,
                             block_expert: torch.Tensor,
                             block_chunks_flat: torch.Tensor,
                             chunk_counts: torch.Tensor, *, bm: int = 128,
                             bn: int = 128, bk: int = 512,
                             max_chunks: int = 1) -> torch.Tensor:
    """Chunk-walking segmented matmul over ``P`` physical queues.

    Same contract as :func:`segmented_matmul` plus the queue:
    ``block_chunks_flat`` int32 ``[P * max_chunks]`` lists each queue's
    M-blocks in pop order, ``chunk_counts`` int32 ``[P]`` the true queue
    lengths.  Output rows are in the original M-block order, bitwise equal
    to :func:`segmented_matmul` for every M-block some queue pops, zero
    elsewhere.  On the card each queue is drained by a team of CTAs per N
    tile (:func:`queues_grid`); the queues and their order are the
    schedule's, untouched.
    """
    m_pad, k_dim, n_dim, e_dim = _check_operands(lhs_padded, rhs,
                                                 block_expert, bm, bn, bk)
    num_physical = _check_queue(block_chunks_flat, chunk_counts,
                                lhs_padded.device, max_chunks)
    if lhs_padded.device.type == "meta":
        return _meta_out("segmented_matmul_chunked", lhs_padded, rhs,
                         block_expert, block_chunks_flat, chunk_counts)
    if not _on_card(lhs_padded.device):
        return segmented_matmul_chunked_plain(
            lhs_padded, rhs, block_expert, block_chunks_flat, chunk_counts,
            bm=bm, bn=bn, bk=bk, max_chunks=max_chunks)
    out = torch.zeros((m_pad, n_dim), dtype=torch.float32,
                      device=lhs_padded.device)
    _int32(m_pad, "M_pad")
    _grid(queues_grid(num_physical, max_chunks, bm, n_dim)[1])
    _launch("segmm_queues", lhs_padded.data_ptr(),
            _DTYPE_CODE[lhs_padded.dtype], rhs.data_ptr(),
            _DTYPE_CODE[rhs.dtype], block_expert.data_ptr(),
            block_chunks_flat.data_ptr(), chunk_counts.data_ptr(),
            _int32(num_physical, "num_physical"),
            _int32(max_chunks, "max_chunks"),
            _int32(m_pad // bm, "M-blocks"), _int32(bm, "bm"),
            block_group(bm), _int32(k_dim, "K"), _int32(n_dim, "N"),
            _int32(e_dim, "E"), _vector_copies(lhs_padded, rhs),
            out.data_ptr())
    _count("segmented_matmul_chunked", lhs_padded, rhs)
    return out


def _popped_blocks(block_chunks_flat: torch.Tensor,
                   chunk_counts: torch.Tensor, max_chunks: int,
                   num_blocks: int) -> torch.Tensor:
    """Sorted int64 ids of the M-blocks some queue pops."""
    queues = block_chunks_flat.long().view(-1, max_chunks)
    slot = torch.arange(max_chunks, device=queues.device)
    popped = queues[slot[None, :] < chunk_counts.long()[:, None]]
    popped = popped[(popped >= 0) & (popped < num_blocks)]
    return torch.unique(popped)


def segmented_matmul_chunked_plain(lhs_padded, rhs, block_expert,
                                   block_chunks_flat, chunk_counts, *,
                                   bm: int = 128, bn: int = 128,
                                   bk: int = 512,
                                   max_chunks: int = 1) -> torch.Tensor:
    """Plain version of :func:`segmented_matmul_chunked`."""
    m_pad, *_ = _check_operands(lhs_padded, rhs, block_expert, bm, bn, bk)
    _check_queue(block_chunks_flat, chunk_counts, lhs_padded.device,
                 max_chunks)
    blocks = _popped_blocks(block_chunks_flat, chunk_counts, max_chunks,
                            m_pad // bm)
    return _block_products(lhs_padded, rhs, block_expert, blocks, bm)
