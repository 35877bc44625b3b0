"""Wrappers of the two segmented-matmul CUDA kernels, each beside its plain
version.

============================  =========================  ==================
launch counter                CUDA source                replaces
============================  =========================  ==================
``segmented_matmul``          ``csrc/segmm.cu``,         K5, the reference's
                              ``csrc/segmm_wgmma.cu``    ``segmented_matmul``
``segmented_matmul_chunked``  the same                   K6, its
                                                         ``..._chunked``
``segmm_wgmma``               ``csrc/segmm_wgmma.cu``    (either: a route)
``segmm_mma``                 ``csrc/segmm.cu``          (either: a route)
============================  =========================  ==================

Each kernel runs one of three tile routines, and :func:`kernel_for` picks
it from the operand types, ``bm``, ``K`` and ``N`` alone, never from an
address, so that K5 and K6 (and every policy and path of
``grouped_matmul``) run the same routine on the same shapes:

* ``"segmm_wgmma"``: bf16 x bf16 with ``bm`` a multiple of
  :data:`WGMMA_TILE_M` (128), ``K % 8 == 0`` and ``N % 8 == 0`` (TMA's
  16-byte strides).  Hopper's own tensor-core path (``wgmma`` fed by TMA,
  a persistent CTA an SM; ``csrc/segmm_wgmma.cu``).  An operand whose base
  is not 16-byte aligned is first copied into an aligned tensor (counted
  in :data:`COPIES`);
* ``"segmm_mma"``: bf16 x bf16 otherwise (the level GEMM's ``bm = 8``):
  ``mma.sync`` m16n8k16 on the tensor cores (``csrc/segmm.cu``);
* ``"segmm_fma"``: float32 x float32 and the mixed pairs: a float32 FMA
  chain on the CUDA cores (``csrc/segmm.cu``).

A launch on a tensor-core route adds one to that route's counter on top of
the kernel's own.  On the H100 the bf16 pair is bound by its bytes (bf16
operands read once, the f32 output written once) at the MoE widths, close
to its operations at 989 TFLOP/s; the CUDA-core pairs by float32 operations
(67 TFLOP/s).  The headers of ``csrc/segmm_wgmma.cu`` and ``csrc/segmm.cu``
say what each design does about its bound.

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
cores, of k-steps of 16 exact bf16 products on the tensor cores.  So K6 is
bitwise equal to K5 on every route, and a tensor-core result differs from
the plain version (``torch.matmul`` in float32) only in the order of its
float32 additions: within ``2 K 2**-24 sum|a b|``, bitwise on
integer-valued operands.

Launch geometry (plain Python, so the CPU tests reach it).  On the
``segmm.cu`` routes both kernels compute 128 x 128 output tiles from groups
of :func:`block_group` M-blocks: K5 one CTA per (group of consecutive
M-blocks, N tile), K6 a team of CTAs per (queue, N tile) (:func:`queue_team`),
CTA ``t`` popping slot group ``t`` (:func:`queue_pops`).  On the wgmma route
a work item is a 128 x 256 output tile, and ``min(items, SMs)`` persistent
CTAs walk them (:func:`wgmma_items`, :func:`wgmma_item`); K6's items are
every slot of every queue, N tile fastest, so each queue is walked in its
pop order.  The queues and their order are the schedule's, untouched.

An M-block whose expert id lies outside ``[0, E)`` gets zero rows, and so
do the rows of M-blocks that no queue pops in the chunked variant.  K6's
output is allocated uninitialised and only those rows are zeroed, not the
whole output (:func:`popped_mask` in plain Python): on the wgmma route by
the K6 kernel's idle producer warps, on the others by a pass in
``csrc/segmm.cu`` before the launch (``segmm_zero_unpopped``: a memset of
a flag per M-block, the marks, one CTA a block).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build, tally

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

#: Every CUDA source of this package, built in parallel by :func:`build`.
SOURCES = (CSRC / "segmm.cu", CSRC / "segmm_wgmma.cu")

#: Kernel launches since the last :func:`reset_launch_counts`:
#: ``segmented_matmul`` (K5) and ``segmented_matmul_chunked`` (K6) count
#: every launch, ``segmm_wgmma`` and ``segmm_mma`` those of either that
#: ran on that tensor-core route.
LAUNCHES = {"segmented_matmul": 0, "segmented_matmul_chunked": 0,
            "segmm_wgmma": 0, "segmm_mma": 0}

#: Operands the wgmma route copied into a 16-byte aligned tensor first
#: (TMA reads from 16-byte aligned bases only), since the last
#: :func:`reset_launch_counts`.
COPIES = {"segmm_wgmma": 0}

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
    "segmm_zero_unpopped": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "segmm_wgmma_blocks": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "segmm_wgmma_queues": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P, _P],
}

#: The source of each C entry point that ``segmm.cu`` does not hold.
_SOURCE_OF = {"segmm_wgmma_blocks": "segmm_wgmma.cu",
              "segmm_wgmma_queues": "segmm_wgmma.cu"}


def reset_launch_counts() -> None:
    for counter in (LAUNCHES, COPIES):
        for name in counter:
            counter[name] = 0


def build() -> dict:
    """Compile every source now; ``{stem: ptxas report}``."""
    return _build.build(SOURCES)


def _fn(name: str):
    source = CSRC / _SOURCE_OF.get(name, "segmm.cu")
    fn = getattr(_build.load(source), name)
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


def kernel_for(lhs_dtype: torch.dtype, rhs_dtype: torch.dtype, bm: int,
               k_dim: int, n_dim: int) -> str:
    """The tile routine that K5 and K6 run on these operands, from their
    types, ``bm``, ``K`` and ``N`` alone: ``"segmm_wgmma"`` (bf16 x bf16,
    ``bm % WGMMA_TILE_M == 0``, ``K % 8 == 0``, ``N % 8 == 0``: wgmma fed
    by TMA), ``"segmm_mma"`` (bf16 x bf16 otherwise: ``mma.sync``), both
    counted in :data:`LAUNCHES` under their names, or ``"segmm_fma"``
    (float32 x float32 and the mixed pairs: the CUDA cores' float32 FMA
    chain).  No address takes part: an unaligned operand of the wgmma route
    is copied, not sent elsewhere."""
    if lhs_dtype != torch.bfloat16 or rhs_dtype != torch.bfloat16:
        return "segmm_fma"
    if bm % WGMMA_TILE_M == 0 and k_dim % 8 == 0 and n_dim % 8 == 0:
        return "segmm_wgmma"
    return "segmm_mma"


def _route(lhs: torch.Tensor, rhs: torch.Tensor, bm: int) -> str:
    return kernel_for(lhs.dtype, rhs.dtype, bm, lhs.shape[1], rhs.shape[2])


#: The wgmma route's work item: 128 rows of one M-block x 256 columns
#: (``kTM`` x ``kTN`` in ``csrc/segmm_wgmma.cu``).
WGMMA_TILE_M = 128
WGMMA_TILE_N = 256


def wgmma_items(num_slots: int, bm: int, n_dim: int) -> int:
    """Work items of the wgmma route: (slot, 128-row sub-tile of its
    M-block, 256-column N tile) for each slot; K5's slots are its
    M-blocks, K6's the ``P * max_chunks`` slots of its queues (popped or
    not)."""
    return (num_slots * (bm // WGMMA_TILE_M)
            * -(-n_dim // WGMMA_TILE_N))


def wgmma_grid(items: int, sms: int) -> int:
    """Persistent CTAs of the wgmma route: one an SM, never more than the
    items; CTA ``c`` walks items ``c, c + grid, c + 2 grid, ...``."""
    return min(items, sms)


def wgmma_item(item: int, *, bm: int, n_dim: int, num_blocks: int,
               queue=None):
    """``(queue, slot, M-block, first row, first column)`` of the wgmma
    route's work item ``item``, or ``None`` when it is no item: the same
    decode as ``segmm_wgmma.cu``'s.  The N tile is the fastest index, then
    the 128-row sub-tile of the M-block, then (K5, ``queue=None``) the
    M-block, or (K6, ``queue=(chunks, counts, max_chunks)``, plain lists)
    the queue ``q`` and, slowest, the slot ``s``: an item only when ``s <
    min(counts[q], max_chunks)`` and its id lies in ``[0, num_blocks)``.
    K5's queue and slot are ``None``."""
    n_tiles = -(-n_dim // WGMMA_TILE_N)
    sub_tiles = bm // WGMMA_TILE_M
    n0 = item % n_tiles * WGMMA_TILE_N
    rest = item // n_tiles
    sub, rest = rest % sub_tiles, rest // sub_tiles
    q = s = None
    block = rest
    if queue is not None:
        chunks, counts, max_chunks = queue
        q, s = rest % len(counts), rest // len(counts)
        count = min(int(counts[q]), max_chunks)
        block = int(chunks[q * max_chunks + s]) if s < count else -1
    if not 0 <= block < num_blocks:
        return None
    return q, s, block, block * bm + sub * WGMMA_TILE_M, n0


def popped_mask(block_chunks_flat: torch.Tensor, chunk_counts: torch.Tensor,
                max_chunks: int, num_blocks: int) -> torch.Tensor:
    """bool ``[num_blocks]``: the M-blocks some queue pops (slot ``s <
    min(chunk_counts[q], max_chunks)``, id in ``[0, num_blocks)``), as K6
    marks them on the card (``segmm_zero_unpopped`` in ``csrc/segmm.cu``,
    ``zero_unpopped`` in ``csrc/segmm_wgmma.cu``) before it zeroes the
    others' rows."""
    mask = torch.zeros(num_blocks, dtype=torch.bool)
    slots = block_chunks_flat.long().cpu().view(-1, max_chunks)
    counts = chunk_counts.long().cpu().clamp(max=max_chunks)
    for q in range(slots.shape[0]):
        for b in slots[q, :int(counts[q])].tolist():
            if 0 <= b < num_blocks:
                mask[b] = True
    return mask


def _vector_copies(lhs: torch.Tensor, rhs: torch.Tensor, bm: int) -> int:
    """1 when a ``segmm.cu`` routine may copy its operands in 16-byte
    chunks, else 0 (smaller loads and copies, scalar stores: the same
    arithmetic).  The CUDA-core routine copies quads and stores float4s: K
    % 4 == 0, N % 4 == 0 and every float32 operand 16-byte aligned.  The
    ``mma.sync`` routine copies 8 bf16 at a time and stores float2s: K % 8
    == 0, N % 8 == 0 and both operands 16-byte aligned."""
    if _route(lhs, rhs, bm) == "segmm_mma":
        aligned = lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0
        return int(lhs.shape[1] % 8 == 0 and rhs.shape[2] % 8 == 0
                   and aligned)
    aligned = all(t.dtype != torch.float32 or t.data_ptr() % 16 == 0
                  for t in (lhs, rhs))
    return int(lhs.shape[1] % 4 == 0 and rhs.shape[2] % 4 == 0 and aligned)


def _count(name: str, lhs: torch.Tensor, rhs: torch.Tensor, bm: int) -> None:
    """One launch of ``name``, and of its route on the tensor cores."""
    LAUNCHES[name] += 1
    route = _route(lhs, rhs, bm)
    if route in LAUNCHES:
        LAUNCHES[route] += 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it at a 16-byte aligned base (counted in
    :data:`COPIES`): TMA reads from aligned bases only.  The caller holds
    the copy until the launch is queued (its memory is then free for work
    queued after it on the stream)."""
    if t.data_ptr() % 16 == 0:
        return t
    COPIES["segmm_wgmma"] += 1
    return t.clone()


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    nblk = _int32(m_pad // bm, "M-blocks")
    if _route(lhs_padded, rhs, bm) == "segmm_wgmma":
        items = wgmma_items(nblk, bm, n_dim)
        lhs_a, rhs_a = _aligned(lhs_padded), _aligned(rhs)   # held: launch
        _launch("segmm_wgmma_blocks", lhs_a.data_ptr(), rhs_a.data_ptr(),
                block_expert.data_ptr(), nblk,
                _int32(bm, "bm"), _int32(k_dim, "K"), _int32(n_dim, "N"),
                _int32(e_dim, "E"),
                wgmma_grid(items, _sms(lhs_padded.device)), out.data_ptr())
    else:
        _grid(blocks_grid(nblk, bm, n_dim))
        _launch("segmm_blocks", lhs_padded.data_ptr(),
                _DTYPE_CODE[lhs_padded.dtype], rhs.data_ptr(),
                _DTYPE_CODE[rhs.dtype], block_expert.data_ptr(), nblk,
                _int32(bm, "bm"), block_group(bm), _int32(k_dim, "K"),
                _int32(n_dim, "N"), _int32(e_dim, "E"),
                _vector_copies(lhs_padded, rhs, bm), out.data_ptr())
    _count("segmented_matmul", lhs_padded, rhs, bm)
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
    tile (:func:`queues_grid`), or on the wgmma route walked in pop order
    by the persistent CTAs (:func:`wgmma_item`); the queues and their
    order are the schedule's, untouched.  The output starts uninitialised:
    a pass on the card zeroes the rows of the M-blocks no queue pops.
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
    out = torch.empty((m_pad, n_dim), dtype=torch.float32,
                      device=lhs_padded.device)
    _int32(m_pad, "M_pad")
    nblk = _int32(m_pad // bm, "M-blocks")
    queue_args = (block_chunks_flat.data_ptr(), chunk_counts.data_ptr(),
                  _int32(num_physical, "num_physical"),
                  _int32(max_chunks, "max_chunks"), nblk)
    if _route(lhs_padded, rhs, bm) == "segmm_wgmma":   # zeroes them itself
        items = wgmma_items(num_physical * max_chunks, bm, n_dim)
        lhs_a, rhs_a = _aligned(lhs_padded), _aligned(rhs)   # held: launch
        _launch("segmm_wgmma_queues", lhs_a.data_ptr(), rhs_a.data_ptr(),
                block_expert.data_ptr(), *queue_args, _int32(bm, "bm"),
                _int32(k_dim, "K"), _int32(n_dim, "N"), _int32(e_dim, "E"),
                wgmma_grid(items, _sms(lhs_padded.device)), out.data_ptr())
    else:
        popped = torch.empty(nblk, dtype=torch.uint8, device=out.device)
        _launch("segmm_zero_unpopped", *queue_args, _int32(bm, "bm"),
                _int32(n_dim, "N"), popped.data_ptr(), out.data_ptr())
        _grid(queues_grid(num_physical, max_chunks, bm, n_dim)[1])
        _launch("segmm_queues", lhs_padded.data_ptr(),
                _DTYPE_CODE[lhs_padded.dtype], rhs.data_ptr(),
                _DTYPE_CODE[rhs.dtype], block_expert.data_ptr(),
                *queue_args, _int32(bm, "bm"), block_group(bm),
                _int32(k_dim, "K"), _int32(n_dim, "N"), _int32(e_dim, "E"),
                _vector_copies(lhs_padded, rhs, bm), out.data_ptr())
    _count("segmented_matmul_chunked", lhs_padded, rhs, bm)
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
