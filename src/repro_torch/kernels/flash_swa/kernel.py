"""Wrappers of the banded sliding-window attention CUDA kernels (K7) and
of its backward, beside their plain versions.

========================  ================================  =================
launch counter            CUDA source                       inputs
========================  ================================  =================
``flash_swa_wgmma``       ``csrc/flash_swa_wgmma.cu``       bfloat16, ``hd <=
                                                            128``, ``hd % 8
                                                            == 0`` (wgmma fed
                                                            by TMA)
``flash_swa_mma``         ``csrc/flash_swa_mma.cu``         bfloat16, ``hd <=
                                                            128``, ``hd % 8
                                                            != 0``
                                                            (``mma.sync``)
``flash_swa``             ``csrc/flash_swa.cu``             float32, or
                                                            bfloat16 with
                                                            ``128 < hd <=
                                                            256`` (CUDA
                                                            cores); it also
                                                            counts every
                                                            launch of the
                                                            others
``flash_swa_bwd_wgmma``   ``csrc/flash_swa_bwd_wgmma.cu``   the backward, as
                                                            ``flash_swa_wgmma``
``flash_swa_bwd_mma``     ``csrc/flash_swa_bwd_mma.cu``     the backward, as
                                                            ``flash_swa_mma``
``flash_swa_bwd``         ``csrc/flash_swa_bwd.cu``         the backward, as
                                                            ``flash_swa``; it
                                                            also counts every
                                                            launch of the
                                                            others
========================  ================================  =================

The forward kernels replace the reference's
``kernels/flash_swa/kernel.py::flash_swa``; the backward computes the
gradient JAX takes of the reference's banded attention.  :func:`flash_swa`
checks its operands as the reference does (``S % qc == 0`` and ``window %
qc == 0``; ``qc`` is only checked: the kernels pick their own tiles),
allocates the output (and, with ``return_lse``, the row log-sum-exp the
backward needs), and for CUDA tensors launches the kernel that
:func:`kernel_for` names on the current stream and adds one to its counters
in :data:`LAUNCHES` (the wgmma routes read their operands through TMA,
which takes 16-byte aligned bases only: an operand that is not is copied
first, counted in :data:`COPIES`, and the route stays the same); for CPU
tensors it runs :func:`flash_swa_plain`, which is also what the kernels
are tested against.  :func:`flash_swa_bwd` does
the same with the kernel that :func:`bwd_kernel_for` names and with
:func:`flash_swa_bwd_plain`.  For ``meta`` tensors (the dry run) both
return empty outputs of the kernels' shapes, launch nothing and add the
kernels' useful flop and bytes to :data:`repro_torch.kernels.tally.TALLY`.
Other devices raise.  Unlike the reference kernel they take GQA operands
directly (``k``/``v`` with ``Hkv`` heads, ``H % Hkv == 0``).  Operands
without heads (``H = Hkv = 0``: a rank of ``model`` that holds none) give
empty outputs on every device, with no launch, no count and no tally.  float32 stays
off the tensor cores: TF32 would round its inputs.  ``ops.py`` ties the two
into an autograd function.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build, tally

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

#: Every CUDA source of this package, built in parallel by :func:`build`.
SOURCES = (CSRC / "flash_swa.cu", CSRC / "flash_swa_mma.cu",
           CSRC / "flash_swa_bwd.cu", CSRC / "flash_swa_bwd_mma.cu",
           CSRC / "flash_swa_wgmma.cu", CSRC / "flash_swa_bwd_wgmma.cu")

#: Kernel launches since the last :func:`reset_launch_counts`:
#: ``flash_swa`` counts every K7 forward launch, ``flash_swa_wgmma`` and
#: ``flash_swa_mma`` those of the two tensor-core kernels, ``flash_swa_bwd``
#: every backward launch (its two kernels, dq then dk/dv, count as one),
#: ``flash_swa_bwd_wgmma`` and ``flash_swa_bwd_mma`` those of the two
#: tensor-core backwards.
LAUNCHES = {"flash_swa": 0, "flash_swa_wgmma": 0, "flash_swa_mma": 0,
            "flash_swa_bwd": 0, "flash_swa_bwd_wgmma": 0,
            "flash_swa_bwd_mma": 0}

#: Operands the wgmma routes copied into a 16-byte aligned tensor first
#: (TMA reads from aligned bases only), since the last
#: :func:`reset_launch_counts`.
COPIES = {"flash_swa_wgmma": 0, "flash_swa_bwd_wgmma": 0}

#: Widest head the CUDA-core kernel takes (its accumulators are 8 columns a
#: lane).
MAX_HEAD_DIM = 256

#: Widest head the tensor-core kernels take (their output tiles live in
#: registers).
MMA_MAX_HEAD_DIM = 128

NEG_INF = -1e30

#: Rows a consumer warpgroup of the wgmma kernels owns.
WGMMA_ROWS = 64
#: The wgmma kernels' tiles (``csrc/flash_swa_wgmma.cu``, ``csrc/
#: flash_swa_bwd_wgmma.cu``): query rows a forward or dq CTA, KV rows a tile
#: of the forward's and of the dq kernel's walk, key rows a dk/dv CTA and
#: query rows a tile of its walk.
WGMMA_FWD_Q, WGMMA_FWD_KV = 128, 128
WGMMA_DQ_Q, WGMMA_DQ_KV = 128, 64
WGMMA_DKDV_KV, WGMMA_DKDV_Q = 128, 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_swa_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                      _P],
    "flash_swa_mma_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                          _I, _P],
    "flash_swa_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _F, _P],
    "flash_swa_bwd_mma": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _F, _I, _P],
    "flash_swa_wgmma_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                            _P],
    "flash_swa_bwd_wgmma": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _F, _P],
}


def reset_launch_counts() -> None:
    for counter in (LAUNCHES, COPIES):
        for name in counter:
            counter[name] = 0


def build() -> dict:
    """Compile every source now; ``{stem: ptxas report}``."""
    return _build.build(SOURCES)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           qc: int) -> tuple[int, int, int, int, int]:
    """The reference's assertions plus shape/type/device/layout checks;
    returns ``(B, S, H, Hkv, hd)``."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not isinstance(t, torch.Tensor) or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be a float32 or bfloat16 tensor")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, S, H, hd] "
                             f"tensor")
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    hkv = k.shape[2]
    if (hkv < 1 or h % hkv) and (h, hkv) != (0, 0):
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV "
                         f"heads")
    if qc < 1 or window < 1 or s % qc or window % qc:
        raise ValueError(f"S={s} and window={window} must be multiples of "
                         f"qc={qc}")
    return b, s, h, hkv, hd


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The counter of the kernel that takes ``dtype`` inputs with heads of
    ``head_dim``: ``"flash_swa_wgmma"`` (bfloat16, ``head_dim <=
    MMA_MAX_HEAD_DIM`` and a multiple of 8, so that the rows of ``H hd``
    and ``Hkv hd`` elements are TMA's 16-byte strides), ``"flash_swa_mma"``
    (the other bfloat16 heads up to ``MMA_MAX_HEAD_DIM``) or
    ``"flash_swa"`` (float32, which TF32 would round, and wider bfloat16
    heads: CUDA cores).  The dtype and the head width alone decide: an
    operand off 16-byte alignment is copied, never sent elsewhere."""
    if dtype == torch.bfloat16 and head_dim <= MMA_MAX_HEAD_DIM:
        return "flash_swa_wgmma" if head_dim % 8 == 0 else "flash_swa_mma"
    return "flash_swa"


def bwd_kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The counter of the backward kernel that takes ``dtype`` inputs with
    heads of ``head_dim``: ``"flash_swa_bwd_wgmma"``,
    ``"flash_swa_bwd_mma"`` or ``"flash_swa_bwd"``, on the same rule as
    :func:`kernel_for`."""
    return {"flash_swa_wgmma": "flash_swa_bwd_wgmma",
            "flash_swa_mma": "flash_swa_bwd_mma",
            "flash_swa": "flash_swa_bwd"}[kernel_for(dtype, head_dim)]


def _in_band(rows: range, keys: range, window: int) -> bool:
    """Every (row, key) pair of ``rows`` x ``keys`` lies in the band."""
    return keys[-1] <= rows[0] and keys[0] > rows[-1] - window


def wgmma_band_walk(q0: int, s: int, window: int, rows_q: int = WGMMA_FWD_Q,
                    rows_kv: int = WGMMA_FWD_KV) -> list:
    """The KV tiles a query tile of a wgmma kernel reads, as the kernel
    walks them: for the ``rows_q`` query rows at ``q0``, ``[(kt,
    masked), ...]`` in order, ``kt`` each ``rows_kv``-row tile's first key
    and ``masked`` one flag per consumer warpgroup's 64 rows, True where
    the tile is not inside the band for all of them (the kernel masks it).
    The forward (defaults) and the dq kernel (``rows_kv =
    WGMMA_DQ_KV``); ``window`` as the wrapper passes it (``min(window,
    s)``)."""
    q_last = min(q0 + rows_q, s) - 1
    kt0 = max(0, q0 - window + 1) // rows_kv * rows_kv
    return [(kt, tuple(not _in_band(range(r0, r0 + WGMMA_ROWS),
                                    range(kt, kt + rows_kv), window)
                       for r0 in range(q0, q0 + rows_q, WGMMA_ROWS)))
            for kt in range(kt0, q_last + 1, rows_kv)]


def wgmma_dkdv_walk(kt: int, s: int, window: int) -> list:
    """The query tiles the dk/dv kernel visits for the key tile at ``kt``
    (one query head; the kernel repeats the walk for each head of the GQA
    group, in order): ``[(qs, states), ...]``, one state per consumer
    warpgroup's 64 key rows: ``"skip"`` where no pair of the band falls in
    the tile (the warpgroup passes it over), ``"whole"`` where every pair
    does and the queries lie below ``s``, else ``"masked"``."""
    q_end = min(s - 1, kt + WGMMA_DKDV_KV - 1 + window - 1)
    walk = []
    for qs in range(kt, q_end + 1, WGMMA_DKDV_Q):
        states = []
        for kr0 in range(kt, kt + WGMMA_DKDV_KV, WGMMA_ROWS):
            if (qs + WGMMA_DKDV_Q - 1 < kr0
                    or qs > kr0 + WGMMA_ROWS - 1 + window - 1):
                states.append("skip")
            elif (_in_band(range(qs, qs + WGMMA_DKDV_Q),
                           range(kr0, kr0 + WGMMA_ROWS), window)
                  and qs + WGMMA_DKDV_Q <= s):
                states.append("whole")
            else:
                states.append("masked")
        walk.append((qs, tuple(states)))
    return walk


def _aligned(t: torch.Tensor, route: str) -> torch.Tensor:
    """``t``, or a copy of it at a 16-byte aligned base (counted in
    :data:`COPIES` under ``route``).  The caller holds the copy until the
    launch is queued."""
    if t.data_ptr() % 16 == 0:
        return t
    COPIES[route] += 1
    return t.clone()


def _function(source: pathlib.Path, name: str):
    fn = getattr(_build.load(source), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _on_card(device: torch.device) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version).
    ``meta`` tensors take neither (see :mod:`repro_torch.kernels.tally`)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def flash_swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int, qc: int = 256, return_lse: bool = False):
    """Causal sliding-window attention: query ``i`` attends to keys ``j``
    with ``i - window < j <= i``.  q ``[B, S, H, hd]``, k/v ``[B, S, Hkv,
    hd]``, all float32 or all bfloat16, contiguous; positions 0..S-1.
    Returns ``[B, S, H, hd]`` in ``q.dtype`` (float32 accumulation), and
    with ``return_lse`` also each row's log-sum-exp, float32 ``[B, H,
    S]``."""
    b, s, h, hkv, hd = _check(q, k, v, window, qc)
    if h == 0:                     # a rank without heads: nothing to do
        out = torch.empty_like(q)
        lse = (torch.empty((b, 0, s), dtype=torch.float32, device=q.device)
               if return_lse else None)
        return (out, lse) if return_lse else out
    if q.device.type == "meta":
        out = torch.empty_like(q)
        lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
               if return_lse else None)
        tally.add("flash_swa", 4 * hd * h * b * tally.band_pairs(s, window),
                  tally.nbytes(q, k, v, out, *(() if lse is None
                                               else (lse,))))
        return (out, lse) if return_lse else out
    if not _on_card(q.device):
        return flash_swa_plain(q, k, v, window=window, qc=qc,
                               return_lse=return_lse)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}: the kernel does "
                         f"not take it")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("the kernel's output would carry no gradient; "
                           "call ops.flash_swa_gqa, which goes through the "
                           "autograd function")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = lse.data_ptr() if return_lse else None
    name = kernel_for(q.dtype, hd)
    if name == "flash_swa_wgmma":
        q, k, v = (_aligned(t, name) for t in (q, k, v))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name == "flash_swa_wgmma":
        rc = _function(SOURCES[4], "flash_swa_wgmma_fwd")(
            *ptrs, lse_ptr, b, s, h, hkv, hd, min(window, s), hd ** -0.5,
            stream)
    elif name == "flash_swa_mma":
        # vec 0: hd % 8 != 0 on this route, so no 16-byte cp.async rows
        rc = _function(SOURCES[1], "flash_swa_mma_fwd")(
            *ptrs, lse_ptr, b, s, h, hkv, hd, min(window, s), hd ** -0.5,
            0, stream)
    else:
        rc = _function(SOURCES[0], "flash_swa_fwd")(
            *ptrs, lse_ptr, _DTYPE_CODE[q.dtype], b, s, h, hkv, hd,
            min(window, s), hd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES["flash_swa"] += 1
    if name != "flash_swa":
        LAUNCHES[name] += 1
    return (out, lse) if return_lse else out


def _band(i: int, s: int, window: int, qc: int, device):
    """Query chunk ``i``'s rows, its KV band's start and width, and the
    band mask ``[qc, band]``."""
    band = min(qc + window, s)
    start = min(max(i * qc - window, 0), s - band)
    qpos = torch.arange(i * qc, (i + 1) * qc, device=device)[:, None]
    kpos = torch.arange(start, start + band, device=device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    return slice(i * qc, (i + 1) * qc), start, band, mask


def flash_swa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, qc: int = 256, return_lse: bool = False):
    """Plain version of :func:`flash_swa`: one ``qc``-row query chunk at a
    time against its ``[start, start + qc + window)`` KV band (the
    reference's banded ``attention``, ``models/layers.py``), never the
    ``[B, H, S, S]`` scores.  Differentiable by autograd."""
    b, s, h, hkv, hd = _check(q, k, v, window, qc)
    groups = h // hkv
    kk = k.repeat_interleave(groups, dim=2) if groups > 1 else k
    vv = v.repeat_interleave(groups, dim=2) if groups > 1 else v
    scale = hd ** -0.5
    outs, lses = [], []
    for i in range(s // qc):
        rows, start, band, mask = _band(i, s, window, qc, q.device)
        qb = q[:, rows].float()
        kb = kk[:, start:start + band].float()
        vb = vv[:, start:start + band].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, vb).to(q.dtype))
        if return_lse:
            lses.append(torch.logsumexp(logits, dim=-1))
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


def _check_bwd(q, k, v, out, lse, dout, window, qc):
    dims = _check(q, k, v, window, qc)
    b, s, h, _, _ = dims
    for t, name in ((out, "out"), (dout, "dout")):
        if (t.dtype != q.dtype or t.device != q.device or t.shape != q.shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"shaped like q {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.device != q.device
            or lse.shape != (b, h, s) or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [B, H, S] = "
                         f"{(b, h, s)} tensor")
    return dims


def flash_swa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  *, window: int, qc: int = 256):
    """The gradient of :func:`flash_swa`: ``(dq, dk, dv)`` in the inputs'
    type, from the forward's inputs, its output, its row log-sum-exp
    (``return_lse``) and the output's gradient ``dout``.  dk/dv sum the
    query heads of each KV head.  CUDA tensors launch the kernel that
    :func:`bwd_kernel_for` names (``csrc/flash_swa_bwd_wgmma.cu``,
    ``csrc/flash_swa_bwd_mma.cu`` or ``csrc/flash_swa_bwd.cu``; counter
    ``flash_swa_bwd``, and the route's own for the first two); CPU tensors
    run :func:`flash_swa_bwd_plain`."""
    b, s, h, hkv, hd = _check_bwd(q, k, v, out, lse, dout, window, qc)
    if h == 0:
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if q.device.type == "meta":
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        tally.add("flash_swa_bwd",
                  10 * hd * h * b * tally.band_pairs(s, window),
                  tally.nbytes(q, k, v, out, lse, dout, *grads))
        return grads
    if not _on_card(q.device):
        return flash_swa_bwd_plain(q, k, v, out, lse, dout, window=window,
                                   qc=qc)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}: the backward "
                         f"kernel does not take it")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    name = bwd_kernel_for(q.dtype, hd)
    if name == "flash_swa_bwd_wgmma":
        q, k, v, out, dout = (_aligned(t, name) for t in (q, k, v, out, dout))
    ptrs = [t.data_ptr() for t in (q, k, v, out, dout, lse, dsum, dq, dk, dv)]
    if name == "flash_swa_bwd_wgmma":
        rc = _function(SOURCES[5], "flash_swa_bwd_wgmma")(
            *ptrs, b, s, h, hkv, hd, min(window, s), hd ** -0.5, stream)
    elif name == "flash_swa_bwd_mma":
        # vec 0: hd % 8 != 0 on this route, so no 16-byte cp.async rows
        rc = _function(SOURCES[3], "flash_swa_bwd_mma")(
            *ptrs, b, s, h, hkv, hd, min(window, s), hd ** -0.5, 0, stream)
    else:
        rc = _function(SOURCES[2], "flash_swa_bwd")(
            *ptrs, _DTYPE_CODE[q.dtype], b, s, h, hkv, hd, min(window, s),
            hd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES["flash_swa_bwd"] += 1
    if name != "flash_swa_bwd":
        LAUNCHES[name] += 1
    return dq, dk, dv


def flash_swa_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, window: int, qc: int = 256):
    """Plain version of :func:`flash_swa_bwd`, one ``qc``-row query chunk
    at a time against its KV band as :func:`flash_swa_plain` does, in
    float32: ``P = exp(scale q.k - lse)`` in the band, ``D = sum(dout *
    out)``, ``dS = P (dout.v - D)``; ``dq = scale dS k``, ``dk = scale
    dS^T q`` and ``dv = P^T dout`` summed over each KV head's query
    heads."""
    b, s, h, hkv, hd = _check_bwd(q, k, v, out, lse, dout, window, qc)
    groups = h // hkv
    kk = k.repeat_interleave(groups, dim=2) if groups > 1 else k
    vv = v.repeat_interleave(groups, dim=2) if groups > 1 else v
    scale = hd ** -0.5
    dsum = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # [B, H, S]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    for i in range(s // qc):
        rows, start, band, mask = _band(i, s, window, qc, q.device)
        keys = slice(start, start + band)
        qb, dob = q[:, rows].float(), dout[:, rows].float()
        kb, vb = kk[:, keys].float(), vv[:, keys].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
        p = torch.where(mask, torch.exp(logits - lse[:, :, rows, None]), 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb)
        ds = p * (dp - dsum[:, :, rows, None]) * scale
        dq[:, rows] = torch.einsum("bhqk,bkhd->bqhd", ds, kb)
        dk[:, keys] += torch.einsum("bhqk,bqhd->bkhd", ds, qb)
        dv[:, keys] += torch.einsum("bhqk,bqhd->bkhd", p, dob)
    dk = dk.view(b, s, hkv, groups, hd).sum(3)
    dv = dv.view(b, s, hkv, groups, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
