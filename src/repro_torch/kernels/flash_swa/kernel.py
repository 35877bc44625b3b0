"""Wrapper of the banded sliding-window attention CUDA kernel (K7), beside
its plain version.

===============  ======================  ===============================
launch counter   CUDA source             replaces (reference)
===============  ======================  ===============================
``flash_swa``    ``csrc/flash_swa.cu``   ``kernels/flash_swa/kernel.py::
                                         flash_swa``
===============  ======================  ===============================

:func:`flash_swa` checks its operands as the reference does (``S % qc ==
0`` and ``window % qc == 0``; ``qc`` is only checked: the kernel picks its
own 64-row tiles), allocates the output, and for CUDA tensors launches the
kernel on the current stream and adds one to :data:`LAUNCHES`; for CPU
tensors it runs :func:`flash_swa_plain`, which is also what the kernel is
tested against.  Other devices raise.  Unlike the reference kernel it takes
GQA operands directly (``k``/``v`` with ``Hkv`` heads, ``H % Hkv == 0``).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

#: Every CUDA source of this package, built in parallel by :func:`build`.
SOURCES = (CSRC / "flash_swa.cu",)

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"flash_swa": 0}

#: Widest head the kernel takes (its accumulators are 8 columns a lane).
MAX_HEAD_DIM = 256

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV "
                         f"heads")
    if qc < 1 or window < 1 or s % qc or window % qc:
        raise ValueError(f"S={s} and window={window} must be multiples of "
                         f"qc={qc}")
    return b, s, h, hkv, hd


def _on_card(device: torch.device) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def flash_swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int, qc: int = 256) -> torch.Tensor:
    """Causal sliding-window attention: query ``i`` attends to keys ``j``
    with ``i - window < j <= i``.  q ``[B, S, H, hd]``, k/v ``[B, S, Hkv,
    hd]``, all float32 or all bfloat16, contiguous; positions 0..S-1.
    Returns ``[B, S, H, hd]`` in ``q.dtype`` (float32 accumulation)."""
    b, s, h, hkv, hd = _check(q, k, v, window, qc)
    if not _on_card(q.device):
        return flash_swa_plain(q, k, v, window=window, qc=qc)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}: the kernel does "
                         f"not take it")
    out = torch.empty_like(q)
    fn = _build.load(SOURCES[0]).flash_swa_fwd
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, s, h, hkv, hd, min(window, s),
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_swa: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["flash_swa"] += 1
    return out


def flash_swa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, qc: int = 256) -> torch.Tensor:
    """Plain version of :func:`flash_swa`: one ``qc``-row query chunk at a
    time against its ``[start, start + qc + window)`` KV band (the
    reference's banded ``attention``, ``models/layers.py``), never the
    ``[B, H, S, S]`` scores."""
    b, s, h, hkv, hd = _check(q, k, v, window, qc)
    groups = h // hkv
    kk = k.repeat_interleave(groups, dim=2) if groups > 1 else k
    vv = v.repeat_interleave(groups, dim=2) if groups > 1 else v
    scale = hd ** -0.5
    band = min(qc + window, s)
    out = torch.empty_like(q)
    for i in range(s // qc):
        start = min(max(i * qc - window, 0), s - band)
        qb = q[:, i * qc:(i + 1) * qc].float()
        kb = kk[:, start:start + band].float()
        vb = vv[:, start:start + band].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
        qpos = torch.arange(i * qc, (i + 1) * qc, device=q.device)[:, None]
        kpos = torch.arange(start, start + band, device=q.device)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        out[:, i * qc:(i + 1) * qc] = torch.einsum(
            "bhqk,bkhd->bqhd", probs, vb).to(q.dtype)
    return out
