"""Roofline terms of a traced step (the reference's ``launch/roofline.py``).

Terms (per device, seconds), at the H100's datasheet figures:

    compute    = flops / PEAK_FLOPS_BF16         (dense bf16 tensor cores)
    memory     = hbm_bytes / HBM_BW              (HBM3)
    collective = wire_bytes / LINK_BW            (NVLink, one direction)

The reference reads flops and bytes from XLA's ``cost_analysis`` and the
collectives from HLO text.  The port traces its step on the ``meta``
device (``launch/dryrun.py``): the flops are ``FlopCounterMode``'s count
plus the kernels' own (``repro_torch.kernels.tally``), the bytes what each
operation reads and writes, and the collectives the mesh's record by kind
and group size (``launch.mesh.CollectiveStats``), to which
:func:`stats_wire_bytes` applies the reference's ring factors.
:func:`collective_wire_bytes` keeps the reference's parser of HLO text.

As in the reference, metrics come from units of one and two layers (one
microbatch) and are composed::

    per_layer = unit(L=2) - unit(L=1)
    total     = n_micro * (unit(L=1) - per_layer) + n_micro * L * per_layer

(the optimizer update is counted ``n_micro - 1`` extra times; it is
O(params / device) flops, orders of magnitude below one layer).

Ring factors, with ``n`` the group size and ``S`` the bytes a call
returns: all-reduce ``2 S (n-1)/n``, all-gather ``S (n-1)/n`` (``S`` the
gathered tensor), reduce-scatter ``S n (n-1)/n`` (``S`` the scattered
block), all-to-all ``S (n-1)/n``, collective-permute ``S`` (one hop), and
the port's broadcast ``S`` (a pipelined chain).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

from repro_torch.launch.mesh import KINDS as RECORDED

# --- hardware constants: NVIDIA H100 SXM5 80 GB (H100 80GB HBM3, 700 W) ---
# NVIDIA H100 Tensor Core GPU datasheet: 989 TFLOPS dense BF16 (1,979 with
# sparsity), 3.35 TB/s HBM3, NVLink 900 GB/s per GPU (bidirectional, 18
# NVLink 4 links through the NVSwitch of an HGX node): 450 GB/s each way.
PEAK_FLOPS_BF16 = 989e12     # per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, one direction (the
#                              reference's ICI_BW, 50e9 a v5e link)

#: The kinds of HLO text (the reference's); a mesh also records broadcasts.
KINDS = RECORDED[:5]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_RE = re.compile(
    r"=\s*(?:\()?\s*((?:\w+\[[\d,]*\][^ ]*,?\s?)+)\)?\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    return default


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Per-device wire bytes of one collective of ``kind`` over ``n``
    ranks that returns ``size`` bytes (the ring factors above)."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * size * frac
    if kind in ("all-gather", "all-to-all"):
        return size * frac
    if kind == "reduce-scatter":
        return size * n * frac
    if kind in ("collective-permute", "broadcast"):
        return float(size)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_wire_bytes(hlo_text: str, num_devices: int
                          ) -> Dict[str, float]:
    """Per-device wire bytes by collective kind (ring model), from HLO
    text, as the reference parses it."""
    out = {k: 0.0 for k in KINDS}
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        shapes_str, kind = m.group(1), m.group(2)
        size = _shape_bytes(shapes_str)  # per-device output bytes
        out[kind] += wire_bytes(kind, size, _group_size(line, num_devices))
    return out


def stats_wire_bytes(kinds) -> Dict[str, float]:
    """Per-device wire bytes by kind from a mesh's record
    (``CollectiveStats`` or its ``kinds``: ``{(kind, group size): [calls,
    bytes, ...]}``); the pipeline's broadcasts count under
    ``broadcast``."""
    kinds = getattr(kinds, "kinds", kinds)
    out = {k: 0.0 for k in RECORDED}
    for (kind, n), (_, nbytes, *_) in kinds.items():
        out[kind] += wire_bytes(kind, nbytes, n)
    return out


@dataclasses.dataclass
class CellMetrics:
    flops: float                 # per device
    hbm_bytes: float             # per device
    wire_bytes: float            # per device
    wire_by_kind: Dict[str, float]

    def terms(self) -> Dict[str, float]:
        return {
            "compute_s": self.flops / PEAK_FLOPS_BF16,
            "memory_s": self.hbm_bytes / HBM_BW,
            "collective_s": self.wire_bytes / LINK_BW,
        }

    def bottleneck(self) -> str:
        t = self.terms()
        return max(t, key=t.get)


def unit_metrics(flops: float, hbm_bytes: float, collectives
                 ) -> CellMetrics:
    """A traced unit's metrics: its flop count, the bytes it reads and
    writes, and its mesh's collective record (see
    :func:`stats_wire_bytes`)."""
    wire = stats_wire_bytes(collectives)
    return CellMetrics(flops=float(flops), hbm_bytes=float(hbm_bytes),
                       wire_bytes=sum(wire.values()), wire_by_kind=wire)


def compose(unit1: CellMetrics, unit2: CellMetrics, num_layers: int,
            n_micro: int) -> CellMetrics:
    """total = n_micro * (rest + L * per_layer)   (see module docstring)."""
    def comb(a1, a2):
        per_layer = max(a2 - a1, 0.0)
        rest = max(a1 - per_layer, 0.0)
        return n_micro * (rest + num_layers * per_layer)

    wire = {k: comb(unit1.wire_by_kind[k], unit2.wire_by_kind[k])
            for k in unit1.wire_by_kind}
    return CellMetrics(
        flops=comb(unit1.flops, unit2.flops),
        hbm_bytes=comb(unit1.hbm_bytes, unit2.hbm_bytes),
        wire_bytes=sum(wire.values()),
        wire_by_kind=wire)


def model_flops(cfg, case, n_params_active: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (forward-only), global."""
    if case.kind == "train":
        tokens = case.global_batch * case.seq_len
        return 6.0 * n_params_active * tokens
    if case.kind == "prefill":
        tokens = case.global_batch * case.seq_len
        return 2.0 * n_params_active * tokens
    tokens = case.global_batch * 1  # decode: one token
    return 2.0 * n_params_active * tokens
