"""What the kernels would have done, for calls on the ``meta`` device.

On a ``meta`` tensor a kernel wrapper (K5/K6 in ``segmm/kernel.py``, K7
and its backward in ``flash_swa/kernel.py``) returns empty outputs of the
kernel's shapes, launches nothing and adds the kernel's useful work to
:data:`TALLY`, with the formulas of the kernels' bounds: K7 ``4 hd H
pairs`` flop, its backward ``10 hd H pairs``, K5/K6 ``2 M K N`` (``M`` the
M-blocks' rows: on ``meta`` the padding cannot be told from the data), and
the bytes each input is read and each output written once.  A
``FlopCounterMode`` does not see these calls (they run no PyTorch
operation that computes), so the dry run (``launch/dryrun.py``) adds the
tally to its count.  Nothing else touches it: CPU tensors still run the
plain versions and CUDA tensors the kernels.
"""
from __future__ import annotations

from typing import Dict

#: ``flops`` and ``bytes`` in all, and ``calls`` by kernel, since the last
#: :func:`reset`.
TALLY: Dict[str, object] = {"flops": 0, "bytes": 0, "calls": {}}


def reset() -> None:
    TALLY["flops"] = TALLY["bytes"] = 0
    TALLY["calls"] = {}


def add(name: str, flops: int, nbytes: int) -> None:
    TALLY["flops"] += int(flops)
    TALLY["bytes"] += int(nbytes)
    calls = TALLY["calls"]
    calls[name] = calls.get(name, 0) + 1


def band_pairs(s: int, window: int) -> int:
    """(query, key) pairs inside a causal band of ``window``:
    ``sum_i min(i + 1, window)``."""
    n = min(s, window)
    return n * (n + 1) // 2 + (s - n) * window


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
