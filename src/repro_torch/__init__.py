"""repro_torch — the load-balancing abstraction in PyTorch, for Hopper GPUs.

A port of the JAX package ``repro`` (which stays the reference): the same
module tree and public names, with every Pallas kernel replaced by a CUDA
kernel written by hand for ``sm_90a`` (see :mod:`repro_torch.kernels`).

Device policy: constructors and generators take ``device=None``, meaning
``"cuda"``; every other function runs on the device of its input tensors.
Without a card, only an explicit ``device="cpu"`` (or CPU tensors) runs —
nothing falls back to the CPU on its own.  On CPU tensors each kernel
wrapper runs its plain PyTorch version, which is how the tests run here.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
