"""Hand-written Hopper kernels for the compute hot spots.

Each kernel ships as a subpackage: ``csrc/`` (CUDA C++ for ``sm_90a``,
built by :mod:`repro_torch.kernels._build` at first use), ``kernel.py``
(the ctypes wrappers, each beside its plain PyTorch version and a launch
counter), ``ops.py`` (the public wrapper doing the load-balancing set-up)
and ``ref.py`` (the oracle).
"""
