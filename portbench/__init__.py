"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix
or metric is a file of its own, found by name:

* ``configs/<config>.json``: the configuration as it is run (sizes, the
  precision it states, its source, ``reduced`` and ``assumed``);
* ``traffic/<traffic>.json``: the mix's parameters, and the ``driver``
  that reads them (``drivers/<driver>.py``);
* ``metrics/<metric>.py``: a reader with ``read(run)``;
* ``reference/``: the plain references that decide ``correct``;
* ``peaks.json`` and ``kernels.json``: the card's datasheet peaks and the
  port's kernel names.

Nothing here imports ``jax`` or the JAX package ``repro``; ``reference/``
imports nothing of ``repro_torch``.
"""
