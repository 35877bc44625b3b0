"""The reference's sharded train step on a ``(2, 2)`` mesh, for
``tests/test_torch_train_mesh.py``.

Run in a fresh process, as::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_train_mesh_reference.py IN.pkl OUT.pkl

(four host devices have to be forced before JAX starts).  ``IN.pkl`` is
the test's: ``{"opt_cfg": {...}, "cases": {name: {"arch", "overrides",
"params", "opt", "steps"}}}`` with numpy trees and batches.  For each
case it builds the reference's config, runs ``make_train_step`` with two
microbatches in float32 on ``jax.make_mesh((2, 2), ("data", "model"))``
once a batch of ``"steps"``, and writes every step's metrics and the
parameters after the last step to ``OUT.pkl``.
"""
from __future__ import annotations

import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(os.path.dirname(HERE), "src"), HERE]

from _torch_parity import reference_modules  # noqa: E402


def main(path_in: str, path_out: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    with open(path_in, "rb") as f:
        data = pickle.load(f)
    out = {}
    with reference_modules("repro.configs", "repro.train.step",
                           "repro.train.optimizer") as (conf, st, opt):
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        for name, case in data["cases"].items():
            cfg = conf.get_config(case["arch"]).reduced(**case["overrides"])
            step, psh, osh = st.make_train_step(
                cfg, opt.OptConfig(**data["opt_cfg"]), mesh,
                num_microbatches=2, dtype=jnp.float32)
            params = jax.device_put(jax.tree.map(jnp.asarray,
                                                 case["params"]), psh)
            state = jax.device_put(jax.tree.map(jnp.asarray, case["opt"]),
                                   osh)
            metrics = []
            for batch in case["steps"]:
                params, state, m = step(params, state, {
                    k: jnp.asarray(v) for k, v in batch.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            out[name] = {"metrics": metrics,
                         "params": jax.tree.map(np.asarray, params)}
    with open(path_out, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
