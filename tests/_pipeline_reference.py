"""The reference's ``make_pipeline_apply`` on ``(pod, data)`` meshes, for
``tests/test_torch_pipeline.py``.

Run in a fresh process, as::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/_pipeline_reference.py IN.pkl OUT.pkl

(eight host devices have to be forced before JAX starts).  ``IN.pkl`` is
the test's: ``{name: {"mesh": (P, D), "layers": {"w", "b"}, "xs"}}`` with
numpy arrays.  For each case it runs the reference's GPipe schedule of
``tanh(x W + b)`` stages (``tests/test_pipeline.py``'s ``stage_fn``) on
``jax.make_mesh(mesh, ("pod", "data"))``, and writes the output and the
gradient of ``sum(y ** 2)`` in the stage parameters to ``OUT.pkl``.
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
        cases = pickle.load(f)

    def stage_fn(p, x):
        for i in range(p["w"].shape[0]):
            x = jnp.tanh(x @ p["w"][i] + p["b"][i])
        return x

    out = {}
    with reference_modules("repro.train.pipeline") as (pipe,):
        for name, case in cases.items():
            p, d = case["mesh"]
            mesh = jax.make_mesh((p, d), ("pod", "data"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
            stages = pipe.split_stages(
                {k: jnp.asarray(v) for k, v in case["layers"].items()}, p)
            xs = jnp.asarray(case["xs"])
            apply = pipe.make_pipeline_apply(stage_fn, mesh, p,
                                             xs.shape[0])
            y = jax.jit(apply)(stages, xs)
            grads = jax.jit(jax.grad(
                lambda sp: jnp.sum(jnp.square(apply(sp, xs)))))(stages)
            out[name] = {"y": np.asarray(y),
                         "grads": {k: np.asarray(v)
                                   for k, v in grads.items()}}
    with open(path_out, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
