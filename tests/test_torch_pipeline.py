"""Port parity: the GPipe pipeline over ``pod`` (``train/pipeline.py``).

The reference's own test case (``tests/test_pipeline.py``): P = 4 stages
on a ``(pod, data) = (4, 2)`` mesh, 8 layers of ``tanh(x W + b)`` at width
16, 6 microbatches of 2.  The port runs it on a spawned gloo group of 8
CPU ranks (``tests/_torch_shard_group.py``, job ``pipeline``) and the
reference's ``make_pipeline_apply`` runs on 8 forced host devices in one
subprocess started when the module starts (``tests/_pipeline_reference.py``);
the same inputs go to both.  A group of 2 ranks runs ``(2, 1)`` and two
reduced H2O-Danube3-4B blocks (banded K7 attention, remat) as the stages.

Tolerances are the reference test's: the forward within 1e-5, every stage
gradient within 1e-4 (``tests/test_pipeline.py:40-54``).
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import init_params, tree_map
from repro_torch.train.pipeline import (block_stage_fn, reference_apply,
                                        split_stages)

from _torch_parity import reference_modules
from _torch_shard_group import _flat, run_group

HERE = Path(__file__).resolve().parent
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
REF_DEADLINE_S = 240
D = 16
DANUBE = dict(num_layers=2, sliding_window=4, attn_query_chunk=4,
              swa_banded=True, remat=True)


def _tanh_case(mesh):
    rng = np.random.default_rng(0)
    layers = {"w": (rng.standard_normal((8, D, D)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((8, D)) * 0.1).astype(np.float32)}
    xs = rng.standard_normal((6, 2, D)).astype(np.float32)
    return {"mesh": mesh, "layers": layers, "xs": xs}


def _danube_case():
    cfg = get_config("h2o_danube3_4b").reduced(**DANUBE)
    params, _ = init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    xs = np.random.default_rng(5).standard_normal(
        (3, 2, 32, cfg.d_model)).astype(np.float32)
    return {"mesh": (2, 1), "danube": DANUBE, "xs": xs,
            "layers": tree_map(lambda a: a.numpy(), params["layers"])}


CASES = {"4x2": _tanh_case((4, 2)), "2x1": _tanh_case((2, 1)),
         "danube": _danube_case()}
REFERENCE_CASES = ("4x2", "2x1")


def _tanh_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


@pytest.fixture(scope="module", autouse=True)
def _reference_process(tmp_path_factory):
    """The reference's pipeline on 8 forced host devices, started once at
    module start."""
    d = tmp_path_factory.mktemp("pipeline_ref")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({k: {n: CASES[k][n] for n in ("mesh", "layers", "xs")}
                     for k in REFERENCE_CASES}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "_pipeline_reference.py"),
         str(d / "in.pkl"), str(d / "out.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    state = {"proc": proc, "out": d / "out.pkl", "start": time.monotonic()}
    yield state
    if proc.poll() is None:
        proc.kill()
    proc.communicate(timeout=30)


@pytest.fixture(scope="module")
def reference(_reference_process):
    proc = _reference_process["proc"]
    left = REF_DEADLINE_S - (time.monotonic() - _reference_process["start"])
    try:
        log, _ = proc.communicate(timeout=max(left, 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, log.decode()[-3000:]
    with open(_reference_process["out"], "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def groups():
    """``world -> [per-rank results of the pipeline job]``, each run
    once."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_group(world, "pipeline", CASES)
        return cache[world]
    return get


def _world(case):
    p, d = CASES[case]["mesh"]
    return p * d


def _stage_grads(ranks, case):
    """The stage gradients stacked ``[P, L/P, ...]`` from the ranks (the
    first rank of each ``pod`` coordinate), by leaf path."""
    by_stage = {}
    for r in ranks:
        by_stage.setdefault(r[case]["coord"], _flat(r[case]["grads"]))
    return {k: np.stack([by_stage[s][k] for s in sorted(by_stage)])
            for k in by_stage[0]}


def _one_device(case):
    """The port's ``reference_apply`` on one device: output and the
    gradient of ``sum(y ** 2)`` in the stacked stages."""
    c = CASES[case]
    p = c["mesh"][0]
    stages = tree_map(lambda a: torch.from_numpy(a).requires_grad_(),
                      split_stages(tree_map(np.asarray, c["layers"]), p))
    stage_fn = _tanh_stage
    if "danube" in c:
        cfg = get_config("h2o_danube3_4b").reduced(**c["danube"])
        stage_fn = block_stage_fn(cfg, c["xs"].shape[2])
    y = reference_apply(stage_fn, stages, torch.from_numpy(c["xs"]), p)
    (y ** 2).sum().backward()
    return y.detach().numpy(), _flat(tree_map(lambda a: a.grad.numpy(),
                                              stages))


def test_split_stages_matches_reference():
    import jax.numpy as jnp
    layers = CASES["4x2"]["layers"]
    with reference_modules("repro.train.pipeline") as (pipe,):
        want = pipe.split_stages({k: jnp.asarray(v)
                                  for k, v in layers.items()}, 4)
    got = split_stages({k: torch.from_numpy(v) for k, v in layers.items()},
                       4)
    for k in layers:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(AssertionError):
        split_stages({"w": torch.zeros(6, 2)}, 4)


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_matches_reference_pipeline(groups, reference, case):
    """Forward on every rank and every stage gradient against the
    reference's ``make_pipeline_apply`` on the same mesh shape."""
    ranks = groups(_world(case))
    want = reference[case]
    for r in ranks:
        np.testing.assert_allclose(r[case]["y"], want["y"], rtol=FWD_TOL,
                                   atol=FWD_TOL)
    got = _stage_grads(ranks, case)
    for k, w in _flat(want["grads"]).items():
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_matches_reference_apply(groups, case):
    """Forward and stage gradients against ``reference_apply`` (the
    sequential oracle) on one device: the tanh stages and the reduced
    Danube blocks."""
    ranks = groups(_world(case))
    y, grads = _one_device(case)
    for r in ranks:
        np.testing.assert_allclose(r[case]["y"], y, rtol=FWD_TOL,
                                   atol=FWD_TOL)
    got = _stage_grads(ranks, case)
    for k, w in grads.items():
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=k)


def test_gradient_counts_the_loss_once(groups):
    """Every rank computes the same loss from the same output; the
    gradient enters on the last stage alone, so no stage's gradient is
    ``P`` times the one-device gradient.  Each stage also sent ``T - 1``
    hops forward and ``T - 1`` back, and one output broadcast."""
    ranks = groups(2)
    y, grads = _one_device("2x1")
    got = _stage_grads(ranks, "2x1")
    for k, w in grads.items():
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL, atol=GRAD_TOL)
        assert not np.allclose(got[k], 2 * w, rtol=GRAD_TOL, atol=GRAD_TOL)
    ticks = CASES["2x1"]["xs"].shape[0] + 2 - 1
    for r in ranks:
        kinds = r["2x1"]["kinds"]
        assert kinds["collective-permute@2"][0] == 2 * (ticks - 1)
        assert kinds["broadcast@2"][0] == 1
