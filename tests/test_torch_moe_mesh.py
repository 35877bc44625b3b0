"""Expert parallelism: one MoE layer (``models.moe.moe(mesh=)``) on gloo
groups of CPU ranks, against the same layer on one device.

One group of two ranks (``tests/_torch_shard_group.py``, job
``moe_layer``) runs every case on ``(2, 1)`` (the batch split over
``data``, every expert on each rank) and on ``(1, 2)`` (four of the eight
experts a rank), with each dispatch (``grouped``, ``capacity``,
``sorted``) and shared experts on ``grouped``.  Each rank's output and aux
loss must lie within 1e-5 (relative to the largest entry) of one device's,
and on ``(1, 2)`` each rank must hold and run only its four experts.

Case ``capacity-drop`` makes the global capacity visible: ``x >= 0`` and
the router's column 0 raised, so every token's top-2 holds expert 0,
whose global capacity (5 of the 16 tokens) keeps only atoms of the first
row; the second row, data shard 1's, drops all of them, where a capacity
counted on each shard alone would keep two.  Both meshes are held to a
token-by-token oracle of the dispatch (float64).  A one-rank mesh is the
one-device path bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as M

from _torch_shard_group import run_group

TOL = 1e-5
D, F, E, K = 32, 48, 8, 2
B, S = 2, 8
DISPATCHES = ("grouped", "capacity", "sorted")


def _params(seed, shared=0, raise0=0.0):
    params, specs = M.moe_init(torch.Generator().manual_seed(seed), D, F, E,
                               shared, "silu_glu", device="cpu")
    params["router"][:, 0] += raise0
    return {k: v.numpy() for k, v in params.items()}, specs


def _cases():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cases = {}
    for d in DISPATCHES:
        p, _ = _params(1)
        cases[d] = dict(params=p, x=x, kw=dict(
            num_experts=E, top_k=K, num_shared=0, dispatch=d))
    p, _ = _params(2, shared=2)
    cases["grouped-shared"] = dict(params=p, x=x, kw=dict(
        num_experts=E, top_k=K, num_shared=2, dispatch="grouped"))
    p, _ = _params(3, raise0=0.2)
    cases["capacity-drop"] = dict(params=p, x=np.abs(x), kw=dict(
        num_experts=E, top_k=K, num_shared=0, dispatch="capacity"))
    return cases


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def group(cases):
    specs = _params(0, shared=2)[1]
    return run_group(2, "moe_layer", {"cases": cases, "specs": specs})


def _one_device(case, **over):
    params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    with torch.no_grad():
        y, aux = M.moe(params, torch.from_numpy(case["x"]),
                       **dict(case["kw"], **over))
    return y.numpy(), float(aux)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("name", list(DISPATCHES) + ["grouped-shared",
                                                     "capacity-drop"])
def test_layer_matches_one_device(cases, group, mesh, name):
    want, want_aux = _one_device(cases[name])
    for r in group:
        got = r[f"{mesh}/{name}"]
        np.testing.assert_allclose(got["y"], want, rtol=0,
                                   atol=TOL * np.abs(want).max())
        np.testing.assert_allclose(got["aux"], want_aux, rtol=TOL)


@pytest.mark.parametrize("name", DISPATCHES)
def test_rank_holds_and_runs_its_own_experts(group, name):
    """On ``(1, 2)`` each rank's ``w1`` block and every expert FFN (or
    grouped GEMM) it runs has ``E / 2`` experts; on ``(2, 1)`` all ``E``."""
    for r in group:
        split, whole = r[f"1x2/{name}"], r[f"2x1/{name}"]
        assert split["w1"][0] == E // 2 and whole["w1"][0] == E
        assert split["experts"] and set(split["experts"]) == {E // 2}
        assert set(whole["experts"]) == {E}
        assert len(split["experts"]) == (3 if name == "sorted" else 1)


def _kept_atoms(idx, capacity):
    """Which atoms a capacity keeps: each expert's first ``capacity`` atoms
    in token-major order (the stable sort's ranks)."""
    seen = np.zeros(E, np.int64)
    kept = np.zeros(idx.shape, bool)
    for t in range(idx.shape[0]):
        for j in range(K):
            kept[t, j] = seen[idx[t, j]] < capacity
            seen[idx[t, j]] += 1
    return kept


def _oracle(params, x, capacity):
    """The capacity dispatch token by token: kept atoms' expert outputs
    weighted and added."""
    p = {k: torch.from_numpy(v).double() for k, v in params.items()}
    x2d = torch.from_numpy(x).reshape(-1, D)
    idx, w, _ = M._router({"router": p["router"].float()}, x2d, E, K)
    kept = _kept_atoms(idx.numpy(), capacity)
    out = np.zeros((x2d.shape[0], D))
    for t in range(x2d.shape[0]):
        for j in range(K):
            if kept[t, j]:
                e, h = int(idx[t, j]), x2d[t].double()
                y = (torch.nn.functional.silu(h @ p["w1"][e])
                     * (h @ p["w3"][e])) @ p["w2"][e]
                out[t] += float(w[t, j]) * y.numpy()
    return out.reshape(x.shape), idx.numpy(), kept


def test_capacity_drops_follow_the_global_order(cases, group):
    case = cases["capacity-drop"]
    cap = int(1.25 * B * S * K / E)
    want, idx, kept = _oracle(case["params"], case["x"], cap)
    assert cap == 5 and bool((idx == 0).any(axis=1).all())  # all pick 0
    zero = (idx == 0).reshape(B, S, K)
    kept = kept.reshape(B, S, K)
    assert kept[0][zero[0]].sum() == cap and not kept[1][zero[1]].any()
    for mesh in ("2x1", "1x2"):
        np.testing.assert_allclose(group[0][f"{mesh}/capacity-drop"]["y"],
                                   want, rtol=0, atol=TOL * np.abs(want).max())
    # a capacity counted on shard 1 alone keeps some of its expert-0 atoms
    alone = _kept_atoms(idx[S:], int(1.25 * S * K / E))
    assert alone[idx[S:] == 0].any()


@pytest.mark.parametrize("name", DISPATCHES)
def test_one_rank_mesh_is_bitwise_one_device(cases, name):
    case = cases[name]
    mesh = make_host_mesh(device="cpu")
    params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    x = torch.from_numpy(case["x"])
    with torch.no_grad():
        a, aux_a = M.moe(params, x, mesh=mesh, **case["kw"])
        b, aux_b = M.moe(params, x, **case["kw"])
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert mesh.stats.calls == 0
