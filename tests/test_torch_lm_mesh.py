"""Port parity: the LM's mesh specs — ``batch_pspec``, ``shardings_for``,
``opt_shardings``, ``_data_axes`` and ``cache_pspecs`` — against the live
JAX reference for all ten configs on the meshes ``(1, 1)``, ``(2, 2)``,
``(4, 2)`` and ``(2, 16, 16)``; and the port's meshes themselves:
``make_production_mesh`` on the fake process group at worlds of 256 and
512 (axis names, shape, each rank's coordinate and sub-groups),
``make_host_mesh`` without a group, and ``NamedSharding``'s blocks.

The reference's functions read a mesh's ``axis_names`` and ``shape`` and
build ``NamedSharding``s on it, so they get a
``jax.sharding.AbstractMesh`` of the shape (no devices); the port's get a
stub with the same two attributes.
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import (NamedSharding, launcher_backend,
                                     make_host_mesh, make_production_mesh,
                                     sharded)
from repro_torch.models.lm import tree_leaves
from repro_torch.serve.decode import _data_axes, cache_pspecs
from repro_torch.train.step import (batch_pspec, opt_shardings, param_specs,
                                    shardings_for)

from _torch_parity import reference_modules

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCHES = (1, 2, 4, 6, 8, 32, 128)


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.train.step", "repro.serve.decode",
                           "repro.configs") as (step, decode, configs):
        yield types.SimpleNamespace(step=step, decode=decode,
                                    configs=configs)


def _meshes(name):
    from jax.sharding import AbstractMesh
    shape, names = MESHES[name]
    stub = types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))
    return AbstractMesh(shape, names), stub


def _norm(spec) -> tuple:
    """A spec with one-axis tuples written as the axis (the installed
    jax's ``PartitionSpec`` does so; both mean the same placement)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _ref_specs(tree, prefix=""):
    """``{path: spec tuple}`` of a reference tree of ``PartitionSpec`` or
    ``NamedSharding`` leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_specs(v, f"{prefix}/{k}"))
        return out
    return {prefix: _norm(getattr(tree, "spec", tree))}


def _port_specs(tree):
    return {p: _norm(s.spec if isinstance(s, NamedSharding) else s)
            for p, s in tree_leaves(tree)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_pspec_matches_reference(ref, mesh):
    jmesh, stub = _meshes(mesh)
    assert batch_pspec(stub) == tuple(ref.step.batch_pspec(jmesh))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_match_reference(ref, arch, mesh):
    """``shardings_for`` (axes the mesh lacks dropped) and
    ``opt_shardings``, leaf by leaf."""
    jmesh, stub = _meshes(mesh)
    jcfg, cfg = ref.configs.get_config(arch), get_config(arch)
    jsh = ref.step.shardings_for(jmesh, ref.step.param_specs(jcfg))
    sh = shardings_for(stub, param_specs(cfg))
    assert _port_specs(sh) == _ref_specs(jsh)
    assert _port_specs(opt_shardings(stub, sh)) == _ref_specs(
        ref.step.opt_shardings(jmesh, jsh))
    assert all(s.mesh is stub for _, s in tree_leaves(sh))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(ref, arch, mesh):
    jmesh, stub = _meshes(mesh)
    jcfg, cfg = ref.configs.get_config(arch), get_config(arch)
    for b in BATCHES:
        assert _data_axes(stub, b) == tuple(ref.decode._data_axes(jmesh, b))
        assert _port_specs(cache_pspecs(cfg, stub, b)) == _ref_specs(
            ref.decode.cache_pspecs(jcfg, jmesh, b)), b


@pytest.fixture
def fake_world():
    """``init(rank, world)``: this process as ``rank`` of a fake process
    group of ``world`` ranks (no peers, collectives do nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(rank, world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", rank=rank, world_size=world,
                                store=FakeStore())
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_the_fake_group(fake_world, multi_pod):
    """Every rank's mesh: the reference's axes and shape, its row-major
    coordinate, and the ranks of each axis's sub-group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = int(np.prod(shape))
    for rank in range(world):
        fake_world(rank, world)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        coords = np.unravel_index(rank, shape)
        assert mesh.axis_names == names
        assert mesh.shape == dict(zip(names, shape))
        assert mesh.size == world and mesh.rank == rank
        for i, name in enumerate(names):
            assert mesh.coord(name) == coords[i]
            ax = mesh.axes[i]
            assert ax.num_shards == shape[i] and ax.rank == coords[i]
            want = []
            for k in range(shape[i]):
                c = list(coords)
                c[i] = k
                want.append(int(np.ravel_multi_index(c, shape)))
            assert dist.get_process_group_ranks(ax.group) == want
        assert mesh.coord("pod") == (coords[0] if multi_pod else 0)


@pytest.mark.parametrize("multi_pod, world", [(False, 4), (False, 512),
                                              (True, 256)])
def test_production_mesh_needs_its_world(fake_world, multi_pod, world):
    fake_world(0, world)
    with pytest.raises(ValueError, match=f"has {world}$"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_host_mesh_without_a_group():
    mesh = make_host_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.group is None and str(mesh).startswith("LMMesh(data=1,")
    with pytest.raises(ValueError, match="model_axis=2"):
        make_host_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="model_axis=0"):
        make_host_mesh(0, device="cpu")


def test_one_rank_mesh_is_no_mesh(fake_world):
    assert sharded(None) is None
    assert sharded(make_host_mesh(device="cpu")) is None
    fake_world(0, 4)
    mesh = make_host_mesh(2, device="cpu")
    assert sharded(mesh) is mesh and mesh.backend == "fake"


@pytest.mark.parametrize("cards, device, want", [
    (0, None, "gloo"), (4, "cpu", "gloo"), (2, None, "gloo"),
    (2, "cuda", "gloo"), (4, None, "nccl"), (8, "cuda", "nccl")])
def test_launcher_backend(monkeypatch, cards, device, want):
    """NCCL only where each of the 4 ranks has a card of its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert launcher_backend(4, device) == want


def test_host_mesh_on_the_fake_group(fake_world):
    for rank in range(8):
        fake_world(rank, 8)
        mesh = make_host_mesh(2, device="cpu")
        assert mesh.shape == {"data": 4, "model": 2}
        assert (mesh.coord("data"), mesh.coord("model")) == divmod(rank, 2)
    with pytest.raises(ValueError, match="model_axis=3"):
        make_host_mesh(3, device="cpu")


def test_named_sharding_blocks(fake_world):
    """Each rank's block of a ``(pod, data)``-major batch axis and of a
    ``(model, data)`` table, and the primary replica of each block."""
    full = torch.arange(8 * 6).reshape(8, 6)
    seen = {}
    for rank in range(8):
        fake_world(rank, 8)
        mesh = make_host_mesh(2, device="cpu")          # (4, 2)
        rows = NamedSharding(mesh, (("data",), None))
        table = NamedSharding(mesh, ("model", "data"))
        d, m = mesh.coord("data"), mesh.coord("model")
        assert torch.equal(rows.shard(full), full[2 * d:2 * d + 2])
        seen[rank] = (rows.primary, table.primary)
        assert NamedSharding(mesh, ()).shard(full) is full
        with pytest.raises(ValueError, match="does not split"):
            NamedSharding(mesh, (None, "data")).local_shape((8, 6))
        assert table.local_shape((8, 8)) == (4, 2)
        assert torch.equal(table.shard(full[:, :4].repeat(1, 2)),
                           full[:, :4].repeat(1, 2)[4 * m:4 * m + 4,
                                                    2 * d:2 * d + 2])
    # rows are replicated over model: rank (d, 0) holds the primary copy
    assert [seen[r][0] for r in range(8)] == [r % 2 == 0 for r in range(8)]
    assert all(seen[r][1] for r in range(8))
