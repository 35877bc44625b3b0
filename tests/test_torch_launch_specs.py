"""Port parity: the dry run's input stand-ins (``launch/specs.py``) and
``models.frontends.frontend_embed_shape``.

Every stand-in is a ``meta`` tensor (the AdamW step counter and decode's
``pos`` excepted: real 0-d CPU int32 tensors, read on the host), and its
``NamedSharding`` gives back the global shape: ``local_shape(global)`` is
the tensor's shape on rank 0 of a fake process group holding the
production mesh ``(16, 16)`` or ``(2, 16, 16)`` (the global shapes are
the reference's: ``param_shapes``, ``cache_shape``, the batch).
``dp_size`` and ``pick_microbatches`` equal the reference's for every arch
and shape.
"""
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import frontends
from repro_torch.models.lm import cache_shape, param_shapes, tree_leaves

from _torch_parity import reference_modules


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.launch.specs", "repro.configs",
                           "repro.models.frontends") as modules:
        yield dict(zip(("specs", "configs", "frontends"), modules))


@pytest.fixture(params=[False, True], ids=["16x16", "2x16x16"])
def mesh(request):
    """Rank 0's production mesh on a fake process group (destroyed
    after the test)."""
    multi = request.param
    if dist.is_initialized():
        dist.destroy_process_group()
    with fake_world(512 if multi else 256):
        yield make_production_mesh(multi_pod=multi, device="meta")


class _Stub:
    """What the reference's ``dp_size`` reads of a mesh."""

    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)


def _check_leaves(args, shardings, want_shapes):
    leaves = [list(tree_leaves(t)) for t in (args, shardings, want_shapes)]
    assert len({len(x) for x in leaves}) == 1
    for (path, t), (p2, sh), (p3, whole) in zip(*leaves):
        assert path == p2 == p3
        assert sh.local_shape(tuple(whole.shape)) == tuple(t.shape), path
        if t.dim() == 0:
            assert t.device.type == "cpu" and t.dtype == torch.int32, path
        else:
            assert t.device.type == "meta", path


def _tree(d):
    return {str(i): v for i, v in enumerate(d)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stand_ins_hold_the_global_shapes(mesh, arch):
    cfg = get_config(arch)
    shapes = {p: tuple(t.shape) for p, t in tree_leaves(param_shapes(cfg))}
    pshape = param_shapes(cfg)

    case = SHAPES["train_4k"]
    (params, opt, batch), (psh, osh, bsh) = S.train_input_specs(cfg, case,
                                                                mesh)
    tok = case.seq_len - (cfg.frontend_len if cfg.frontend else 0)
    gb = {"tokens": (case.global_batch, tok),
          "labels": (case.global_batch, tok)}
    if cfg.frontend:
        gb["prefix_embeds"] = (case.global_batch, cfg.frontend_len,
                               cfg.d_model)
    gopt = {"mu": pshape, "nu": pshape, "step": torch.zeros(())}
    _check_leaves({"p": params, "o": opt, "b": batch},
                  {"p": psh, "o": osh, "b": bsh},
                  {"p": pshape, "o": gopt,
                   "b": {k: torch.empty(v, device="meta")
                         for k, v in gb.items()}})
    assert all(t.dtype == torch.float32 for _, t in tree_leaves(params))
    assert batch["tokens"].dtype == torch.int32

    for name in ("prefill_32k", "decode_32k"):
        case = SHAPES[name]
        fn = (S.prefill_input_specs if case.kind == "prefill"
              else S.decode_input_specs)
        args, shs = fn(cfg, case, mesh)
        assert all(t.dtype == (torch.bfloat16 if t.dtype.is_floating_point
                               else t.dtype)
                   for _, t in tree_leaves(args[0]))
        assert {p: tuple(sh.local_shape(shapes[p])) for p, sh in
                tree_leaves(shs[0])} == {p: tuple(t.shape) for p, t in
                                         tree_leaves(args[0])}
        if case.kind == "decode":
            cache = {k: torch.empty(shape, device="meta") for k, (shape, _)
                     in cache_shape(cfg, case.global_batch,
                                    case.seq_len).items()}
            _check_leaves(_tree(args[1:]), _tree(shs[1:]),
                          _tree([torch.empty((case.global_batch, 1)),
                                 torch.zeros(()), cache]))
            assert int(args[2]) == 0
        else:
            assert tuple(args[1].shape) == (case.global_batch, case.seq_len
                                            - (cfg.frontend_len
                                               if cfg.frontend else 0))
            assert len(args) == (3 if cfg.frontend else 2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_microbatches_match_reference(ref, mesh, arch):
    stub = _Stub(mesh)
    assert S.dp_size(mesh) == ref["specs"].dp_size(stub) == math.prod(
        mesh.shape[a] for a in ("pod", "data") if a in mesh.shape)
    cfg, jcfg = get_config(arch), ref["configs"].get_config(arch)
    for name, case in SHAPES.items():
        jcase = ref["configs"].SHAPES[name]
        assert S.pick_microbatches(cfg, case, mesh) == \
            ref["specs"].pick_microbatches(jcfg, jcase, stub), name


@pytest.mark.parametrize("arch", ["internvl2_1b", "musicgen_large"])
def test_frontend_embed_shape_matches_reference(ref, arch):
    import jax.numpy as jnp
    cfg, jcfg = get_config(arch), ref["configs"].get_config(arch)
    got = frontends.frontend_embed_shape(cfg, 3)
    want = ref["frontends"].frontend_embed_shape(jcfg, 3)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.device.type == "meta" and got.dtype == torch.bfloat16
    assert want.dtype == jnp.bfloat16
    f32 = frontends.frontend_embed_shape(cfg, 2, torch.float32)
    assert f32.dtype == torch.float32
    gen = torch.Generator().manual_seed(0)
    drawn = frontends.make_frontend_embeds(cfg, 2, gen)
    assert drawn.shape == f32.shape and drawn.dtype == torch.float32
    assert float(np.abs(drawn.numpy()).max()) > 0
    with pytest.raises(AssertionError):
        frontends.frontend_embed_shape(get_config("qwen15_05b"), 1)
