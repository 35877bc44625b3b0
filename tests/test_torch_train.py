"""Port parity: training — ``lm_loss``, ``loss_and_grads``, AdamW and the
train step — against the live JAX reference, on the CPU in float32.

``repro.models.lm``, ``repro.train.*`` and ``repro.configs`` come through
``_torch_parity.reference_modules``; the reference's parameters and
optimizer state are carried into the port with
``interop.lm_params_from_arrays`` and ``interop.opt_state_from_arrays``.
The banded archs (Danube, Hymba) run ``reduced(sliding_window=8,
attn_query_chunk=8, swa_banded=True)``, so their 32-token sequences take
K7's banded branch (its plain version and plain backward here).

Tolerances: losses 1e-5 relative; every gradient leaf within 2e-5 of the
leaf's largest entry (6.6e-6 measured: float32 sums in another order);
an AdamW update on the same trees 1e-6 (relative, and absolute on the
parameters); parameters after two train steps within 1e-5 absolute, with
``eps = 1e-3``: at the default 1e-8 Adam's first steps move every entry by
about ``lr * sign(g)``, so gradient entries that are zero up to rounding
flip by ``2 lr`` between any two summation orders.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import lm_params_from_arrays, opt_state_from_arrays
from repro_torch.kernels.flash_swa import kernel as FK
from repro_torch.launch.mesh import GraphMesh, LMMesh, make_host_mesh
from repro_torch.models import lm_loss
from repro_torch.models.lm import init_params, tree_leaves
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, lr_at)
from repro_torch.train.step import (METRIC_KEYS, loss_and_grads,
                                    make_train_step, param_specs)

from _torch_parity import np_of, reference_modules

BANDED = dict(sliding_window=8, attn_query_chunk=8, swa_banded=True)
SWA_ARCHS = ("h2o_danube3_4b", "hymba_15b")
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
STEP_ATOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    import jax
    with reference_modules("repro.models.lm", "repro.configs",
                           "repro.train.step",
                           "repro.train.optimizer") as modules:
        jlm, jconf, jstep, jopt = modules
        yield types.SimpleNamespace(lm=jlm, configs=jconf, step=jstep,
                                    opt=jopt, jax=jax)


def _overrides(arch, **extra):
    return {**(BANDED if arch in SWA_ARCHS else {}), **extra}


def _model(ref, arch, seed=1, **extra):
    """(reference config, reference params as numpy, port config, port
    params) for ``arch`` reduced."""
    jax = ref.jax
    over = _overrides(arch, **extra)
    jcfg = ref.configs.get_config(arch).reduced(**over)
    jparams = jax.tree.map(np.asarray,
                           ref.lm.init_params(jcfg, jax.random.PRNGKey(seed))
                           [0])
    cfg = get_config(arch).reduced(**over)
    return jcfg, jparams, cfg, lm_params_from_arrays(jparams, device="cpu")


def _batch(cfg, b, s, seed):
    """numpy tokens, labels (10% masked) and the frontend stub."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.where(rng.random((b, s)) < 0.1, -1,
                      rng.integers(0, cfg.vocab_size, (b, s))
                      ).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend:
        batch["prefix_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _jax_batch(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_tree_close(got, want, tol, what):
    want = dict(tree_leaves(want))
    got = dict(tree_leaves(got))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(np_of(g), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {path}")


def _np_tree(ref, tree):
    return ref.jax.tree.map(np.asarray, tree)


def _tensor_tree(tree):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_matches_reference(ref, arch):
    jcfg, jparams, cfg, params = _model(ref, arch)
    batch = _batch(cfg, 2, 32, 11)
    jtotal, jm = ref.lm.lm_loss(jparams, jcfg, _jax_batch(batch),
                                dtype=np.float32)
    total, m = lm_loss(params, cfg, _torch_batch(batch), dtype=torch.float32)
    for got, want in ((total, jtotal), (m["loss"], jm["loss"]),
                      (m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                                   atol=1e-7)
    assert float(m["ntokens"]) == float(jm["ntokens"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(ref, arch):
    """Two microbatches (the reference's scan; the port's two backwards
    into one gradient buffer)."""
    jcfg, jparams, cfg, params = _model(ref, arch, seed=2)
    batch = _batch(cfg, 2, 32, 12)
    jl, jm, jg = ref.step.loss_and_grads(jparams, jcfg, _jax_batch(batch), 2,
                                         np.float32)
    tl, tm, tg = loss_and_grads(params, cfg, _torch_batch(batch), 2,
                                torch.float32)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert float(tm["ntokens"]) == float(jm["ntokens"])
    _assert_tree_close(tg, _np_tree(ref, jg), GRAD_TOL, arch)


@pytest.mark.parametrize("case", [
    ("qwen15_05b", {}), ("h2o_danube3_4b", {}),
    ("nemotron4_340b", {"loss_seq_chunk": 8}),
    ("qwen15_05b", {"loss_seq_chunk": 16})],
    ids=["qwen", "danube-banded", "nemotron-chunked-ce",
         "qwen-chunked-ce"])
def test_one_microbatch_and_chunked_ce(ref, case):
    """One microbatch (no scan), and the sequence-chunked cross-entropy
    (``loss_seq_chunk`` dividing S) under checkpoint."""
    arch, extra = case
    jcfg, jparams, cfg, params = _model(ref, arch, seed=3, **extra)
    batch = _batch(cfg, 2, 32, 13)
    jl, jm, jg = ref.step.loss_and_grads(jparams, jcfg, _jax_batch(batch), 1,
                                         np.float32)
    tl, tm, tg = loss_and_grads(params, cfg, _torch_batch(batch), 1,
                                torch.float32)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    _assert_tree_close(tg, _np_tree(ref, jg), GRAD_TOL, arch)


def test_grad_accum_bf16_matches_reference(ref):
    """``grad_accum_bf16``: the microbatches' gradients summed in a
    bfloat16 accumulator, as the reference; held at bf16's 2^-8."""
    jcfg, jparams, cfg, params = _model(ref, "qwen15_05b", seed=4,
                                        grad_accum_bf16=True)
    batch = _batch(cfg, 4, 16, 14)
    _, _, jg = ref.step.loss_and_grads(jparams, jcfg, _jax_batch(batch), 2,
                                       np.float32)
    _, _, tg = loss_and_grads(params, cfg, _torch_batch(batch), 2,
                              torch.float32)
    _assert_tree_close(tg, _np_tree(ref, jg), 2 ** -7, "bf16 accumulation")
    _, _, f32 = loss_and_grads(params, dataclasses.replace(
        cfg, grad_accum_bf16=False), _torch_batch(batch), 2, torch.float32)
    assert any(not torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(tg), tree_leaves(f32)))


def test_remat_gives_the_same_gradients_and_reruns_k7(monkeypatch):
    """``cfg.remat`` (per-layer checkpoint): the same loss and gradients,
    bitwise on the CPU, and the banded attention's forward runs twice a
    layer (the recompute), its backward once."""
    cfg = get_config("h2o_danube3_4b").reduced(**BANDED)
    gen = torch.Generator().manual_seed(5)
    params, _ = init_params(cfg, gen, device="cpu")
    batch = _torch_batch(_batch(cfg, 2, 32, 15))
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = FK.flash_swa, FK.flash_swa_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(FK, "flash_swa", count_fwd)
    monkeypatch.setattr(FK, "flash_swa_bwd", count_bwd)
    results = {}
    for remat in (False, True):
        calls.update(fwd=0, bwd=0)
        run_cfg = dataclasses.replace(cfg, remat=remat)
        results[remat] = loss_and_grads(params, run_cfg, batch, 1,
                                        torch.float32)
        assert calls["fwd"] == cfg.num_layers * (2 if remat else 1)
        assert calls["bwd"] == cfg.num_layers
    assert torch.equal(results[True][0], results[False][0])
    for (_, a), (_, b) in zip(tree_leaves(results[True][2]),
                              tree_leaves(results[False][2])):
        assert torch.equal(a, b)


def test_microbatched_grads_match_full_batch():
    """The reference's own check (``tests/test_train.py``) on the port:
    per-microbatch token means, so losses close and gradients looser."""
    cfg = get_config("qwen15_05b").reduced()
    params, _ = init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    batch = _torch_batch(_batch(cfg, 4, 16, 16))
    l1, _, g1 = loss_and_grads(params, cfg, batch, 1, torch.float32)
    l2, _, g2 = loss_and_grads(params, cfg, batch, 4, torch.float32)
    np.testing.assert_allclose(float(l1), float(l2), rtol=0.05)
    for (_, a), (_, b) in zip(tree_leaves(g1), tree_leaves(g2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.1,
                                   atol=2e-2)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 57, 100, 250])
def test_lr_at_matches_reference(ref, step):
    cfg = OptConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    want = ref.opt.lr_at(ref.opt.OptConfig(**dataclasses.asdict(cfg)),
                         np.int32(step))
    np.testing.assert_allclose(float(lr_at(cfg, step)), float(want),
                               rtol=1e-6)


def _opt_trees(seed):
    """Parameters (matrices and vectors), gradients and a state three
    steps in, as numpy."""
    rng = np.random.default_rng(seed)

    def tree(scale, positive=False):
        draw = lambda shape: (np.abs(rng.standard_normal(shape))
                              if positive else rng.standard_normal(shape))
        return {"w": (scale * draw((6, 5))).astype(np.float32),
                "layers": {"b": (scale * draw((7,))).astype(np.float32),
                           "m": (scale * draw((2, 3, 4))).astype(np.float32)}}
    return (tree(1.0), tree(0.3),
            {"mu": tree(0.01), "nu": tree(1e-4, positive=True),
             "step": np.int32(3)})


@pytest.mark.parametrize("clip_norm", [100.0, 0.5], ids=["unclipped",
                                                         "clipped"])
def test_adamw_update_matches_reference(ref, clip_norm):
    import jax.numpy as jnp
    params, grads, state = _opt_trees(7)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                    clip_norm=clip_norm)
    jp, jstate, jm = ref.opt.adamw_update(
        params, grads, ref.jax.tree.map(jnp.asarray, state),
        ref.opt.OptConfig(**dataclasses.asdict(cfg)))
    tp, tg = _tensor_tree(params), _tensor_tree(grads)
    tstate = opt_state_from_arrays(state, device="cpu")
    out_p, out_state, tm = adamw_update(tp, tg, tstate, cfg)
    assert out_p is tp     # in place
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert float(tm["grad_norm"]) > clip_norm or clip_norm == 100.0
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(out_state["step"]) == int(jstate["step"]) == 4
    for got, want in ((out_p, jp), (out_state["mu"], jstate["mu"]),
                      (out_state["nu"], jstate["nu"])):
        _assert_tree_close(got, _np_tree(ref, want), 1e-6, "adamw")


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    cfg = OptConfig(lr=0.2, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, clip_norm=10.0)
    for _ in range(150):
        params, opt, _ = adamw_update(params, {"w": 2 * params["w"].clone()},
                                      opt, cfg)
    assert float((params["w"] ** 2).sum()) < 1e-2


def test_lr_schedule():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    assert float(lr_at(cfg, 5)) == pytest.approx(0.5)
    assert float(lr_at(cfg, 10)) == pytest.approx(1.0, rel=0.1)
    assert float(lr_at(cfg, 100)) == pytest.approx(0.1, rel=0.01)


def test_grad_clipping_reports_pre_clip_norm():
    params = {"w": torch.zeros(4)}
    opt = init_opt_state(params)
    cfg = OptConfig(lr=0.1, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    _, _, metrics = adamw_update(params, {"w": torch.full((4,), 1e6)}, opt,
                                 cfg)
    assert float(metrics["grad_norm"]) > 1e5
    assert float(params["w"].abs().max()) <= 0.1 + 1e-6


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_two_train_steps_match_reference(ref, arch):
    """``make_train_step`` (two microbatches, clipping on) twice from the
    same parameters and optimizer state as the reference's jitted step on
    a one-device mesh."""
    import jax
    import jax.numpy as jnp
    jcfg, jparams, cfg, params = _model(ref, arch, seed=6)
    jopt = _np_tree(ref, ref.opt.init_opt_state(jparams))
    cfg_opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                        clip_norm=0.5, eps=1e-3)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jstep, psh, osh = ref.step.make_train_step(
        jcfg, ref.opt.OptConfig(**dataclasses.asdict(cfg_opt)), mesh,
        num_microbatches=2, dtype=jnp.float32)
    jp = jax.device_put(jax.tree.map(jnp.asarray, jparams), psh)
    jo = jax.device_put(jax.tree.map(jnp.asarray, jopt), osh)
    step = make_train_step(cfg, cfg_opt, num_microbatches=2,
                           dtype=torch.float32)
    opt = opt_state_from_arrays(jopt, device="cpu")
    for i in range(2):
        batch = _batch(cfg, 4, 32, 20 + i)
        jp, jo, jm = jstep(jp, jo, _jax_batch(batch))
        params, opt, m = step(params, opt, _torch_batch(batch))
        assert set(m) == set(METRIC_KEYS)
        for key in METRIC_KEYS:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    assert int(opt["step"]) == 2
    want = dict(tree_leaves(_np_tree(ref, jp)))
    for path, leaf in tree_leaves(params):
        np.testing.assert_allclose(leaf.numpy(), want[path], rtol=0,
                                   atol=STEP_ATOL, err_msg=path)


def test_loss_decreases_with_microbatching():
    from repro_torch.data.synthetic import batch_at, for_model
    cfg = get_config("qwen15_05b").reduced()
    params, _ = init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptConfig(warmup_steps=2, total_steps=50),
                           num_microbatches=2, dtype=torch.float32)
    dcfg = for_model(cfg, seq_len=32, global_batch=4)
    losses = []
    for i in range(8):
        params, opt, m = step(params, opt, batch_at(dcfg, i, device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_moe_arch_trains():
    from repro_torch.data.synthetic import batch_at, for_model
    cfg = get_config("olmoe_1b_7b").reduced()
    params, _ = init_params(cfg, torch.Generator().manual_seed(2),
                            device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=20),
                           dtype=torch.float32)
    dcfg = for_model(cfg, seq_len=16, global_batch=2)
    before = {p: t.clone() for p, t in tree_leaves(params)}
    for i in range(3):
        params, opt, m = step(params, opt, batch_at(dcfg, i, device="cpu"))
        assert np.isfinite(float(m["loss"]))
    for path, leaf in tree_leaves(params):
        assert bool(torch.isfinite(leaf).all()), path
        assert not torch.equal(leaf, before[path]), path


def test_meshes_of_more_than_one_device_raise():
    """A one-rank mesh is the one-device path: two steps bitwise equal to
    ``mesh=None``'s, and no collective.  A model axis of more than one
    rank that does not divide the KV heads builds a step whose attention
    runs whole on every rank of it, with no collective at build time
    (tests/test_torch_train_mesh.py runs both kinds of mesh)."""
    from repro_torch.data.synthetic import batch_at, for_model
    cfg = get_config("qwen15_05b").reduced()
    mesh = make_host_mesh(device="cpu")
    dcfg = for_model(cfg, seq_len=16, global_batch=4)
    runs = []
    for m in (None, mesh):
        params, _ = init_params(cfg, torch.Generator().manual_seed(8),
                                device="cpu")
        opt = init_opt_state(params)
        step = make_train_step(cfg, OptConfig(warmup_steps=1),
                               m, num_microbatches=2, dtype=torch.float32)
        for i in range(2):
            params, opt, metrics = step(params, opt,
                                        batch_at(dcfg, i, device="cpu"))
        runs.append((params, opt, metrics))
    (p0, o0, m0), (p1, o1, m1) = runs
    for (path, a), (_, b) in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(tree_leaves(o0), tree_leaves(o1)):
        assert torch.equal(a, b), path
    assert {k: float(v) for k, v in m0.items()} == {
        k: float(v) for k, v in m1.items()}
    assert mesh.stats.calls == 0
    cpu = torch.device("cpu")
    wide = LMMesh(("data", "model"), (GraphMesh(1, 0, cpu),
                                      GraphMesh(8, 0, cpu)), 0, cpu)
    from repro_torch.models.layers import heads_split
    assert not heads_split(cfg.num_heads, cfg.num_kv_heads, wide)
    assert callable(make_train_step(cfg, OptConfig(), wide))
    assert wide.stats.calls == 0


def test_param_specs_match_reference(ref):
    for arch in ("qwen15_05b", "olmoe_1b_7b", "hymba_15b"):
        want = dict(tree_leaves(ref.step.param_specs(
            ref.configs.get_config(arch))))
        got = dict(tree_leaves(param_specs(get_config(arch))))
        assert got.keys() == want.keys()
        for path, spec in got.items():
            assert tuple(spec) == tuple(want[path]), path
