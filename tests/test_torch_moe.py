"""Port parity: the MoE layer against the live JAX reference.

``repro.models.moe`` is imported through the batching-table swap of
``_torch_parity``; its parameters (``moe_init`` from a PRNG key) are
carried into the port with ``interop.moe_params_from_arrays``.  Configs:
OLMoE-1B-7B and DeepSeek-MoE-16B (shared experts), both ``.reduced()``.
Tolerances: rtol/atol 2e-3 for layer outputs (the reference's own,
``tests/test_models.py``), 1e-5 for ``aux``; router ids equal only where
the fixture asserts a gap above 1e-6 between the k-th and (k+1)-th
probability.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.interop import moe_params_from_arrays
from repro_torch.models import moe as TM

from _torch_parity import assert_bitwise, np_of, reference_modules

ARCHS = ["olmoe_1b_7b", "deepseek_moe_16b"]
POLICY_PATHS = [(s, p) for s in ("group_mapped", "chunked_rr",
                                 "chunked_lpt") for p in ("pure", "native")]


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.models.moe", "repro.configs") as modules:
        yield modules


@pytest.fixture
def autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)


def _setup(ref, arch, *, seed=7, shape=(2, 8)):
    """(reference params, port params, x as numpy, port config)."""
    import jax
    jmoe, jconfigs = ref
    cfg = get_config(arch).reduced()
    jcfg = jconfigs.get_config(arch).reduced()
    jparams, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg.d_model,
                               jcfg.d_ff, jcfg.num_experts,
                               jcfg.num_shared_experts, jcfg.activation)
    jparams = {k: np.asarray(v) for k, v in jparams.items()}
    params = moe_params_from_arrays(jparams, device="cpu")
    x = (np.random.default_rng(seed + 1)
         .standard_normal((*shape, cfg.d_model)).astype(np.float32) * 0.5)
    return jparams, params, x, cfg


def _kw(cfg):
    return dict(num_experts=cfg.num_experts, top_k=cfg.top_k)


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=tol,
                               atol=tol)


class TestRouter:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_router_against_reference(self, ref, arch):
        import jax.numpy as jnp
        jparams, params, x, cfg = _setup(ref, arch, shape=(4, 16))
        x2d = x.reshape(-1, cfg.d_model)
        jidx, jw, jaux = ref[0]._router(jparams, jnp.asarray(x2d),
                                        cfg.num_experts, cfg.top_k)
        idx, w, aux = TM._router(params, torch.from_numpy(x2d),
                                 cfg.num_experts, cfg.top_k)
        logits = x2d @ jparams["router"]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        top = -np.sort(-probs, axis=-1)
        gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        assert gap.min() > 1e-6, "fixture too close to a top-k tie"
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(np_of(idx), np.asarray(jidx))
        np.testing.assert_allclose(np_of(w), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


class TestDispatch:
    @pytest.mark.parametrize("dispatch", ["capacity", "grouped", "sorted"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_moe_against_reference(self, ref, arch, dispatch):
        import jax.numpy as jnp
        jparams, params, x, cfg = _setup(ref, arch)
        kw = dict(_kw(cfg), num_shared=cfg.num_shared_experts,
                  dispatch=dispatch, capacity_factor=cfg.capacity_factor)
        jout, jaux = ref[0].moe(jparams, jnp.asarray(x), **kw)
        out, aux = TM.moe(params, torch.from_numpy(x), **kw)
        assert out.shape == x.shape and out.dtype == torch.float32
        _close(out, jout)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)

    @pytest.mark.parametrize("schedule,path", POLICY_PATHS)
    def test_sorted_policies(self, ref, schedule, path):
        import jax.numpy as jnp
        jparams, params, x, cfg = _setup(ref, "olmoe_1b_7b")
        kw = dict(_kw(cfg), schedule=schedule, execution_path=path)
        jout, jaux = ref[0].moe_sorted(jparams, jnp.asarray(x), **kw)
        out, aux = TM.moe_sorted(params, torch.from_numpy(x), **kw)
        _close(out, jout)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        base, _ = TM.moe_sorted(params, torch.from_numpy(x), **_kw(cfg))
        assert_bitwise(out, base, f"{schedule}/{path} vs group_mapped")

    def test_sorted_auto(self, ref, autotune_cache):
        import jax.numpy as jnp
        jparams, params, x, cfg = _setup(ref, "olmoe_1b_7b", shape=(4, 32))
        jout, _ = ref[0].moe_sorted(jparams, jnp.asarray(x), **_kw(cfg),
                                    schedule="auto")
        out, _ = TM.moe_sorted(params, torch.from_numpy(x), **_kw(cfg),
                               schedule="auto")
        _close(out, jout)

    @pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
    def test_capacity_drops_like_the_reference(self, ref, capacity_factor):
        import jax.numpy as jnp
        jparams, params, x, cfg = _setup(ref, "olmoe_1b_7b", shape=(2, 16))
        kw = dict(_kw(cfg), capacity_factor=capacity_factor)
        for name in ("moe_capacity", "moe_capacity_grouped",
                     "moe_capacity_einsum"):
            jout, _ = getattr(ref[0], name)(jparams, jnp.asarray(x), **kw)
            out, _ = getattr(TM, name)(params, torch.from_numpy(x), **kw)
            _close(out, jout)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_sorted_equals_capacity_uncapped(self, ref, arch):
        _, params, x, cfg = _setup(ref, arch)
        cap, aux1 = TM.moe_capacity(params, torch.from_numpy(x), **_kw(cfg),
                                    capacity_factor=100.0)
        srt, aux2 = TM.moe_sorted(params, torch.from_numpy(x), **_kw(cfg))
        _close(srt, np_of(cap))
        np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-5)

    def test_shared_experts(self, ref):
        import jax.numpy as jnp
        jparams, params, x, cfg = _setup(ref, "deepseek_moe_16b")
        assert cfg.num_shared_experts > 0 and "sw1" in params
        _close(TM.moe_shared(params, torch.from_numpy(x)),
               ref[0].moe_shared(jparams, jnp.asarray(x)))

    def test_unknown_dispatch_raises(self, ref):
        _, params, x, cfg = _setup(ref, "olmoe_1b_7b")
        with pytest.raises(ValueError):
            TM.moe(params, torch.from_numpy(x), **_kw(cfg), num_shared=0,
                   dispatch="dense")


class TestInitAndModule:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_shapes_specs_and_ranges(self, ref, arch):
        import jax
        cfg = get_config(arch).reduced()
        jparams, jspecs = ref[0].moe_init(
            jax.random.PRNGKey(0), cfg.d_model, cfg.d_ff, cfg.num_experts,
            cfg.num_shared_experts, cfg.activation)
        gen = torch.Generator().manual_seed(0)
        params, specs = TM.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.num_experts, cfg.num_shared_experts,
                                    cfg.activation, device="cpu")
        assert params.keys() == jparams.keys() == specs.keys()
        for name, value in params.items():
            assert tuple(value.shape) == jparams[name].shape, name
            assert specs[name] == tuple(jspecs[name]), name
            bound = float(np.abs(np.asarray(jparams[name])).max())
            assert float(value.abs().max()) <= bound * 1.05, name

    def test_init_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.moe_init(torch.Generator(), 8, 8, 2, 0, "silu_glu")

    def test_layer_forward_is_moe(self, ref):
        _, params, x, cfg = _setup(ref, "deepseek_moe_16b")
        layer = TM.MoELayer(params, **_kw(cfg),
                            num_shared=cfg.num_shared_experts,
                            schedule="chunked_lpt")
        out, aux = layer(torch.from_numpy(x))
        want, want_aux = TM.moe(params, torch.from_numpy(x), **_kw(cfg),
                                num_shared=cfg.num_shared_experts,
                                dispatch="sorted", schedule="chunked_lpt")
        assert_bitwise(out, want)
        assert float(aux) == float(want_aux)
        assert not any(p.requires_grad for p in layer.parameters())

    def test_layer_from_config(self):
        cfg = get_config("olmoe_1b_7b").reduced()
        layer = TM.MoELayer.from_config(
            cfg, torch.Generator().manual_seed(1), device="cpu")
        x = torch.randn(1, 4, cfg.d_model,
                        generator=torch.Generator().manual_seed(2))
        out, aux = layer(x)
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert layer.w1.shape == (cfg.num_experts, cfg.d_model, cfg.d_ff)
