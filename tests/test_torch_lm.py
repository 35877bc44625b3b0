"""Port parity: the LM stack (layers, ssm, lm) against the live JAX reference.

``repro.models.{lm,layers,ssm}`` are imported through
``_torch_parity.reference_modules``; the reference's parameters
(``init_params`` from a PRNG key) are carried into the port with
``interop.lm_params_from_arrays``, inputs are numpy.  Every check runs in
float32 on the CPU, where the banded attention branch runs K7's plain
version.  Tolerances: rtol/atol 1e-4 for layers and the SSM recurrences
(the reference's own chunked-vs-scan tolerance), 2e-3 for whole-model
logits (the reference's own prefill/decode tolerance,
``tests/test_models.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS

from _torch_parity import np_of, reference_modules

LAYER_TOL = 1e-4
MODEL_TOL = 2e-3
#: Banded SWA at reduced size: window 4, query chunk 4, so a 32-token
#: prompt (> 4 + 4) takes the banded branch (tests/test_models.py).
BANDED = dict(sliding_window=4, attn_query_chunk=4, swa_banded=True)
SWA_ARCHS = ["h2o_danube3_4b", "hymba_15b"]


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.models.lm", "repro.models.layers",
                           "repro.models.ssm", "repro.configs") as modules:
        yield modules


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(np_of(got), np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _model(ref, arch, seed=1, **overrides):
    """(reference config, reference params as numpy, port config, port
    params) for ``arch`` reduced with ``overrides``."""
    import jax
    jlm, _, _, jconfigs = ref
    jcfg = jconfigs.get_config(arch).reduced(**overrides)
    jparams = _np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(seed))[0])
    cfg = get_config(arch).reduced(**overrides)
    return jcfg, jparams, cfg, lm_params_from_arrays(jparams, device="cpu")


def _inputs(cfg, b, s, seed):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    prefix = (_rand((b, cfg.frontend_len, cfg.d_model), seed + 1, 0.02)
              if cfg.frontend else None)
    return tokens, prefix


def _maybe(x):
    return None if x is None else _t(x)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class TestLayers:
    def test_rmsnorm_and_rope(self, ref):
        jl = ref[1]
        x = _rand((2, 6, 4, 16), 0)
        scale = _rand((16,), 1)
        _close(TL.rmsnorm({"scale": _t(scale)}, _t(x)),
               jl.rmsnorm({"scale": scale}, x))
        pos = np.random.default_rng(2).integers(0, 5000, (2, 6)).astype(
            np.int32)
        for theta in (10_000.0, 1_000_000.0):
            _close(TL.rope_freqs(16, theta), jl.rope_freqs(16, theta))
            _close(TL.apply_rope(_t(x), _t(pos), theta),
                   jl.apply_rope(x, pos, theta))

    @pytest.mark.parametrize("heads", [(4, 4), (4, 1), (8, 2)])
    @pytest.mark.parametrize("branch", ["full", "chunked", "chunked_swa",
                                        "banded"])
    def test_attention_branches(self, ref, branch, heads):
        import jax
        jl = ref[1]
        h, hkv = heads
        hd, d, s = 16, 32, 32
        kw = {"full": dict(sliding_window=None, query_chunk=None),
              "chunked": dict(sliding_window=None, query_chunk=8),
              "chunked_swa": dict(sliding_window=8, query_chunk=8),
              "banded": dict(sliding_window=8, query_chunk=8,
                             swa_banded=True)}[branch]
        jp = _np_tree(jl.attention_init(jax.random.PRNGKey(3), d, h, hkv,
                                        hd, True)[0])
        jp["bq"] = _rand(jp["bq"].shape, 4)
        x = _rand((2, s, d), 5)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s))
        common = dict(num_heads=h, num_kv_heads=hkv, head_dim=hd,
                      rope_theta=10_000.0, return_kv=True, **kw)
        want = jl.attention(jp, x, pos, **common)
        got = TL.attention({k: _t(v) for k, v in jp.items()}, _t(x),
                           _t(pos), **common)
        for g, w in zip(got, want):
            _close(g, w)

    def test_banded_branch_runs_k7(self, monkeypatch):
        calls = []
        real = TL.flash_swa_gqa

        def spy(q, k, v, **kw):
            calls.append((tuple(q.shape), tuple(k.shape), kw))
            return real(q, k, v, **kw)

        monkeypatch.setattr(TL, "flash_swa_gqa", spy)
        gen = torch.Generator().manual_seed(0)
        params, _ = TL.attention_init(gen, 32, 8, 2, 16, False, device="cpu")
        x = torch.randn(1, 32, 32, generator=gen)
        pos = torch.arange(32, dtype=torch.int32)[None]
        kw = dict(num_heads=8, num_kv_heads=2, head_dim=16,
                  rope_theta=1e4, sliding_window=8, query_chunk=8)
        TL.attention(params, x, pos, swa_banded=True, **kw)
        assert calls == [((1, 32, 8, 16), (1, 32, 2, 16),
                          dict(window=8, qc=8))]
        TL.attention(params, x, pos, swa_banded=False, **kw)
        TL.attention(params, x[:, :16], pos[:, :16], swa_banded=True, **kw)
        assert len(calls) == 1    # not banded: S <= qc + window

    @pytest.mark.parametrize("window", [None, 4])
    def test_attention_decode_ring(self, ref, window):
        """Decode over a 6-slot ring, past the wrap, against the
        reference step by step."""
        import jax
        import jax.numpy as jnp
        jl = ref[1]
        h, hkv, hd, d, slots = 4, 2, 16, 32, 6
        jp = _np_tree(jl.attention_init(jax.random.PRNGKey(6), d, h, hkv,
                                        hd, False)[0])
        tp = {k: _t(v) for k, v in jp.items()}
        jk = jv = np.zeros((2, slots, hkv, hd), np.float32)
        tk, tv = torch.zeros(2, slots, hkv, hd), torch.zeros(2, slots, hkv,
                                                             hd)
        kw = dict(num_heads=h, num_kv_heads=hkv, head_dim=hd,
                  rope_theta=10_000.0, sliding_window=window)
        for pos in range(10):
            x = _rand((2, 1, d), 10 + pos)
            want, jk, jv = jl.attention_decode(jp, x, jnp.int32(pos), jk,
                                               jv, **kw)
            got, tk2, tv2 = TL.attention_decode(tp, _t(x), pos, tk, tv, **kw)
            assert tk2 is tk and tv2 is tv        # updated in place
            _close(got, want)
            _close(tk, jk)
            _close(tv, jv)

    @pytest.mark.parametrize("activation", ["silu_glu", "sq_relu", "gelu"])
    def test_mlp(self, ref, activation):
        import jax
        jl = ref[1]
        jp = _np_tree(jl.mlp_init(jax.random.PRNGKey(7), 32, 48,
                                  activation)[0])
        x = _rand((2, 5, 32), 8)
        _close(TL.mlp({k: _t(v) for k, v in jp.items()}, _t(x), activation),
               jl.mlp(jp, x, activation))
        gen = torch.Generator().manual_seed(0)
        tp, specs = TL.mlp_init(gen, 32, 48, activation, device="cpu")
        assert {k: v.shape for k, v in tp.items()} == {
            k: tuple(v.shape) for k, v in jp.items()}
        assert specs.keys() == tp.keys()


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

class TestSSM:
    def test_recurrences_match_reference_and_chunked(self, ref):
        js = ref[2]
        B, S, H, K, V = 2, 64, 2, 8, 8
        r = _rand((B, S, H, K), 1)
        k = _rand((B, S, H, K), 2, 0.3)
        v = _rand((B, S, H, V), 3)
        logw = -np.exp(_rand((B, S, H, K), 4))
        u = _rand((H, K), 5, 0.2)
        s0 = _rand((B, H, K, V), 6, 0.1)
        want = js.wkv_scan(r, k, v, logw, u, s0)
        targs = [_t(a) for a in (r, k, v, logw, u)]
        o1, s1 = TS.wkv_scan(*targs, _t(s0))
        _close(o1, want[0])
        _close(s1, want[1])
        for chunk in (1, 8, 16, 64, 24):
            o2, s2 = TS.wkv_chunked(*targs, _t(s0), chunk=chunk)
            _close(o2, o1)
            _close(s2, s1)
        D, N = 6, 4
        a = np.random.default_rng(7).uniform(0.01, 0.999, (B, S, D, N)
                                             ).astype(np.float32)
        bx = _rand((B, S, D, N), 8)
        c = _rand((B, S, N), 9)
        want = js.ssm_scan(a, bx, c)
        y1, h1 = TS.ssm_scan(_t(a), _t(bx), _t(c))
        _close(y1, want[0])
        _close(h1, want[1])
        for chunk in (16, 40):
            y2, h2 = TS.ssm_chunked(_t(a), _t(bx), _t(c), chunk=chunk)
            _close(y2, y1)
            _close(h2, h1)

    @pytest.mark.parametrize("use_chunked", [True, False])
    def test_blocks_with_state(self, ref, use_chunked):
        import jax
        js = ref[2]
        d, heads, hd, s = 32, 2, 16, 12
        x = _rand((2, s, d), 11)
        xp = _rand((2, 1, d), 12)
        state = _rand((2, heads, hd, hd), 13, 0.1)
        jp = _np_tree(js.rwkv6_init(jax.random.PRNGKey(14), d, heads,
                                    hd)[0])
        kw = dict(num_heads=heads, head_dim=hd, chunk=4,
                  use_chunked=use_chunked, return_state=True)
        jy, (jx, jst) = js.rwkv6_block(jp, x, x_prev=xp, state=state, **kw)
        ty, (tx, tst) = TS.rwkv6_block({k: _t(v) for k, v in jp.items()},
                                       _t(x), x_prev=_t(xp),
                                       state=_t(state), **kw)
        for g, w in ((ty, jy), (tx, jx), (tst, jst)):
            _close(g, w)
        jc = _np_tree(js.rwkv_cmix_init(jax.random.PRNGKey(15), d, 48)[0])
        jy, jx = js.rwkv_cmix(jc, x, x_prev=xp, return_state=True)
        ty, tx = TS.rwkv_cmix({k: _t(v) for k, v in jc.items()}, _t(x),
                              x_prev=_t(xp), return_state=True)
        _close(ty, jy)
        _close(tx, jx)
        jm = _np_tree(js.mamba_init(jax.random.PRNGKey(16), d, 24, 4)[0])
        h0 = _rand((2, 24, 4), 17, 0.1)
        jy, jh = js.mamba_block(jm, x, chunk=4, use_chunked=use_chunked,
                                state=h0, return_state=True)
        ty, th = TS.mamba_block({k: _t(v) for k, v in jm.items()}, _t(x),
                                chunk=4, use_chunked=use_chunked,
                                state=_t(h0), return_state=True)
        _close(ty, jy)
        _close(th, jh)


# ---------------------------------------------------------------------------
# the model, all ten families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
class TestLM:
    def test_forward_matches_reference(self, ref, arch):
        jcfg, jparams, cfg, params = _model(ref, arch)
        tokens, prefix = _inputs(cfg, 2, 16, 20)
        want, jaux = ref[0].forward(jparams, jcfg, tokens, prefix,
                                    dtype=np.float32)
        got, aux = TLM.forward(params, cfg, _t(tokens), _maybe(prefix),
                               dtype=torch.float32)
        s_total = 16 + cfg.frontend_len
        assert got.shape == (2, s_total, cfg.padded_vocab)
        _close(got, want, MODEL_TOL)
        _close(aux, jaux, 1e-5)

    def test_prefill_and_decode_match_reference(self, ref, arch):
        import jax.numpy as jnp
        jcfg, jparams, cfg, params = _model(ref, arch, seed=2)
        tokens, prefix = _inputs(cfg, 2, 14, 21)
        off, plen = cfg.frontend_len, 9
        cache_len = 14 + off
        jl, jc = ref[0].prefill(jparams, jcfg, tokens[:, :plen], prefix,
                                dtype=np.float32, cache_len=cache_len)
        tl, tc = TLM.prefill(params, cfg, _t(tokens[:, :plen]),
                             _maybe(prefix), dtype=torch.float32,
                             cache_len=cache_len)
        _close(tl, jl, MODEL_TOL)
        assert tc.keys() == jc.keys()
        for name in tc:
            _close(tc[name], jc[name], MODEL_TOL)
        for t in range(plen, 14):
            jl, jc = ref[0].decode_step(jparams, jcfg, tokens[:, t:t + 1],
                                        jnp.int32(t + off), jc,
                                        dtype=np.float32)
            tl, tc = TLM.decode_step(params, cfg, _t(tokens[:, t:t + 1]),
                                     t + off, tc, dtype=torch.float32)
            _close(tl, jl, MODEL_TOL)

    def test_prefill_then_decode_matches_forward(self, arch):
        """The port's prefill + decode continuation == its forward
        (tests/test_models.py's check; MoE with a drop-free capacity)."""
        cfg = get_config(arch).reduced(capacity_factor=8.0)
        gen = torch.Generator().manual_seed(11)
        params, _ = TLM.init_params(cfg, gen, device="cpu")
        tokens, prefix = _inputs(cfg, 2, 14, 12)
        tokens, prefix = _t(tokens), _maybe(prefix)
        off, plen = cfg.frontend_len, 9
        want, _ = TLM.forward(params, cfg, tokens, prefix,
                              dtype=torch.float32)
        logits, cache = TLM.prefill(params, cfg, tokens[:, :plen], prefix,
                                    dtype=torch.float32,
                                    cache_len=14 + off)
        _close(logits[:, 0], want[:, off + plen - 1], MODEL_TOL)
        for t in range(plen, 14):
            logits, cache = TLM.decode_step(params, cfg, tokens[:, t:t + 1],
                                            t + off, cache,
                                            dtype=torch.float32)
            _close(logits[:, 0], want[:, off + t], MODEL_TOL)

    def test_init_shapes_and_counts(self, ref, arch):
        jcfg, jparams, cfg, params = _model(ref, arch)
        gen = torch.Generator().manual_seed(0)
        tparams, specs = TLM.init_params(cfg, gen, device="cpu")
        shapes = dict((p, tuple(v.shape)) for p, v in
                      TLM.tree_leaves(tparams))
        assert shapes == dict((p, tuple(v.shape)) for p, v in
                              TLM.tree_leaves(jparams))
        assert sorted(p for p, _ in TLM.tree_leaves(specs)) == sorted(shapes)
        full = get_config(arch)
        jfull = ref[3].get_config(arch)
        assert TLM.param_count(full) == ref[0].param_count(jfull)
        assert TLM.active_param_count(full) == ref[0].active_param_count(
            jfull)


# ---------------------------------------------------------------------------
# banded SWA (K7 inside the model)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SWA_ARCHS)
class TestBanded:
    def test_banded_forward_matches_reference(self, ref, arch, monkeypatch):
        calls = []
        real = TL.flash_swa_gqa
        monkeypatch.setattr(TL, "flash_swa_gqa",
                            lambda *a, **kw: calls.append(kw) or real(*a,
                                                                      **kw))
        jcfg, jparams, cfg, params = _model(ref, arch, seed=21, **BANDED)
        tokens, _ = _inputs(cfg, 2, 32, 22)
        want, _ = ref[0].forward(jparams, jcfg, tokens, dtype=np.float32)
        got, _ = TLM.forward(params, cfg, _t(tokens), dtype=torch.float32)
        assert calls == [dict(window=4, qc=4)] * cfg.num_layers
        _close(got, want, MODEL_TOL)
        # banded == full sliding-window attention (the reference's test)
        full_cfg = get_config(arch).reduced(sliding_window=4)
        full, _ = TLM.forward(params, full_cfg, _t(tokens),
                              dtype=torch.float32)
        _close(got, full, LAYER_TOL)

    def test_banded_prefill_then_decode(self, ref, arch):
        """A banded 16-token prompt, then decode past the 4-slot ring's
        wrap, against the reference and the port's own forward."""
        import jax.numpy as jnp
        jcfg, jparams, cfg, params = _model(ref, arch, seed=23, **BANDED)
        tokens, _ = _inputs(cfg, 2, 24, 24)
        jl, jc = ref[0].prefill(jparams, jcfg, tokens[:, :16],
                                dtype=np.float32, cache_len=24)
        tl, tc = TLM.prefill(params, cfg, _t(tokens[:, :16]),
                             dtype=torch.float32, cache_len=24)
        assert tc["k"].shape[2] == 4
        _close(tl, jl, MODEL_TOL)
        want, _ = TLM.forward(params, cfg, _t(tokens), dtype=torch.float32)
        _close(tl[:, 0], want[:, 15], MODEL_TOL)
        for t in range(16, 24):
            jl, jc = ref[0].decode_step(jparams, jcfg, tokens[:, t:t + 1],
                                        jnp.int32(t), jc, dtype=np.float32)
            tl, tc = TLM.decode_step(params, cfg, _t(tokens[:, t:t + 1]), t,
                                     tc, dtype=torch.float32)
            _close(tl, jl, MODEL_TOL)
            _close(tl[:, 0], want[:, t], MODEL_TOL)


# ---------------------------------------------------------------------------
# the module and interop
# ---------------------------------------------------------------------------

def test_decoder_lm_module(ref):
    jcfg, jparams, cfg, params = _model(ref, "qwen15_05b", seed=30)
    model = TLM.DecoderLM(cfg, params)
    tokens, _ = _inputs(cfg, 1, 8, 31)
    want, _ = ref[0].forward(jparams, jcfg, tokens, dtype=np.float32)
    got, _ = model(_t(tokens), dtype=torch.float32)
    _close(got, want, MODEL_TOL)
    # trainable weights; serving's prefill and decode record no graph
    assert all(p.requires_grad for p in model.parameters())
    logits, _ = model.prefill(_t(tokens), dtype=torch.float32)
    assert logits.grad_fn is None
    cache = model.init_cache(1, 8, dtype=torch.float32)
    assert cache["k"].shape == (cfg.num_layers, 1, 8, cfg.num_kv_heads,
                                cfg.resolved_head_dim)
    gen = torch.Generator().manual_seed(0)
    bf = TLM.DecoderLM.from_config(cfg, gen, device="cpu",
                                   dtype=torch.bfloat16)
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}


def test_lm_params_from_arrays(ref):
    _, jparams, _, params = _model(ref, "hymba_15b")
    for (jpath, jleaf), (tpath, tleaf) in zip(TLM.tree_leaves(jparams),
                                              TLM.tree_leaves(params)):
        assert jpath == tpath
        assert tleaf.dtype == torch.float32 and tleaf.device.type == "cpu"
        np.testing.assert_array_equal(tleaf.numpy(), jleaf)
    with pytest.raises(KeyError, match="layers"):
        lm_params_from_arrays({k: v for k, v in jparams.items()
                               if k != "layers"}, device="cpu")
