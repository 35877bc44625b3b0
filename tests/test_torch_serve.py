"""Port parity: serving (sampling, ``generate``, the decode step, the
``launch.serve`` entry point) against the live JAX reference.

The RNG streams of ``jax.random`` and ``torch.Generator`` differ, so greedy
decoding is held token-equal to the reference and sampled tokens only to
their range.  Weights: the reference's ``init_params`` carried in with
``interop.lm_params_from_arrays``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as TLM
from repro_torch.serve.decode import generate, make_serve_step, sample_logits

from _torch_parity import reference_modules


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.serve.decode", "repro.models.lm",
                           "repro.configs") as modules:
        yield modules


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


class TestSampling:
    def test_greedy_is_argmax(self):
        logits = torch.tensor([[[0.1, 5.0, -1.0]]])
        tok = sample_logits(_gen(), logits, temperature=0.0)
        assert tok.shape == (1, 1) and tok.dtype == torch.int32
        assert int(tok[0, 0]) == 1

    def test_temperature_sampling_in_range(self):
        logits = torch.randn(4, 1, 32, generator=_gen(1))
        for seed in range(4):
            tok = sample_logits(_gen(seed), logits, temperature=1.0)
            assert tok.shape == (4, 1) and tok.dtype == torch.int32
            assert bool(((tok >= 0) & (tok < 32)).all())

    def test_padded_vocab_slots_never_sampled(self):
        logits = torch.full((2, 1, 8), -1.0)
        logits[:, :, 6] = 100.0
        logits[:, :, 2] = 1.0
        greedy = sample_logits(_gen(), logits, temperature=0.0, vocab_size=5)
        assert greedy[:, 0].tolist() == [2, 2]
        for seed in range(8):
            tok = sample_logits(_gen(seed), logits, temperature=1.0,
                                vocab_size=5)
            assert bool((tok < 5).all()), f"pad token sampled (seed {seed})"

    def test_vocab_size_none_or_full_is_identity(self):
        logits = torch.randn(3, 1, 16, generator=_gen(4))
        a = sample_logits(_gen(5), logits, temperature=0.0)
        b = sample_logits(_gen(5), logits, temperature=0.0, vocab_size=16)
        assert torch.equal(a, b)

    def test_greedy_matches_reference_on_ties_and_pads(self, ref):
        import jax
        logits = np.random.default_rng(6).integers(-2, 3, (5, 1, 20)).astype(
            np.float32)                        # many ties: first max wins
        for vocab in (None, 12, 20):
            want = ref[0].sample_logits(jax.random.PRNGKey(0), logits, 0.0,
                                        vocab_size=vocab)
            got = sample_logits(None, torch.from_numpy(logits), 0.0,
                                vocab_size=vocab)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _model(ref, arch, seed=3):
    import jax
    _, jlm, jconfigs = ref
    jcfg = jconfigs.get_config(arch).reduced()
    jparams = jax.tree.map(np.asarray,
                           jlm.init_params(jcfg, jax.random.PRNGKey(seed))[0])
    return jcfg, jparams, get_config(arch).reduced(), lm_params_from_arrays(
        jparams, device="cpu")


class TestGenerate:
    def test_zero_steps_returns_empty(self, ref):
        _, _, cfg, params = _model(ref, "qwen15_05b")
        prompt = torch.tensor([[1, 2, 3]], dtype=torch.int32)
        cache = TLM.init_cache(cfg, 1, 3, torch.float32, device="cpu")
        out, cache = generate(params, cfg, prompt, steps=0, cache=cache)
        assert out.shape == (1, 0) and out.dtype == torch.int32
        assert cache is not None

    @pytest.mark.parametrize("arch", ["qwen15_05b", "h2o_danube3_4b",
                                      "rwkv6_3b", "hymba_15b"])
    def test_greedy_matches_reference(self, ref, arch):
        """Greedy tokens equal the reference's; the SWA configs' 8-slot
        ring wraps (4 prompt + 8 generated positions)."""
        import jax.numpy as jnp
        jcfg, jparams, cfg, params = _model(ref, arch)
        prompt = np.asarray([[1, 2, 3, 4], [7, 5, 3, 1]], np.int32)
        total = 4 + 8
        want, _ = ref[0].generate(
            jparams, jcfg, jnp.asarray(prompt), steps=8,
            cache=ref[1].init_cache(jcfg, 2, total, jnp.float32),
            temperature=0.0)
        got, _ = generate(params, cfg, torch.from_numpy(prompt), steps=8,
                          cache=TLM.init_cache(cfg, 2, total, torch.float32,
                                               device="cpu"))
        assert got.shape == (2, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_sampled_tokens_in_range(self, ref):
        _, _, cfg, params = _model(ref, "qwen15_05b")
        prompt = torch.tensor([[1, 2]], dtype=torch.int32)
        out, _ = generate(params, cfg, prompt, steps=6,
                          cache=TLM.init_cache(cfg, 1, 8, torch.float32,
                                               device="cpu"),
                          generator=_gen(9), temperature=1.0)
        assert out.shape == (1, 6)
        assert bool(((out >= 0) & (out < cfg.vocab_size)).all())

    def test_serve_step_matches_decode_step(self, ref):
        _, _, cfg, params = _model(ref, "h2o_danube3_4b")
        step, param_sh, cache_sh, cache = make_serve_step(
            cfg, batch=2, seq_len=16, dtype=torch.float32, device="cpu")
        assert param_sh is None and cache_sh is None
        assert cache["k"].shape == (cfg.num_layers, 2, 8, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
        other = TLM.init_cache(cfg, 2, 16, torch.float32, device="cpu")
        tok = torch.tensor([[3], [4]], dtype=torch.int32)
        for t in range(10):
            a, cache = step(params, tok, t, cache)
            b, other = TLM.decode_step(params, cfg, tok, t, other,
                                       dtype=torch.float32)
            assert torch.equal(a, b)


class TestLauncher:
    @pytest.mark.parametrize("arch", ["h2o_danube3_4b", "rwkv6_3b"])
    def test_reduced_on_cpu(self, capsys, arch):
        launch_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                           "--tokens", "5", "--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("5 tokens x 2 batch in ")
        assert lines[0].endswith("tok/s)")
        sample = lines[1].removeprefix("sample: [").rstrip("]").split()
        assert len(sample) == 5 and all(0 <= int(t) < 256 for t in sample)

    def test_graph_and_meshes_raise(self):
        # --graph serves (tests/test_torch_serve_graph.py runs it on the
        # CPU); its default device is the card, as the LM path's is
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                launch_serve.main(["--graph"])
        with pytest.raises(ValueError, match="one device"):
            launch_serve.main(["--graph", "--mesh", "single", "--device",
                               "cpu"])
        with pytest.raises(ValueError, match="the process group has 1$"):
            launch_serve.main(["--arch", "qwen15_05b", "--reduced",
                               "--mesh", "single", "--device", "cpu"])

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs on it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_serve.main(["--arch", "qwen15_05b", "--reduced"])
