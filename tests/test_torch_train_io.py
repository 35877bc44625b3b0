"""Port parity: the train modules' I/O — checkpoints (both packages read
each other's files), gradient compression, the int8 optimizer state,
synthetic data, and the train launcher — against the live JAX reference.

``repro.train.checkpoint``, ``compress`` and ``quantized_opt`` and
``repro.data.synthetic`` import no ``repro.compat`` at their top, but go
through ``_torch_parity.reference_modules`` like the rest.  Tolerances:
checkpoints bitwise; compression and the int8 codes bitwise on the codes
and 1e-6 relative on the scales (the same float32 formulas); one int8
AdamW step 1e-6 relative.  The synthetic batches come from another
generator than the reference's, so they are compared by their
properties: shapes, types, the Zipf range and the share of masked labels.
"""
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, batch_at, for_model
from repro_torch.interop import lm_params_from_arrays, opt_state_from_arrays
from repro_torch.models.lm import init_params, tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import quantized_opt as QO
from repro_torch.train.compress import (compress_roundtrip, ef_compress,
                                        init_error_state)
from repro_torch.train.optimizer import OptConfig, init_opt_state

from _torch_parity import np_of, reference_modules

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    import jax
    with reference_modules("repro.train.checkpoint", "repro.train.compress",
                           "repro.train.quantized_opt",
                           "repro.train.optimizer", "repro.data.synthetic",
                           "repro.models.lm", "repro.configs") as mods:
        names = ("ckpt", "compress", "qopt", "opt", "synthetic", "lm",
                 "configs")
        yield types.SimpleNamespace(jax=jax, **dict(zip(names, mods)))


def _port_state(seed=3):
    cfg = get_config("qwen15_05b").reduced()
    params, _ = init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    opt = init_opt_state(params)
    for _, leaf in tree_leaves(opt["mu"]):
        leaf.uniform_(-1, 1, generator=torch.Generator().manual_seed(seed))
    opt["step"].fill_(7)
    return cfg, params, opt


def _assert_same(port_tree, ref_tree):
    want = dict(tree_leaves(ref_tree))
    got = dict(tree_leaves(port_tree))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        w = np.asarray(want[path])
        g = np_of(leaf)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_port_checkpoint_restores_in_reference(ref, tmp_path):
    cfg, params, opt = _port_state()
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 7, params, opt, extra={"arch": cfg.name})
    assert ref.ckpt.latest_step(d) == 7
    like_p = ref.jax.tree.map(np.asarray, ref.lm.init_params(
        ref.configs.get_config("qwen15_05b").reduced(),
        ref.jax.random.PRNGKey(0))[0])
    like_o = ref.opt.init_opt_state(like_p)
    jp, jo, meta = ref.ckpt.restore(d, 7, like_p, like_o)
    assert meta == {"step": 7, "format": 1, "arch": cfg.name}
    _assert_same(params, ref.jax.tree.map(np.asarray, jp))
    _assert_same(opt, ref.jax.tree.map(np.asarray, jo))


def test_reference_checkpoint_restores_in_port(ref, tmp_path):
    jax = ref.jax
    jcfg = ref.configs.get_config("qwen15_05b").reduced()
    jp = jax.tree.map(np.asarray,
                      ref.lm.init_params(jcfg, jax.random.PRNGKey(4))[0])
    jo = jax.tree.map(np.asarray, ref.opt.init_opt_state(jp))
    jo["step"] = np.int32(5)
    d = str(tmp_path / "ckpt")
    ref.ckpt.save(d, 5, jp, jo, extra={"arch": jcfg.name})
    assert ckpt.latest_step(d) == 5
    _, like_p, like_o = _port_state()
    params, opt, meta = ckpt.restore(d, 5, like_p, like_o)
    assert meta["step"] == 5 and meta["arch"] == jcfg.name
    _assert_same(params, jp)
    _assert_same(opt, jo)
    assert params["embed"].device.type == "cpu"
    # restore_latest and the interop helpers give the same trees
    latest = ckpt.restore_latest(d, like_p, like_o)
    _assert_same(latest[0], jp)
    _assert_same(opt_state_from_arrays(jo, device="cpu"), jo)
    _assert_same(lm_params_from_arrays(jp, device="cpu"), jp)


def test_keep_k_gc_and_latest(tmp_path):
    _, params, opt = _port_state()
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, params, opt, keep=2)
    assert sorted(ckpt.all_steps(d)) == [4, 5]
    assert ckpt.latest_step(d) == 5
    assert ckpt.restore_latest(str(tmp_path / "none"), params, opt) is None


def test_partial_save_is_invisible(tmp_path):
    _, params, opt = _port_state()
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 1, params, opt)
    os.makedirs(os.path.join(d, "tmp.2"))       # a save that died
    os.makedirs(os.path.join(d, "step_3"))      # renamed, no meta.json
    assert ckpt.latest_step(d) == 1


def test_async_save_copies_before_the_thread(tmp_path):
    _, params, opt = _port_state()
    d = str(tmp_path / "ckpt")
    want = params["embed"].clone()
    t = ckpt.save(d, 9, params, opt, async_save=True)
    params["embed"].add_(1.0)         # the next step updates in place
    t.join(timeout=60)
    assert not t.is_alive()
    assert ckpt.latest_step(d) == 9
    restored, _, _ = ckpt.restore(d, 9, params, opt)
    assert torch.equal(restored["embed"], want)


def test_bfloat16_leaves_refuse_to_save(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path), 1, {"w": torch.ones(2, dtype=torch.bfloat16)},
                  {"step": torch.zeros((), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_compress_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
    out = compress_roundtrip(g)
    assert out.shape == g.shape and out.dtype == torch.float32
    err = float((out - g).abs().max())
    assert err <= float(g.abs().max()) / 127.0 + 1e-6


@pytest.mark.parametrize("shape", [(512,), (3, 1000), (2049,)], ids=str)
def test_compress_matches_reference(ref, shape):
    rng = np.random.default_rng(len(shape))
    g = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        np_of(compress_roundtrip(torch.from_numpy(g))),
        np.asarray(ref.compress.compress_roundtrip(g)))


def test_ef_compress_matches_reference(ref):
    rng = np.random.default_rng(1)
    grads = {"w": rng.standard_normal(512).astype(np.float32),
             "b": {"x": rng.standard_normal((4, 700)).astype(np.float32)}}
    jerr = ref.compress.init_error_state(grads)
    terr = init_error_state({"w": torch.zeros(512),
                             "b": {"x": torch.zeros(4, 700)}})
    tg = {"w": torch.from_numpy(grads["w"]),
          "b": {"x": torch.from_numpy(grads["b"]["x"])}}
    sent_total = torch.zeros(512)
    for _ in range(30):
        jsent, jerr = ref.compress.ef_compress(grads, jerr)
        tsent, terr = ef_compress(tg, terr)
        sent_total += tsent["w"]
    _assert_same(tsent, ref.jax.tree.map(np.asarray, jsent))
    want_err = dict(tree_leaves(ref.jax.tree.map(np.asarray, jerr)))
    for path, err in tree_leaves(terr):
        np.testing.assert_allclose(np_of(err), want_err[path], rtol=0,
                                   atol=1e-6, err_msg=path)
    resid = float((sent_total - 30 * tg["w"]).abs().max())
    assert resid <= float(tg["w"].abs().max()) / 127.0 + 1e-5


# ---------------------------------------------------------------------------
# the int8 optimizer state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_space", [False, True], ids=["linear", "log"])
def test_quantize_blockwise_matches_reference(ref, log_space):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 300)).astype(np.float32)
    if log_space:
        x = np.abs(x) ** 4 * 1e-3
        x[0, :5] = 0.0
    got = QO.quantize_blockwise(torch.from_numpy(x), log_space=log_space)
    want = ref.qopt.quantize_blockwise(x, log_space=log_space)
    np.testing.assert_array_equal(np_of(got["q"]), np.asarray(want["q"]))
    for key in ("s", "m"):
        np.testing.assert_allclose(np_of(got[key]), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-12)
    back = QO.dequantize_blockwise(got, x.shape, log_space=log_space)
    want_back = ref.qopt.dequantize_blockwise(want, x.shape,
                                              log_space=log_space)
    np.testing.assert_allclose(np_of(back), np.asarray(want_back),
                               rtol=1e-6, atol=1e-12)


def test_adamw_update_int8_matches_reference(ref):
    import dataclasses
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((8, 40)).astype(np.float32),
              "b": rng.standard_normal(300).astype(np.float32)}
    grads = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
    cfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5)
    jcfg = ref.qopt.OptConfig(**dataclasses.asdict(cfg))
    jstate = ref.qopt.init_opt_state_int8(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tg = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    tstate = QO.init_opt_state_int8(tp)
    for _ in range(2):
        jp, jstate, jm = ref.qopt.adamw_update_int8(params, grads, jstate,
                                                    jcfg)
        tp, tstate, tm = QO.adamw_update_int8(tp, tg, tstate, cfg)
        params = {k: np.asarray(v) for k, v in jp.items()}
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(np_of(tp[k]), params[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert int(tstate["step"]) == 2
    assert QO.state_bytes(tp, True) == ref.qopt.state_bytes(params, True)
    assert QO.state_bytes(tp, False) == ref.qopt.state_bytes(params, False)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

def test_batch_shapes_range_and_masks():
    cfg = DataConfig(seed=11, vocab_size=1000, seq_len=64, global_batch=4,
                     mean_doc_len=8)
    b = batch_at(cfg, 42, device="cpu")
    assert set(b) == {"tokens", "labels"}
    for t in b.values():
        assert t.shape == (4, 64) and t.dtype == torch.int32
    tok, lab = b["tokens"], b["labels"]
    assert int(tok.min()) >= 0 and int(tok.max()) <= 999
    assert bool((lab[:, -1] == -1).all())
    kept = lab[:, :-1] >= 0
    assert torch.equal(lab[:, :-1][kept], tok[:, 1:][kept])
    masked = float((~kept).float().mean())
    assert 0.03 < masked < 0.3          # boundaries at 1 / 8 a position


def test_deterministic_across_restart():
    cfg = DataConfig(seed=11, vocab_size=1000, seq_len=64, global_batch=4)
    b1, b2 = batch_at(cfg, 42, device="cpu"), batch_at(cfg, 42, device="cpu")
    for name in b1:
        assert torch.equal(b1[name], b2[name])
    b3 = batch_at(cfg, 43, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])
    b4 = batch_at(DataConfig(seed=12, vocab_size=1000, seq_len=64,
                             global_batch=4), 42, device="cpu")
    assert not torch.equal(b1["tokens"], b4["tokens"])


def test_frontend_stub_and_distribution_against_reference(ref):
    model = get_config("internvl2_1b").reduced()
    dcfg = for_model(model, seq_len=256, global_batch=8, seed=3)
    got = batch_at(dcfg, 0, model, device="cpu")
    assert got["prefix_embeds"].shape == (8, model.frontend_len,
                                          model.d_model)
    assert got["prefix_embeds"].dtype == torch.float32
    jdcfg = ref.synthetic.DataConfig(seed=3, vocab_size=model.vocab_size,
                                     seq_len=256, global_batch=8)
    want = ref.synthetic.batch_at(jdcfg, 0)
    tok, jtok = np_of(got["tokens"]), np.asarray(want["tokens"])
    assert tok.dtype == jtok.dtype == np.int32
    # the same Zipf law: the share of the most frequent ids, within noise
    for ident in (0, 1, model.vocab_size - 1):
        assert abs((tok == ident).mean() - (jtok == ident).mean()) < 0.05
    assert abs((np_of(got["labels"]) < 0).mean()
               - (np.asarray(want["labels"]) < 0).mean()) < 0.02


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_launcher_trains_and_resumes(tmp_path):
    d = str(tmp_path / "ckpt")
    common = ["--arch", "qwen15_05b", "--reduced", "--device", "cpu",
              "--ckpt", d, "--ckpt-every", "1", "--keep", "2"]
    first = _launch(*common, "--steps", "2")
    assert first.returncode == 0, first.stderr
    assert "finished 2 steps" in first.stdout
    assert sorted(ckpt.all_steps(d)) == [1, 2]
    second = _launch(*common, "--steps", "3")
    assert second.returncode == 0, second.stderr
    assert "resumed @ step 2" in second.stdout
    assert "finished 1 steps" in second.stdout
    assert ckpt.latest_step(d) == 3


def test_launcher_refuses_sharded_meshes():
    """``--mesh single`` is the reference's 16 x 16 production mesh: on a
    world of one process it raises, naming the world's size."""
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match=r"\(16, 16\) needs 256 ranks; "
                                         r"the process group has 1$"):
        main(["--arch", "qwen15_05b", "--reduced", "--device", "cpu",
              "--mesh", "single", "--steps", "1"])