"""Port parity: the sharded train step (FSDP over ``data``, tensor
parallelism over ``model``) on gloo groups of CPU ranks, against the
one-device port and against the reference's own ``(2, 2)`` run.

Two groups run once each (``tests/_torch_shard_group.py``, job
``lm_train``): two ranks on the meshes ``(2, 1)`` and ``(1, 2)``, four on
``(2, 2)``, and four on ``(1, 4)``, with reduced Qwen and reduced Danube
(``sliding_window=4, attn_query_chunk=4, swa_banded=True``, so its
32-token sequences take the banded branch, with remat, and
``num_kv_heads=2`` so that a model axis of 2 splits its KV heads), and
reduced Qwen with the sequence-chunked cross-entropy (``loss_seq_chunk=8``)
on ``(1, 2)``.  Attention runs on each rank's block of heads
(``layers.head_block``) where ``model`` does not divide them: case
``1x2/danube-kv1`` (4 query heads, one KV head gathered whole over
``model`` and narrowed), ``1x2/danube-h6kv3`` (6 / 3 heads: the blocks'
query heads read KV heads 0-1 and 1-2, an uneven grouping, so K/V are
repeated a query head before K7), ``1x4/danube-h3`` (3 / 1 heads on 4:
blocks 1, 1, 1, 0, a rank without heads), and reduced Hymba with 5 / 1
heads on ``(1, 2)`` and ``(2, 2)`` (blocks 3 + 2, every projection
gathered whole and narrowed); and the MoE configs, expert-parallel over ``model`` with the
router statistics over the whole batch: reduced OLMoE-1B-7B (8 experts,
top-2, ``grouped``) on all three meshes, reduced DeepSeek-MoE-16B (shared
experts) on ``(2, 2)``, and OLMoE with ``moe_dispatch="capacity"`` on
``(2, 1)`` and ``(2, 2)``, its router's column 0 raised so that expert 0
overflows the global capacity and the drops fall on the second data
shard's rows.  The SSM families run tensor-parallel over ``model``:
reduced RWKV6-3B (4 heads of 16, split 2 a rank on ``(1, 2)`` and ``(2,
2)``; with ``d_model=48``, 3 heads, cases ``1x2/rwkv-h3`` and
``1x4/rwkv-h3`` run the time mix on the head blocks 2 + 1 and 1, 1, 1, 0,
and the channel mix on ``d_ff / tp`` columns) and reduced Hymba-1.5B
(``sliding_window=4, attn_query_chunk=4, swa_banded=True``, remat; its
one KV head gathered whole over ``model``, its mamba heads split over
their ``d_inner`` of 64).  Every
leaf that is whole over ``model`` (the router, the norms, the SSM blocks'
``mu``, ``decay_base``, ``bonus_u``, ``wb``, ``wc``) is copied on every
rank of it: each rank's own gradient of it is held to one device.  Every case
starts from the reference's weights, carried to each rank's blocks with
``interop.lm_params_from_arrays(shardings=)``, and runs in float32 with
two microbatches of a global batch of 4.  One batch masks far more labels
in the rows that go to data shard 0 than in those of shard 1, so the
shards count different numbers of tokens: the loss's normaliser must be
global.

The reference's ``make_train_step`` runs on a ``(2, 2)`` mesh of four
forced host devices in one subprocess (``tests/_train_mesh_reference.py``),
started when the module starts, from the same weights and batches; its
GSPMD pads Hymba's 5 heads where the port splits them 3 + 2.

Tolerances are ``tests/test_torch_train.py``'s: losses 1e-5 relative,
every gradient leaf within 2e-5 of its largest entry, parameters after two
steps within 1e-5 absolute (``OptConfig(eps=1e-3)``, as there).  A
checkpoint saved from ``(2, 2)`` restores onto ``(1, 4)`` and ``(4, 1)``
bitwise.
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
from repro_torch.interop import lm_params_from_arrays, opt_state_from_arrays
from repro_torch.launch.mesh import GraphMesh, LMMesh
from repro_torch.models.lm import tree_leaves
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import loss_and_grads, make_train_step

from _torch_parity import reference_modules
from _torch_shard_group import _flat, run_group

HERE = Path(__file__).resolve().parent
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
STEP_ATOL = 1e-5
REF_DEADLINE_S = 240
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5,
           eps=1e-3)
ARCHS = {"qwen": ("qwen15_05b", {}),
         "danube": ("h2o_danube3_4b", dict(
             sliding_window=4, attn_query_chunk=4, swa_banded=True,
             num_kv_heads=2, remat=True)),
         "qwen-chunked-ce": ("qwen15_05b", dict(loss_seq_chunk=8)),
         # one KV head: a model axis of 2 gathers it whole and narrows it
         "danube-kv1": ("h2o_danube3_4b", dict(
             sliding_window=4, attn_query_chunk=4, swa_banded=True,
             remat=True)),
         # 6 / 3 heads on 2: blocks of 3 query heads read KV heads 2 + 1
         "danube-h6kv3": ("h2o_danube3_4b", dict(
             num_heads=6, num_kv_heads=3, sliding_window=4,
             attn_query_chunk=4, swa_banded=True, remat=True)),
         # 3 / 1 heads on 4: blocks 1, 1, 1, 0
         "danube-h3": ("h2o_danube3_4b", dict(
             num_heads=3, sliding_window=4, attn_query_chunk=4,
             swa_banded=True, remat=True)),
         "olmoe": ("olmoe_1b_7b", {}),
         "deepseek": ("deepseek_moe_16b", {}),
         "olmoe-capacity": ("olmoe_1b_7b", dict(moe_dispatch="capacity")),
         "rwkv": ("rwkv6_3b", {}),
         # 3 heads: blocks 2 + 1 on a model axis of 2, 1, 1, 1, 0 on 4
         "rwkv-h3": ("rwkv6_3b", dict(d_model=48)),
         "hymba": ("hymba_15b", dict(
             sliding_window=4, attn_query_chunk=4, swa_banded=True,
             remat=True)),
         # 5 / 1 heads: blocks 3 + 2 on a model axis of 2
         "hymba-h5": ("hymba_15b", dict(
             num_heads=5, sliding_window=4, attn_query_chunk=4,
             swa_banded=True, remat=True))}
#: arch keys whose router's column 0 is raised by this much
ROUTER_RAISE = {"olmoe-capacity": 1.0}
#: the archs the reference's (2, 2) subprocess runs
REFERENCE_ARCHS = ("qwen", "danube", "olmoe", "deepseek", "olmoe-capacity",
                   "hymba", "hymba-h5")
#: case -> (world, model axis, arch key); the checkpoint case (2x2/danube)
#: stays the last of world 4
CASES = {"2x1/olmoe": (2, 1, "olmoe"), "1x2/olmoe": (2, 2, "olmoe"),
         "2x1/olmoe-capacity": (2, 1, "olmoe-capacity"),
         "2x2/olmoe": (4, 2, "olmoe"), "2x2/deepseek": (4, 2, "deepseek"),
         "2x2/olmoe-capacity": (4, 2, "olmoe-capacity"),
         "2x1/qwen": (2, 1, "qwen"), "1x2/qwen": (2, 2, "qwen"),
         "1x2/danube": (2, 2, "danube"),
         "1x2/qwen-chunked-ce": (2, 2, "qwen-chunked-ce"),
         "1x2/danube-kv1": (2, 2, "danube-kv1"),
         "1x2/danube-h6kv3": (2, 2, "danube-h6kv3"),
         "1x2/rwkv": (2, 2, "rwkv"), "1x2/rwkv-h3": (2, 2, "rwkv-h3"),
         "1x2/hymba": (2, 2, "hymba"), "1x2/hymba-h5": (2, 2, "hymba-h5"),
         "2x2/rwkv": (4, 2, "rwkv"), "2x2/hymba": (4, 2, "hymba"),
         "2x2/hymba-h5": (4, 2, "hymba-h5"),
         "1x4/danube-h3": (4, 4, "danube-h3"),
         "1x4/rwkv-h3": (4, 4, "rwkv-h3"),
         "2x2/qwen": (4, 2, "qwen"), "2x2/danube": (4, 2, "danube")}
B, S = 4, 32


def _batch(cfg, seed, uneven=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.where(rng.random((B, S)) < 0.1, -1,
                      rng.integers(0, cfg.vocab_size, (B, S))
                      ).astype(np.int32)
    if uneven:           # each microbatch's first row: data shard 0's
        labels[::2, :S - 3] = -1
    return {"tokens": tokens, "labels": labels}


def _tensors(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def data():
    """Per arch key: the reference's weights and optimizer state (numpy),
    the batches, and the port's config."""
    import jax
    with reference_modules("repro.models.lm", "repro.configs",
                           "repro.train.optimizer") as (jlm, jconf, jopt):
        out = {}
        for key, (arch, over) in ARCHS.items():
            jcfg = jconf.get_config(arch).reduced(**over)
            params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3))
            params = jax.tree.map(np.array, params)
            if key in ROUTER_RAISE:
                params["layers"]["moe"]["router"][..., 0] += ROUTER_RAISE[key]
            cfg = get_config(arch).reduced(**over)
            out[key] = dict(
                arch=arch, overrides=over, cfg=cfg, params=params,
                opt=jax.tree.map(np.asarray, jopt.init_opt_state(params)),
                batches={"even": _batch(cfg, 5),
                         "uneven": _batch(cfg, 6, uneven=True)},
                steps=[_batch(cfg, 20), _batch(cfg, 21)])
        return out


@pytest.fixture(scope="module", autouse=True)
def _reference_process(data, tmp_path_factory):
    """The reference's ``(2, 2)`` run, started once at module start."""
    d = tmp_path_factory.mktemp("train_mesh_ref")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"opt_cfg": OPT, "cases": {
            key: {k: data[key][k] for k in ("arch", "overrides", "params",
                                            "opt", "steps")}
            for key in REFERENCE_ARCHS}}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "_train_mesh_reference.py"),
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
def single(data):
    """The one-device port per arch key: ``loss_and_grads`` on each batch
    and two train steps."""
    out = {}
    for key, case in data.items():
        cfg = case["cfg"]
        res = {}
        for name, batch in case["batches"].items():
            params = lm_params_from_arrays(case["params"], device="cpu")
            loss, m, grads = loss_and_grads(params, cfg, _tensors(batch), 2,
                                            torch.float32)
            res[name] = (float(loss), float(m["ntokens"]),
                         {p: g.numpy().copy() for p, g in tree_leaves(grads)})
        params = lm_params_from_arrays(case["params"], device="cpu")
        opt = opt_state_from_arrays(case["opt"], device="cpu")
        step = make_train_step(cfg, OptConfig(**OPT), num_microbatches=2,
                               dtype=torch.float32)
        res["metrics"] = []
        for batch in case["steps"]:
            params, opt, m = step(params, opt, _tensors(batch))
            res["metrics"].append({k: float(v) for k, v in m.items()})
        res["params"] = {p: t.numpy() for p, t in tree_leaves(params)}
        out[key] = res
    return out


@pytest.fixture(scope="module")
def groups(data, tmp_path_factory):
    """``world -> [per-rank results of lm_train_job]``, each run once."""
    ckpt_dir = str(tmp_path_factory.mktemp("train_mesh_ckpt"))
    cache = {}

    def get(world):
        if world not in cache:
            cases = {}
            for name, (w, m, key) in CASES.items():
                if w == world:
                    c = data[key]
                    cases[name] = dict(
                        arch=c["arch"], overrides=c["overrides"],
                        params=c["params"], opt=c["opt"],
                        batches=c["batches"], steps=c["steps"],
                        model_axis=m, microbatches=2)
            cache[world] = run_group(world, "lm_train", {
                "cases": cases, "opt_cfg": OPT,
                "ckpt_dir": ckpt_dir if world == 4 else None})
        return cache[world]
    return get


@pytest.mark.parametrize("batch", ["even", "uneven"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_one_device(groups, single, case, batch):
    world, _, key = CASES[case]
    ranks = groups(world)
    loss, ntok, grads = single[key][batch]
    for r in ranks:
        got_loss, got_ntok = r[case][f"loss/{batch}"]
        np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
        assert got_ntok == ntok
    got = _flat(ranks[0][case][f"grads/{batch}"])
    assert got.keys() == grads.keys()
    for path, want in grads.items():
        np.testing.assert_allclose(
            got[path], want, rtol=0,
            atol=GRAD_TOL * max(np.abs(want).max(), 1e-30), err_msg=path)
    if "/layers/moe/router" in grads:
        # copied on every rank of the mesh: each holds the whole gradient
        want = grads["/layers/moe/router"]
        for i, r in enumerate(ranks):
            np.testing.assert_allclose(
                r[case][f"router/{batch}"], want, rtol=0,
                atol=GRAD_TOL * np.abs(want).max(),
                err_msg=f"rank {i}'s router gradient")
    # each rank's copy of every leaf whole over ``model``
    copies = [r[case][f"copies/{batch}"] for r in ranks]
    assert copies[0], "no leaf whole over model"
    for i, c in enumerate(copies):
        assert c.keys() == copies[0].keys()
        for path, got in c.items():
            want = grads[path]
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=GRAD_TOL * max(np.abs(want).max(), 1e-30),
                err_msg=f"rank {i}'s gradient of {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_two_steps_match_one_device(groups, single, case):
    world, m, key = CASES[case]
    ranks = groups(world)
    want = single[key]
    assert ranks[0][case]["shape"] == {"data": world // m, "model": m}
    for r in ranks:
        for got, exp in zip(r[case]["metrics"], want["metrics"]):
            for k, v in exp.items():
                np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL,
                                           err_msg=k)
    got = _flat(ranks[0][case]["params"])
    assert got.keys() == want["params"].keys()
    for path, exp in want["params"].items():
        np.testing.assert_allclose(got[path], exp, rtol=0, atol=STEP_ATOL,
                                   err_msg=path)


def test_uneven_batch_counts_differ_between_shards(data):
    """Microbatch ``i`` is rows ``2i, 2i + 1``; data shard 0 takes the
    first: it counts at most 3 tokens a microbatch, shard 1 far more."""
    counts = (data["qwen"]["batches"]["uneven"]["labels"] >= 0).sum(axis=1)
    assert counts[::2].max() <= 3 < 20 < counts[1::2].min()


@pytest.mark.parametrize("target", ["1x4", "4x1"])
def test_checkpoint_restores_onto_another_mesh(groups, target):
    """Saved from ``(2, 2)`` after two steps, restored onto ``target`` and
    gathered back: bitwise the saved parameters and AdamW state."""
    res = groups(4)[0]["2x2/danube"][f"restored/{target}"]
    same, step, local = res
    assert same and step == 2
    d, m = (int(x) for x in target.split("x"))
    full = _flat(groups(4)[0]["2x2/danube"]["params"])
    assert local["/layers/attn/wq"] == (full["/layers/attn/wq"].shape[0],
                                        full["/layers/attn/wq"].shape[1] // d,
                                        full["/layers/attn/wq"].shape[2] // m)


@pytest.mark.parametrize("key", REFERENCE_ARCHS)
def test_matches_reference_2x2(groups, reference, key):
    """The port's ``(2, 2)`` group against the reference's ``(2, 2)``
    forced-device run: every metric of both steps and the parameters."""
    got = groups(4)[0][f"2x2/{key}"]
    want = reference[key]
    for g, w in zip(got["metrics"], want["metrics"]):
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL, err_msg=k)
    params = _flat(got["params"])
    wparams = _flat(want["params"])
    assert params.keys() == wparams.keys()
    for path, exp in wparams.items():
        np.testing.assert_allclose(params[path], exp, rtol=0,
                                   atol=STEP_ATOL, err_msg=path)


#: (heads, model axis) -> each rank's head count
HEAD_BLOCKS = {(25, 4): [7, 7, 7, 4], (25, 16): [2] * 12 + [1, 0, 0, 0],
               (14, 16): [1] * 14 + [0, 0],
               (40, 16): [3] * 13 + [1, 0, 0], (32, 16): [2] * 16,
               (3, 4): [1, 1, 1, 0]}


@pytest.mark.parametrize("heads,tp", list(HEAD_BLOCKS))
def test_head_blocks_cover_the_heads_in_order(heads, tp):
    """``layers.head_block`` on each rank of a model axis of ``tp``: the
    blocks cover ``[0, H)`` in rank order, none holds more than ``ceil(H
    / tp)`` heads (GSPMD's padded block), and where ``tp`` divides ``H``
    they are the even split."""
    from repro_torch.models.layers import head_block, local_heads
    cpu = torch.device("cpu")
    blocks = [head_block(heads, LMMesh(("data", "model"), (
        GraphMesh(1, 0, cpu), GraphMesh(tp, r, cpu)), 0, cpu))
        for r in range(tp)]
    assert blocks[0][0] == 0 and blocks[-1][1] == heads
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert all(0 <= stop - start <= -(-heads // tp)
               for start, stop in blocks)
    assert [stop - start for start, stop in blocks] == HEAD_BLOCKS[
        (heads, tp)]
    if heads % tp == 0:
        n = heads // tp
        assert blocks == [(r * n, (r + 1) * n) for r in range(tp)]
    mesh = LMMesh(("data", "model"), (GraphMesh(1, 0, cpu),
                                      GraphMesh(tp, tp - 1, cpu)), 0, cpu)
    assert local_heads(heads, 1, mesh)[0] == HEAD_BLOCKS[(heads, tp)][-1]


def test_split_batch_steps_build():
    """Reduced Danube (one KV head) builds its step on a model axis of 2;
    an MoE step on a split batch builds, and with
    ``moe_dispatch="sorted"`` it raises, as the reference's train step
    does."""
    cpu = torch.device("cpu")
    mesh = LMMesh(("data", "model"), (GraphMesh(1, 0, cpu),
                                      GraphMesh(2, 0, cpu)), 0, cpu)
    assert callable(make_train_step(get_config("h2o_danube3_4b").reduced(),
                                    OptConfig(), mesh))
    moe = get_config("olmoe_1b_7b").reduced()
    split = LMMesh(("data", "model"), (GraphMesh(2, 0, cpu),
                                       GraphMesh(1, 0, cpu)), 0, cpu)
    assert callable(make_train_step(moe, OptConfig(), split))
    with pytest.raises(NotImplementedError, match="sorted.*split batch"):
        make_train_step(get_config("olmoe_1b_7b").reduced(
            moe_dispatch="sorted"), OptConfig(), split)
