"""The sharded decode step (``serve.decode.make_serve_step(cfg, mesh)``)
on gloo groups of CPU ranks, against the one-device ``decode_step``.

Two groups run once each (``tests/_torch_shard_group.py``, job
``lm_serve``): two ranks on ``(1, 2)`` and four on ``(2, 2)`` and ``(1,
4)``.  The cases cover both KV-cache layouts and the SSM states: reduced
Qwen (4 KV heads, split over ``model``), reduced GLM-4-9B and
H2O-Danube3-4B (one KV head on a model axis of 2: the cache's ring slots
split over ``model``, with the flash-decode combine; Danube's 8-slot
window ring wraps within the 12 steps), reduced RWKV6 (``wkv`` cut over
``model`` on K; its 4 heads split over ``model``, so each step reshards
the state to this rank's heads and back) and reduced Hymba (hybrid:
split slots plus the ``h`` state, its mamba channels split over
``model``), Hymba with 5 query heads on ``(1, 2)`` and ``(2, 2)`` and
Danube with 3 on ``(1, 4)`` (``wo`` on each rank's stored rows of the
combined output), and RWKV6 with ``d_model=48`` (3 heads: the time mix
on the head blocks 2 + 1 on ``(1, 2)`` and 1, 1, 1, 0 on ``(1, 4)``, its
weights gathered whole over ``model`` and narrowed, the channel mix on
``d_ff / tp`` columns); and reduced OLMoE-1B-7B and
DeepSeek-MoE-16B (shared experts) with each MoE dispatch (``grouped``,
``capacity``, ``sorted``), their experts split over ``model``; on ``(2,
2)`` the ``capacity`` dispatch's global capacity (one atom an expert for
the two tokens of a step) drops atoms by their order over both data
shards.  On ``(2, 2)`` a batch of 2 splits over ``data`` and a batch of 1
is replicated.  Each step's logits
must lie within 1e-5 of the largest logit of the one-device step's.
Where ``model`` splits the SSM blocks on their stored blocks, the last
step all-gathers no weight of ``tmix``, ``cmix`` or ``mamba`` over
``model`` (the shapes gathered, and ``mesh.stats``' all-gather bytes on
``(1, 2)``); where the time mix's blocks are not its heads it gathers
those and no other; and no step all-gathers an attention weight over
``model``.  The
world-2 group also runs ``launch.serve`` and ``launch.train`` with
``--mesh host``.  A one-rank mesh is the one-device path: bitwise the same
logits and no collective.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import (decode_step, init_cache, init_params,
                                   tree_leaves)
from repro_torch.serve.decode import make_serve_step
from repro_torch.train.step import shard_tree

from _torch_shard_group import run_group

TOL = 1e-5
STEPS = 12
SEQ = 16
DENSE = ("qwen15_05b", "glm4_9b", "h2o_danube3_4b", "rwkv6_3b",
         "hymba_15b")
MOE = ("olmoe_1b_7b", "deepseek_moe_16b")
ARCHS = DENSE + MOE
DISPATCHES = ("grouped", "capacity", "sorted")
#: case -> (world, model axis, arch, batch, config overrides)
CASES = {f"1x2/{a}": (2, 2, a, 2, {}) for a in DENSE}
CASES.update({f"2x2/{a}": (4, 2, a, 2, {}) for a in DENSE})
CASES["2x2/qwen15_05b/b1"] = (4, 2, "qwen15_05b", 1, {})
# 3 RWKV6 heads: the time mix on head blocks 2 + 1 and 1, 1, 1, 0
CASES["1x2/rwkv6_3b/h3"] = (2, 2, "rwkv6_3b", 2, {"d_model": 48})
CASES["1x4/rwkv6_3b/h3"] = (4, 4, "rwkv6_3b", 2, {"d_model": 48})
# query heads that model does not divide: 5 on 2, 3 on 4
CASES["1x2/hymba_15b/h5"] = (2, 2, "hymba_15b", 2, {"num_heads": 5})
CASES["2x2/hymba_15b/h5"] = (4, 2, "hymba_15b", 2, {"num_heads": 5})
CASES["1x4/h2o_danube3_4b/h3"] = (4, 4, "h2o_danube3_4b", 2,
                                  {"num_heads": 3})
#: the SSM cases whose blocks run on their stored blocks / whose time mix
#: gathers its weights whole over ``model`` and narrows them
SSM_SPLIT = ("1x2/rwkv6_3b", "2x2/rwkv6_3b", "1x2/hymba_15b",
             "2x2/hymba_15b", "1x2/hymba_15b/h5", "2x2/hymba_15b/h5")
SSM_NARROWED = ("1x2/rwkv6_3b/h3", "1x4/rwkv6_3b/h3")
#: overrides that change the weights' shapes (the others share the arch's)
SHAPED = ("d_model", "num_heads")
for _w, _mesh in ((2, "1x2"), (4, "2x2")):
    CASES.update({f"{_mesh}/{a}/{d}": (_w, 2, a, 2, {"moe_dispatch": d})
                  for a in MOE for d in DISPATCHES})


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.numpy().copy()


def _shape(over):
    return {k: v for k, v in sorted(over.items()) if k in SHAPED}


def _wkey(arch, over):
    """The weights a case runs on: its arch's, or those of its shape."""
    return arch + "".join(f"/{k}={v}" for k, v in _shape(over).items())


@pytest.fixture(scope="module")
def weights():
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).reduced()
        params, _ = init_params(cfg, torch.Generator().manual_seed(10 + i),
                                device="cpu")
        out[arch] = (cfg, params)
    for _, _, arch, _, over in CASES.values():
        if _wkey(arch, over) not in out:
            cfg = get_config(arch).reduced(**_shape(over))
            params, _ = init_params(cfg, torch.Generator().manual_seed(30),
                                    device="cpu")
            out[_wkey(arch, over)] = (cfg, params)
    return out


def _tokens(cfg, batch, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, STEPS)).astype(np.int32)


@pytest.fixture(scope="module")
def groups(weights):
    cache = {}
    argv = dict(
        serve_argv=["--arch", "h2o_danube3_4b", "--reduced", "--batch", "2",
                    "--tokens", "4", "--device", "cpu", "--mesh", "host",
                    "--model-axis", "2", "--temperature", "0"],
        train_argv=["--arch", "qwen15_05b", "--reduced", "--steps", "2",
                    "--device", "cpu", "--mesh", "host"])

    def get(world):
        if world not in cache:
            cases = {}
            for name, (w, m, arch, b, over) in CASES.items():
                if w == world:
                    cfg, params = weights[_wkey(arch, over)]
                    cases[name] = dict(arch=arch, overrides=over,
                                       params=_np_tree(params),
                                       model_axis=m, seq_len=SEQ,
                                       tokens=_tokens(cfg, b))
            cache[world] = run_group(world, "lm_serve", dict(
                cases=cases, **(argv if world == 2 else {})))
        return cache[world]
    return get


def _single(cfg, params, tokens):
    cache = init_cache(cfg, tokens.shape[0], SEQ, torch.float32,
                       device="cpu")
    out = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, cache = decode_step(params, cfg, torch.from_numpy(
                tokens[:, t:t + 1]), t, cache, dtype=torch.float32)
            out.append(lg.numpy())
    return np.stack(out)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_one_device(groups, weights, case):
    world, m, arch, b, over = CASES[case]
    cfg = get_config(arch).reduced(**over)
    params = weights[_wkey(arch, over)][1]
    ranks = groups(world)
    want = _single(cfg, params, _tokens(cfg, b))
    got = ranks[0][case]["logits"]
    assert got.shape == want.shape == (STEPS, b, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    assert len({r[case]["checksum"] for r in ranks}) == 1


@pytest.mark.parametrize("case", ["1x2/qwen15_05b", "1x2/glm4_9b",
                                  "2x2/rwkv6_3b", "2x2/hymba_15b",
                                  "2x2/qwen15_05b/b1"])
def test_cache_blocks(groups, weights, case):
    """Each rank's cache blocks: KV heads over ``model`` where it divides
    them, else the ring's slots; the batch over ``data`` where it
    divides it."""
    world, m, arch, b, _ = CASES[case]
    cfg = weights[arch][0]
    res = groups(world)[0][case]
    d = world // m
    rows = b // d if b % d == 0 and b >= d else b
    if "k" in res["cache_shapes"]:
        s_cache = min(SEQ, cfg.sliding_window or SEQ)
        heads = cfg.num_kv_heads % m == 0
        assert res["cache_shapes"]["k"] == (
            cfg.num_layers, rows, s_cache if heads else s_cache // m,
            cfg.num_kv_heads // m if heads else cfg.num_kv_heads,
            cfg.resolved_head_dim)
    if "wkv" in res["cache_shapes"]:
        h, k = cfg.rwkv_num_heads, cfg.rwkv_head_dim
        assert res["cache_shapes"]["wkv"] == (cfg.num_layers, rows, h,
                                              k // m, k)
    if "h" in res["cache_shapes"]:
        assert res["cache_shapes"]["h"][1:3] == (
            rows, cfg.num_heads * cfg.resolved_head_dim // m)


def _ssm_leaf(path: str) -> bool:
    return path.split("/")[1:3] in (["layers", "tmix"], ["layers", "cmix"],
                                    ["layers", "mamba"])


def _ssm_blocks(res):
    """``{shape of a rank's block of one layer: path}`` of the SSM
    blocks' weights."""
    return {shape[1:]: path for path, shape in res["local_shapes"].items()
            if _ssm_leaf(path)}


@pytest.mark.parametrize("case", SSM_SPLIT + SSM_NARROWED)
def test_ssm_weights_stay_on_their_ranks(groups, weights, case):
    """A decode step where ``model`` splits the SSM blocks on their stored
    blocks all-gathers none of their weights over ``model``: no gathered
    block has the shape of a weight block, and on ``(1, 2)`` (every group
    of two is ``model``) ``mesh.stats`` counts fewer all-gathered bytes
    than one layer's SSM weights.  Where the time mix's stored blocks are
    not its heads (3 RWKV6 heads), each layer gathers each of its cut
    weights once, and no other SSM weight: the channel mix splits."""
    world, m, arch, b, over = CASES[case]
    cfg, params = weights[_wkey(arch, over)]
    full = dict(tree_leaves(params))
    for res in (r[case] for r in groups(world)):
        blocks = _ssm_blocks(res)
        hits = [blocks[s] for s in res["model_gathers"] if s in blocks]
        if case in SSM_NARROWED:
            tmix = [shape[1:] for path, shape in res["local_shapes"].items()
                    if path.startswith("/layers/tmix/")
                    and shape != tuple(full[path].shape)]
            got = Counter(s for s in res["model_gathers"] if s in blocks)
            assert tmix and got == Counter(tmix * cfg.num_layers), hits
            continue
        assert hits == [], hits
        if world == m:
            whole = sum(t[0].numel() * t.element_size()
                        for path, t in full.items() if _ssm_leaf(path))
            gathered = res["stats"].get("all-gather@2", [0, 0, 0.0])[1]
            assert 0 < gathered < whole, (gathered, whole)


@pytest.mark.parametrize("case", [c for c, (_, m, a, _, _) in CASES.items()
                                  if m > 1 and a != "rwkv6_3b"])
def test_decode_gathers_no_attention_weight(groups, case):
    """No decode step all-gathers a block of ``wq``, ``wk``, ``wv``,
    ``wo`` or their biases over ``model``, whatever the head count: the
    heads split on the stored blocks, or the sequence-split cache's
    combined output meets each rank's stored rows of ``wo``."""
    world = CASES[case][0]
    for res in (r[case] for r in groups(world)):
        attn = {shape[1:]: path for path, shape in res["local_shapes"].items()
                if path.startswith("/layers/attn/")}
        hits = [attn[s] for s in res["model_gathers"] if s in attn]
        assert attn and hits == [], hits


def test_launchers_run_on_a_group(groups):
    """``launch.serve --mesh host --model-axis 2`` and ``launch.train
    --mesh host`` on two ranks: every rank samples the same tokens and
    trains to the same metrics."""
    outs = [r["launchers"] for r in groups(2)]
    text, metrics = outs[0]
    assert "4 tokens x 2 batch" in text and "sample: [" in text
    assert "mesh={'data': 2, 'model': 1}" in text
    assert "finished 2 steps" in text
    assert np.isfinite(metrics["loss"])
    sample = [o[0].split("sample: ")[1].splitlines()[0] for o in outs]
    assert sample[0] == sample[1]
    assert outs[0][1] == outs[1][1]


@pytest.mark.parametrize("arch", ["qwen15_05b", "rwkv6_3b", "olmoe_1b_7b"])
def test_one_rank_mesh_is_the_one_device_path(weights, arch):
    cfg, params = weights[arch]
    mesh = make_host_mesh(device="cpu")
    step, psh, csh, cache = make_serve_step(cfg, mesh, batch=2,
                                            seq_len=SEQ, dtype=torch.float32)
    local = shard_tree(params, psh)
    assert all(a is b for (_, a), (_, b) in zip(tree_leaves(local),
                                                tree_leaves(params)))
    plain, _, _, other = make_serve_step(cfg, batch=2, seq_len=SEQ,
                                         dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2))
    for t in range(4):
        a, cache = step(local, toks[:, t:t + 1], t, cache)
        b, other = plain(params, toks[:, t:t + 1], t, other)
        assert torch.equal(a, b)
    assert mesh.stats.calls == 0
