"""The dry run (``launch/dryrun.py``), its report (``launch/report.py``)
and the sharded prefill it traces.

Cells at ``.reduced()`` size are traced on the ``meta`` device as rank 0
of a fake process group holding the production mesh; ``run_cell`` makes
and destroys the group itself, so no other test sees it.  The record has
the reference's keys with the port's measures (``trace_s`` for
``lower_s``/``compile_s``; flops from ``FlopCounterMode`` plus the
kernels' tally; the peak from ``StepTracer``), a traced step leaves no
tensor on a real device, an MoE train cell on the split batch traces
(its experts split over ``model``: reduced OLMoE with 16 experts, one a
rank), and ``report.main`` prints the three tables with no failure.

``prefill(mesh=)`` (the prefill cells' step) runs on spawned gloo groups
of 2 CPU ranks on ``(1, 2)`` and ``(2, 1)``, reduced configs whose heads
split over ``model`` (Qwen) and whose KV or query heads do not (Danube,
banded, Hymba, and both with 5 and 6 / 3 heads: each rank attends with
its block of query heads and returns every KV head for the cache), with
SSM states (RWKV6 and Hymba, their blocks split over ``model``, and RWKV6
with 3 heads, its time mix on head blocks 2 + 1) and a frontend prefix
(InternVL2), and reduced OLMoE with ``moe_dispatch="sorted"`` (the grouped
GEMMs on each rank's experts), against one device's ``prefill`` at 1e-5.
At the production mesh's ``model = 16`` RWKV6-3B's 40 heads split on
blocks of 3 and its channel mix on its channels, Hymba-1.5B's mamba
channels split, and a Danube-shaped train step (32 / 8 heads) gathers
neither ``wq`` nor ``wo`` over ``model``.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeCase, get_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.kernels import tally
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import init_params, prefill, tree_map

from _torch_shard_group import run_group

TRAIN = ShapeCase("train_small", 64, 32, "train")
DECODE = ShapeCase("decode_small", 256, 32, "decode")
PREFILL = ShapeCase("prefill_small", 64, 32, "prefill")
DANUBE = dict(sliding_window=16, attn_query_chunk=8, swa_banded=True)
OLMOE = dict(num_experts=16)     # a model axis of 16 splits the experts
KEYS = {"arch", "shape", "mesh", "multi_pod", "kind", "num_microbatches",
        "params", "params_active", "trace_s", "memory", "cost_analysis_raw",
        "kernels", "collectives"}
ROOF_KEYS = {"flops_per_device", "hbm_bytes_per_device",
             "wire_bytes_per_device", "wire_by_kind", "compute_s",
             "memory_s", "collective_s", "bottleneck", "model_flops_global",
             "useful_flops_ratio"}
TOL = 1e-5


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A dense train cell (Qwen, both meshes), a banded prefill cell
    (Danube: K7 on its meta path), a decode cell (GLM-4, the sequence-split
    cache) and an MoE train cell (OLMoE), written to one directory."""
    out = tmp_path_factory.mktemp("dryrun")
    recs, errors = {}, {}
    cells = [("qwen15_05b", TRAIN, {}, False), ("qwen15_05b", TRAIN, {}, True),
             ("h2o_danube3_4b", PREFILL, DANUBE, False),
             ("glm4_9b", DECODE, {}, False),
             ("olmoe_1b_7b", TRAIN, OLMOE, False)]
    for arch, case, over, multi in cells:
        key = (arch, multi)
        try:
            recs[key] = dryrun.run_cell(
                arch, case.name, multi_pod=multi, do_roofline=not multi,
                out_dir=str(out), cfg=get_config(arch).reduced(**over),
                case=case)
        except NotImplementedError as e:
            errors[key] = e
    return out, recs, errors


def test_records_hold_the_reference_keys(records):
    out, recs, _ = records
    single = recs[("qwen15_05b", False)]
    assert KEYS <= set(single) and ROOF_KEYS <= set(single["roofline"])
    assert KEYS <= set(recs[("qwen15_05b", True)])
    assert "roofline" not in recs[("qwen15_05b", True)]
    assert single["mesh"] == [16, 16] and single["num_microbatches"] == 2
    mem = single["memory"]
    assert mem["peak_estimate_bytes"] == (mem["argument_size_in_bytes"]
                                          + mem["temp_size_in_bytes"]) > 0
    assert single["cost_analysis_raw"]["flops"] > 0
    r = single["roofline"]
    assert r["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert r["wire_bytes_per_device"] == pytest.approx(
        sum(r["wire_by_kind"].values()))
    assert set(single["collectives"]) >= {"all-gather@16", "all-reduce@16",
                                          "reduce-scatter@16"}
    with open(out / "qwen15_05b__train_small__single.json") as f:
        assert json.load(f)["params"] == single["params"]


def test_kernel_meta_paths_count_in_the_flops(records):
    """The banded prefill's K7 launches nothing on ``meta`` and tallies
    ``4 hd H pairs`` a call on this rank's rows and heads (rank 0's block
    of ``ceil(H / 16)``: one of reduced Danube's 4)."""
    _, recs, _ = records
    rec = recs[("h2o_danube3_4b", False)]
    cfg = get_config("h2o_danube3_4b").reduced(**DANUBE)
    assert rec["kernels"] == {"flash_swa": cfg.num_layers}
    rows = PREFILL.global_batch // 16            # batch over data
    heads = -(-cfg.num_heads // 16)              # rank 0's head block
    want = (4 * cfg.resolved_head_dim * heads * rows
            * tally.band_pairs(PREFILL.seq_len, cfg.sliding_window))
    assert rec["cost_analysis_raw"]["kernel_flops"] == cfg.num_layers * want


def test_moe_cell_fails_naming_queue_3a(records):
    """The OLMoE train cell on the split batch, which failed naming ROADMAP
    queue 3a until expert parallelism was ported, traces: a peak, flops
    beside the roofline's 6ND, and the MoE's all-reduces over ``model``
    (its combine) and over ``data`` (the router statistics) in its
    record."""
    out, recs, errors = records
    assert not errors
    rec = recs[("olmoe_1b_7b", False)]
    assert "error" not in rec and rec["memory"]["peak_estimate_bytes"] > 0
    cfg = get_config("olmoe_1b_7b").reduced(**OLMOE)
    six_nd = rec["roofline"]["model_flops_global"]
    assert six_nd == 6.0 * rec["params_active"] * TRAIN.global_batch * \
        TRAIN.seq_len
    # remat off: a forward and a backward of every layer, gathers and
    # dispatch glue on top; each rank runs one of the 16 experts
    assert 0.5 < rec["cost_analysis_raw"]["flops"] * 256 / six_nd < 20
    calls = {k: v[0] for k, v in rec["collectives"].items()}
    assert calls["all-reduce@16"] > 0 and calls["all-gather@16"] > 0
    # per layer and microbatch the combine's sum over model, its gradient
    # (to_tp on the tokens and on the combine weights), the aux statistics
    layers, micro = cfg.num_layers, rec["num_microbatches"]
    assert calls["all-reduce@16"] >= 4 * layers * micro
    with open(out / "olmoe_1b_7b__train_small__single.json") as f:
        assert "error" not in json.load(f)


def test_report_prints_the_tables(records):
    out, _, _ = records
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main([str(out)])
    text = buf.getvalue()
    assert "fits 79.2G" in text and "| glm4_9b | decode_small | decode |" \
        in text
    # one row a cell, 16x16 / 2x16x16 side by side
    assert "| qwen15_05b | train_small | train | 2 / 1 |" in text
    assert "olmoe_1b_7b | train_small | train |" in text
    assert "failed" not in text
    assert text.count("| qwen15_05b | train_small |") == 3  # 3 tables
    assert report.fmt_bytes(2 ** 30) == "1.00"


def test_traced_step_leaves_nothing_on_a_real_device():
    """A one-rank train step traced on ``meta``: every output is a meta
    tensor but the host-side step counter and scalars, no kernel
    launched, and the optimizer's clip scale read nothing back."""
    from repro_torch.kernels.flash_swa import kernel as FK
    cfg = get_config("h2o_danube3_4b").reduced(**DANUBE, remat=True)
    mesh = make_host_mesh(device="meta")
    step, args = dryrun.build_cell(cfg, TRAIN, mesh, 2)
    before = dict(FK.LAUNCHES)
    seen = []

    class Devices(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            for t in torch.utils._pytree.tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.device.type != "meta":
                    seen.append((str(func), tuple(t.shape)))
            return out

    with Devices():
        params, opt, metrics = step(*args)
    t = dryrun.trace_step(*dryrun.build_cell(cfg, TRAIN, mesh, 2))
    assert FK.LAUNCHES == before
    assert all(shape == () for _, shape in seen), seen
    for tree in (params, opt["mu"], opt["nu"]):
        assert all(x.device.type == "meta"
                   for x in torch.utils._pytree.tree_flatten(tree)[0])
    assert opt["step"].device.type == "cpu" and int(opt["step"]) == 1
    assert t["kernels"] == {"flash_swa": 4 * cfg.num_layers,
                            "flash_swa_bwd": 2 * cfg.num_layers}
    assert t["flops"] > t["kernel_flops"] > 0


@pytest.mark.parametrize("stage", [0, 1])
def test_pipeline_stage_traces_on_a_fake_group(stage):
    """Each stage of a two-stage pipeline traced on ``meta`` as its rank of
    a fake group: K7 and its backward tallied a layer a tick (forward and
    remat recompute, then the backward), the hops recorded as
    collective-permutes, nothing launched, and the group gone after."""
    from repro_torch.kernels.flash_swa import kernel as FK
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import param_shapes
    from repro_torch.train.pipeline import (block_stage_fn,
                                            make_pipeline_apply)
    cfg = get_config("h2o_danube3_4b").reduced(**DANUBE, remat=True)
    pods, micro, per, s = 2, 2, cfg.num_layers // 2, TRAIN.seq_len
    ticks = micro + pods - 1
    before = dict(FK.LAUNCHES)

    def step(params, xs):
        y = apply(params, xs)
        (y.float() ** 2).mean().backward()
        return y

    with dryrun.fake_world(pods, stage):
        mesh = make_mesh((pods, 1), ("pod", "data"), device="meta")
        assert mesh.coord("pod") == stage
        params = tree_map(lambda a: a[None].detach().requires_grad_(),
                          param_shapes(dataclasses.replace(
                              cfg, num_layers=per))["layers"])
        xs = torch.empty((micro, 1, s, cfg.d_model), device="meta")
        apply = make_pipeline_apply(block_stage_fn(cfg, s), mesh, pods,
                                    micro)
        t = dryrun.trace_step(step, (params, xs), mesh)
    assert not torch.distributed.is_initialized()
    assert FK.LAUNCHES == before
    assert t["kernels"] == {"flash_swa": 2 * ticks * per,
                            "flash_swa_bwd": ticks * per}
    # a hop between ticks, each way
    assert t["collectives"][("collective-permute", pods)][0] == \
        2 * (ticks - 1)
    assert t["memory"]["peak_estimate_bytes"] > \
        t["memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("shape", [(16, 16), (2, 2), (1, 4)])
def test_ssm_blocks_split_where_model_divides_them(shape):
    """RWKV6-3B (40 heads of 64, ``d_ff`` 8,960, ``d_model`` 2,560) and
    Hymba-1.5B (``d_inner`` 1,600) on a mesh of ``shape``: every block
    splits, on the card's ``(2, 2)`` and ``(1, 4)`` and on the production
    mesh's ``model = 16``, where RWKV6's time mix runs on head blocks of 3
    (``layers.head_block``: thirteen ranks of 3, one of 1, two of none)
    and its channel mix on 560 hidden and 160 gate columns a rank."""
    from repro_torch.launch.mesh import GraphMesh, LMMesh
    from repro_torch.models.layers import head_block
    from repro_torch.models.lm import _ssm_mesh
    cpu = torch.device("cpu")
    mesh = LMMesh(("data", "model"), tuple(GraphMesh(n, 0, cpu)
                                           for n in shape), 0, cpu)
    rwkv, hymba = get_config("rwkv6_3b"), get_config("hymba_15b")
    assert rwkv.rwkv_num_heads == 40
    assert hymba.num_heads * hymba.resolved_head_dim == 1600
    assert _ssm_mesh(hymba, mesh, "mamba") is mesh
    for block in ("tmix", "cmix"):
        assert _ssm_mesh(rwkv, mesh, block) is mesh, block
    tp = shape[1]
    last = LMMesh(("data", "model"), (GraphMesh(shape[0], 0, cpu),
                                      GraphMesh(tp, tp - 1, cpu)), 0, cpu)
    c = -(-40 // tp)
    assert head_block(40, mesh) == (0, c)
    assert head_block(40, last) == ((40, 40) if tp == 16
                                    else (40 - c, 40))


def test_danube_shaped_step_gathers_no_wq_or_wo_over_model(monkeypatch):
    """A train step of reduced Danube with Danube's 32 / 8 heads, traced
    as rank 0 of a fake ``(16, 16)`` group: 2 query heads a rank on
    ``wq``'s and ``wo``'s stored blocks, so neither is all-gathered over
    ``model``; ``wk``/``wv`` (8 KV heads on 16) are, and narrowed to the
    KV head the block reads."""
    from repro_torch.launch.mesh import LMMesh, make_production_mesh
    from repro_torch.models.lm import param_shapes, tree_leaves
    cfg = get_config("h2o_danube3_4b").reduced(num_heads=32, num_kv_heads=8,
                                               **DANUBE)
    gathered = []
    plain = LMMesh.all_gather

    def spied(self, x, axis, dim=0):
        if axis == "model" and self.axis_size(axis) > 1:
            gathered.append(tuple(x.shape))
        return plain(self, x, axis, dim)

    monkeypatch.setattr(LMMesh, "all_gather", spied)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="meta")
        t = dryrun.trace_step(*dryrun.build_cell(cfg, TRAIN, mesh, 1), mesh)
    assert not torch.distributed.is_initialized()
    full = dict(tree_leaves(param_shapes(cfg)))
    # a layer's weight as the model gather would take it: its data
    # blocks gathered, its model block this rank's
    block = {name: (full[f"/layers/attn/{name}"].shape[1],
                    full[f"/layers/attn/{name}"].shape[2] // 16)
             for name in ("wq", "wk", "wv")}
    block["wo"] = (full["/layers/attn/wo"].shape[1] // 16,
                   full["/layers/attn/wo"].shape[2])
    assert block["wq"] not in (block["wk"], block["wo"])
    assert block["wq"] not in gathered and block["wo"] not in gathered
    assert block["wk"] in gathered
    assert t["kernels"] == {"flash_swa": cfg.num_layers,
                            "flash_swa_bwd": cfg.num_layers}


def test_tracer_follows_storages():
    tr = dryrun.StepTracer()
    with tr:
        a = torch.empty(1000, device="meta")
        b = a * 2
        c = b + 1
        del b
        d = c.view(10, 100)
        del a, c
        e = torch.ones(500, device="meta")
    assert tr.peak == 12000 and tr.live == 6000
    assert tr.bytes == 4000 * 2 + 4000 * 2 + 2000
    del d, e


# ---------------------------------------------------------------------------
# prefill on a mesh
# ---------------------------------------------------------------------------

BANDED = dict(sliding_window=4, attn_query_chunk=4, swa_banded=True)
PREFILL_ARCHS = {
    "qwen": ("qwen15_05b", {}),
    "danube": ("h2o_danube3_4b", BANDED),
    "danube-h6kv3": ("h2o_danube3_4b", dict(num_heads=6, num_kv_heads=3,
                                            **BANDED)),
    "hymba": ("hymba_15b", {}),
    "hymba-h5": ("hymba_15b", dict(num_heads=5, **BANDED)),
    "rwkv": ("rwkv6_3b", {}),
    "rwkv-h3": ("rwkv6_3b", dict(d_model=48)),   # 3 heads: blocks 2 + 1
    "internvl": ("internvl2_1b", {}),
    "olmoe-sorted": ("olmoe_1b_7b", dict(moe_dispatch="sorted")),
}
B, S = 2, 16


def _prefill_cases():
    cases = {}
    for key, (arch, over) in PREFILL_ARCHS.items():
        cfg = get_config(arch).reduced(**over)
        params, _ = init_params(cfg, torch.Generator().manual_seed(6),
                                device="cpu")
        rng = np.random.default_rng(7)
        case = {"arch": arch, "overrides": over,
                "params": tree_map(lambda a: a.numpy(), params),
                "tokens": rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32)}
        if cfg.frontend:
            case["prefix"] = (rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)) * 0.02).astype(
                    np.float32)
        for m in (1, 2):
            cases[f"{key}/m{m}"] = dict(case, model_axis=m)
    return cases


@pytest.fixture(scope="module")
def prefill_cases():
    return _prefill_cases()


@pytest.fixture(scope="module")
def prefill_group(prefill_cases):
    return run_group(2, "lm_prefill", prefill_cases)


@pytest.mark.parametrize("case", [f"{k}/m{m}" for k in PREFILL_ARCHS
                                  for m in (1, 2)])
def test_prefill_on_a_mesh_matches_one_device(prefill_cases, prefill_group,
                                              case):
    c = prefill_cases[case]
    cfg = get_config(c["arch"]).reduced(**c["overrides"])
    params = lm_params_from_arrays(c["params"], device="cpu")
    prefix = c.get("prefix")
    with torch.no_grad():
        logits, cache = prefill(
            params, cfg, torch.from_numpy(c["tokens"]),
            None if prefix is None else torch.from_numpy(prefix),
            dtype=torch.float32)
    got = prefill_group[0][case]
    np.testing.assert_allclose(got["logits"], logits.numpy(), rtol=TOL,
                               atol=TOL)
    assert set(got["cache"]) == set(cache)
    for name, want in cache.items():
        np.testing.assert_allclose(got["cache"][name], want.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
