"""The reference's sharded traversal at S = 1/2/4/8, written to an ``.npz``.

Run by ``tests/test_torch_shard.py`` in a fresh process, as::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/_shard_reference.py OUT.npz DYADIC.npy

(eight host devices have to be forced before JAX starts).  It imports the
reference through ``_torch_parity.reference_modules`` and stores, under
``s{S}/...`` keys: the plan arrays of ``build_sharded_advance`` (stacked
over the shards as the reference holds them) for every boundary schedule,
and a subset of the sharded drivers' answers (each call costs the
reference a ``shard_map`` compile of a few seconds): BFS with parents at
S = 1, 2 and 8, SSSP at S = 1, 4 and 8, ``bfs_multi`` at S = 2, dyadic
PageRank (the test's ``DYADIC.npy`` graph) and compacted delta-stepping
at S = 4, and BFS with parents on the ``lpt_contiguous`` plan at S = 4.
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(os.path.dirname(HERE), "src"), HERE]

from _conformance import powerlaw_graph_dense  # noqa: E402
from _torch_parity import reference_modules  # noqa: E402

MB = dict(schedule="merge_path", path="pure", num_blocks=4)
BOUNDARIES = ("edge_balanced", "equal_width", "lpt_contiguous")


def plan_arrays(splan) -> dict:
    import jax
    a = {k: np.asarray(v) for k, v in splan.arrays.items()}
    out = {"src": a["src"], "weight": a["weight"], "dst": a["dst"],
           "push_weight": a["push_weight"], "push_src": a["push_src"],
           "out_degrees": a["out_degrees"], "pull_valid": a["pull_valid"],
           "push_valid": a["push_valid"],
           "glob2pad": np.asarray(splan.glob2pad),
           "pad2glob": np.asarray(splan.pad2glob),
           "boundaries": np.asarray(splan.boundaries),
           "shard_size": np.asarray(splan.shard_size),
           "threshold": np.asarray(splan.direction_threshold),
           "compact_capacity": np.asarray(
               -1 if splan.template.compact_capacity is None
               else splan.template.compact_capacity)}
    for name, leaves, td in (
            ("pull_offsets", splan.pull_spec_leaves, splan.pull_spec_treedef),
            ("push_offsets", splan.push_spec_leaves,
             splan.push_spec_treedef)):
        specs = [jax.tree_util.tree_unflatten(td, [l[s] for l in leaves])
                 for s in range(splan.num_shards)]
        out[name] = np.stack([np.asarray(sp.tile_offsets) for sp in specs])
        out["e_" + name.split("_")[0]] = np.asarray(specs[0].num_atoms)
    t = splan.template
    out["pull_spans"] = np.asarray([t.part.atom_span, t.part.tile_span])
    out["push_spans"] = np.asarray([t.push_part.atom_span,
                                    t.push_part.tile_span])
    if splan.delta is not None:
        out.update(delta=np.asarray(splan.delta),
                   light_mask=a["light_mask"],
                   push_light_mask=a["push_light_mask"],
                   light_out_degrees=a["light_out_degrees"])
    return out


def main(path: str, dyadic_path: str) -> None:
    w = powerlaw_graph_dense(24, avg_degree=3.0, seed=7)
    dyadic = np.load(dyadic_path)
    out = {}
    with reference_modules("repro.sparse", "repro.sparse.shard") as (rs, sh):
        g = rs.Graph(rs.CSR.from_dense(w))
        for S in (1, 2, 4, 8):
            plans = {}
            for b in BOUNDARIES:
                kw = dict(shard_schedule=b, **MB)
                if b != "equal_width":
                    kw["delta"] = "auto"
                plans[b] = sh.build_sharded_advance(g, S, **kw)
                for k, v in plan_arrays(plans[b]).items():
                    out[f"s{S}/plan/{b}/{k}"] = v
            sp = plans["equal_width"]
            if S in (1, 2, 8):
                d, p = sh.sharded_bfs(sp, 0, return_parents=True)
                out[f"s{S}/bfs/depth"], out[f"s{S}/bfs/parent"] = d, p
            if S in (1, 4, 8):
                out[f"s{S}/sssp"] = sh.sharded_sssp(sp, 0)
            if S == 2:
                out[f"s{S}/multi"] = sh.sharded_bfs_multi(sp, [0, 5, 11])
            if S == 4:
                gd = rs.Graph(rs.CSR.from_dense(dyadic))
                out[f"s{S}/pr_dyadic"] = sh.sharded_pagerank(
                    sh.build_sharded_advance(gd, S, **MB), damping=0.5,
                    num_iters=3, tol=0.0)
                spc = sh.build_sharded_advance(g, S, delta="auto",
                                               compact=True, **MB)
                for k, v in plan_arrays(spc).items():
                    out[f"s{S}/plan/compact_delta/{k}"] = v
                out[f"s{S}/delta_compact"] = sh.sharded_delta_stepping(
                    spc, 0)
                d, p = sh.sharded_bfs(plans["lpt_contiguous"], 0,
                                      return_parents=True)
                out[f"s{S}/lpt/depth"], out[f"s{S}/lpt/parent"] = d, p
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
