"""repro_torch.sparse — formats, load-balanced linear algebra, graphs."""
from repro_torch.sparse.formats import (COO, CSC, CSR, random_csr,
                                        suite_like_corpus)
from repro_torch.sparse.ops import spmm, spmv, spmv_reference, spvv
from repro_torch.sparse.advance import (AdvancePlan, advance,
                                        advance_frontier, advance_push,
                                        advance_relax_min,
                                        advance_src_argmin, build_advance,
                                        build_advance_views, estimate_delta,
                                        frontier_filter)
from repro_torch.sparse.graph import (Graph, bfs, bfs_multi,
                                      delta_stepping, pagerank, sssp)
from repro_torch.sparse.shard import (SHARD_SCHEDULES, ShardedAdvancePlan,
                                      build_sharded_advance,
                                      shard_boundaries, sharded_bfs,
                                      sharded_bfs_multi,
                                      sharded_delta_stepping,
                                      sharded_pagerank, sharded_sssp)
from repro_torch.sparse.wavefront import (PackedForest, WavefrontPlan,
                                          build_wavefront, pack_forest,
                                          topological_levels, wavefront_eval)

__all__ = ["COO", "CSC", "CSR", "random_csr", "suite_like_corpus",
           "spmm", "spmv", "spmv_reference", "spvv",
           "AdvancePlan", "advance", "advance_frontier", "advance_push",
           "advance_relax_min", "advance_src_argmin", "build_advance",
           "build_advance_views", "estimate_delta", "frontier_filter",
           "Graph", "bfs", "bfs_multi", "delta_stepping", "pagerank",
           "sssp",
           "SHARD_SCHEDULES", "ShardedAdvancePlan", "build_sharded_advance",
           "shard_boundaries", "sharded_bfs", "sharded_bfs_multi",
           "sharded_delta_stepping", "sharded_pagerank", "sharded_sssp",
           "PackedForest", "WavefrontPlan", "build_wavefront",
           "pack_forest", "topological_levels", "wavefront_eval"]
