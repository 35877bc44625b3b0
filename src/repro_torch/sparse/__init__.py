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
from repro_torch.sparse.graph import (Graph, bfs, delta_stepping, pagerank,
                                      sssp)

__all__ = ["COO", "CSC", "CSR", "random_csr", "suite_like_corpus",
           "spmm", "spmv", "spmv_reference", "spvv",
           "AdvancePlan", "advance", "advance_frontier", "advance_push",
           "advance_relax_min", "advance_src_argmin", "build_advance",
           "build_advance_views", "estimate_delta", "frontier_filter",
           "Graph", "bfs", "delta_stepping", "pagerank", "sssp"]
