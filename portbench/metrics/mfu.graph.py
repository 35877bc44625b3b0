"""A graph query's share of the HBM roofline, in %: the least bytes its
advances need, ``4 (V + 1) + 4 E + 12 V`` an iteration (row offsets and
columns read once; the previous ranks, out-degrees and new ranks once
each), over the card's HBM peak, divided by the queries' traced time.
PageRank's ``2 E`` flop are far below this bound."""
from portbench.harness.readers import advances, traced, unit_seconds
from portbench.harness.roofline import pagerank_iteration_bytes


def read(run):
    if not traced(run) or not run.records:
        return None
    V, E = run.context["V"], run.context["E"]
    least = pagerank_iteration_bytes(V, E) * advances(run)
    return 100.0 * least / run.peaks["hbm_bytes_per_s"] / unit_seconds(run)
