"""K2's share of its roofline, in %: ``8 E + 4 V`` bytes an advance (each
edge's value and destination read once, each vertex's sum written once)
over the card's HBM peak, divided by the device time of K2
(``chunk_walk_tiles``) and the ordered fixup that finishes its sums
(``segment_sum_fixup``'s kernels) an advance.  The bound counts the same
work whatever kernels implement the reduction."""
from portbench.harness.readers import advances, group_time, traced
from portbench.harness.roofline import k2_advance_bytes


def read(run):
    n = advances(run)
    if not traced(run) or n == 0:
        return None
    secs, launches = group_time(run, "k2")
    if secs <= 0 or launches == 0:
        return None
    V, E = run.context["V"], run.context["E"]
    least = k2_advance_bytes(V, E) * n / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least / secs
