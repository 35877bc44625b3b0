"""K7's backward's share of its roofline, in %: ``10 hd H`` flop a
(query, key) pair of one sequence a backward, at the bf16 peak, over the
device time of its two kernels (``dq_kernel`` and ``dkdv_kernel``) a
backward."""
from portbench.harness.readers import group_time, traced
from portbench.harness.roofline import k7_bwd_flop


def read(run):
    if not traced(run):
        return None
    secs, _ = group_time(run, "k7_bwd")
    _, backwards = group_time(run, "k7_dq")
    if secs <= 0 or backwards == 0:
        return None
    c = run.context
    least = k7_bwd_flop(c["model"], c["seq_len"]) \
        / run.peaks["bf16_flop_per_s"]
    return 100.0 * least * backwards / secs
