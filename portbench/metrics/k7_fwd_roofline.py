"""K7's share of its roofline, in %: ``4 hd H`` flop a (query, key) pair
of one sequence a launch, at the bf16 peak, over the mean device time of a
launch of ``flash_swa_wgmma``."""
from portbench.harness.readers import group_time, traced
from portbench.harness.roofline import k7_fwd_flop


def read(run):
    if not traced(run):
        return None
    secs, launches = group_time(run, "k7_fwd")
    if secs <= 0 or launches == 0:
        return None
    c = run.context
    least = k7_fwd_flop(c["model"], c["seq_len"]) \
        / run.peaks["bf16_flop_per_s"]
    return 100.0 * least * launches / secs
