"""The training step's model flop share of the card's bf16 peak, in %:
``6 N`` flop a token (``N`` the parameters less the embedding table) plus
``12 L H hd`` a (query, key) pair of every sequence, over the traced
steps' time times 989 TFLOP/s.  Recomputation is not counted."""
from portbench.harness.readers import traced, unit_seconds
from portbench.harness.roofline import lm_step_flop


def read(run):
    if not traced(run) or not run.records:
        return None
    c = run.context
    flop = lm_step_flop(c["model"], c["batch"], c["seq_len"]) \
        * len(run.records)
    return 100.0 * flop / run.peaks["bf16_flop_per_s"] / unit_seconds(run)
