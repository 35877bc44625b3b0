"""The device's idle share of the traced window of training steps, in %."""
from portbench.harness.readers import idle_share_pct


def read(run):
    return idle_share_pct(run)
