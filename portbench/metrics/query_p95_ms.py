"""The 95th percentile of the latency of every query completed in the
window, from its issue to its synchronized result (host clock)."""
from portbench.harness.readers import percentile


def read(run):
    if not run.records:
        return None
    return 1e3 * percentile([r["latency_s"] for r in run.records], 95.0)
