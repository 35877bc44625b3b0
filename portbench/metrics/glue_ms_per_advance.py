"""Device milliseconds an advance spends outside the port's own CUDA
kernels (``kernels.json``'s ``port`` names): the executors' and the
advance plan's PyTorch operations, copies and fills."""
from portbench.harness.readers import advances, group_time, traced


def read(run):
    n = advances(run)
    if not traced(run) or n == 0:
        return None
    total = sum(run.trace.device_ops.values())
    port, _ = group_time(run, "port")
    return 1e3 * (total - port) / n
