"""Peak device memory over the window of training steps, GiB."""
from portbench.harness.readers import peak_gib


def read(run):
    return peak_gib(run)
