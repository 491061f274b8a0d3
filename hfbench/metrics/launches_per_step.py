"""CUDA kernel launches a train step: the kernels (not copies or sets)
of the traced steps in the profiler, over the steps."""

from hfbench.trace import kernels

SOURCE = "device_trace"


def read(run):
    rec = run["window"]["trace"]
    if rec is None:
        return None
    return len(kernels(rec)) / run["traced_iterations"]
