"""The fused XConv's share of its roofline: the least time of a batch's
XConv calls on one H100 (`hfbench.flops.xconv_bound_s`: per call the
larger of its bytes over 3.35 TB/s and 3x its operations over TF32's
495 TFLOP/s), over the device time the profiler gives the XConv's kernels
(CUDA functions with `xconv` in the name: the kernel and its split
epilogue) a traced batch."""

from hfbench import flops
from hfbench.trace import kernels

SOURCE = "device_trace"
FUNCTIONS = ("xconv",)


def read(run):
    rec = run["window"]["trace"]
    if rec is None:
        return None
    us = sum(e - s for name, s, e in kernels(rec) if any(f in name for f in FUNCTIONS))
    if us <= 0:
        return None
    per_batch_s = us * 1e-6 / run["traced_iterations"]
    calls = flops.iteration_xconv_calls(run["model"], run["configs"], run["window"]["batch"])
    return 100.0 * flops.xconv_bound_s(calls) / per_batch_s
