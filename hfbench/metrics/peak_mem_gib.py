"""`torch.cuda.max_memory_allocated()` over set-up and window, GiB."""

SOURCE = "host_clock"


def read(run):
    return run["memory_peak_bytes"] / 2**30
