"""Set-up: from the start of the run's process (before torch is imported)
to the start of the window: imports, the fixture decode, the staged
batches, the model's construction and weights, the kernels' build or load,
the warm-up."""

SOURCE = "host_clock"


def read(run):
    return run["setup_s"]
