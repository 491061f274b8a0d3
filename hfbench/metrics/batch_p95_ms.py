"""The 95th percentile over all batches of the window of the time from
dispatch until the batch's outputs are on the host (linear interpolation
between order statistics)."""

import numpy as np

SOURCE = "host_clock"


def read(run):
    return float(np.percentile(np.asarray(run["window"]["latency_s"]) * 1e3, 95))
