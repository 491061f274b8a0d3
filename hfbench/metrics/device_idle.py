"""The share of the traced window in which no operation ran on the
device: one minus the union of the device's intervals (not their sum)
over the window. One reader for `device_idle.serve` and `.train`."""

from hfbench.trace import busy_and_gaps

SOURCE = "device_trace"


def read(run):
    rec = run["window"]["trace"]
    if rec is None:
        return None
    busy, _ = busy_and_gaps(rec)
    w0, w1 = rec["window"]
    return 100.0 * (1.0 - busy / (w1 - w0))
