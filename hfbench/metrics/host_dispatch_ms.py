"""The host's time in the entry's call (a forward, or a train step),
from the call to its return (before the outputs are read), mean over the
window's untraced iterations: the program's Python, its planning and the
issuing of its launches. One reader for `host_dispatch_ms.serve` and
`.train`."""

SOURCE = "host_clock"


def read(run):
    w = run["window"]
    it = w["untraced"]
    return sum(w["dispatch_s"][i] for i in it) / len(it) * 1e3 if it else None
