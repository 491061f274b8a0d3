"""Every frame whose outputs reached the host within the window, over
the window (from its start to the end of its last batch)."""

SOURCE = "host_clock"


def read(run):
    w = run["window"]
    return w["frames"] / w["seconds"]
