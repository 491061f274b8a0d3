"""The window over the steps completed in it: from its start to the end
of its last step (its loss read on the host), over the steps."""

SOURCE = "host_clock"


def read(run):
    w = run["window"]
    return w["seconds"] / w["iterations"] * 1e3
