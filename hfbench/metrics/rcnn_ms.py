"""Device time of the program's RCNN (`models.rcnn.RcnnModel`) a batch: CUDA events from the
benchmark's forward pre/post hooks on that module, mean over the
window's untraced batches."""

SOURCE = "program_span"


def read(run):
    ms = run["window"]["layer_ms"].get("rcnn")
    return sum(ms) / len(ms) if ms else None
