"""Device time of the program's RPN's point extractor (`models/extractors/pointcnn.py` or `pointnet.py`) a batch: CUDA events from the
benchmark's forward pre/post hooks on that module, mean over the
window's untraced batches."""

SOURCE = "program_span"


def read(run):
    ms = run["window"]["layer_ms"].get("pc_extractor")
    return sum(ms) / len(ms) if ms else None
