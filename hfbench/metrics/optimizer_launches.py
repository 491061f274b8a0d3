"""Kernel launches of the optimizer a traced train step: the CUDA launch
calls (`cudaLaunchKernel*`, and `cuLaunchKernel*` of the low-level API) that
start inside the program's `hfr.train.optimizer` span (clipping, the
update and the EMA), over the number of those spans. The autograd
engine's thread is idle while the optimizer runs, so a launch inside the
span's time is the optimizer's."""

from hfbench.program_spans import count_inside, spans

SOURCE = "program_span"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def read(run):
    rec = run["window"]["trace"]
    if rec is None:
        return None
    within = spans(rec, "train.optimizer")
    if not within:
        return None
    return count_inside(rec, lambda n: n.startswith(LAUNCHES), within) / len(within)
