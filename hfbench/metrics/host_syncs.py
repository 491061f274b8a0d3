"""Blocking waits of the host on the device a traced iteration: the CUDA
runtime's synchronising calls (`cudaStreamSynchronize`,
`cudaDeviceSynchronize`, `cudaEventSynchronize`, the synchronous
`cudaMemcpy`) that start inside the program's outermost span
(`hfr.two_stage` a forward, `hfr.train.step` a step), over the number of
those spans. One reader for `host_syncs.serve` and `.train`."""

from hfbench.program_spans import count_inside, roots

SOURCE = "program_span"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    rec = run["window"]["trace"]
    if rec is None:
        return None
    within = roots(rec)
    if not within:
        return None
    return count_inside(rec, lambda n: n in SYNCS, within) / len(within)
