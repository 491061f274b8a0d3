"""The whole forward's or train step's share of the chip's peak: the
dense operations of an iteration counted from the configuration
(`hfbench.flops.iteration_flops`; a train step's forward and backward as
3x the forward's products), times the window's untraced iterations, over
their time, against the peak of the configuration's compute dtype
(`hfbench.flops.PEAK_FLOPS_PER_S`: float32 165 TFLOP/s, TF32's 495 over 3,
as its products run in 3xTF32; bf16 989). One reader for `mfu.serve` and
`mfu.train`."""

from hfbench import flops

SOURCE = "host_clock"


def read(run):
    w = run["window"]
    it = w["untraced"]
    if not it:
        return None
    per = flops.iteration_flops(run["model"], run["configs"], w["batch"], run["num_classes"],
                                run["kind"] == "train")
    seconds = sum(w["latency_s"][i] for i in it)
    return 100.0 * per * len(it) / seconds / flops.PEAK_FLOPS_PER_S[run["compute_dtype"]]
