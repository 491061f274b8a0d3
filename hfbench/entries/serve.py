"""Serving entry: a closed loop over batches staged on the card. Each
batch is dispatched to the program's entry, its output dict is copied to
the host (as `run_inference` does before it writes), then the next batch
is dispatched.

The workload file's `model` picks the entry the window drives:

  - "two_stage": `heterofusionrcnn_torch.inference.TwoStageDetector.forward`
    (RPN, then the RCNN on its proposals), judged on stage 1 (proposals,
    scores) and stage 2 (final boxes, scores, classes, valid flags,
    counts);
  - "rpn": `heterofusionrcnn_torch.models.rpn.RpnModel.forward` in test
    mode, judged on the segmentation softmax, the proposals and scores.

After the window, a sample of its batches and of their frames, drawn from
the seed, is judged against the reference (`hfbench/reference/`) on the same inputs and
weights. Each stage of the reference runs on what the reference itself
made: its RCNN over its own proposals, so that nothing the program made
enters the reference.
"""

from __future__ import annotations

import torch

from hfbench import harness, judge, trace, weights
from hfbench.inputs import traffic as traffic_lib

INPUT_KEYS = ("point_cloud", "image_input", "stereo_calib_p2")


class Entry:
    """setup() -> window(seconds) -> release() -> judge()."""

    def __init__(self, cell: harness.Cell, seed: int, device: torch.device, trace_on: bool,
                 control: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.trace_on, self.control = trace_on, control
        self.model_kind = cell.spec["model"]
        self.keep = cell.spec["outputs"]
        t = cell.traffic
        self.trace = trace.DeviceTrace(t["trace_start"], t["trace_iterations"],
                                       trace_on and device.type == "cuda")

    # ----------------------------------------------------------- set-up
    def setup(self) -> None:
        phase = harness.Phases(harness.clock())
        harness.set_precision(self.control)
        cfg = self.cell.config
        self.cfgs = harness.program_configs(cfg)
        mc = self.cfgs["rpn"].model_config
        ic = mc.input_config
        host = traffic_lib.staged_batches(self.cell.traffic, self.seed, ic.pc_sample_pts,
                                          ic.img_dims_w, ic.img_dims_h)
        phase("inputs on the host")
        self.inputs = [tuple(torch.from_numpy(b[k]).to(self.device) for k in INPUT_KEYS)
                       for b in host]
        phase("inputs on the device")
        self.model = self._program()
        phase("model built")
        self.state = weights.seeded_state(self.model.state_dict(), self.seed, self.device)
        self.model.load_state_dict(self.state)
        phase("weights")
        self._to_host(self._forward(self.inputs[0]))
        phase("first forward")
        for x in self.inputs[1:]:  # every staged batch once: all shapes and data paths warm
            self._to_host(self._forward(x))
        self.timer = trace.ModuleTimer(self._layers(), self.trace.enabled)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        phase("warm-up")

    def _program(self):
        cs = [tuple(c) for c in self.cell.config["cluster_sizes"]]
        sw = self.cell.config.get("switches", {})
        with torch.device(self.device):
            if self.model_kind == "two_stage":
                from heterofusionrcnn_torch.inference import TwoStageDetector

                model = TwoStageDetector(self.cfgs["rpn"], self.cfgs["rcnn"], cs,
                                         conv_kernels=sw.get("conv_kernels", False),
                                         crop_kernel=sw.get("crop_kernel", False),
                                         bev_z_max=self.cell.config["bev_z_max"])
            else:
                from heterofusionrcnn_torch.models.rpn import RpnModel

                model = RpnModel(self.cfgs["rpn"].model_config, len(cs), cs,
                                 save_rpn_feature=False,
                                 conv_kernels=sw.get("conv_kernels", False), mode="test")
        return model.eval()

    def _layers(self):
        """The program's modules whose device time the trace reads."""
        m = self.model
        rpn = m.rpn if self.model_kind == "two_stage" else m
        out = {"rpn": rpn, "pc_extractor": getattr(rpn, rpn.pc_extractor_name)}
        if self.model_kind == "two_stage":
            out["rcnn"] = m.rcnn
        return out

    def _forward(self, x):
        with torch.no_grad(), trace.span("forward"):
            return self.model(*x)

    def _to_host(self, out):
        with trace.span("to_host"):
            return {k: out[k].to("cpu") for k in self.keep}

    # ----------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        """Batches back to back for `seconds`; every batch's dispatch and
        latency (dispatch until its outputs are on the host). The outputs
        of the batches the check samples (`check_sample`) are kept."""
        n = len(self.inputs)
        self.sample, self.frames = self.check_sample()
        self.outputs, latency, dispatch, ends = {}, [], [], []
        i = 0
        t0 = harness.clock()
        while True:
            self.trace.before(i)
            ta = harness.clock()
            out = self._forward(self.inputs[i % n])
            tb = harness.clock()
            host = self._to_host(out)
            tc = harness.clock()
            self.timer.mark()
            self.trace.after(i)
            if i in self.sample:
                self.outputs[i] = host
            latency.append(tc - ta)
            dispatch.append(tb - ta)
            ends.append(tc - t0)
            i += 1
            if tc - t0 >= seconds and self.trace.done and i > self.sample[-1]:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        batch = self.cell.traffic["batch"]
        untraced = [j for j in range(i) if j not in self.trace.iterations]
        return {"iterations": i, "seconds": ends[-1], "frames": i * batch, "batch": batch,
                "latency_s": latency, "dispatch_s": dispatch, "ends_s": ends,
                "untraced": untraced,
                "layer_ms": self.timer.per_iteration(untraced) if self.trace.enabled else {},
                "trace": self.trace.record}

    def check_sample(self):
        """The window's batches the check judges (`check.batches` of its
        first pass over the staged batches) and in each the frames it
        judges (`check.frames`, half of them from each half of the batch,
        so that a half left out shows; every frame where it is absent),
        drawn from the seed."""
        r = traffic_lib.rng(self.seed, 1)
        spec = self.cell.spec["check"]
        batches = sorted(int(j) for j in r.choice(len(self.inputs), spec["batches"], replace=False))
        b = self.cell.traffic["batch"]
        k = min(spec.get("frames", b), b)
        frames = {}
        for j in batches:
            first = r.choice(b // 2, k // 2, replace=False)
            second = b // 2 + r.choice(b - b // 2, k - k // 2, replace=False)
            frames[j] = sorted(int(f) for f in first.tolist() + second.tolist())
        return batches, frames

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.timer.close()
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- check
    def judge(self):
        """({number: value}, {number: limit}) over the sampled batches."""
        from hfbench.reference import exact_float32
        from hfbench.reference.models import TwoStage, build_rpn

        spec = self.cell.spec["check"]
        limits = dict(spec["limits"])
        n = len(self.inputs)
        exact_float32()
        rcfg = harness.reference_configs(self.cell.config)
        cs = [tuple(c) for c in self.cell.config["cluster_sizes"]]
        with torch.device(self.device):
            if self.model_kind == "two_stage":
                ref = TwoStage(rcfg["rpn"], rcfg["rcnn"], cs, self.cell.config["bev_z_max"])
            else:
                ref = build_rpn(rcfg["rpn"], cs, "test", device=self.device)
        ref.load_state_dict(weights.seeded_state(ref.state_dict(), self.seed, self.device))
        ref.eval()
        nums = judge.Numbers()
        tol = spec["match_tol"]
        with torch.no_grad():
            for j in self.sample:
                idx = torch.tensor(self.frames[j])
                pc, img, p2 = (x[idx.to(x.device)] for x in self.inputs[j % n])
                prog = {k: v[idx].to(self.device) for k, v in self.outputs[j].items()}
                if self.model_kind == "two_stage":
                    rpn_out = ref.rpn(pc, img, p2)
                    judge.judge_stage1(nums, "stage1", prog, rpn_out, tol)
                    judge.judge_stage2(nums, prog, ref.stage2(rpn_out, img, p2),
                                       tol)
                else:
                    rpn_out = ref(pc, img, p2)
                    judge.judge_seg(nums, prog, rpn_out)
                    judge.judge_stage1(nums, "stage1", prog, rpn_out, tol)
        return nums.values(), limits
