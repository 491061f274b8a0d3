"""Training entry: the RPN's train step (`runtime.train_state.
make_rpn_train_step` over `models.rpn.rpn_loss`, with the optimizer of
`runtime.optimizer.build_optimizer` and `TrainState.create`, built as
`experiments.common` builds them for `run_training`), steps back to back
on labelled batches staged on the card, each step's loss read on the host
as a trainer that logs it does.

Set-up builds one train state, drives it from the seed through its first
three steps by the window's own call on three different batches, and
hands that same state to the window. Those three steps are the ones
judged: the reference (`hfbench/reference/models.train_steps`) runs them
from the same weights, batches and generator seeds, and the numbers are
each step's total loss, the first step's clipped gradient (worked out from
Adam's first moment after it) by the worst leaf, each parameter's change
over the three steps by the median leaf, and the BatchNorm statistics'
change by the worst leaf. Leaves whose reference gradient is nought to
rounding are left out of the first two (`judge.moving_leaves`).
"""

from __future__ import annotations

import sys

import torch

from hfbench import harness, judge, trace, weights
from hfbench.inputs import traffic as traffic_lib

BATCH_KEYS = ("point_cloud", "image_input", "stereo_calib_p2",
              "label_seg", "label_reg", "label_boxes_3d")
CHECKED_STEPS = 3
ADAM_B1 = 0.9


class Entry:
    """setup() -> window(seconds) -> release() -> judge()."""

    def __init__(self, cell: harness.Cell, seed: int, device: torch.device, trace_on: bool,
                 control: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.trace_on, self.control = trace_on, control
        t = cell.traffic
        self.trace = trace.DeviceTrace(t["trace_start"], t["trace_iterations"],
                                       trace_on and device.type == "cuda")
        # The generators' seed (TrainState seeds "dropout" with it + 1 and
        # "path_drop" with it + 2).
        self.gen_seed = int(seed) % (1 << 62)

    # ----------------------------------------------------------- set-up
    def setup(self) -> None:
        from heterofusionrcnn_torch.models.rpn import RpnModel, rpn_loss
        from heterofusionrcnn_torch.runtime.optimizer import build_optimizer
        from heterofusionrcnn_torch.runtime.train_state import TrainState, make_rpn_train_step

        phase = harness.Phases(harness.clock())
        harness.set_precision(self.control)
        self.cfg = harness.program_configs(self.cell.config)["rpn"]
        mc, tc = self.cfg.model_config, self.cfg.train_config
        ic = mc.input_config
        host = traffic_lib.staged_batches(self.cell.traffic, self.seed, ic.pc_sample_pts,
                                          ic.img_dims_w, ic.img_dims_h)
        phase("inputs on the host")
        self.batches = [{k: torch.from_numpy(b[k]).to(self.device) for k in BATCH_KEYS}
                        for b in host]
        phase("inputs on the device")
        cs = [tuple(c) for c in self.cell.config["cluster_sizes"]]
        with torch.device(self.device):
            self.model = RpnModel(mc, len(cs), cs, save_rpn_feature=False, mode="train")
        phase("model built")
        self.init = weights.seeded_state(self.model.state_dict(), self.seed, self.device)
        self.model.load_state_dict(self.init)
        optimizer = build_optimizer(self.model, tc.optimizer, grad_clip_norm=tc.grad_clip_norm)
        self.state = TrainState.create(self.model, optimizer, self.gen_seed)
        self.step = make_rpn_train_step(lambda preds: rpn_loss(preds, mc))
        phase("weights and optimizer")
        self.losses = []
        for i in range(CHECKED_STEPS):
            metrics = self._step(self.batches[i])
            self.losses.append({k: float(v) for k, v in metrics.items()
                                if k.endswith("loss")})
            if i == 0:  # the clipped gradient, from Adam's first moment
                self.first_grad = {n: mu / (1 - ADAM_B1) for n, mu in
                                   zip(optimizer.names, optimizer.state["mu"])}
            phase(f"step {i + 1}")
        self.after = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _step(self, batch):
        with trace.span("train_step"):
            return self.step(self.state, batch)

    # ----------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        """Steps back to back for `seconds`, each ended by reading its loss
        on the host; every step's dispatch (the step call) and time."""
        n = len(self.batches)
        times, dispatch, ends = [], [], []
        i = 0
        t0 = harness.clock()
        while True:
            self.trace.before(i)
            ta = harness.clock()
            metrics = self._step(self.batches[(CHECKED_STEPS + i) % n])
            tb = harness.clock()
            with trace.span("read_loss"):
                float(metrics["total_loss"])
            tc = harness.clock()
            self.trace.after(i)
            times.append(tc - ta)
            dispatch.append(tb - ta)
            ends.append(tc - t0)
            i += 1
            if tc - t0 >= seconds and self.trace.done:
                break
        untraced = [j for j in range(i) if j not in self.trace.iterations]
        return {"iterations": i, "seconds": ends[-1], "batch": self.cell.traffic["batch"],
                "latency_s": times, "dispatch_s": dispatch, "ends_s": ends,
                "untraced": untraced, "layer_ms": {}, "trace": self.trace.record}

    def release(self) -> None:
        """Free the program's model, optimizer state and activations."""
        del self.state, self.step, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- check
    def judge(self):
        """({number: value}, {number: limit}) of the three checked steps."""
        from hfbench.reference import exact_float32
        from hfbench.reference.models import build_rpn, train_steps
        from hfbench.reference.optimizer import build_optimizer as ref_optimizer

        exact_float32()
        spec = self.cell.spec["check"]
        rcfg = harness.reference_configs(self.cell.config)["rpn"]
        cs = [tuple(c) for c in self.cell.config["cluster_sizes"]]
        ref = build_rpn(rcfg, cs, "train", device=self.device)
        ref.load_state_dict(self.init)
        tc = rcfg.train_config
        opt = ref_optimizer(ref, tc.optimizer, grad_clip_norm=tc.grad_clip_norm)
        gens = {name: torch.Generator(device=self.device).manual_seed(self.gen_seed + i)
                for i, name in ((1, "dropout"), (2, "path_drop"))}
        losses, grads = train_steps(ref, opt, self.batches[:CHECKED_STEPS], gens)
        ref_after = ref.state_dict()

        values = {"loss_gap": max(abs(got["total_loss"] - want["total_loss"]) / abs(want["total_loss"])
                                  for got, want in zip(self.losses, losses))}
        moving = judge.moving_leaves(grads)
        params = dict(ref.named_parameters())
        stats = [k for k in ref_after if k.endswith(("running_mean", "running_var"))]
        gaps = {
            "grad_gap": judge.leaf_gaps(self.first_grad, grads, moving),
            "change_gap": judge.leaf_gaps({n: self.after[n] - self.init[n] for n in params},
                                          {n: ref_after[n] - self.init[n] for n in params},
                                          moving),
            "bn_stat_gap": judge.leaf_gaps({k: self.after[k] - self.init[k] for k in stats},
                                           {k: ref_after[k] - self.init[k] for k in stats},
                                           stats),
        }
        for name, per_leaf in gaps.items():
            worst = max(per_leaf, key=per_leaf.get)
            ordered = sorted(per_leaf.values())
            print(f"{name}: worst leaf {worst} {per_leaf[worst]!r}, median leaf "
                  f"{ordered[len(ordered) // 2]!r}", file=sys.stderr)
            values[name] = per_leaf[worst]
        # The worst leaf's change swings with the float32 sums' order (the
        # reference against itself reads as much, PERF.md): the median
        # leaf's is compared.
        ordered = sorted(gaps["change_gap"].values())
        values["change_gap"] = ordered[len(ordered) // 2]
        print(f"leaves compared {len(moving)} of {len(params)}", file=sys.stderr)
        return values, dict(spec["limits"])
