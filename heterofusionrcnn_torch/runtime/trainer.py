"""Training loop (PyTorch port of heterofusionrcnn_tpu/runtime/trainer.py).

The JAX trainer's external behaviour: the output tree
<output_root>/<checkpoint_name>/{checkpoints,logs,predictions}, the config
snapshot at start, resume from the latest checkpoint, the iteration budget
divided by the world size, metrics every `summary_interval` steps into
logs/metrics.jsonl (and TensorBoard where it imports), a checkpoint every
`checkpoint_interval` steps and at the end, the host-RSS cap
(`HFR_MAX_HOST_RSS_MB`: checkpoint, then exit 75 for a relaunch) and
`profile_steps` traced by `torch.profiler` into logs/profile. Runs on the
card unless the caller passes `device="cpu"`; float32 matmuls and
convolutions stay in full float32 (TF32 off, cuDNN's backward included).

The profile (`logs/profile/trace_step<N>.json`, a Chrome trace) holds the
port's spans (`runtime/tracing.py`) as `hfr.*` ranges on the host
thread's row: `hfr.train.step` around `hfr.train.forward` (the models'
`hfr.rpn.*` or `hfr.rcnn.*` inside), `hfr.train.loss`,
`hfr.train.backward`, `hfr.train.all_reduce` (data-parallel) and
`hfr.train.optimizer` (`hfr.optimizer.clip`, `.update`, `.ema`). The
operators, the `hfr::<op>` custom ops and the `cudaLaunchKernel` calls
nest inside them; each kernel on the device's rows links back to its
launch, and an idle stretch there falls under the range open on the host.

Data-parallel (a process group of W ranks, `parallel/`): every rank runs
this loop on its own batches, each starting from rank 0's state
(`replicate_state`, after a warm start or a resume); the learning rate is
scaled by W and the budget divided by W, as in JAX; rank 0 alone writes
the config snapshot, the metrics, the profile and the checkpoints, and a
host-RSS cap passed on any rank makes every rank checkpoint and exit 75.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from heterofusionrcnn_torch.configs.config import PipelineConfig, save_config
from heterofusionrcnn_torch.datasets.prefetch import BatchPrefetcher
from heterofusionrcnn_torch.inference import exact_float32
from heterofusionrcnn_torch.models.extractors.layers import init_weights
from heterofusionrcnn_torch.parallel.mesh import any_rank, rank_and_size, replicate_state
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager, restore_matching
from heterofusionrcnn_torch.runtime.optimizer import build_optimizer
from heterofusionrcnn_torch.runtime.train_state import TrainState


class MetricsLogger:
    """Scalars into <log_dir>/metrics.jsonl, one JSON object a logged step
    (the JAX trainer's keys), and into TensorBoard when
    `torch.utils.tensorboard` imports. `histograms` adds one histogram a
    parameter; `img_images` / `pc_images` add the input image and a BEV
    histogram of the points (train_config's summary toggles)."""

    def __init__(self, log_dir: str, histograms: bool = True, img_images: bool = False,
                 pc_images: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.histograms = histograms
        self.img_images = img_images
        self.pc_images = pc_images
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": int(step)}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in record.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def log_image(self, step: int, name: str, image) -> None:
        """An (H, W) or (H, W, C) array, min-max normalised."""
        arr = np.asarray(image, dtype=np.float32)
        arr = (arr - arr.min()) / (arr.max() - arr.min() + 1e-8)
        if self._tb is not None:
            self._tb.add_image(name, arr, step, dataformats="HW" if arr.ndim == 2 else "HWC")

    def log_param_histograms(self, step: int, module: nn.Module) -> None:
        if self.histograms and self._tb is not None:
            for name, p in module.named_parameters():
                self._tb.add_histogram(name.replace(".", "/"), p.detach().float().cpu(), step)

    def log_input_summaries(self, step: int, batch: dict) -> None:
        if self.img_images and "image_input" in batch:
            self.log_image(step, "input/image", np.asarray(batch["image_input"])[0])
        if self.pc_images and "point_cloud" in batch:
            pc = np.asarray(batch["point_cloud"])[0]
            bev, _, _ = np.histogram2d(pc[:, 0], pc[:, 2], bins=(200, 176),
                                       range=[[-40, 40], [0, 70]])
            self.log_image(step, "input/pc_bev", np.log1p(bev))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def device_memory_mb(device) -> float:
    """Peak device memory in MB since the process started (or the last
    `torch.cuda.reset_peak_memory_stats`); 0.0 on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1e6


def host_rss_mb() -> float:
    """Host resident-set size in MB from /proc/self/statm; 0.0 where that
    file does not exist."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
    except OSError:
        return 0.0
    return rss_pages * (os.sysconf("SC_PAGE_SIZE") / 1e6)


def setup_output_dirs(output_root: str, checkpoint_name: str) -> Dict[str, str]:
    """<root>/<name>/{checkpoints,logs,predictions}."""
    base = os.path.join(output_root, checkpoint_name)
    paths = {"base": base}
    for sub in ("checkpoints", "logs", "predictions"):
        paths[sub] = os.path.join(base, sub)
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def train(
    model: nn.Module,
    loss_fn: Callable,
    make_train_step: Callable,
    next_batch: Callable[[], dict],
    pipeline_cfg: PipelineConfig,
    output_root: str,
    device: str = "cuda",
    seed: int = 0,
    init_params_from: Optional[Dict[str, torch.Tensor]] = None,
    profile_steps: Optional[Tuple[int, int]] = None,
    group: Optional[dist.ProcessGroup] = None,
) -> TrainState:
    """Train `model` (weights from `seed`) on `next_batch()`'s host batches,
    loaded and copied to `device` one batch ahead in a worker thread.

    Args:
      loss_fn: predictions -> (loss_dict, total); with a `group`, this
        rank's share of the global loss (`common.build_model(group=...)`).
      make_train_step: loss_fn -> step(state, batch) -> metrics; `batch`
        holds every entry of `next_batch()`'s dict, on `device`.
      init_params_from: a state dict for a warm start: tensors of the same
        name and shape replace the fresh weights (`restore_matching`).
      profile_steps: (start, stop) step range traced with torch.profiler
        into <logs>/profile (a Chrome trace).
      group: the data-parallel process group (None: one process);
        `next_batch()` then gives this rank's rows of each global batch.
    Returns:
      the final TrainState.
    """
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    exact_float32()
    rank, world = rank_and_size(group)
    tc = pipeline_cfg.train_config
    name = pipeline_cfg.model_config.checkpoint_name
    paths = setup_output_dirs(output_root, name)
    if rank == 0:
        save_config(pipeline_cfg, os.path.join(paths["base"], name + "_config.json"))

    init_weights(model, seed)
    if init_params_from is not None:
        model.load_state_dict(restore_matching(model.state_dict(), init_params_from))
    model.to(device)
    optimizer = build_optimizer(model, tc.optimizer, world_size=world,
                                grad_clip_norm=tc.grad_clip_norm)
    state = TrainState.create(model, optimizer, seed, group)

    ckpt = CheckpointManager(paths["checkpoints"], tc.max_checkpoints_to_keep, group)
    if not tc.overwrite_checkpoints and ckpt.latest_step() is not None:
        ckpt.restore(state)
        if rank == 0:
            print(f"Resumed from step {state.step}", flush=True)
    replicate_state(state, group)

    train_step = make_train_step(loss_fn)
    logger = None
    if rank == 0:
        logger = MetricsLogger(paths["logs"], histograms=tc.summary_histograms,
                               img_images=tc.summary_img_images, pc_images=tc.summary_pc_images)
    log_every = tc.summary_interval
    max_iters = tc.max_iterations // world

    def prep(b):
        return b, batch_to_device(b, device)

    prefetcher = BatchPrefetcher(next_batch, capacity=2, transform=prep)
    step = state.step
    t_last = time.time()
    profiler = None
    try:
        while step < max_iters:
            if profile_steps is not None and rank == 0:
                if step == profile_steps[0] and profiler is None:
                    profiler = _start_profile(device)
                elif step >= profile_steps[1] and profiler is not None:
                    _stop_profile(profiler, paths["logs"], step)
                    profiler = None
            host_batch, batch = prefetcher.next()
            metrics = train_step(state, batch)
            step = state.step

            if step % log_every == 0:
                rss_mb = host_rss_mb()
                if logger is not None:
                    dt = time.time() - t_last
                    t_last = time.time()
                    names = sorted(metrics)
                    vals = torch.stack([metrics[k].float() for k in names]).cpu().numpy()
                    host_metrics = dict(zip(names, map(float, vals)))
                    host_metrics["steps_per_sec"] = log_every / max(dt, 1e-9)
                    host_metrics["device_mem_mb"] = device_memory_mb(device)
                    host_metrics["host_rss_mb"] = rss_mb
                    logger.log(step, host_metrics)
                    logger.log_param_histograms(step, model)
                    logger.log_input_summaries(step, host_batch)
                    print(f"step {step}/{max_iters} "
                          + " ".join(f"{k}={v:.4f}" for k, v in host_metrics.items()),
                          flush=True)
                # A restart point: past HFR_MAX_HOST_RSS_MB (on any rank),
                # checkpoint now and exit 75 (EX_TEMPFAIL) so that an outer
                # loop relaunches and resumes at this step.
                max_rss = float(os.environ.get("HFR_MAX_HOST_RSS_MB", "0") or 0)
                if max_rss and any_rank(rss_mb > max_rss, group, device):
                    ckpt.save(step, state)
                    print(f"host RSS {rss_mb:.0f} MB (rank {rank}), limit {max_rss:.0f} MB: "
                          f"checkpointed at step {step}, exiting 75 for relaunch", flush=True)
                    raise SystemExit(75)

            if step % tc.checkpoint_interval == 0 or step == max_iters:
                ckpt.save(step, state)
        if profiler is not None:
            _stop_profile(profiler, paths["logs"], step)
        if step % tc.checkpoint_interval != 0:
            ckpt.save(step, state)
    finally:
        prefetcher.close()
        if logger is not None:
            logger.close()
        ckpt.close()
    return state


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, log_dir: str, step: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"trace_step{step}.json"))
