"""Fused two-stage inference over a KITTI split (the port of
heterofusionrcnn_tpu/experiments/run_inference.py: same flags, output
layout and file format). Runs on the card unless given `--device cpu`.

    python -m heterofusionrcnn_torch.experiments.run_inference \\
        --rpn_config rpn_multiclass --rcnn_config rcnn_multiclass \\
        --rpn_checkpoint outputs/rpn_multiclass/checkpoints \\
        --rcnn_checkpoint outputs/rcnn_multiclass/checkpoints \\
        --data_split val --output_root outputs [--conv_kernels] [--crop_kernel]

Checkpoints are the port's (`runtime.checkpoint.CheckpointManager`), the
latest step of each directory. One prediction file per frame lands in
<output_root>/<rcnn checkpoint_name>/predictions/final_predictions_and_scores/
<split>/<rpn step>_<rcnn step>_fused/<frame>.txt, one row per box:
x y z l w h ry score class (%.5f). `--kitti_eval` converts them to KITTI
rows and prints the native evaluator's AP lines. It also prints the host
ms a frame of each of the port's spans (`runtime/tracing.py`): the
detector's layers from `two_stage` down.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from heterofusionrcnn_torch.experiments import common
from heterofusionrcnn_torch.inference import exact_float32
from heterofusionrcnn_torch.runtime import tracing
from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager


def load_state(ckpt_dir: str):
    """(state dict, step) of the latest checkpoint in `ckpt_dir`."""
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    restored = mgr.restore_raw(step)
    mgr.close()
    return restored["state_dict"], step


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Fused two-stage KITTI inference with the PyTorch/CUDA port")
    parser.add_argument("--rpn_config", default="rpn_multiclass")
    parser.add_argument("--rcnn_config", default="rcnn_multiclass")
    parser.add_argument("--rpn_checkpoint", required=True)
    parser.add_argument("--rcnn_checkpoint", required=True)
    parser.add_argument("--data_split", default="val")
    parser.add_argument("--dataset_dir", default=None)
    parser.add_argument("--output_root", default="outputs")
    parser.add_argument("--shared_img_feature", type=int, default=None, choices=(0, 1),
                        help="override rcnn_use_rpn_img_feature_map: 1 = the RCNN crops "
                             "stage-1's image feature map (one VGG pass per frame), "
                             "0 = the RCNN runs its own image extractor")
    parser.add_argument("--img_downsample", type=int, default=None,
                        help="override the image-extractor downsample factor")
    parser.add_argument("--kitti_eval", action="store_true",
                        help="convert predictions to KITTI format and run the native "
                             "C++ evaluator (prints AP)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--conv_kernels", action="store_true",
                        help="run the VGG 3x3 convs and transposed convs through the fused "
                             "conv + BN + ReLU kernels (ops/conv.py)")
    parser.add_argument("--crop_kernel", action="store_true",
                        help="gather the RCNN crop's feature rows with the crop kernel "
                             "(ops/cropping.crop_gather)")
    return parser.parse_args(argv)


@torch.no_grad()
def main(argv=None) -> dict:
    """Run the CLI; returns the output directory, the frame names, the ms of
    each frame's forward, the host ms a frame of each span and, with
    --kitti_eval, the AP table."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    exact_float32()

    rpn_cfg = common.resolve_config(args.rpn_config, args.dataset_dir)
    rcnn_cfg = common.resolve_config(args.rcnn_config, args.dataset_dir)
    rpn_cfg.dataset_config.aug_list = []
    if args.shared_img_feature is not None:
        rcnn_cfg.model_config.rcnn_config.rcnn_use_rpn_img_feature_map = bool(
            args.shared_img_feature)
    if args.img_downsample is not None:
        for c in (rpn_cfg, rcnn_cfg):
            c.model_config.layers_config.img_vgg_pyr.downsample = args.img_downsample

    dataset = common.build_dataset(rpn_cfg, "test", args.data_split)
    det = common.build_detector(rpn_cfg, rcnn_cfg, dataset, args.conv_kernels, args.crop_kernel)
    rpn_sd, rpn_step = load_state(args.rpn_checkpoint)
    rcnn_sd, rcnn_step = load_state(args.rcnn_checkpoint)
    det.rpn.load_state_dict(rpn_sd)
    det.rcnn.load_state_dict(rcnn_sd)
    det = det.to(args.device)

    step_tag = f"{rpn_step}_{rcnn_step}_fused"
    predictions_root = os.path.join(
        args.output_root, rcnn_cfg.model_config.checkpoint_name, "predictions")
    out_dir = os.path.join(predictions_root, "final_predictions_and_scores",
                           args.data_split, step_tag)
    os.makedirs(out_dir, exist_ok=True)

    ic = rpn_cfg.model_config.input_config
    times, frames = [], []
    dataset._index_in_epoch = 0
    epoch0 = dataset.epochs_completed
    tracing.enable()
    try:
        while dataset.epochs_completed == epoch0:
            batch, names = dataset.next_batch(
                1, shuffle=False, model="rpn", pc_sample_pts=ic.pc_sample_pts,
                img_w=ic.img_dims_w, img_h=ic.img_dims_h,
            )
            inputs = [torch.from_numpy(batch[k]).to(args.device)
                      for k in ("point_cloud", "image_input", "stereo_calib_p2")]
            t0 = time.time()
            out = {k: v.cpu().numpy() for k, v in det(*inputs).items()}
            times.append(time.time() - t0)
            frames.append(names[0])

            n = int(out["num_final"][0])
            rows = np.column_stack([out["final_boxes"][0][:n], out["final_scores"][0][:n],
                                    out["final_classes"][0][:n]])
            np.savetxt(os.path.join(out_dir, names[0] + ".txt"), rows, fmt="%.5f")
        span_ms = tracing.host_ms(tracing.collect()["spans"])
    finally:
        tracing.enable(False)

    print(f"inference done: {len(times)} samples, mean {np.mean(times) * 1000:.1f} ms, "
          f"median {np.median(times) * 1000:.1f} ms -> {out_dir}")
    print("host ms a frame by span: "
          + ", ".join(f"{name} {ms:.2f}" for name, ms in span_ms.items()))
    result = {"out_dir": out_dir, "frames": frames, "frame_ms": [t * 1e3 for t in times],
              "span_ms": span_ms}

    if args.kitti_eval:
        from heterofusionrcnn_torch.runtime.kitti_writer import save_predictions_in_kitti_format
        from heterofusionrcnn_torch.runtime.native_eval import run_kitti_native_eval

        kitti_dir = save_predictions_in_kitti_format(dataset, predictions_root, 0.1, step_tag)
        aps = run_kitti_native_eval(dataset.label_dir, kitti_dir)
        for key in sorted(aps):
            e, m, h = aps[key]
            print(f"AP {key}: {e:.2f} {m:.2f} {h:.2f}")
        result["aps"] = aps
    return result


if __name__ == "__main__":
    main()
