#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels (`heterofusionrcnn_torch/ops/csrc`, seven
   sources, one nvcc per source, all at once; xconv.cu holds the fused
   XConv and its split epilogue), prints ptxas's registers, stack, spills
   and static shared memory of the conv, transposed conv and XConv kernels
   and counts their tensor-core instructions in the SASS (HGMMA, of it
   bf16, and HMMA): the conv, transposed conv and XConv libraries run
   `wgmma` in both forms (TF32 and bf16); the check fails without bf16
   HGMMA in any of the three.
3. Drives the main path: full-width `rpn_multiclass` -> `rcnn_multiclass`
   two-stage inference (16384 points, 360x1200 images) at batch 4 with
   random weights and BatchNorm statistics from seed 0, kernel switches
   off (the JAX package's default path). Every launch count is set to 0
   just before one forward and read just after; each of its six kernels
   (KNN, the KNN's sorted-arm prep, FPS, NMS, fused XConv, the XConv's
   split epilogue) must have launched. The forward is then
   timed over 5 batches with CUDA events and profiled once (device time by
   kernel name, device busy share).
4. Drives the same detector (same weights, same inputs) with both switches
   on, counted the same way: per forward 13 fused 3x3 convs and 3 fused
   transposed convs (one VGG pass, the map is shared) and 1 crop gather,
   besides the four kernels of step 3. Times it against the switches-off
   forward in turns (off, on, on, off), and prints the RCNN's whole point
   crop (`pc_crop_and_sample`, recorded and rerun alone): its ms and its
   device time by op.
5. Calls each kernel's wrapper again on the exact inputs those forwards
   gave it (recorded in separate, uncounted forwards, one record per launch
   of the counted ones) and holds the result against the kernel's plain
   PyTorch version: indices bit-exact for KNN, FPS and NMS, the crop gather
   bit-exact, |kernel - plain| <= 1e-4 + 1e-4 |plain| for the fused XConv
   and the two convs. The crop also runs the all-distinct call of the same
   shapes (`idx` uniform over the source, its own bound, bit-exact), and
   its row gives the kernel alone (torch.profiler device time), the op's
   host time per call and the other kernels the op launches (casts; must
   be none). Every KNN call runs under both arms (brute and
   sorted), each bit-exact in indices and distances, and its sorted-arm
   prep (keys, sort, float4 candidates, tile boxes: one kernel) bit-exact
   against `knn_prep_plain`; each call's line gives its arm, ms, both arms'
   ms, the share of (query, candidate) pairs the sorted arm evaluates, the
   prep's ms and, beside it, a stable torch.sort of the same keys alone (a
   yardstick for the sort inside the prep kernel). Times the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call (`library_ms`, a yardstick the port never calls: cdist + topk,
   cuDNN conv2d / conv_transpose2d with TF32 off, index_select); computes
   each kernel's bound from its inputs (for the two convs and the XConv,
   which run on the tensor cores in 3xTF32, 3 x operations at the TF32
   rate; for KNN over all P x N pairs, with the bound over the pairs its
   arm evaluates on this data beside it, `visited_bound_ms`), prints each
   conv call's time and achieved TFLOP/s beside cuDNN's (and the kernel's
   alone on the weight operand the wrapper arranges per call), each XConv
   call's time, TFLOP/s, tile and split beside one FP32 `torch.matmul` of
   its composed product on the materialised (B*P, K*Cin) operand (a
   yardstick the port never calls), and computes FPS's latency
   floor (npoint times the per-iteration latency of the FPS kernel on 1024
   points, one CTA) for the report file. Prints each FPS and NMS call's
   ms, its cluster size and threads a CTA and its us per iteration or keep
   step, then sweeps each call over clusters of 1, 2, 4, 8 and 16 CTAs
   (each bit-exact against the plain version, each timed; into
   chip_smoke.json under the kernel's "sweep").
6. Checks the outputs: finite, expected shapes, sane counts, and the same
   detector at small width on the card agreeing with its CPU run.
7. The KITTI entry point: saves seed-0 random weights (random BatchNorm
   statistics) as port checkpoints in a temporary directory under --out,
   runs
   `python -m heterofusionrcnn_torch.experiments.run_inference` in process
   with `--conv_kernels --crop_kernel --kitti_eval` on tests/fixtures/kitti,
   split val, full width, and checks one prediction file of finite rows per
   frame, 26 convs, 6 transposed convs and 1 crop launched on every frame
   (the RCNN runs its own VGG pass, the CLI's default), each of those
   calls and every fused XConv, split-epilogue, KNN, FPS and NMS call held
   against its plain version as in step 5, and the evaluator's AP lines.

8. Training (`training_phase`): full-width `rpn_multiclass` at batch 2 on
   the fixture train frames (real labels, `flipping` + `pca_jitter`),
   through `python -m heterofusionrcnn_torch.experiments.run_training` in
   process from a JSON config with checkpoint_interval 3, into
   --out/chip_smoke_train: 6 steps, then a second run that resumes at 6 and
   reaches 8. Each step runs between zeroing and reading every launch
   count and is timed between two device synchronisations; it must launch
   KNN, its sorted-arm prep and FPS, and no fused XConv and no NMS (the
   training XConv runs unfused). Prints each step's ms and four losses
   (all finite) and the peak device memory. Every KNN and FPS call of one
   recorded step is held bit-exact against its plain version, timed and
   bounded as in step 5 (rows knn_train, knn_prep_train, fps_train of the
   kernels line, launches per train step). The trained weights then run
   two val-mode forwards around one more train step: each forward's NMS
   calls bit-exact and fused XConv calls within the gate, every XConv's
   kept weight fold equal to a fresh fold, the step refolding each XConv
   once. One more step is profiled (device time by kernel name). Then one
   train step at `rpn_unittest` width on the card against the same step on
   the CPU (dropout and path drop off: losses within 1e-4, parameters
   within 1e-3 / 1e-5 as the tests hold them), and 8 full-width steps on
   one repeated batch, which must lower the total loss (the curve is
   printed).
9. Two-stage training (`two_stage_phase`): `python -m
   heterofusionrcnn_torch.experiments.run_evaluation` in process with
   `--save_rpn_feature --for_rcnn_train` on the fixture train split, from
   step 8's full-width RPN checkpoint, counted, the first frame's kernel
   calls recorded: every labelled frame's proposals, IoU table and feature
   file (rpn_fts_channels + 5 = 293 wide), all finite, the frame's NMS
   calls bit-exact and fused XConv and split-epilogue calls within the
   gate. Then `run_training` in process with `rcnn_multiclass` at full
   width (batch 1, 64 RoIs of 512 points, `--warm_start_from` the RPN
   checkpoint, the three handoff directories) into --out/chip_smoke_rcnn:
   6 steps, then a resume to 8, each step counted and timed as in step 8;
   each must launch KNN and FPS and no fused XConv and no NMS, at least
   one must hold a positive RoI (rcnn_reg_loss > 0), and no cropped
   stage-1 feature may carry autograd history. Every KNN and FPS
   call of one recorded step bit-exact, timed and bounded (rows
   knn_rcnn_train, fps_rcnn_train), one step profiled (device time by
   kernel name, busy share of the median step), one `rcnn_unittest` step
   on the card against the CPU (batch 2 of 16 RoIs from a synthetic
   handoff, tests/rcnn_fixtures.py, with a positive RoI; losses within
   1e-4, gradients as `grads_agree` holds them, parameters within 1e-3 /
   1e-5 widened by 2 x lr where the gradients agree only within the
   absolute part), and 8
   full-width steps on one repeated batch with a positive RoI (the profiled
   step's batch), which must lower the total loss.
10. The RCNN's evaluation (`rcnn_eval_phase`): `run_evaluation
   --save_rpn_feature` in process on the fixture val split from step 8's
   RPN checkpoint (val mode on a labelled split keeps the train NMS sizes,
   512 proposals a frame, as the JAX model does), then
   `run_evaluation --pipeline_config rcnn_multiclass --num_rois 100` in
   process over that handoff (the first 100 proposals of each frame) from
   step 9's RCNN checkpoint, at `--eval_batch_size` 1 and then 2, into
   --out/chip_smoke_rcnn_eval. Each
   forward runs between zeroing and reading every launch count: KNN 4 (the
   brute arm), FPS 3, XConv 4 (plus split epilogues), NMS 1, nothing else.
   Prints ms per frame (host clock around each forward and its copy to the
   host, the JAX evaluator's timing) and one profiled frame's device time
   and busy share (over the batch-1 median). The first frame's KNN, FPS,
   XConv, split-epilogue and NMS calls are held against their plain
   versions (indices bit-exact, XConv within its gate), timed and bounded
   (rows *_rcnn_eval of the kernels line, launches per forward). Both
   runs' files are checked (finite final rows and a KITTI file a frame,
   both ap_summary.json, the two ledgers, logs/rcnn_eval.csv) and batch
   2's held against batch 1's as tests/test_evaluator_batched.py holds
   them (final rows within 2e-5 as sets of rows, KITTI rows within 1e-2,
   ledgers within 1e-4). Then the CLI's `--evaluate_repeatedly` over the
   last two RCNN checkpoints, stopping at the second: each evaluated once
   with `num_rois` 100, nothing on a second call.
11. Export (`export_phase`): the batch-4 detector with both switches on
   through `runtime.export.export_fused_inference` into
   --out/chip_smoke_export (its graph calls the `torch.ops.hfr` ops), then
   `load_exported` in a fresh process that imports only torch and the
   port, on inputs of seed 1: its outputs against the eager forward's on
   the same inputs (proposals, scores and boxes within 1e-4 + 1e-4
   |eager|; classes, valid flags and counts exact) and different from the
   outputs for the trace inputs; its launches per CUDA function (the
   profiler, one forward) equal to step 4's counted switches-on forward's,
   the KNN's sorted and brute arms apart. Prints the export time, the
   artifact's size and the loaded forward's ms per batch beside the eager.
12. The bf16 serving path (`bf16_phase`): the same detector, weights and
   inputs as step 3 built with `build_two_stage(compute_dtype="bfloat16")`
   (float32 weights, the layers in bf16, the heads float32), switches off
   and on. Each forward is counted: KNN, its prep, FPS and NMS as step 3's,
   the bf16 XConv (`xconv_bf16`, and `xconv_epilogue_bf16` for split
   layers) with the switches off, plus 13 `conv_bf16`, 3 `convt_bf16` and
   1 `crop_bf16` with them on, and no float32 XConv, conv, transposed conv
   or crop. Each bf16 forward is timed with CUDA events in turns against
   the float32 forward with the same switches (float32, bf16, bf16,
   float32) and profiled once (device time by kernel name, busy share),
   and its whole point crop printed as in step 4.
   Every call of the switches-on bf16 forward is held against its plain
   version: KNN, FPS and NMS bit-exact, the crop bit-exact, the XConv,
   split epilogue, conv and transposed conv within BF16_RTOL |plain| +
   BF16_ATOL_SHARE max |plain| (the worst error in bf16 ulps and the share
   of elements not bit-equal printed); each is timed beside its plain
   version and a library yardstick (bf16 torch.matmul of the XConv's
   composed product, cuDNN bf16 conv2d / conv_transpose2d on the call's
   own channels-last input, and on an NCHW copy beside it, bf16
   index_select) and bounded at the bf16 tensor-core rate (989 TFLOP/s) or
   3.35 TB/s (rows *_bf16 of the kernels line); the conv rows also time
   the kernel alone on its prepared operands (`kernel_ms`: the weight
   arranged once, as the op caches it) beside the op with its wrapper, and
   print each call's share of its bound; each XConv call's line gives its
   share of its bound and its cluster size (the CTAs that share the call's
   A chunks, `plan_xconv`). The switches-on bf16 forward's
   profile counts the copy kernels (`aten::copy_`) of the image branch,
   inside the conv ops and around them: inside, only the first layer's
   channel padding (3 -> 8) may copy. The outputs are checked as
   in step 6; the bf16 RPN's segmentation logits must lie within
   SEG_LOGIT_BOUND of the float32 RPN's, and the share of the float32
   forward's final boxes matched by a bf16 box at BEV IoU >= 0.7 is
   printed beside the share matched by the float32 detector with every
   weight moved by 2^-8 N(0, 1) (random weights make the final selection
   chaotic: the yardstick says how much of the miss bf16 alone explains);
   the `*_unittest` detector in bf16 on the card must agree with
   its CPU run before any top-k (switches off and on). Then one
   `run_evaluation` of the RCNN in process over step 10's handoff from a
   pipeline config with `compute_dtype` "bfloat16" (step 9's float32
   checkpoint), batch 1, `--num_rois 100`: per forward KNN 4, FPS 3, bf16
   XConv 4, NMS 1 (plus split epilogues), nothing else; its files checked
   as in step 10 and its ms per frame printed.
13. Data parallelism (`dp_phase`, `heterofusionrcnn_torch/parallel`), each
   run of ranks in processes started by `spawn` (tests/torch_dp_worker.py
   `run_steps`), joined within DP_DEADLINE_S. (a) Two full-width
   `rpn_multiclass` train steps at batch 2 (the fixture train frames,
   dropout and path drop on, the EMA on) through a real one-rank NCCL group
   in a child process, against the same two steps with no group in this
   process, from the same weights and generators. (b) The same two steps
   on two gloo ranks sharing the card, one frame a rank, against this
   process's steps at batch 2 in the ranks' summation order
   (`frames_as_ranks`: every convolution frame by frame, so that cuDNN
   picks the ranks' batch-1 algorithms, and BatchNorm's moments from
   per-frame sums added as the all-reduce adds them); then two
   `rcnn_unittest` steps (the synthetic handoff of tests/rcnn_fixtures.py,
   a positive RoI) against plain steps. Each step of the ranks starts from
   the one-process state before it, and is held as `params_agree` holds a
   step: metrics within
   LOSS_TOL, the step's gradients (from Adam's first moment) and its
   parameters, statistics and EMA within PARAM_TOL, widened by 2 x lr where
   the two gradients agree only within the absolute part; the RCNN's
   gradients as `grads_agree` holds them, and the full-width RPN's
   image-branch gradients at two ranks within DP_IMAGE_GRAD_SHARE of the
   tensor's largest |element|. Printed beside it: the same one-process
   steps from the same states at batch 2, and with only the convolutions
   frame by frame, against the steps in the ranks' order (the largest
   |difference| of a gradient over its largest |element|, per step, in the
   image branch and elsewhere, `grad_shares`), and each rank's differences
   from the steps in its order and at batch 2. Every rank counts its
   launches a step (KNN, its sorted-arm prep and FPS at full width; KNN
   and FPS in the small RCNN, whose sets take the brute arm) and holds one
   KNN and one FPS call of its second step bit-exact against the plain
   version. Prints each rank's step ms,
   the all-reduces of a step (count and bytes) and the gradient all-reduce
   alone (its bytes, ms and share of the second step) beside the card's
   name and power limit; ranks that share one card say nothing of
   multi-card speed. (c) `run_training --num_devices 2` on the one card
   raises before any rank starts.
14. bf16 training (`bf16_train_phase`, cell I). (a) Step 8's cell C from a
   saved `rpn_multiclass` config with `compute_dtype` "bfloat16" and the
   EMA on (`rpn_multiclass_bf16`), through `run_training` in process into
   --out/chip_smoke_bf16_train: 6 steps and a resume to 8, each counted
   and timed as in step 8 (KNN, its prep and FPS launched; no XConv of
   either dtype, no NMS), losses finite, peak memory; every parameter,
   buffer, Adam moment, EMA entry and checkpoint tensor float32; one
   recorded step's KNN and FPS calls bit-exact, timed and bounded (rows
   knn_bf16_train, knn_prep_bf16_train, fps_bf16_train); one profiled step
   (busy share of the median step); the same config's step in float32 and
   in bf16 in turns (float32, bf16, bf16, float32; BF16_TURN_STEPS each);
   8 steps on one repeated batch lower the loss. (b) `val_check` on the
   trained bf16 RPN: two val forwards around one more step, the bf16 XConv
   and split-epilogue calls within the bf16 gate, NMS bit-exact, no
   float32 XConv launch, each XConv refolding its bf16 Wc operand once a
   step. (c) The handoff from (a)'s checkpoint (`handoff_phase`, the bf16
   XConv calls held), then `rcnn_multiclass` in bf16 (batch 1, 64 RoIs,
   warm-started), BF16_RCNN_STEPS steps counted and timed, a positive
   RoI, state float32, rows knn_bf16_rcnn_train and fps_bf16_rcnn_train.
   (d) One bf16 step at `rpn_unittest` and at `rcnn_unittest` width on
   the card against the CPU (`step_agrees(bf16=True)`): losses within
   2^-7, gradients, parameters and statistics at bf16 resolution
   (`bf16_params_agree`, tests/test_torch_parallel.py's bf16 bounds), the
   measured spread printed. (e) Two bf16 `rcnn_unittest` steps on two
   gloo ranks sharing the card against this process's (step 13's `dp_run`,
   held by `bf16_dp_steps_agree`).
15. The rest of stage 1 (`stage1_variants_phase`, cell J). (a) The
   PointNet++ RPN (`rpn_multiclass` with `pc_extractor_type` "pointnet",
   `rpn_pointnet_layers()`: SA 16384 -> 4096 -> 1024 -> 256 -> 64, four FP
   levels) in test mode at batch 4 on the synthetic seed-0 inputs, random
   weights and seeded BatchNorm statistics: counted (4 FPS and 1 NMS
   launches, no KNN, prep or XConv), each FPS and NMS call bit-exact
   (rows fps_pointnet, nms_pointnet), its ms (CUDA events, mean of 5),
   device ms, busy share, peak memory, and the ball query's, `three_nn`'s
   and `three_interpolate`'s ms and device ms by name (plain PyTorch on the
   card, their recorded calls rerun alone). (b) `rpn_multiclass` with
   `rpn_fixed_num_proposal_nms` False in test and val mode (synthetic
   labels with more than 2048 foreground points a frame): one NMS launch a
   forward over 2048 boxes a frame, bit-exact, keep indices unique, keeps
   valid-first and score-sorted within post (row nms_nonfixed); the test
   forward timed in turns against the fixed path on the same weights,
   beside cell A's ms. (c) The PointNet++ RPN through `run_training` from a
   saved config (batch 2, STAGE1_TRAIN_STEPS steps, each counted: FPS, no
   KNN, XConv or NMS; losses finite; one step's FPS calls bit-exact, row
   fps_pointnet_train), then `run_evaluation --save_rpn_feature` on 2
   fixture frames into --out/chip_smoke_stage1, the handoff's feature
   width `rpn_fts_channels`. (d) At `rpn_unittest` width on the card
   against the CPU: an ids-sampling PointCNN (the same uniforms on both)
   and a cxyz-sorted one in eval mode, features within
   STAGE1_SMALL_RTOL / ATOL, the points equal; every KNN call bit-exact
   (row knn_ids), every fused XConv and split epilogue of the sorted model
   within the XConv gate (rows xconv_sorted, xconv_epilogue_sorted), each
   of its neighbourhoods its KNN rows reordered. (e) The native
   point-cloud loader against the numpy path on every fixture frame on
   the card's host: byte-equal points, ms a frame each. Each part's
   seconds are printed.

16. The workflow tools (`workflow_phase`, cell K). (a)
   `tools/torch_run_full_pipeline.py` through its `main(argv)` at full
   width (`rpn_multiclass` -> `rcnn_multiclass` on the fixtures, 2 + 2
   iterations, `--num_rois 100`) into --out/chip_smoke_pipeline: each of
   its CLI calls between zeroing and reading every launch count, summed
   per stage (RPN training: KNN, prep, FPS, no XConv or NMS; the handoff:
   KNN, prep, FPS, XConv, NMS; RCNN training: KNN, FPS only; the RCNN's
   evaluation: KNN, FPS, XConv, NMS, no prep; no stage a switched or bf16
   kernel), the split epilogue launched, each stage's seconds printed; the
   first call of each kernel's op recorded and held against its plain
   version (rows knn_pipeline, knn_prep_pipeline, fps_pipeline,
   xconv_pipeline, xconv_epilogue_pipeline, nms_pipeline, each with the
   pipeline's launches); every handoff proposal and final prediction file
   through `utils.format_checker`, the feature files' width, both AP
   summaries, both final checkpoints loaded into the port's models. (b)
   `tools/torch_run_eval_sweep.py` over (a)'s RCNN checkpoints in a fresh
   root: every step once, nothing on a second run. (c)
   `tools/torch_gen_label_segs.py` (4 spawned workers) and
   `tools/torch_gen_label_clusters.py` on the fixture train split, ms a
   frame. Each part's seconds are printed.
17. Batch-sharded serving (`serve_phase`, cell L): step 3's detector (seed-0
   weights and BatchNorm statistics) and batch of 4 through
   `inference.sharded_forward`, (a) on a real one-rank NCCL group with the
   kernel switches off, (b) on two gloo ranks sharing the card, two frames
   each, with the switches on (the crop, conv and transposed conv kernels
   on the path), each rank in a process started by `spawn` and joined
   within SERVE_DEADLINE_S, starting from weights of its own and taking
   rank 0's by `replicate_module`. Every rank's gathered dict is held
   against this process's forward of the same detector on the same batch:
   classes, valid flags, counts and the zero pattern of the final scores
   exactly, boxes within SERVE_BOX_TOL, scores within SERVE_SCORE_TOL (the
   largest differences printed, "bit-equal" where 0). Each rank counts its
   launches by kernel in one sharded forward, which must equal this
   process's launches at the rank's batch, and its collectives (the
   gather's three `all_gather_into_tensor` calls and nothing else). Prints
   each rank's forward ms (CUDA events, mean of ITERS after a warm call),
   the gather's ms and bytes and the rank's peak memory, beside the card's
   name and power limit; ranks that share one card say nothing of
   multi-card speed. Then the host tools that need no matplotlib:
   `tools/torch_dataset_stats.py mean` on the fixtures and
   `tools/torch_show_predictions_3d.py`'s HTML of step 16's RCNN
   predictions on the val frames, their seconds printed.

Prints a {"kernels": [...]} JSON line, then the result as its last line,
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
CUDA is unavailable, the package is missing or any check fails. Details go
to --out (default outputs/) as chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM FP32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 on the tensor cores
# The conv kernels run each FP32-grade multiply-add as three TF32 products
# (3xTF32): their bound counts 3 x operations at the TF32 rate.
TF32_PRODUCTS = 3
XCONV_RTOL = XCONV_ATOL = 1e-4
CONV_RTOL = CONV_ATOL = 1e-4
BATCH = 4                      # frames per forward on the main path
SEED = 0                       # weights, BatchNorm statistics and inputs
ITERS = 5                      # forwards timed
REPS = 10                      # kernel calls timed per main-path call
# One rotated IoU in nms.cu: two clipping passes of 4 edges x 4 half-planes
# at ~30 FP32 and compare operations each, ~10 more per half-plane for the
# collinear test of the second pass, ~10 for the IoU itself.
NMS_OPS_PER_IOU = 2 * 16 * 30 + 16 * 10 + 10

TPU_KERNELS = {
    "knn": "heterofusionrcnn_tpu/ops/pallas_knn.py:356 (_knn_pallas_sorted), :472 (knn_pallas brute arm)",
    "knn_prep": "heterofusionrcnn_tpu/ops/pallas_knn.py:356 (_knn_pallas_sorted's Morton keys, sort, "
                "tiles and tile boxes, :362-383)",
    "fps": "heterofusionrcnn_tpu/ops/pallas_fps.py:116 (farthest_point_sample_pallas)",
    "nms": "heterofusionrcnn_tpu/ops/pallas_nms.py:138 (oriented_nms_pallas)",
    "xconv": "heterofusionrcnn_tpu/ops/pallas_xconv.py:263 (fused_xconv)",
    "xconv_epilogue": "heterofusionrcnn_tpu/ops/pallas_xconv.py:263 (fused_xconv; its ELU + BN "
                      "epilogue, for split contractions)",
    "crop": "heterofusionrcnn_tpu/ops/pallas_crop.py:122 (crop_gather)",
    "conv": "heterofusionrcnn_tpu/ops/pallas_conv.py:157 (conv3x3_affine_relu)",
    "convt": "heterofusionrcnn_tpu/ops/pallas_convtranspose.py:86 (convtranspose3x3_affine_relu)",
}
# The op each kernel's wrapper is reached through on the main path; each
# call of it launches the kernel once.
KERNEL_OPS = {"knn": "knn_point", "fps": "farthest_point_sample",
              "nms": "oriented_nms", "xconv": "fused_xconv",
              "xconv_epilogue": "xconv_split_epilogue", "crop": "crop_gather",
              "conv": "conv3x3_affine_relu", "convt": "convtranspose3x3_affine_relu"}
SLICE1 = ("knn", "knn_prep", "fps", "nms", "xconv", "xconv_epilogue")
# Launches of the switch-controlled kernels per batch-4 forward with the
# switches on (one shared VGG pass) and per KITTI frame (two VGG passes).
SWITCHED_PER_FORWARD = {"conv": 13, "convt": 3, "crop": 1}
SWITCHED_PER_FRAME = {"conv": 26, "convt": 6, "crop": 1}
KITTI_DIR = os.path.join(ROOT, "tests", "fixtures", "kitti")
CLUSTERS = (1, 2, 4, 8, 16)    # cluster sizes the FPS and NMS kernels take


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_ms_and_result(fn, warm: bool):
    """(ms, result) of a plain version: `cuda_ms(fn, 1)` and a run of its
    own, or, unless `warm`, one cold run timed and kept (a plain version
    of seconds a call runs once)."""
    import torch

    if warm:
        return cuda_ms(fn, 1), fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


class Recorder:
    """Wraps an op function and keeps the arguments of every call (of the
    first `limit` calls, where given)."""

    def __init__(self, fn, limit=None):
        self.fn = fn
        self.limit = limit
        self.calls = []

    def __call__(self, *args, **kwargs):
        if self.limit is None or len(self.calls) < self.limit:
            self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)


def randomize_batchnorm(module, seed):
    """Seeded BatchNorm scales, shifts and running statistics, so every
    folded BN shift in the kernels is non-zero and every scale differs
    from 1 (a fresh init folds to shift 0, scale ~1)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5, 2.0)):
                t.copy_(lo + (hi - lo) * torch.rand(c, generator=gen))
            for t in (m.bias, m.running_mean):
                t.copy_(0.1 * torch.randn(c, generator=gen))
    return module


@contextlib.contextmanager
def recording(ops=tuple(KERNEL_OPS.values()), limit=None):
    """Wraps the kernel ops named in `ops` where the models call them;
    yields {op: [(args, kwargs), ...]}, one record per call (the first
    `limit` calls of each op, where given)."""
    from heterofusionrcnn_torch.models.extractors import layers, pointcnn, pointnet
    from heterofusionrcnn_torch.ops import cropping, nms, sampling, xconv

    # The modules whose calls of each op are recorded (the same op reached
    # from two modules goes into one list): ids sampling's KNN is
    # `sampling`'s, the PointNet++ extractor's FPS and KNN `pointnet`'s.
    where = {"knn_point": (pointcnn, pointnet, sampling),
             "farthest_point_sample": (pointcnn, pointnet),
             "fused_xconv": (pointcnn,), "xconv_split_epilogue": (xconv,),
             "oriented_nms": (nms,), "crop_gather": (cropping,),
             "conv3x3_affine_relu": (layers,), "convtranspose3x3_affine_relu": (layers,),
             "query_ball_point": (pointnet,), "three_nn": (pointnet,),
             "three_interpolate": (pointnet,)}
    recs = {op: Recorder(getattr(where[op][0], op), limit) for op in ops}
    for op, rec in recs.items():
        for mod in where[op]:
            setattr(mod, op, rec)
    try:
        yield {op: rec.calls for op, rec in recs.items()}
    finally:
        for op, rec in recs.items():
            for mod in where[op]:
                setattr(mod, op, rec.fn)


def expected_launches(calls, names):
    """Launches the recorded calls make: one per call of each kernel's op,
    and one prep launch per KNN call on the sorted arm."""
    from heterofusionrcnn_torch.ops.grouping import knn_arm

    out = {name: len(calls[KERNEL_OPS[name]]) for name in names if name != "knn_prep"}
    out["knn_prep"] = sum(knn_arm(xyz.shape[1], qrs.shape[1]) == "sorted"
                              for (_, xyz, qrs), _ in calls["knn_point"])
    return out


def record_kernel_inputs(det, inputs):
    """One uncounted forward with the kernel ops wrapped, so the checks run
    on the inputs the main path gives each kernel."""
    with recording() as calls:
        det(*inputs)
    return calls


def check_switched(name, args, kwargs):
    """One switched kernel's call against its plain version: the convs
    within CONV_ATOL + CONV_RTOL |plain|, the crop bit for bit. Returns
    the max |kernel - plain|."""
    import torch

    from heterofusionrcnn_torch.ops import conv, cropping

    kernel, plain = {
        "conv": (conv.conv3x3_affine_relu, conv.conv3x3_affine_relu_plain),
        "convt": (conv.convtranspose3x3_affine_relu, conv.convtranspose3x3_affine_relu_plain),
        "crop": (cropping.crop_gather, cropping.crop_gather_plain),
    }[name]
    got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
    shape = tuple(args[0].shape)
    if name == "crop":
        if not torch.equal(got, want):
            raise AssertionError(f"crop gather differs at {shape} {tuple(args[1].shape)}")
        return 0.0
    err = (got - want).abs()
    if not bool((err <= CONV_ATOL + CONV_RTOL * want.abs()).all()):
        raise AssertionError(f"{name} differs by {float(err.max())} at {shape}")
    return float(err.max())


def knn_bits(result):
    """A KNN result's distances and indices as one int32 tensor, to compare
    bit for bit."""
    import torch

    return torch.cat([t.view(torch.int32) for t in result])


def check_index_exact(name, args, kwargs):
    """One KNN, FPS or NMS call against its plain version, bit for bit (KNN:
    indices and distances)."""
    import torch

    from heterofusionrcnn_torch.ops import grouping, nms, sampling

    if name == "knn":
        k, xyz, qrs = args
        got = knn_bits(grouping.knn_point(k, xyz, qrs))
        want = knn_bits(grouping.knn_point_plain(k, xyz, qrs))
    elif name == "fps":
        xyz, npoint = args
        got = sampling.farthest_point_sample(xyz, npoint)
        want = sampling.farthest_point_sample_plain(xyz, npoint)
    else:
        bev, scores, thresh, keep = args[:4]
        valid = args[4] if len(args) > 4 else kwargs.get("valid_mask")
        got = nms.oriented_nms(bev, scores, thresh, keep, valid)[0]
        want = nms.oriented_nms_plain(bev, scores, thresh, keep, valid)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version at {tuple(args[0].shape)}")


def check_xconv(pts, fts, qrs, idx, w):
    """One fused XConv call against its plain version within XCONV_ATOL +
    XCONV_RTOL |plain|; returns the max |kernel - plain|."""
    from heterofusionrcnn_torch.ops import xconv

    got = xconv.fused_xconv(pts, fts, qrs, idx, w)
    want = xconv.fused_xconv_plain(pts, fts, qrs, idx, w)
    err = (got - want).abs()
    if not bool((err <= XCONV_ATOL + XCONV_RTOL * want.abs()).all()):
        raise AssertionError(f"xconv differs by {float(err.max())} at {tuple(idx.shape)} "
                             f"Cin {w.wc.shape[1]} D {w.wc.shape[2]}")
    return float(err.max())


def check_epilogue(partial, sc, bc, out_dtype=None):
    """The float32 split epilogue against its plain version, within the
    XConv's gate (`out_dtype`: the op's argument, float32 here)."""
    import torch

    from heterofusionrcnn_torch.ops import xconv

    if out_dtype not in (None, torch.float32):
        raise AssertionError(f"a {out_dtype} split epilogue on the float32 path")
    got = xconv.xconv_split_epilogue(partial, sc, bc)
    want = xconv.xconv_split_epilogue_plain(partial, sc, bc)
    err = (got - want).abs()
    if not bool((err <= XCONV_ATOL + XCONV_RTOL * want.abs()).all()):
        raise AssertionError(f"xconv epilogue differs by {float(err.max())} at "
                             f"{tuple(partial.shape)}")
    return float(err.max())


def xconv_call_err(args, bf16=False):
    """A recorded fused XConv call against its plain version: `check_xconv`
    or, for a bf16 call, within the bf16 gate (`bf16_compare`); the max
    |kernel - plain|."""
    if not bf16:
        return check_xconv(*args)
    import torch

    from heterofusionrcnn_torch.ops import xconv

    if args[5] != torch.bfloat16:
        raise AssertionError(f"a {args[5]} XConv call on the bf16 path")
    return bf16_compare(xconv.fused_xconv(*args), xconv.fused_xconv_plain(*args),
                        "xconv_bf16")[0]


def epilogue_call_err(args, bf16=False):
    """A recorded split-epilogue call against its plain version, as
    `xconv_call_err` holds the XConv."""
    if not bf16:
        return check_epilogue(*args)
    from heterofusionrcnn_torch.ops import xconv

    return bf16_compare(xconv.xconv_split_epilogue(*args),
                        xconv.xconv_split_epilogue_plain(*args), "xconv_epilogue_bf16")[0]


def nms_iou_count(boxes, scores, thresh, keep, valid):
    """IoUs the greedy loop needs on this data: at each keep step, one per
    box still alive (valid, not kept, not suppressed by an earlier keep).
    A frame's kept boxes against all in one IoU table, walked on the host."""
    import torch

    from heterofusionrcnn_torch.core.rotated_iou import bev_iou

    total = 0
    for f in range(boxes.shape[0]):
        ks = keep[f].tolist()
        kept = ks[:ks.index(-1)] if -1 in ks else ks
        over = (bev_iou(boxes[f, kept], boxes[f]) > thresh).cpu()
        alive = torch.ones(boxes.shape[1], dtype=torch.bool)
        if valid is not None:
            alive &= valid[f].bool().cpu()
        for j, i in enumerate(kept):
            total += int(alive.sum()) - 1
            alive &= ~over[j]
            alive[i] = False
    return total


def sweep(shape, want, rounds, fit, launch, reps):
    """One FPS or NMS call on clusters of every size the kernel takes, each
    with its default threads: bit-exact against the plain version's `want`
    and timed (`rounds` iterations or keep steps a launch). A size of which
    not one cluster fits the card is recorded and not launched."""
    import torch

    out = []
    for c in CLUSTERS:
        rec = dict(shape=shape, cluster=c, fit=fit(c))
        if rec["fit"]:
            if not torch.equal(launch(c), want):
                raise AssertionError(f"{shape} differs from the plain version on clusters of {c}")
            rec["ms"] = cuda_ms(lambda: launch(c), reps)
            rec["us_per_round"] = rec["ms"] * 1e3 / max(rounds, 1)
        out.append(rec)
    print(f"  clusters of {'/'.join(str(c) for c in CLUSTERS)}: "
          + " / ".join(f"{rec['ms']:.4f}" if rec["fit"] else "does not fit" for rec in out)
          + " ms, each exact", flush=True)
    return out


def new_row(rows, name, source, kernel=None):
    """A kernels-line row `name` for the TPU kernel `kernel` (default: the
    row's name)."""
    rows[name] = dict(name=name, route="cuda", source=source,
                      replaces=TPU_KERNELS[kernel or name], launches=0, max_abs_err=0.0,
                      ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="operations",
                      library_ms=None, calls=[])
    return rows[name]


def add_bound(r, nbytes, flops, flops_per_s=FP32_FLOPS_PER_S):
    """Adds one call's bound: the larger of its bytes over the memory rate
    and its operations over the unit's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    r["_bytes_ms"] = r.get("_bytes_ms", 0.0) + t_bytes
    r["_ops_ms"] = r.get("_ops_ms", 0.0) + t_ops
    r["bound_ms"] += max(t_bytes, t_ops)


def finish_rows(rows):
    """Sets each row's `bound_by` from its summed byte and operation bounds."""
    for r in rows.values():
        r["bound_by"] = ("bytes" if r.pop("_bytes_ms", 0.0) > r.pop("_ops_ms", 0.0)
                         else "operations")
    return rows


def knn_rows(rows, calls, reps, suffix=""):
    """Rows knn<suffix> and knn_prep<suffix> over the recorded KNN calls."""
    import torch

    from heterofusionrcnn_torch.ops import grouping

    # KNN: 8 FP32 operations per (query, candidate) pair, all P x N pairs (the
    # brute scan's work; the pairs the sorted arm evaluates are counted
    # beside it, `visited_pairs`), and the bytes of points, queries and
    # results (`bytes_bound_ms`). `visited_bound_ms`: the same bound on the
    # pairs the main path's arm evaluates on this data (the sorted arm's
    # visited pairs, every pair on the brute arm), the row's real floor.
    # `ms` is the wrapper on the arm `knn_arm` picks (the main path's, the
    # sorted arm's prep included); both arms are held bit for bit and timed
    # on every call.
    r = new_row(rows, "knn" + suffix, "heterofusionrcnn_torch/ops/csrc/knn.cu", "knn")
    r.update(library_ms=0.0, bytes_bound_ms=0.0, visited_bound_ms=0.0, pairs=0, visited_pairs=0,
             sorted_pairs=0)
    # The sorted arm's prep kernel (keys, sort, float4 candidates, tile
    # boxes): bytes only, the points read once, the keys, float4 candidates,
    # tile boxes and the query order written once. Its ms is part of the
    # KNN's. `torch_sort_ms`: a stable torch.sort of the same keys alone.
    rp = new_row(rows, "knn_prep" + suffix, "heterofusionrcnn_torch/ops/csrc/knn.cu", "knn_prep")
    for (k, xyz, qrs), _ in calls["knn_point"]:
        same = qrs is xyz
        b, n, p = xyz.shape[0], xyz.shape[1], qrs.shape[1]
        shape = f"{b}x{p}q x {n}{' same set' if same else ''} k{k}"
        want = knn_bits(grouping.knn_point_plain(k, xyz, qrs))
        for arm in ("brute", "sorted"):
            if not torch.equal(knn_bits(grouping.knn_point(k, xyz, qrs, arm=arm)), want):
                raise AssertionError(f"knn {arm} arm differs from the plain version at {shape}")
        prep = grouping.knn_prep(xyz, qrs)
        plain = grouping.knn_prep_plain(xyz, qrs)
        # The candidates bit for bit (index bits in the fourth word), the rest by value.
        if not (torch.equal(prep.cand.view(torch.int32), plain.cand.view(torch.int32))
                and all(w is None or torch.equal(g, w) for g, w in zip(prep[1:], plain[1:]))):
            raise AssertionError(f"knn prep differs from its plain version at {shape}")
        arm = grouping.knn_arm(n, p)
        ms = cuda_ms(lambda: grouping.knn_point(k, xyz, qrs), reps)
        arm_ms = {a: cuda_ms(lambda: grouping.knn_point(k, xyz, qrs, arm=a), reps)
                  for a in ("brute", "sorted")}
        pms = cuda_ms(lambda: grouping.knn_point_plain(k, xyz, qrs), 1)
        lms = cuda_ms(lambda: torch.topk(torch.cdist(qrs, xyz), k, dim=-1, largest=False), reps)
        visited = torch.zeros(1, dtype=torch.int64, device=xyz.device)
        grouping.knn_sorted(k, xyz, qrs, visited=visited)
        v = int(visited)
        keys = [grouping.knn_sort_keys(xyz, xyz)] + ([] if same else [grouping.knn_sort_keys(qrs, xyz)])
        sort_ms = cuda_ms(lambda: [torch.sort(t, dim=1, stable=True) for t in keys], reps)
        prep_ms = cuda_ms(lambda: grouping.knn_prep(xyz, qrs), reps)
        prep_pms = cuda_ms(lambda: grouping.knn_prep_plain(xyz, qrs), reps)
        nbytes = (b * n * 3 + b * p * 3) * 4 + b * p * k * 8
        add_bound(r, nbytes, 8.0 * b * p * n)
        r["bytes_bound_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        evaluated = v if arm == "sorted" else b * p * n
        r["visited_bound_ms"] += max(nbytes / HBM_BYTES_PER_S,
                                     8.0 * evaluated / FP32_FLOPS_PER_S) * 1e3
        r["ms"] += ms
        r["plain_ms"] += pms
        r["library_ms"] += lms
        r["pairs"] += b * p * n
        if arm == "sorted":
            r["visited_pairs"] += v
            r["sorted_pairs"] += b * p * n
            ntiles = -(-n // grouping.KNN_TILE)
            pbytes = b * n * (12 + 16 + 4) + b * ntiles * 32 + (0 if same else b * p * (12 + 8))
            add_bound(rp, pbytes, 0.0)
            rp["ms"] += prep_ms
            rp["plain_ms"] += prep_pms
        share = v / (b * p * n)
        r["calls"].append(dict(shape=shape, arm=arm, ms=ms, brute_ms=arm_ms["brute"],
                               sorted_ms=arm_ms["sorted"], prep_ms=prep_ms, torch_sort_ms=sort_ms,
                               visited_pairs=v, pairs=b * p * n, visited_share=share,
                               plain_ms=pms, library_ms=lms))
        print(f"knn {shape}: {arm} arm {ms:.4f} ms (brute {arm_ms['brute']:.4f}, sorted "
              f"{arm_ms['sorted']:.4f}); sorted arm evaluates {share:.4f} of the pairs; prep "
              f"{prep_ms:.4f} ms (a stable torch.sort of its keys alone {sort_ms:.4f})",
              flush=True)
    r["visited_share"] = r["visited_pairs"] / max(r["sorted_pairs"], 1)


def fps_row(rows, calls, reps, suffix="", sweeps=True, warm_plain=True):
    """Row fps<suffix> over the recorded FPS calls; `sweeps` reruns each
    call on clusters of every size; `warm_plain` warms the plain version
    up before its timed run."""
    import torch

    from heterofusionrcnn_torch.ops import sampling
    from heterofusionrcnn_torch.ops.dispatch import cluster_threads

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # FPS: 9 FP32 operations (distance + min) per point per iteration. Its
    # real floor is latency, npoint dependent argmaxes over the set: one
    # iteration of the kernel is timed on 1024 points (B=1, npoint=1024, the
    # plan's one CTA) and npoint of them make each call's latency floor.
    # Every call runs again on clusters of every size (`sweep`).
    r = new_row(rows, "fps" + suffix, "heterofusionrcnn_torch/ops/csrc/fps.cu", "fps")
    probe = torch.rand((1, 1024, 3), generator=torch.Generator().manual_seed(SEED)).cuda()
    r["iteration_us"] = cuda_ms(lambda: sampling.farthest_point_sample(probe, 1024), reps) / 1024 * 1e3
    r["latency_ms"] = 0.0
    r["sweep"] = []
    for (xyz, npoint), _ in calls["farthest_point_sample"]:
        got = sampling.farthest_point_sample(xyz, npoint)
        pms, want = plain_ms_and_result(
            lambda: sampling.farthest_point_sample_plain(xyz, npoint), warm_plain)
        if not torch.equal(got, want):
            raise AssertionError(f"fps picks differ at {tuple(xyz.shape)} -> {npoint}")
        ms = cuda_ms(lambda: sampling.farthest_point_sample(xyz, npoint), reps)
        b, n = xyz.shape[:2]
        add_bound(r, b * n * 12 + b * npoint * 4, 9.0 * b * n * npoint)
        r["latency_ms"] += npoint * r["iteration_us"] * 1e-3
        r["ms"] += ms
        r["plain_ms"] += pms
        c, threads = sampling.fps_plan(b, n, sms, lambda c, t: sampling.fps_clusters(n, c, t) > 0)
        shape = f"{b}x{n}->{npoint}"
        per_it = ms * 1e3 / max(npoint - 1, 1)
        r["calls"].append(dict(shape=shape, ms=ms, plain_ms=pms, cluster=c, threads=threads,
                               us_per_iteration=per_it))
        print(f"fps {shape}: {ms:.4f} ms on clusters of {c} x {threads} threads, "
              f"{per_it:.3f} us per iteration", flush=True)
        if sweeps:
            r["sweep"] += sweep(
                shape, want, npoint - 1,
                lambda c: sampling.fps_clusters(n, c, cluster_threads(
                    n, c, sampling.FPS_POINTS_PER_THREAD)),
                lambda c: sampling._fps_kernel(xyz, npoint, c), reps)


def nms_row(rows, calls, reps, suffix="", sweeps=True, warm_plain=True):
    """Row nms<suffix> over the recorded NMS calls; `sweeps` reruns each
    call on clusters of every size; `warm_plain` as `fps_row`'s."""
    import torch

    from heterofusionrcnn_torch.ops import nms
    from heterofusionrcnn_torch.ops.dispatch import cluster_threads

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # NMS: NMS_OPS_PER_IOU per rotated IoU, counted for the IoUs this data
    # needs. Every call runs again on clusters of every size (`sweep`).
    r = new_row(rows, "nms" + suffix, "heterofusionrcnn_torch/ops/csrc/nms.cu", "nms")
    r["sweep"] = []
    for a, kw in calls["oriented_nms"]:
        bev, scores, thresh, keep = a[:4]
        valid = a[4] if len(a) > 4 else kw.get("valid_mask")
        got, _ = nms.oriented_nms(bev, scores, thresh, keep, valid)
        pms, want = plain_ms_and_result(
            lambda: nms.oriented_nms_plain(bev, scores, thresh, keep, valid), warm_plain)
        if not torch.equal(got, want):
            raise AssertionError(f"nms keep lists differ at {tuple(bev.shape)} -> {keep}")
        ms = cuda_ms(lambda: nms.oriented_nms(bev, scores, thresh, keep, valid), reps)
        b, n = bev.shape[:2]
        ious = nms_iou_count(bev, scores, thresh, got, valid)
        add_bound(r, b * n * 25 + b * keep * 4, float(NMS_OPS_PER_IOU * ious))
        r["ms"] += ms
        r["plain_ms"] += pms
        c, threads = nms.nms_plan(b, n, sms, lambda c, t: nms.nms_clusters(n, c, t) > 0)
        shape = f"{b}x{n}->{keep}@{thresh}"
        r["calls"].append(dict(shape=shape, ms=ms, plain_ms=pms, ious=ious, cluster=c,
                               threads=threads, us_per_step=ms * 1e3 / keep))
        print(f"nms {shape}: {ms:.4f} ms on clusters of {c} x {threads} threads, "
              f"{ms * 1e3 / keep:.3f} us per keep step, {ious} IoUs", flush=True)
        if sweeps:
            r["sweep"] += sweep(
                shape, want, keep, lambda c: nms.nms_clusters(n, c, cluster_threads(n, c)),
                lambda c: nms._nms_kernel(bev, scores, thresh, keep, valid, c), reps)


def xconv_row(rows, calls, reps, suffix=""):
    """Row xconv<suffix> over the recorded fused XConv calls."""
    import torch

    from heterofusionrcnn_torch.ops import xconv

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # Fused XConv: FLOPs of lift-1, lift-2, X-net, X @ in and the composed
    # separable conv, each three TF32 tensor-core products (3xTF32; the
    # FP32-FMA bound of the same work is kept beside it as `fp32_bound_ms`);
    # bytes of points, queries, indices, features, weights and the output.
    # `matmul_ms` times the composed product alone as one FP32 torch.matmul
    # (TF32 off) on the materialised (B*P, K*Cin) operand: a yardstick of the
    # product the kernel fuses, never called by the port.
    r = new_row(rows, "xconv" + suffix, "heterofusionrcnn_torch/ops/csrc/xconv.cu", "xconv")
    r["fp32_bound_ms"] = 0.0
    r["matmul_ms"] = 0.0
    torch.backends.cuda.matmul.allow_tf32 = False
    for (pts, fts, qrs, idx, w), _ in calls["fused_xconv"]:
        r["max_abs_err"] = max(r["max_abs_err"], check_xconv(pts, fts, qrs, idx, w))
        ms = cuda_ms(lambda: xconv.fused_xconv(pts, fts, qrs, idx, w), reps)
        pms = cuda_ms(lambda: xconv.fused_xconv_plain(pts, fts, qrs, idx, w), 1)
        b, n = pts.shape[:2]
        _, p, k = idx.shape
        cf, cin, d = w.w1.shape[1], w.wc.shape[1], w.wc.shape[2]
        cp = cin - cf
        a = xconv.xconv_gemm_operand(pts, fts, qrs, idx, w).reshape(b * p, k * cin)
        wc = w.wc.reshape(k * cin, d)
        mms = cuda_ms(lambda: torch.matmul(a, wc), reps)
        del a
        per_q = k * (2 * 3 * cf + 2 * cf * cf + 2 * k * cin + 2 * cin * d)
        if w.with_x:
            per_q += 2 * 3 * k * k * k + 2 * 2 * k * k * k
        wbytes = 4 * sum(t.numel() for f, t in vars(w).items()
                         if t is not None and f != "wc_operand")
        nbytes = 4 * (b * n * (3 + cp) + b * p * (3 + k + d)) + wbytes
        flops = float(b * p * per_q)
        add_bound(r, nbytes, TF32_PRODUCTS * flops, TF32_FLOPS_PER_S)
        r["fp32_bound_ms"] += max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
        r["ms"] += ms
        r["plain_ms"] += pms
        r["matmul_ms"] += mms
        plan = xconv.plan_xconv(b * p, k, cf, cp, d, sms)
        shape = f"{b}x{p} K{k} Cf{cf} Cin{cin} D{d}"
        sep = 2.0 * b * p * k * cin * d
        r["calls"].append(dict(shape=shape, ms=ms, plain_ms=pms, matmul_ms=mms,
                               tflops=flops / ms * 1e-9, blocks=plan.blocks,
                               tile=f"{xconv.BLOCK_Q}x{xconv.BLOCK_D}", splits=plan.splits,
                               matmul_tflops=sep / mms * 1e-9))
        print(f"xconv {shape}: {ms:.4f} ms, {flops / ms * 1e-9:.2f} TFLOP/s, tile "
              f"{xconv.BLOCK_Q}x{xconv.BLOCK_D} x {plan.splits} split(s) = {plan.blocks} blocks; "
              f"FP32 matmul of the product alone {mms:.4f} ms ({sep / mms * 1e-9:.2f} TFLOP/s)",
              flush=True)


def epilogue_row(rows, calls, reps, suffix=""):
    """Row xconv_epilogue<suffix> over the recorded split-epilogue calls."""
    from heterofusionrcnn_torch.ops import xconv

    # The XConv's split epilogue: the splits' partial sums read once, the
    # output written once; ELU and the affine on each output.
    r = new_row(rows, "xconv_epilogue" + suffix, "heterofusionrcnn_torch/ops/csrc/xconv.cu",
                "xconv_epilogue")
    for (partial, sc, bc, *out_dtype), _ in calls["xconv_split_epilogue"]:
        r["max_abs_err"] = max(r["max_abs_err"], check_epilogue(partial, sc, bc, *out_dtype))
        ms = cuda_ms(lambda: xconv.xconv_split_epilogue(partial, sc, bc), reps)
        pms = cuda_ms(lambda: xconv.xconv_split_epilogue_plain(partial, sc, bc), reps)
        s_, m, d = partial.shape
        add_bound(r, 4 * (partial.numel() + m * d + 2 * d), float(m * d * (s_ + 3)))
        r["ms"] += ms
        r["plain_ms"] += pms
        r["calls"].append(dict(shape=f"{s_}x{m}x{d}", ms=ms, plain_ms=pms))


def profiled(fn, reps, attempts=3):
    """Device events of reps calls of fn under torch.profiler: {kernel name:
    (launches, device ms)}. A trace was seen to drop its first records, and
    once all of them: up to `attempts` traces are taken, until one holds a
    device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = {e.key: (e.count, e.device_time_total / 1e3) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
        if events:
            break
    return events


def crop_op_times(fn, kernel, reps):
    """The crop op `fn` per call: back to back (`ms`, CUDA events), its host
    time (`host_us`: host clock over reps calls, no synchronisation inside,
    the median of three), the kernel alone (`kernel_ms`: torch.profiler
    device time a recorded launch) and the other kernels the op launches a
    call (`cast_launches`: per recorded crop launch, so records the trace
    drops do not count). Raises unless each call raised the wrapper's
    count of `kernel` by one and the profile holds the crop kernel."""
    import statistics

    import torch

    ms = cuda_ms(fn, reps)
    hosts = []
    for _ in range(3):
        before = kernel.launches
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        hosts.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
        if kernel.launches - before != reps:
            raise AssertionError(f"{reps} crop op calls launched {kernel.name} "
                                 f"{kernel.launches - before} times")
    events = profiled(fn, reps)
    crop = [v for k, v in events.items() if "crop_gather_kernel" in k]
    launches = sum(c for c, _ in crop)
    if not launches:
        raise AssertionError(f"no crop kernel in the profile: {list(events)}")
    other = sum(c for k, (c, _) in events.items() if "crop_gather_kernel" not in k)
    return dict(ms=ms, host_us=statistics.median(hosts),
                kernel_ms=sum(t for _, t in crop) / launches, cast_launches=other / launches)


def crop_row(r, calls, reps):
    """Row crop or crop_bf16 over the recorded crop calls: a copy, bytes
    only (each distinct gathered row read once, each output row written
    once, plus the indices). Each call and the all-distinct call of the
    same shapes (`idx` uniform over the source from SEED, `distinct_*`, its
    own bound) held against the plain version bit for bit and timed by
    `crop_op_times`; the library call is `index_select` on the flattened
    rows. The op must launch no kernel but its own (`cast_launches` 0)."""
    import torch

    from heterofusionrcnn_torch.ops import cropping

    r.update(library_ms=0.0, kernel_ms=0.0, host_us=0.0, cast_launches=0.0, distinct_ms=0.0,
             distinct_kernel_ms=0.0, distinct_bound_ms=0.0)
    for (src, idx, box_ind), _ in calls:
        kernel = cropping.CROP_BF16_KERNEL if src.dtype == torch.bfloat16 else cropping.CROP_KERNEL
        b, n, c = src.shape
        nb, rr = idx.shape
        spread = torch.randint(0, n, tuple(idx.shape), generator=torch.Generator().manual_seed(SEED),
                               dtype=idx.dtype).to(idx.device)
        times, bytes_ = {}, {}
        for case, ids in (("recorded", idx), ("distinct", spread)):
            if not torch.equal(cropping.crop_gather(src, ids, box_ind),
                               cropping.crop_gather_plain(src, ids, box_ind)):
                raise AssertionError(f"{r['name']} differs from its plain version ({case} call, "
                                     f"{b}x{n}x{c} -> {nb}x{rr})")
            times[case] = crop_op_times(lambda: cropping.crop_gather(src, ids, box_ind), kernel,
                                        reps)
            rows_idx = (box_ind.long()[:, None] * n + ids.long()).reshape(-1)
            distinct = int(torch.unique(rows_idx).numel())
            bytes_[case] = ((distinct + nb * rr) * c * src.element_size()
                            + idx.numel() * idx.element_size()
                            + box_ind.numel() * box_ind.element_size())
        pms = cuda_ms(lambda: cropping.crop_gather_plain(src, idx, box_ind), reps)
        flat = src.reshape(b * n, c)
        rows_idx = (box_ind.long()[:, None] * n + idx.long()).reshape(-1)
        lms = cuda_ms(lambda: torch.index_select(flat, 0, rows_idx), reps)
        add_bound(r, bytes_["recorded"], 0.0)
        rec, dis = times["recorded"], times["distinct"]
        dis_bound = bytes_["distinct"] / HBM_BYTES_PER_S * 1e3
        r["ms"] += rec["ms"]
        r["kernel_ms"] += rec["kernel_ms"]
        r["host_us"] += rec["host_us"]
        r["cast_launches"] += rec["cast_launches"] + dis["cast_launches"]
        r["distinct_ms"] += dis["ms"]
        r["distinct_kernel_ms"] += dis["kernel_ms"]
        r["distinct_bound_ms"] += dis_bound
        r["plain_ms"] += pms
        r["library_ms"] += lms
        r["calls"].append(dict(shape=f"{b}x{n}x{c} -> {nb}x{rr}", plain_ms=pms, library_ms=lms,
                               recorded=rec, distinct=dis, distinct_bound_ms=dis_bound))
        bound = bytes_["recorded"] / HBM_BYTES_PER_S * 1e3
        print(f"{r['name']} {b}x{n}x{c} -> {nb}x{rr}: op {rec['ms']:.4f} ms, host "
              f"{rec['host_us']:.1f} us a call, kernel alone {rec['kernel_ms']:.4f} ms "
              f"({bound / rec['kernel_ms']:.3f} of its {bound:.4f} ms bound); all-distinct: op "
              f"{dis['ms']:.4f} ms, kernel alone {dis['kernel_ms']:.4f} ms "
              f"({dis_bound / dis['kernel_ms']:.3f} of {dis_bound:.4f}); plain {pms:.4f}, "
              f"index_select {lms:.4f}; other kernels a call {rec['cast_launches']:.0f}",
              flush=True)
    if r["cast_launches"]:
        raise AssertionError(f"{r['name']}: the op launched other kernels besides its own")
    return r


def crop_stage(det, inputs, label, reps=REPS):
    """The RCNN's whole point crop (`pc_crop_and_sample`) of one forward of
    `det`, recorded and rerun alone: its ms (CUDA events) and device time
    by op (torch.profiler: each op's own kernels), printed on one line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from heterofusionrcnn_torch.models import rcnn as rcnn_module

    rec = Recorder(rcnn_module.pc_crop_and_sample)
    with patched(rcnn_module, "pc_crop_and_sample", rec):
        det(*inputs)
    args, kwargs = rec.calls[0]
    ms = cuda_ms(lambda: rec.fn(*args, **kwargs), reps)
    for _ in range(3):  # traces were seen to drop records: take another if this one has none
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rec.fn(*args, **kwargs)
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = sum(e.device_time_total for e in events
                     if e.device_type == DeviceType.CUDA and e.device_time_total > 0) / 1e3
        if device:
            break
    ops = sorted(((e.key, e.count, e.self_device_time_total / 1e3) for e in events
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda o: -o[2])
    print(f"crop stage ({label}, pc_crop_and_sample, crop_kernel {kwargs.get('crop_kernel')}): "
          f"{ms:.4f} ms a call, device {device:.4f} ms; by op: "
          + ", ".join(f"{k} {c}x {t:.4f}" for k, c, t in ops), flush=True)
    return dict(ms=ms, device_ms=device,
                ops=[dict(op=k, count=c, device_ms=t) for k, c, t in ops])


def check_kernels(calls, calls_on, reps):
    """Kernel vs plain on every recorded call (`calls`: the switches-off
    forward, `calls_on`: the switched kernels of the switches-on forward);
    times and bounds summed over the calls of one forward."""
    import torch.nn.functional as F

    from heterofusionrcnn_torch.ops import conv

    rows = {}

    def row(name, source):
        return new_row(rows, name, source)

    knn_rows(rows, calls, reps)
    fps_row(rows, calls, reps)
    nms_row(rows, calls, reps)
    xconv_row(rows, calls, reps)
    epilogue_row(rows, calls, reps)

    # Fused 3x3 conv and transposed conv: 2 * 9 * Cin * Cout operations per
    # (input) pixel, each three TF32 tensor-core products (3xTF32), against
    # bytes of the input, the weights, scale and shift, and the output. The
    # FP32-FMA bound of the same work is kept beside it (`fp32_bound_ms`).
    # The library call is the convolution alone (cuDNN, TF32 off).
    # `kernel_ms` times the kernel alone on the weight operand the wrapper
    # arranges and splits per call (`ms` includes that arrangement).
    convs = (
        ("conv", "conv.cu", conv.conv3x3_affine_relu, conv.conv3x3_affine_relu_plain,
         lambda x, w: F.conv2d(x, w, padding=1), 1, conv.CONV_KERNEL, "hfr_conv3x3",
         conv.conv_weight_operand),
        ("convt", "convt.cu", conv.convtranspose3x3_affine_relu,
         conv.convtranspose3x3_affine_relu_plain,
         lambda x, w: F.conv_transpose2d(x, w, stride=2), 4, conv.CONVT_KERNEL, "hfr_convt3x3",
         conv.convt_weight_operand),
    )
    for name, src, fn, plain, library, up, kern, cfn, operand in convs:
        r = row(name, f"heterofusionrcnn_torch/ops/csrc/{src}")
        r["library_ms"] = 0.0
        r["fp32_bound_ms"] = 0.0
        r["kernel_ms"] = 0.0
        for (x, w, sc, sh), kw in calls_on[KERNEL_OPS[name]]:
            r["max_abs_err"] = max(r["max_abs_err"], check_switched(name, (x, w, sc, sh), kw))
            ms = cuda_ms(lambda: fn(x, w, sc, sh, **kw), reps)
            pms = cuda_ms(lambda: plain(x, w, sc, sh, **kw), reps)
            lms = cuda_ms(lambda: library(x, w), reps)
            b, cin, h, wd = x.shape
            cout = sc.shape[0]
            wt = operand(w)
            out_hw = (h, wd) if up == 1 else (2 * h, 2 * wd)
            kms = cuda_ms(lambda: conv._launch(kern, cfn, x, wt, sc, sh, cout, out_hw,
                                               kw.get("relu", True)), reps)
            flops = 2.0 * 9 * cin * cout * b * h * wd
            nbytes = 4 * (x.numel() + w.numel() + 2 * cout + up * b * cout * h * wd)
            add_bound(r, nbytes, TF32_PRODUCTS * flops, TF32_FLOPS_PER_S)
            r["fp32_bound_ms"] += max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
            r["ms"] += ms
            r["kernel_ms"] += kms
            r["plain_ms"] += pms
            r["library_ms"] += lms
            shape = f"{b}x{cin}x{h}x{wd}->{cout}"
            tflops = flops / ms * 1e-9
            r["calls"].append(dict(shape=shape, ms=ms, kernel_ms=kms, plain_ms=pms,
                                   library_ms=lms, tflops=tflops,
                                   kernel_tflops=flops / kms * 1e-9,
                                   library_tflops=flops / lms * 1e-9))
            print(f"{name} {shape}: {ms:.4f} ms, {tflops:.2f} TFLOP/s (kernel alone "
                  f"{kms:.4f} ms, {flops / kms * 1e-9:.2f} TFLOP/s); cuDNN {lms:.4f} ms, "
                  f"{flops / lms * 1e-9:.2f} TFLOP/s", flush=True)

    crop_row(row("crop", "heterofusionrcnn_torch/ops/csrc/crop.cu"),
             calls_on[KERNEL_OPS["crop"]], reps)

    return finish_rows(rows)


def ptxas_summary(log: str):
    """Registers, stack, spills and static shared memory of each kernel in
    an `nvcc -Xptxas -v` log (dynamic shared memory is set at launch)."""
    import re

    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = dict(function=m.group(1))
            out.append(fn)
            continue
        if fn is None:
            continue
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("static_smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                fn[key] = int(m.group(1))
    return out


def sass_mma_counts(lib_path) -> dict:
    """Tensor-core instructions in a built library's SASS (`cuobjdump`
    beside nvcc): HGMMA is Hopper's wgmma (HGMMA_BF16 those on bf16
    operands), HMMA the older mma.sync."""
    from heterofusionrcnn_torch.ops.dispatch import _nvcc

    import re

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}
    counts["HGMMA_BF16"] = len(re.findall(r"\bHGMMA\.\S*BF16", sass))
    return counts


def profile_forward(det, inputs, top: int = 15):
    """One forward under torch.profiler: device time by kernel name (the
    device-side events only, so nothing is counted twice) and the device's
    busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det(*inputs)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return {
        "device_busy_ms": sum(r[2] for r in rows),
        "top": [{"name": k[:120], "count": c, "device_ms": ms} for k, c, ms in rows[:top]],
    }


def small_width_agrees(seed, switches: bool):
    """The detector at `*_unittest` width: card run vs CPU run (plain
    versions) with the same weights and inputs; `switches` turns both
    kernel switches on."""
    import torch

    from heterofusionrcnn_torch.configs.presets import rcnn_unittest, rpn_unittest
    from heterofusionrcnn_torch.inference import build_two_stage

    det, inputs = build_two_stage(2, seed, "cpu", rpn_unittest(), rcnn_unittest(),
                                  conv_kernels=switches, crop_kernel=switches)
    randomize_batchnorm(det, seed)
    want = det(*inputs)
    got = det.to("cuda")(*(t.to("cuda") for t in inputs))
    ok = torch.equal(got["num_final"].cpu(), want["num_final"])
    for key in ("final_boxes", "final_scores"):
        ok = ok and torch.allclose(got[key].cpu(), want[key], rtol=1e-3, atol=1e-3)
    return bool(ok), got["num_final"].cpu().tolist()


def counted_forward(det, inputs, kernels):
    """One forward between zeroing every launch count and reading it."""
    import torch

    for kern in kernels.values():
        kern.launches = 0
    out = det(*inputs)
    torch.cuda.synchronize()
    return out, {name: kern.launches for name, kern in kernels.items()}


def check_outputs(out, b):
    import torch

    boxes, scores, num = out["final_boxes"], out["final_scores"], out["num_final"]
    if boxes.shape != (b, 100, 7) or scores.shape != (b, 100) or num.shape != (b,):
        raise AssertionError(f"unexpected output shapes {boxes.shape} {scores.shape} {num.shape}")
    if out["final_classes"].shape != (b, 100) or out["proposals"].shape != (b, 100, 7):
        raise AssertionError("unexpected class or proposal shapes")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("non-finite outputs")
    if not bool(((num >= 1) & (num <= 100)).all()):
        raise AssertionError(f"final box counts out of range: {num.tolist()}")
    return num.tolist()


def kitti_phase(kernels, out_root):
    """The KITTI inference CLI on the fixture frames with both switches on:
    one prediction file of finite rows per frame, the switched kernels
    launched on every frame and held against their plain versions on every
    frame's inputs, AP lines from the evaluator. The weights are
    saved as port checkpoints in a temporary directory under `out_root`,
    removed afterwards."""
    os.makedirs(out_root, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="checkpoints-", dir=out_root)
    try:
        return _kitti_run(kernels, out_root, ckpt)
    finally:
        shutil.rmtree(ckpt)


def kitti_cli(out_root, ckpt, flags):
    """Saves the full-width detector's seed-0 random weights (random
    BatchNorm statistics) as port checkpoints under `ckpt`, then runs the
    KITTI inference CLI in process on the fixture val frames with the extra
    `flags`, predictions under `out_root`; returns its result."""
    from heterofusionrcnn_torch.experiments import common, run_inference
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager

    rpn_cfg = common.resolve_config("rpn_multiclass", KITTI_DIR)
    rcnn_cfg = common.resolve_config("rcnn_multiclass", KITTI_DIR)
    det = common.build_detector(rpn_cfg, rcnn_cfg, common.build_dataset(rpn_cfg, "test", "val"))
    randomize_batchnorm(init_weights(det, SEED), SEED)
    CheckpointManager(os.path.join(ckpt, "rpn")).save(0, det.rpn)
    CheckpointManager(os.path.join(ckpt, "rcnn")).save(0, det.rcnn)
    del det
    return run_inference.main([
        "--rpn_config", "rpn_multiclass", "--rcnn_config", "rcnn_multiclass",
        "--rpn_checkpoint", os.path.join(ckpt, "rpn"),
        "--rcnn_checkpoint", os.path.join(ckpt, "rcnn"),
        "--dataset_dir", KITTI_DIR, "--data_split", "val",
        "--output_root", os.path.join(out_root, "predictions"), *flags,
    ])


def _kitti_run(kernels, out_root, ckpt):
    import numpy as np

    from heterofusionrcnn_torch.inference import TwoStageDetector

    per_frame = []
    forward = TwoStageDetector.forward

    def counted(self, *inputs):
        out, launches = counted_forward(lambda *a: forward(self, *a), inputs, kernels)
        per_frame.append(launches)
        return out

    TwoStageDetector.forward = counted
    switched = {k: KERNEL_OPS[k] for k in SWITCHED_PER_FRAME}
    other_ops = tuple(KERNEL_OPS[k] for k in ("xconv", "xconv_epilogue", "knn", "fps", "nms"))
    try:
        with recording(tuple(switched.values()) + other_ops) as calls:
            result = kitti_cli(out_root, ckpt, ["--conv_kernels", "--crop_kernel", "--kitti_eval"])
    finally:
        TwoStageDetector.forward = forward
    frames = result["frames"]
    if not frames or len(per_frame) != len(frames):
        raise AssertionError(f"{len(per_frame)} forwards for frames {frames}")
    for name, launches in zip(frames, per_frame):
        got = {k: launches[k] for k in SWITCHED_PER_FRAME}
        if got != SWITCHED_PER_FRAME or not all(launches[k] for k in SLICE1):
            raise AssertionError(f"frame {name}: launches {launches}")
        rows = np.loadtxt(os.path.join(result["out_dir"], name + ".txt")).reshape(-1, 9)
        if not np.isfinite(rows).all():
            raise AssertionError(f"frame {name}: non-finite rows")
    if sorted(os.listdir(result["out_dir"])) != sorted(f + ".txt" for f in frames):
        raise AssertionError("prediction files do not match the loaded frames")
    if len(result.get("aps", {})) != 12:
        raise AssertionError(f"evaluator AP lines missing: {result.get('aps')}")
    # Every switched kernel's call of every frame against its plain version.
    result["max_abs_err"] = {}
    for name, op in switched.items():
        if len(calls[op]) != SWITCHED_PER_FRAME[name] * len(frames):
            raise AssertionError(f"{name}: {len(calls[op])} recorded calls over {len(frames)} frames")
        result["max_abs_err"][name] = max(check_switched(name, a, kw) for a, kw in calls[op])
    # Every fused XConv call of every frame, and every split epilogue.
    for name, check in (("xconv", check_xconv), ("xconv_epilogue", check_epilogue)):
        op = KERNEL_OPS[name]
        if len(calls[op]) != sum(launches[name] for launches in per_frame):
            raise AssertionError(f"{name}: {len(calls[op])} recorded calls, launches {per_frame}")
        result["max_abs_err"][name] = max(check(*a) for a, _ in calls[op])
    # Every KNN, FPS and NMS call of every frame, bit for bit.
    result["index_exact_calls"] = {}
    if expected_launches(calls, ("knn",))["knn_prep"] != sum(f["knn_prep"] for f in per_frame):
        raise AssertionError(f"knn prep launches {per_frame} do not match the sorted-arm calls")
    for name in ("knn", "fps", "nms"):
        op = KERNEL_OPS[name]
        if len(calls[op]) != sum(launches[name] for launches in per_frame):
            raise AssertionError(f"{name}: {len(calls[op])} recorded calls, launches {per_frame}")
        for a, kw in calls[op]:
            check_index_exact(name, a, kw)
        result["index_exact_calls"][name] = len(calls[op])
    del calls
    result["launches_per_frame"] = per_frame
    print("KITTI frames ms: " + " ".join(f"{t:.2f}" for t in result["frame_ms"]), flush=True)
    return result


# The training phase: `rpn_multiclass` at full width on the fixture frames,
# batch 2, through the training CLI for TRAIN_STEPS steps (a checkpoint
# every TRAIN_INTERVAL), then a second run that resumes and reaches
# TRAIN_RESUMED_TO.
TRAIN_STEPS, TRAIN_RESUMED_TO, TRAIN_INTERVAL = 6, 8, 3
TRAIN_RECORDED_STEP = 1        # the step (0-based, first run) whose kernel calls are held
TRAIN_KERNELS = ("knn", "knn_prep", "fps")  # launched by every train step
CURVE_STEPS = 8                # steps on one repeated batch that must lower the loss
# tests/test_torch_training.py's tolerances: losses rtol 1e-4 / atol 1e-5;
# gradients, and parameters after a step, rtol 1e-3 / atol 1e-5. Adam moves
# an element by about the learning rate times the sign of its gradient, so
# where the card's and the CPU's gradients agree only within the absolute
# part of that tolerance (rounding noise of two summation orders: the
# biases that a training BatchNorm follows, whose gradient is 0 in exact
# arithmetic, and elements of a tiny gradient) the updated element is held
# within 2 x the learning rate more; every other element within 1e-3 / 1e-5.
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


class StepMonitor:
    """Stands in for a train-step factory (`make_rpn_train_step` or
    `make_rcnn_train_step`, `make_step`) where the training CLI builds its
    step: each step between zeroing every launch count and reading it,
    timed on the host clock between two device synchronisations, its
    losses kept, and the KNN and FPS calls of one step recorded."""

    def __init__(self, kernels, make_step):
        self.kernels = kernels
        self.make_step = make_step
        self.steps = []
        self.calls = None

    def factory(self, loss_fn):
        import torch

        step = self.make_step(loss_fn)

        def monitored(state, batch):
            record = len(self.steps) == TRAIN_RECORDED_STEP
            start = state.step
            for kern in self.kernels.values():
                kern.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (recording(("knn_point", "farthest_point_sample")) if record
                  else contextlib.nullcontext()) as calls:
                metrics = step(state, batch)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if record:
                self.calls = calls
            losses = {k: float(v) for k, v in metrics.items()}
            self.steps.append(dict(start=start, ms=ms, losses=losses,
                                   launches={k: kern.launches for k, kern in self.kernels.items()}))
            print(f"train step {start + 1}: {ms:.2f} ms, "
                  + " ".join(f"{k}={v:.4f}" for k, v in losses.items()), flush=True)
            return metrics

        return monitored


def train_batch(cfg, device, seed=SEED):
    """One batch of 2 fixture train frames at the config's sizes, on `device`."""
    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.runtime.trainer import batch_to_device

    dataset = common.build_dataset(cfg, "train", "train")
    dataset.seed(seed)
    return batch_to_device(common.make_batch_fn(cfg, dataset, "rpn", 2)(), device), dataset


def no_dropout(cfg):
    lc = cfg.model_config.layers_config
    for fc in (lc.rpn_fc_layers + lc.pc_pointcnn.fc_layers + lc.rcnn_mlp_layers
               + lc.rcnn_fc_layers + lc.rcnn_pc_pointcnn.fc_layers):
        fc.dropout_rate = 0.0
    cfg.model_config.path_drop_probabilities = [1.0, 1.0]
    return cfg


def check_fresh_folds(model):
    """Every XConv's kept weight fold equals a fold of its weights now."""
    import torch

    from heterofusionrcnn_torch.models.extractors.pointcnn import XConv

    for name, m in model.named_modules():
        if isinstance(m, XConv):
            kept, fresh = m.kernel_weights(), m.weights()
            for field, t in vars(fresh).items():
                if t is not None and not torch.equal(getattr(kept, field), t):
                    raise AssertionError(f"{name}: the kept fold's {field} is stale")


def val_forward(model, batch, kernels):
    """One val-mode forward (eval, autograd off) of the trained module:
    launches counted, the NMS and fused XConv calls recorded."""
    import torch

    from heterofusionrcnn_torch.runtime.train_state import RPN_BATCH_KEYS

    model.eval()
    model.mode = "val"
    try:
        for kern in kernels.values():
            kern.launches = 0
        with torch.no_grad(), recording(("fused_xconv", "xconv_split_epilogue",
                                         "oriented_nms")) as calls:
            out = model(*(batch[k] for k in RPN_BATCH_KEYS))
            torch.cuda.synchronize()
    finally:
        model.mode = "train"
    return out, calls, {k: kern.launches for k, kern in kernels.items()}


def val_check(state, cfg, batch, kernels, bf16=False):
    """The trained weights in val mode, twice around one more train step:
    each forward's NMS calls bit-exact and fused XConv calls within the
    gate against their plain versions (`bf16`: the bf16 XConv, within the
    bf16 gate, and no float32 XConv launch), every kept weight fold equal
    to a fresh fold (with its bf16 Wc operand), and the step refolding
    every XConv once."""
    import torch

    from heterofusionrcnn_torch.models.extractors.pointcnn import XConv
    from heterofusionrcnn_torch.models.rpn import rpn_loss
    from heterofusionrcnn_torch.runtime.train_state import make_rpn_train_step

    model = state.model
    xconvs = {n: m for n, m in model.named_modules() if isinstance(m, XConv)}
    xk = "xconv_bf16" if bf16 else "xconv"
    result = {}
    for rnd in range(2):
        if rnd:
            folds = {n: m.weight_folds for n, m in xconvs.items()}
            make_rpn_train_step(lambda p: rpn_loss(p, cfg.model_config))(state, batch)
        out, calls, launches = val_forward(model, batch, kernels)
        if rnd and any(m.weight_folds != folds[n] + 1 for n, m in xconvs.items()):
            raise AssertionError("a train step did not refold every XConv exactly once")
        check_fresh_folds(model)
        if bf16 and any(m.kernel_weights().wc_operand_bf16 is None for m in xconvs.values()):
            raise AssertionError("an XConv fold without its bf16 Wc operand")
        if (launches[xk] != len(xconvs) or launches["nms"] != 1
                or (bf16 and launches["xconv"])):
            raise AssertionError(f"val forward launches {launches}")
        if len(calls["fused_xconv"]) != launches[xk]:
            raise AssertionError("recorded XConv calls do not match the launches")
        err = max(xconv_call_err(a, bf16) for a, _ in calls["fused_xconv"])
        for a, _ in calls["xconv_split_epilogue"]:
            err = max(err, epilogue_call_err(a, bf16))
        for a, kw in calls["oriented_nms"]:
            check_index_exact("nms", a, kw)
        for key in ("proposals", "proposal_iou3d", "seg_softmax"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"val forward: non-finite {key}")
        result[f"forward{rnd}"] = dict(launches=launches, xconv_max_abs_err=err,
                                       proposals=int(out["num_proposals_before_padding"].sum()))
    return result


def params_agree(got, want, grads_got, grads_want, lr, grads_close=None):
    """State dict `got` (card) against `want` (CPU) after one Adam step,
    with the gradients of that step on each side. Returns the names of the
    gradients outside PARAM_TOL (or outside `grads_close(got, want, name)`)
    and of the tensors outside PARAM_TOL after the step, and {name: count}
    of the elements whose two gradients agree only within the absolute
    part of the gradient tolerance, allowed 2 x lr more after the step."""
    bad, noise = [], {}
    for name, w in want.items():
        g = got[name].cpu()
        if not g.is_floating_point():
            continue
        tol = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * w.abs()
        if name in grads_want:
            gw, gg = grads_want[name], grads_got[name].cpu()
            close = (grads_close(gg, gw, name) if grads_close else
                     bool(((gg - gw).abs() <= PARAM_TOL["atol"] + PARAM_TOL["rtol"] * gw.abs()).all()))
            if not close:
                bad.append("gradient of " + name)
            unresolved = (gg - gw).abs() > PARAM_TOL["rtol"] * gw.abs()
            if unresolved.any():
                noise[name] = int(unresolved.sum())
            tol = tol + 2 * lr * unresolved
        if not bool(((g - w).abs() <= tol).all()):
            bad.append(name)
    return bad, noise


def step_agrees(cfg, batch, dataset, make_step, seed, grads_close=None, bf16=False):
    """One train step (`make_step`) of `cfg`'s model on the card and on the
    CPU (plain versions) from the same weights and host batch `batch`:
    losses within LOSS_TOL, the step's gradients, updated parameters and
    statistics as `params_agree` holds them (`bf16`: a bf16 model, at bf16
    resolution: losses within BF16_LOSS_RTOL, the rest as
    `bf16_params_agree` holds it)."""
    import copy

    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from heterofusionrcnn_torch.runtime.optimizer import ADAM_B1, build_optimizer
    from heterofusionrcnn_torch.runtime.train_state import TrainState

    model, loss_fn = common.build_model(cfg, dataset, "train")
    init_weights(model, seed)
    results = []
    for device in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(device)
        state = TrainState.create(m, build_optimizer(m, cfg.train_config.optimizer, 1,
                                                     cfg.train_config.grad_clip_norm), seed)
        metrics = make_step(loss_fn)(state, {k: v.to(device) for k, v in batch.items()})
        # The step's own clipped gradient: Adam's first moment after one
        # step from zero is (1 - b1) times it. A second backward on the card
        # need not repeat the step's rounding (its scatter-adds use atomics).
        opt_sd = state.optimizer.state_dict()["state"]
        grads = {n: mu / (1 - ADAM_B1) for n, mu in opt_sd["mu"].items()}
        results.append(({k: float(v) for k, v in metrics.items()}, m.state_dict(), grads,
                        opt_sd["nu"]))
    (want_l, want_sd, want_g, want_nu), (got_l, got_sd, got_g, _) = results
    lr = cfg.train_config.optimizer.initial_learning_rate
    total = sum(p.numel() for p in model.parameters())
    if bf16:
        losses_ok = all(abs(got_l[k] - want_l[k]) <= BF16_LOSS_RTOL * abs(want_l[k])
                        for k in want_l)
        bad, capped, worst = bf16_params_agree(got_sd, want_sd, got_g, want_g, want_nu, 1, lr)
        return losses_ok and not bad, dict(cpu=want_l, cuda=got_l, outside=bad, capped=capped,
                                           capped_share=capped / total, worst=worst)
    losses_ok = all(abs(got_l[k] - want_l[k]) <= LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(want_l[k])
                    for k in want_l)
    bad, noise = params_agree(got_sd, want_sd, got_g, want_g, lr, grads_close)
    return losses_ok and not bad, dict(cpu=want_l, cuda=got_l, outside=bad,
                                       widened_share=sum(noise.values()) / total,
                                       widened_elements=noise)


def small_width_train_agrees(seed):
    """One RPN train step at `rpn_unittest` width on the card and on the CPU,
    dropout and path drop off (`step_agrees`)."""
    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.runtime.train_state import make_rpn_train_step

    cfg = no_dropout(common.resolve_config("rpn_unittest", KITTI_DIR))
    batch, dataset = train_batch(cfg, "cpu", seed)
    return step_agrees(cfg, batch, dataset, make_rpn_train_step, seed)


def loss_curve(cfg, batch, dataset, make_step, steps=CURVE_STEPS):
    """`steps` train steps (`make_step`) of `cfg`'s model (dropout and path
    drop off) on one repeated device batch: the total loss of each."""
    import torch

    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from heterofusionrcnn_torch.runtime.optimizer import build_optimizer
    from heterofusionrcnn_torch.runtime.train_state import TrainState

    model, loss_fn = common.build_model(no_dropout(cfg), dataset, "train")
    model = init_weights(model, SEED).cuda()
    state = TrainState.create(model, build_optimizer(model, cfg.train_config.optimizer, 1,
                                                     cfg.train_config.grad_clip_norm), SEED)
    step = make_step(loss_fn)
    curve = [float(step(state, batch)["total_loss"]) for _ in range(steps)]
    del state, model
    torch.cuda.empty_cache()
    return curve


def training_phase(kernels, out_root):
    """The training CLI at full width (see TRAIN_STEPS), its checks, the
    kernel rows of one recorded train step, the val-mode check, the small-
    width card/CPU step, the loss curve and one profiled step."""
    import torch

    from heterofusionrcnn_torch.configs.config import save_config
    from heterofusionrcnn_torch.experiments import common, run_training
    from heterofusionrcnn_torch.models.rpn import rpn_loss
    from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
    from heterofusionrcnn_torch.runtime.train_state import make_rpn_train_step

    root = os.path.join(out_root, "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = common.resolve_config("rpn_multiclass", KITTI_DIR)
    cfg.train_config.checkpoint_interval = TRAIN_INTERVAL
    cfg_path = os.path.join(root, "rpn_multiclass.json")
    save_config(cfg, cfg_path)
    argv = ["--pipeline_config", cfg_path, "--data_split", "train", "--output_root", root,
            "--seed", str(SEED)]
    monitor = StepMonitor(kernels, make_rpn_train_step)
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad(), patched(run_training, "make_rpn_train_step", monitor.factory):
        run_training.main(argv + ["--max_iterations", str(TRAIN_STEPS)])
        state = run_training.main(argv + ["--max_iterations", str(TRAIN_RESUMED_TO)])
    report = dict(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, steps=monitor.steps)
    starts = [s["start"] for s in monitor.steps]
    if starts != list(range(TRAIN_RESUMED_TO)) or state.step != TRAIN_RESUMED_TO:
        raise AssertionError(f"steps started at {starts}, ended at {state.step}")
    ckpts = CheckpointManager(os.path.join(root, "rpn_multiclass", "checkpoints")).all_steps()
    if ckpts != [3, 6, 8]:
        raise AssertionError(f"checkpoints {ckpts}")
    check_train_steps(monitor.steps, TRAIN_KERNELS, ("xconv", "nms"), "train")
    recorded = monitor.steps[TRAIN_RECORDED_STEP]["launches"]
    calls = monitor.calls
    if expected_launches(calls, TRAIN_KERNELS) != {k: recorded[k] for k in TRAIN_KERNELS}:
        raise AssertionError(f"recorded train-step calls do not match its launches {recorded}")
    for name in ("knn", "fps"):
        for a, kw in calls[KERNEL_OPS[name]]:
            check_index_exact(name, a, kw)
    step_ms = [s["ms"] for s in monitor.steps]
    print(f"train steps ms (batch 2): " + " ".join(f"{t:.2f}" for t in step_ms)
          + f"; peak device memory {report['peak_mem_gb']:.2f} GB", flush=True)

    rows = {}
    with torch.no_grad():
        knn_rows(rows, calls, REPS, "_train")
        fps_row(rows, calls, REPS, "_train", sweeps=False)
    for name in TRAIN_KERNELS:
        rows[name + "_train"]["launches"] = recorded[name]
    finish_rows(rows)
    del calls, monitor.calls

    batch, _ = train_batch(cfg, "cuda")
    report["val"] = val_check(state, cfg, batch, kernels)
    step = make_rpn_train_step(lambda p: rpn_loss(p, cfg.model_config))
    report["profile_step"] = profile_forward(lambda: step(state, batch), (), top=25)
    del state, batch
    torch.cuda.empty_cache()

    agree, detail = small_width_train_agrees(SEED)
    report["small_width_train"] = dict(agrees=agree, **detail)
    print(f"rpn_unittest step, card against CPU: {len(detail['widened_elements'])} tensors hold "
          f"{sum(detail['widened_elements'].values())} elements whose gradients agree only "
          f"within 1e-5 absolute ({detail['widened_share']:.6f} of the parameters)", flush=True)
    if not agree:
        raise AssertionError(f"small-width train step: card and CPU disagree: {detail}")
    cfg = common.resolve_config("rpn_multiclass", KITTI_DIR)
    batch, dataset = train_batch(cfg, "cuda")
    curve = loss_curve(cfg, batch, dataset, make_rpn_train_step)
    del batch
    report["loss_curve"] = curve
    print("loss curve (one repeated batch): " + " ".join(f"{v:.4f}" for v in curve), flush=True)
    if not curve[-1] < curve[0]:
        raise AssertionError(f"{CURVE_STEPS} steps on one batch did not lower the loss: {curve}")
    return report, rows


# Step 9, two-stage training: the RPN evaluator writes the handoff files
# from step 8's full-width checkpoint, then `rcnn_multiclass` trains from
# them for RCNN_STEPS steps and a resume to RCNN_RESUMED_TO (a checkpoint
# every TRAIN_INTERVAL), warm-started from the RPN.
RCNN_STEPS, RCNN_RESUMED_TO = 6, 8
RCNN_KERNELS = ("knn", "fps")  # launched by every RCNN train step (sets below 4096: brute arm)


def handoff_phase(kernels, rpn_root, pipeline_config="rpn_multiclass", bf16=False):
    """`run_evaluation --save_rpn_feature --for_rcnn_train` in process on
    the fixture train split from the latest checkpoint under `rpn_root` of
    `pipeline_config` (a preset or a saved config), counted, with the first
    frame's kernel calls recorded: every labelled frame's three files,
    features of the RCNN's width, finite; the first frame's NMS calls
    bit-exact and fused XConv and split-epilogue calls within the gate
    (`bf16`: the bf16 XConv's). Returns the report and the three
    directories."""
    import numpy as np
    import torch

    from heterofusionrcnn_torch.datasets.kitti import labels as label_io
    from heterofusionrcnn_torch.experiments import common, run_evaluation
    from heterofusionrcnn_torch.models.rpn import rpn_fts_channels
    from heterofusionrcnn_torch.runtime import evaluator

    first = {}
    apply = evaluator.RpnEvaluator._apply

    def recorded_apply(self, batch):
        if first:
            return apply(self, batch)
        with recording(("fused_xconv", "xconv_split_epilogue", "oriented_nms")) as calls:
            out = apply(self, batch)
            torch.cuda.synchronize()
        first.update(calls)
        return out

    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    with patched(evaluator.RpnEvaluator, "_apply", recorded_apply):
        summary, = run_evaluation.main([
            "--pipeline_config", pipeline_config, "--dataset_dir", KITTI_DIR,
            "--output_root", rpn_root, "--data_split", "train", "--save_rpn_feature",
            "--for_rcnn_train"])
    torch.cuda.synchronize()
    report = dict(s=time.perf_counter() - t0, step=summary["global_step"],
                  launches={k: kern.launches for k, kern in kernels.items()},
                  recall_50=summary["recall_50"], avg_iou3d=summary["avg_iou3d"])
    name = common.resolve_config(pipeline_config, KITTI_DIR).model_config.checkpoint_name
    pred = os.path.join(rpn_root, name, "predictions")
    dirs = [os.path.join(pred, d, "train", str(summary["global_step"]))
            for d in ("proposals_and_scores", "proposals_iou", "rpn_feature")]
    cfg = common.resolve_config("rcnn_multiclass", KITTI_DIR)
    dataset = common.build_dataset(cfg, "val", "train")
    labelled = [s.name for s in dataset.sample_list if label_io.filter_labels(
        label_io.read_labels(dataset.label_dir, int(s.name)), dataset.classes)]
    width = rpn_fts_channels(cfg.model_config) + 5
    for name in labelled:
        props = np.loadtxt(os.path.join(dirs[0], name + ".txt"), ndmin=2)
        ious = np.loadtxt(os.path.join(dirs[1], name + ".txt"), ndmin=2)
        feats = np.load(os.path.join(dirs[2], name + ".npy"))
        if props.shape[1] != 8 or len(ious) != len(props) or feats.shape[1] != width:
            raise AssertionError(f"handoff of {name}: {props.shape} {ious.shape} {feats.shape}")
        if not all(np.isfinite(a).all() for a in (props, ious, feats)):
            raise AssertionError(f"handoff of {name}: non-finite values")
    frames = len(labelled)
    xk = "xconv_bf16" if bf16 else "xconv"
    per_frame = {k: report["launches"][k] / frames for k in (xk, "nms", "knn", "fps")}
    if not all(per_frame.values()) or (bf16 and report["launches"]["xconv"]):
        raise AssertionError(f"the RPN evaluation did not launch every kernel: {report['launches']}")
    err = max(xconv_call_err(a, bf16) for a, _ in first["fused_xconv"])
    for a, _ in first["xconv_split_epilogue"]:
        err = max(err, epilogue_call_err(a, bf16))
    for a, kw in first["oriented_nms"]:
        check_index_exact("nms", a, kw)
    report.update(frames=frames, feature_width=width, xconv_max_abs_err=err,
                  first_frame_calls={k: len(v) for k, v in first.items()})
    print(f"handoff: {frames} frames, features {width} wide, {report['s']:.1f} s; launches "
          f"{report['launches']}; first frame's {len(first['fused_xconv'])} XConv (max error "
          f"{err:.3g}) and {len(first['oriented_nms'])} NMS calls held", flush=True)
    return report, dirs


def rcnn_small_width_agrees(seed, out_root):
    """One RCNN train step at `rcnn_unittest` width (batch 2 of 16 RoIs from
    a synthetic handoff over the fixture frames, dropout and path drop off)
    on the card and on the CPU (`step_agrees`, the gradients held by
    tests/rcnn_fixtures.py `grads_agree`)."""
    from heterofusionrcnn_torch.experiments import common
    from tests.rcnn_fixtures import grads_agree, write_handoff

    cfg = no_dropout(common.resolve_config("rcnn_unittest", KITTI_DIR))
    dataset = common.build_dataset(cfg, "train", "train")
    dataset.seed(seed)
    root = os.path.join(out_root, "chip_smoke_rcnn_unittest")
    shutil.rmtree(root, ignore_errors=True)
    dataset.proposal_dir, dataset.proposal_iou_dir, dataset.rpn_feature_dir = write_handoff(
        dataset, root)
    from heterofusionrcnn_torch.runtime.trainer import batch_to_device

    batch = batch_to_device(common.make_batch_fn(cfg, dataset, "rcnn", 2)(), "cpu")
    agree, detail = step_agrees(cfg, batch, dataset, common.make_rcnn_train_step, seed,
                                grads_agree)
    if not detail["cpu"]["rcnn_reg_loss"] > 0:  # else the bin and residual heads go unchecked
        raise AssertionError(f"rcnn_unittest step without a positive RoI: {detail['cpu']}")
    return agree, detail


def two_stage_phase(kernels, out_root):
    """Step 9 (module docstring): the handoff, the RCNN training CLI at full
    width with its checks, the kernel rows of one recorded RCNN step, one
    profiled step, the small-width card/CPU step and the loss curve."""
    import numpy as np
    import torch

    from heterofusionrcnn_torch.configs.config import save_config
    from heterofusionrcnn_torch.experiments import common, run_training
    from heterofusionrcnn_torch.models import rcnn as rcnn_module
    from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
    from heterofusionrcnn_torch.runtime.trainer import batch_to_device

    rpn_root = os.path.join(out_root, "chip_smoke_train")
    report = {}
    report["handoff"], dirs = handoff_phase(kernels, rpn_root)

    root = os.path.join(out_root, "chip_smoke_rcnn")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = common.resolve_config("rcnn_multiclass", KITTI_DIR)
    cfg.train_config.checkpoint_interval = TRAIN_INTERVAL
    cfg_path = os.path.join(root, "rcnn_multiclass.json")
    save_config(cfg, cfg_path)
    argv = ["--pipeline_config", cfg_path, "--data_split", "train", "--output_root", root,
            "--seed", str(SEED), "--warm_start_from",
            os.path.join(rpn_root, "rpn_multiclass", "checkpoints"), "--proposal_dir", dirs[0],
            "--proposal_iou_dir", dirs[1], "--rpn_feature_dir", dirs[2]]
    # No gradient may reach the stage-1 features: every crop's features
    # must come out of the crop without autograd history.
    crop_grads = []
    crop = rcnn_module.pc_crop_and_sample

    def checked_crop(*args, **kwargs):
        out = crop(*args, **kwargs)
        crop_grads.append(out[1].requires_grad)
        return out

    monitor = StepMonitor(kernels, common.make_rcnn_train_step)
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad(), patched(run_training, "make_rcnn_train_step", monitor.factory), \
            patched(rcnn_module, "pc_crop_and_sample", checked_crop):
        run_training.main(argv + ["--max_iterations", str(RCNN_STEPS)])
        state = run_training.main(argv + ["--max_iterations", str(RCNN_RESUMED_TO)])
    report.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, steps=monitor.steps)
    if len(crop_grads) != RCNN_RESUMED_TO or any(crop_grads):
        raise AssertionError(f"cropped stage-1 features that autograd tracks: {crop_grads}")
    starts = [s["start"] for s in monitor.steps]
    if starts != list(range(RCNN_RESUMED_TO)) or state.step != RCNN_RESUMED_TO:
        raise AssertionError(f"RCNN steps started at {starts}, ended at {state.step}")
    ckpts = CheckpointManager(os.path.join(root, "rcnn_multiclass", "checkpoints")).all_steps()
    if ckpts != [3, 6, 8]:
        raise AssertionError(f"RCNN checkpoints {ckpts}")
    for s in monitor.steps:
        if sorted(s["losses"]) != ["rcnn_bin_cls_loss", "rcnn_cls_loss", "rcnn_reg_loss",
                                   "total_loss"]:
            raise AssertionError(f"RCNN step metrics {sorted(s['losses'])}")
    check_train_steps(monitor.steps, RCNN_KERNELS, ("xconv", "nms"), "RCNN")
    positive = sum(s["losses"]["rcnn_reg_loss"] > 0 for s in monitor.steps)
    if not positive:  # else no step trained the bin and residual heads
        raise AssertionError("no RCNN train step held a positive RoI")
    report["steps_with_positive_rois"] = positive
    recorded = monitor.steps[TRAIN_RECORDED_STEP]["launches"]
    calls = monitor.calls
    if expected_launches(calls, ("knn", "knn_prep", "fps")) != {
            k: recorded[k] for k in ("knn", "knn_prep", "fps")}:
        raise AssertionError(f"recorded RCNN step calls do not match its launches {recorded}")
    for name in RCNN_KERNELS:
        for a, kw in calls[KERNEL_OPS[name]]:
            check_index_exact(name, a, kw)
    step_ms = [s["ms"] for s in monitor.steps]
    report["median_ms_after_first"] = float(np.median(step_ms[1:]))
    print("RCNN train steps ms (batch 1, 64 RoIs): " + " ".join(f"{t:.2f}" for t in step_ms)
          + f"; peak device memory {report['peak_mem_gb']:.2f} GB; {positive} steps with "
          "a positive RoI", flush=True)

    rows = {}
    with torch.no_grad():
        knn_rows(rows, calls, REPS, "_rcnn_train")
        fps_row(rows, calls, REPS, "_rcnn_train", sweeps=False)
    if rows["knn_prep_rcnn_train"]["calls"] or recorded["knn_prep"]:
        raise AssertionError("an RCNN KNN call took the sorted arm")
    del rows["knn_prep_rcnn_train"]  # not on this path: every set is below 4096 points
    for name in RCNN_KERNELS:
        rows[name + "_rcnn_train"]["launches"] = recorded[name]
    finish_rows(rows)
    del calls, monitor.calls

    dataset = common.build_dataset(cfg, "train", "train")
    dataset.seed(SEED)
    dataset.proposal_dir, dataset.proposal_iou_dir, dataset.rpn_feature_dir = dirs
    # The profiled and the loss-curve batch: the first with a positive RoI,
    # so that the curve trains the bin and residual heads too.
    next_batch = common.make_batch_fn(cfg, dataset, "rcnn", 1)
    reg_lo = cfg.dataset_config.mini_batch_config.reg_iou_3d_thresholds.pos_iou_lo
    for _ in range(len(dataset.sample_list)):
        host = next_batch()
        if (host["rpn_iou"] > reg_lo).any():
            break
    else:
        raise AssertionError("no RCNN batch of the fixture frames holds a positive RoI")
    batch = batch_to_device(host, "cuda")
    step = common.make_rcnn_train_step(lambda p: rcnn_module.rcnn_loss(p, cfg.model_config))
    report["profile_step"] = profile_forward(lambda: step(state, batch), (), top=25)
    report["device_busy_share"] = (report["profile_step"]["device_busy_ms"]
                                   / report["median_ms_after_first"])
    print(f"RCNN step profile: {report['profile_step']['device_busy_ms']:.2f} ms of device time, "
          f"busy share {report['device_busy_share']:.3f} of the median step", flush=True)
    del state
    torch.cuda.empty_cache()

    agree, detail = rcnn_small_width_agrees(SEED, out_root)
    report["small_width_train"] = dict(agrees=agree, **detail)
    print(f"rcnn_unittest step, card against CPU: losses {detail['cuda']} / {detail['cpu']}; "
          f"{sum(detail['widened_elements'].values())} elements in "
          f"{len(detail['widened_elements'])} tensors widened "
          f"({detail['widened_share']:.6f} of the parameters)", flush=True)
    if not agree:
        raise AssertionError(f"rcnn_unittest train step: card and CPU disagree: {detail}")
    curve = loss_curve(cfg, batch, dataset, common.make_rcnn_train_step)
    report["loss_curve"] = curve
    print("RCNN loss curve (one repeated batch): " + " ".join(f"{v:.4f}" for v in curve),
          flush=True)
    if not curve[-1] < curve[0]:
        raise AssertionError(f"{CURVE_STEPS} RCNN steps on one batch did not lower the loss: "
                             f"{curve}")
    return report, rows


# Step 10, the RCNN's evaluation: the RPN evaluator writes the val split's
# handoff from step 8's checkpoint, then the evaluation CLI runs step 9's
# RCNN over it at 100 RoIs a frame.
RCNN_EVAL_ROIS = 100
# Launches of every RCNN eval forward (sets of 512 and fewer points: the
# KNN's brute arm), besides split epilogues.
RCNN_EVAL_PER_FORWARD = {"knn": 4, "fps": 3, "xconv": 4, "nms": 1}
RCNN_EVAL_OPS = ("knn_point", "farthest_point_sample", "fused_xconv", "xconv_split_epilogue",
                 "oriented_nms")
# tests/test_evaluator_batched.py's tolerances for batch 2 against batch 1:
# the final rows (%.5f), the KITTI rows (3 decimals), the ledgers.
FINAL_ATOL, KITTI_ATOL, LEDGER_ATOL = 2e-5, 1e-2, 1e-4


def _same_row_sets(got, want, atol, name):
    """Rows of `got` matched one to one with rows of `want` (the pairing of
    least total difference: rows of equal scores may come in either order),
    each pair within `atol` (+ 1e-9 for the decimal -> binary parse)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    if got.shape != want.shape:
        raise AssertionError(f"{name}: rows {got.shape} against {want.shape}")
    if len(got):
        diff = np.abs(got[:, None, :] - want[None, :, :]).max(-1)
        rows, cols = linear_sum_assignment(diff)
        if diff[rows, cols].max() > atol + 1e-9:
            raise AssertionError(f"{name}: rows differ by {diff[rows, cols].max()}")


def _kitti_rows(path):
    import numpy as np

    if os.path.getsize(path) == 0:
        return np.zeros((0, 15))
    return np.atleast_2d(np.genfromtxt(path, usecols=range(1, 16)))


def check_rcnn_eval_files(pred, step, frames):
    """One RCNN evaluation's files under `pred` (a predictions dir): finite
    final rows and a KITTI file for each frame, both AP summaries, the two
    ledgers (one row, finite) and the headed log beside them."""
    import numpy as np

    final = os.path.join(pred, "final_predictions_and_scores", "val", str(step))
    kitti = os.path.join(pred, "kitti_native_eval", "0.1", str(step))
    for name in frames:
        rows = np.loadtxt(os.path.join(final, name + ".txt"), ndmin=2).reshape(-1, 9)
        if not (np.isfinite(rows).all() and ((rows[:, 7] >= 0) & (rows[:, 7] <= 1)).all()):
            raise AssertionError(f"final predictions of {name}: {rows}")
        _kitti_rows(os.path.join(kitti, "data", name + ".txt"))
    for sub in ("", "results_05_iou"):
        with open(os.path.join(kitti, sub, "ap_summary.json")) as f:
            if len(json.load(f)) != 12:
                raise AssertionError(f"ap_summary.json in {kitti}/{sub}")
    for name, width in (("rcnn_avg_losses.csv", 5), ("rcnn_avg_cls_acc.csv", 2)):
        rows = np.loadtxt(os.path.join(pred, name), delimiter=",", ndmin=2)
        if rows.shape != (1, width) or not np.isfinite(rows).all():
            raise AssertionError(f"{name}: {rows}")
    with open(os.path.join(os.path.dirname(pred), "logs", "rcnn_eval.csv")) as f:
        if [r[0] for r in csv.reader(f)] != ["global_step", str(step)]:
            raise AssertionError("logs/rcnn_eval.csv")


def compare_rcnn_eval(pred_a, pred_b, step, frames):
    """Batch 2's files against batch 1's (tests/test_evaluator_batched.py):
    the final rows within FINAL_ATOL as sets, the KITTI rows within
    KITTI_ATOL, the ledgers within LEDGER_ATOL."""
    import numpy as np

    for name in frames:
        for sub, loader, atol in (
                (os.path.join("final_predictions_and_scores", "val", str(step)),
                 lambda p: np.loadtxt(p, ndmin=2).reshape(-1, 9), FINAL_ATOL),
                (os.path.join("kitti_native_eval", "0.1", str(step), "data"), _kitti_rows,
                 KITTI_ATOL)):
            _same_row_sets(loader(os.path.join(pred_a, sub, name + ".txt")),
                           loader(os.path.join(pred_b, sub, name + ".txt")), atol,
                           f"{sub}/{name}")
    for name in ("rcnn_avg_losses.csv", "rcnn_avg_cls_acc.csv"):
        a, b = (np.loadtxt(os.path.join(p, name), delimiter=",", ndmin=2) for p in (pred_a, pred_b))
        if a.shape != b.shape or np.abs(a - b).max() > LEDGER_ATOL:
            raise AssertionError(f"{name}: {a} against {b}")


def rcnn_eval_phase(kernels, out_root):
    """Step 10 (module docstring): the val handoff, the RCNN evaluation CLI
    at batch 1 and 2 with its checks, one profiled frame, the first frame's
    kernel calls held and timed (rows *_rcnn_eval), and the watcher."""
    import functools

    import numpy as np
    import torch

    from heterofusionrcnn_torch.experiments import common, run_evaluation
    from heterofusionrcnn_torch.runtime import evaluator
    from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager

    rpn_root = os.path.join(out_root, "chip_smoke_train")
    t0 = time.perf_counter()
    summary, = run_evaluation.main([
        "--pipeline_config", "rpn_multiclass", "--dataset_dir", KITTI_DIR, "--output_root",
        rpn_root, "--data_split", "val", "--save_rpn_feature"])
    report = dict(handoff_s=time.perf_counter() - t0, rpn_step=summary["global_step"])
    pred = os.path.join(rpn_root, "rpn_multiclass", "predictions")
    dirs = [os.path.join(pred, d, "val", str(summary["global_step"]))
            for d in ("proposals_and_scores", "proposals_iou", "rpn_feature")]
    # On a labelled split the RPN's val mode keeps the train NMS sizes (512
    # proposals a frame, as in JAX); --num_rois takes the first 100.
    rpn = common.resolve_config("rpn_multiclass").model_config.rpn_config
    props = [np.loadtxt(os.path.join(dirs[0], n), ndmin=2) for n in os.listdir(dirs[0])]
    if not props or any(p.shape[0] > rpn.rpn_train_post_nms_size or p.shape[1] != 8
                        or not np.isfinite(p).all() for p in props):
        raise AssertionError(f"val handoff proposals: {[p.shape for p in props]}")
    report["handoff_proposals"] = [p.shape[0] for p in props]

    ckpts = os.path.abspath(os.path.join(out_root, "chip_smoke_rcnn", "rcnn_multiclass",
                                         "checkpoints"))
    base = os.path.join(out_root, "chip_smoke_rcnn_eval")
    shutil.rmtree(base, ignore_errors=True)
    apply = evaluator.RcnnEvaluator._apply
    forwards, first, kept = [], {}, []

    def counted_apply(self, batch):
        record = not first
        for kern in kernels.values():
            kern.launches = 0
        with recording(RCNN_EVAL_OPS) if record else contextlib.nullcontext() as calls:
            out = apply(self, batch)
            torch.cuda.synchronize()
        forwards.append(dict(batch=self.eval_batch_size,
                             launches={k: kern.launches for k, kern in kernels.items()}))
        if record:
            first.update(calls)
            kept.append((self, batch))
        return out

    def cli(root, *flags):
        os.makedirs(os.path.join(root, "rcnn_multiclass"), exist_ok=True)
        if not os.path.exists(os.path.join(root, "rcnn_multiclass", "checkpoints")):
            os.symlink(ckpts, os.path.join(root, "rcnn_multiclass", "checkpoints"))
        return run_evaluation.main([
            "--pipeline_config", "rcnn_multiclass", "--dataset_dir", KITTI_DIR, "--output_root",
            root, "--data_split", "val", "--num_rois", str(RCNN_EVAL_ROIS), "--proposal_dir",
            dirs[0], "--proposal_iou_dir", dirs[1], "--rpn_feature_dir", dirs[2], *flags])

    summaries = {}
    with patched(evaluator.RcnnEvaluator, "_apply", counted_apply):
        for bs in (1, 2):
            summaries[bs], = cli(os.path.join(base, f"batch{bs}"), "--eval_batch_size", str(bs))
    step = summaries[1]["global_step"]
    preds = {bs: os.path.join(base, f"batch{bs}", "rcnn_multiclass", "predictions")
             for bs in (1, 2)}
    final = os.path.join(preds[1], "final_predictions_and_scores", "val", str(step))
    frames = sorted(os.path.splitext(n)[0] for n in os.listdir(final))
    if not frames or len([f for f in forwards if f["batch"] == 1]) != len(frames):
        raise AssertionError(f"{len(forwards)} forwards for frames {frames}")
    for f in forwards:
        got = {k: f["launches"][k] for k in RCNN_EVAL_PER_FORWARD}
        others = {k: v for k, v in f["launches"].items()
                  if k not in RCNN_EVAL_PER_FORWARD and k != "xconv_epilogue" and v}
        if got != RCNN_EVAL_PER_FORWARD or others:
            raise AssertionError(f"RCNN eval forward (batch {f['batch']}) launches {f['launches']}")
    for bs in (1, 2):
        check_rcnn_eval_files(preds[bs], step, frames)
    compare_rcnn_eval(preds[1], preds[2], step, frames)

    tstats = {bs: summaries[bs]["inference_time_stats"] for bs in (1, 2)}
    ev, batch = kept[0]
    profiled = profile_forward(lambda: apply(ev, batch), (), top=20)
    del kept, ev, batch
    median_ms = tstats[1]["median"] * 1e3
    report.update(step=step, frames=len(frames), launches_per_forward=forwards[0]["launches"],
                  forwards=forwards, ms_per_frame={bs: {k: v * 1e3 for k, v in t.items()}
                                                   for bs, t in tstats.items()},
                  profile=profiled, device_busy_share=profiled["device_busy_ms"] / median_ms,
                  avg_cls_acc=summaries[1]["avg_cls_acc"], avg_losses=summaries[1]["avg_losses"])
    print(f"RCNN eval: {len(frames)} frames, {RCNN_EVAL_ROIS} RoIs a frame; ms per frame (host "
          f"clock) batch 1 median {median_ms:.2f} mean {tstats[1]['mean'] * 1e3:.2f}, batch 2 "
          f"median {tstats[2]['median'] * 1e3:.2f}; one frame {profiled['device_busy_ms']:.2f} ms "
          f"of device time, busy share {report['device_busy_share']:.3f}; launches a forward "
          f"{forwards[0]['launches']}", flush=True)

    # The watcher over two checkpoints through the CLI, stopping at the
    # second: each evaluated once, nothing on a second call.
    watch = os.path.join(base, "watch")
    os.makedirs(os.path.join(watch, "rcnn_multiclass", "checkpoints"))
    steps = CheckpointManager(ckpts).all_steps()[-2:]
    for s_ in steps:
        os.symlink(os.path.join(ckpts, str(s_)),
                   os.path.join(watch, "rcnn_multiclass", "checkpoints", str(s_)))
    evaluated = []
    once = evaluator.RcnnEvaluator.run_checkpoint_once

    def counted_once(self, state, step_, **kw):
        evaluated.append((step_, kw))
        return once(self, state, step_, **kw)

    with patched(evaluator.RcnnEvaluator, "run_checkpoint_once", counted_once), \
            patched(run_evaluation, "repeated_checkpoint_run", functools.partial(
                evaluator.repeated_checkpoint_run, stop_at_step=steps[-1])):
        for _ in range(2):
            cli(watch, "--evaluate_repeatedly")
    if evaluated != [(s_, {"num_rois": RCNN_EVAL_ROIS}) for s_ in steps]:
        raise AssertionError(f"the watcher evaluated {evaluated}")
    report["watcher_evaluated"] = [s_ for s_, _ in evaluated]

    # The first frame's kernel calls against their plain versions, timed.
    rows = {}
    with torch.no_grad():
        knn_rows(rows, first, REPS, "_rcnn_eval")
        fps_row(rows, first, REPS, "_rcnn_eval", sweeps=False)
        xconv_row(rows, first, REPS, "_rcnn_eval")
        epilogue_row(rows, first, REPS, "_rcnn_eval")
        nms_row(rows, first, REPS, "_rcnn_eval", sweeps=False)
    if rows["knn_prep_rcnn_eval"]["calls"] or report["launches_per_forward"]["knn_prep"]:
        raise AssertionError("an RCNN eval KNN call took the sorted arm")
    del rows["knn_prep_rcnn_eval"]  # not on this path: every set is below 4096 points
    for name in ("knn", "fps", "xconv", "xconv_epilogue", "nms"):
        rows[name + "_rcnn_eval"]["launches"] = report["launches_per_forward"][name]
    if not report["launches_per_forward"]["xconv_epilogue"]:
        del rows["xconv_epilogue_rcnn_eval"]
    report["xconv_max_abs_err"] = rows["xconv_rcnn_eval"]["max_abs_err"]
    report["handoff"] = dict(dirs=dirs, ckpts=ckpts)  # step 12's bf16 evaluation reads them
    finish_rows(rows)
    del first
    torch.cuda.empty_cache()
    return report, rows


# Step 11, export: the batch-4 switches-on detector through
# `runtime.export`, loaded and run in a fresh process on inputs of another
# seed. Its outputs against the eager forward's: boxes within
# EXPORT_RTOL |eager| + EXPORT_ATOL, classes, valid flags and counts exact.
EXPORT_ATOL = EXPORT_RTOL = 1e-4
EXPORT_SEED = 1
# The CUDA functions of each kernel, as the profiler names them.
KERNEL_FUNCTIONS = {
    "knn": ("knn_brute_kernel", "knn_sorted_kernel"), "knn_prep": ("knn_prep_kernel",),
    "fps": ("fps_kernel",), "nms": ("nms_kernel",), "xconv": ("xconv_kernel",),
    "xconv_epilogue": ("xconv_split_epilogue",), "conv": ("conv3x3_kernel",),
    "convt": ("convt3x3_kernel",), "crop": ("crop_gather_kernel",),
}
# The fresh process: imports torch and the port only, loads the artifact,
# runs it on a batch of EXPORT_SEED (warm-up, then timed with CUDA events),
# profiles one forward (launches by CUDA function name; a kernel of its own
# opens the trace, whose first records the profiler was seen to drop),
# saves inputs and outputs, prints one JSON line.
LOADED_CHILD = r"""
import json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from heterofusionrcnn_torch.configs.presets import rpn_multiclass
from heterofusionrcnn_torch.inference import random_batch
from heterofusionrcnn_torch.runtime.export import load_exported

path, out, seed, batch, iters = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:6])
t0 = time.perf_counter()
forward = load_exported(path)
load_s = time.perf_counter() - t0
host = random_batch(rpn_multiclass(), batch, seed)
keys = ("point_cloud", "image_input", "stereo_calib_p2")
inputs = [torch.from_numpy(host[k]).cuda() for k in keys]
t0 = time.perf_counter()
result = forward(*inputs)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(iters):
    forward(*inputs)
end.record()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    torch.ones(1, device="cuda").add_(1)  # the trace's first kernel: none of the forward's
    torch.cuda.synchronize()
    forward(*inputs)
    torch.cuda.synchronize()
kernels = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
busy = sum(e.device_time_total for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0) / 1e3
torch.save({"inputs": [t.cpu() for t in inputs],
            "outputs": {k: v.cpu() for k, v in result.items()}}, out)
print(json.dumps(dict(load_s=load_s, first_forward_s=first_s,
                      ms=start.elapsed_time(end) / iters, device_busy_ms=busy,
                      kernels=kernels)))
"""


def launches_by_function(names_counts):
    """{CUDA function of KERNEL_FUNCTIONS: launches} from {profiler kernel
    name: count} (each template instance of a function summed)."""
    import re

    out = {}
    for fn in (f for fns in KERNEL_FUNCTIONS.values() for f in fns):
        out[fn] = sum(count for key, count in names_counts.items()
                      if re.search(rf"(?<!\w){fn}(?!\w)", key))
    return out


def launches_by_kernel(by_function):
    """{kernel: launches} from `launches_by_function`'s counts."""
    return {kernel: sum(by_function[f] for f in fns) for kernel, fns in KERNEL_FUNCTIONS.items()}


def export_phase(out_root, launches_on):
    """Step 11 (module docstring): export, a fresh process's load and run,
    its outputs and launches against the eager switches-on forward's."""
    import torch

    from heterofusionrcnn_torch.inference import build_two_stage
    from heterofusionrcnn_torch.runtime.export import export_fused_inference

    det, inputs = build_two_stage(BATCH, SEED, "cuda", conv_kernels=True, crop_kernel=True)
    randomize_batchnorm(det, SEED)
    root = os.path.abspath(os.path.join(out_root, "chip_smoke_export"))
    shutil.rmtree(root, ignore_errors=True)
    path = os.path.join(root, "two_stage.pt2")
    t0 = time.perf_counter()
    size = export_fused_inference(det, *inputs, path)
    report = dict(export_s=time.perf_counter() - t0, artifact_bytes=size)
    graph = torch.export.load(path).graph
    report["graph_ops"] = {}
    for node in graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("hfr."):
            op = str(node.target).split(".")[1]
            report["graph_ops"][op] = report["graph_ops"].get(op, 0) + 1
    del graph
    print(f"export: {report['export_s']:.1f} s, artifact {size / 1e6:.2f} MB, custom ops in the "
          f"graph {report['graph_ops']}", flush=True)

    saved = os.path.join(root, "loaded_outputs.pt")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", LOADED_CHILD, path, saved, str(EXPORT_SEED),
                           str(BATCH), str(ITERS)], cwd=root, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the loaded artifact failed in a fresh process:\n{proc.stderr}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    result = torch.load(saved)
    new = [t.cuda() for t in result["inputs"]]
    got = {k: v.cuda() for k, v in result["outputs"].items()}
    eager = det(*new)
    if set(got) != set(eager):
        raise AssertionError(f"loaded outputs {sorted(got)} != eager {sorted(eager)}")
    err = {}
    for key in ("proposals", "proposal_scores", "final_boxes", "final_scores"):
        diff = (got[key] - eager[key]).abs()
        err[key] = float(diff.max())
        if not bool((diff <= EXPORT_ATOL + EXPORT_RTOL * eager[key].abs()).all()):
            raise AssertionError(f"loaded {key} differs from the eager forward's by {err[key]}")
    for key in ("final_classes", "final_valid", "num_final"):
        if not torch.equal(got[key], eager[key]):
            raise AssertionError(f"loaded {key} differs from the eager forward's")
    traced = det(*inputs)
    for key in ("proposals", "final_boxes"):
        if torch.allclose(got[key], traced[key]):
            raise AssertionError(f"loaded {key} equal the outputs for the trace inputs")
    check_outputs(got, BATCH)

    # Every kernel as often as step 4's counted eager forward launched it,
    # and the KNN's arms alike (one prep launch a sorted-arm call): the
    # same arms and paths.
    loaded_fns = launches_by_function(child["kernels"])
    loaded = launches_by_kernel(loaded_fns)
    arms = (loaded_fns["knn_sorted_kernel"], loaded_fns["knn_brute_kernel"])
    if loaded != launches_on or arms != (launches_on["knn_prep"],
                                         launches_on["knn"] - launches_on["knn_prep"]):
        raise AssertionError(f"loaded launches {loaded_fns}, counted eager {launches_on}")
    eager_ms = cuda_ms(lambda: det(*new), ITERS)
    report.update(loaded=child, loaded_launches=loaded, launches_by_function=loaded_fns,
                  max_abs_err=err,
                  loaded_ms=child["ms"], eager_ms=eager_ms, num_final=got["num_final"].tolist())
    print(f"loaded artifact (fresh process): load {child['load_s']:.1f} s, first forward "
          f"{child['first_forward_s']:.1f} s, {child['ms']:.2f} ms per batch of {BATCH} (eager "
          f"{eager_ms:.2f}), device {child['device_busy_ms']:.2f} ms; launches {loaded}; max "
          f"|loaded - eager| {err}", flush=True)
    del det, eager, traced, got
    torch.cuda.empty_cache()
    return report


# Step 12, the bf16 serving path: the detector with `compute_dtype`
# "bfloat16" (float32 weights, the layers in bf16, the heads float32).
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 on the tensor cores
# bf16 kernel vs its plain bf16 version: 2^-7 |plain| (two bf16 ulps where
# the spacing is finest, one where it is coarsest: a float32 sum in another
# order rounds to the neighbouring value) plus 2^-8 of the call's largest
# |plain| (one ulp there: an intermediate rounding that flips ahead of a
# shift that cancels the result to about 0). As tests/test_torch_cuda.py.
BF16_RTOL = 2.0 ** -7
BF16_ATOL_SHARE = 2.0 ** -8
# The bf16 RPN's segmentation logits against the float32 RPN's on the same
# weights: within 5% of the float32 logits' largest magnitude (the
# `*_unittest` detector with randomized BatchNorm measured 0.75% and 1.1% at
# seeds 0 and 1 on the CPU; bf16 keeps 8 significant bits, 2^-9 relative a
# rounding, over ~20 rounded layers and wider sums at full width).
SEG_LOGIT_BOUND = 0.05
# bf16 card run vs CPU run at `*_unittest` width, before any top-k (the
# stage-1 features and scores): 2^-6 |cpu| + 1% of the tensor's largest
# magnitude, tests/test_torch_bf16.py's model tolerance (the kernels and the
# CPU's plain versions round to neighbouring bf16 values now and then, and
# the differences travel through the stacked layers).
BF16_MODEL_RTOL, BF16_MODEL_SCALE_SHARE = 2.0 ** -6, 0.01
BF16_SWITCHED = {"conv_bf16": 13, "convt_bf16": 3, "crop_bf16": 1}
BF16_OPS = ("knn_point", "farthest_point_sample", "oriented_nms", "fused_xconv",
            "xconv_split_epilogue", "crop_gather", "conv3x3_affine_relu",
            "convtranspose3x3_affine_relu")


def bf16_compare(got, want, name):
    """A bf16 kernel's result against its plain version within BF16_RTOL
    |plain| + BF16_ATOL_SHARE max |plain|: (max |kernel - plain|, the worst
    error in bf16 ulps of |plain| (floored at BF16_ATOL_SHARE max |plain|),
    the share of elements not bit-equal)."""
    import torch

    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16 or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against {want.dtype} "
                             f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite outputs")
    err = (g - w).abs()
    bound = BF16_RTOL * w.abs() + BF16_ATOL_SHARE * float(w.abs().max())
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name} differs from its plain version by {float(err.max())} "
                             f"(over the bound by {float((err - bound).max())})")
    # ulps of |plain|, floored at the absolute part's scale (ulps of a
    # value that cancels to about 0 say nothing).
    floor = max(BF16_ATOL_SHARE * float(w.abs().max()), 1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=floor))) - 7)
    return float(err.max()), float((err / ulp).max()), float((g != w).float().mean())


def bf16_rows(calls, reps):
    """Rows xconv_bf16, xconv_epilogue_bf16, conv_bf16, convt_bf16 and
    crop_bf16 over one bf16 forward's recorded calls: each call held against
    its plain bf16 version, timed beside the plain version and a library
    yardstick (bf16 torch.matmul of the XConv's composed product, cuDNN bf16
    conv2d / conv_transpose2d, bf16 index_select), bounded at the bf16
    tensor-core rate or the memory rate."""
    import torch
    import torch.nn.functional as F

    from heterofusionrcnn_torch.ops import conv, xconv

    bf16 = torch.bfloat16
    rows = {}

    def row(name, src, base):
        r = new_row(rows, name, f"heterofusionrcnn_torch/ops/csrc/{src}", base)
        r.update(ulps=0.0, not_bit_equal=0.0, elements=0)
        return r

    def note(r, err):
        r["max_abs_err"] = max(r["max_abs_err"], err[0])
        r["ulps"] = max(r["ulps"], err[1])

    r = row("xconv_bf16", "xconv.cu", "xconv")
    r["library_ms"] = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (pts, fts, qrs, idx, w, dtype), _ in calls["fused_xconv"]:
        if dtype != bf16:
            raise AssertionError(f"a {dtype} XConv call on the bf16 path")
        got = xconv.fused_xconv(pts, fts, qrs, idx, w, bf16)
        want = xconv.fused_xconv_plain(pts, fts, qrs, idx, w, bf16)
        err = bf16_compare(got, want, "xconv_bf16")
        note(r, err)
        r["not_bit_equal"] += err[2] * got.numel()
        r["elements"] += got.numel()
        del got, want
        ms = cuda_ms(lambda: xconv.fused_xconv(pts, fts, qrs, idx, w, bf16), reps)
        pms = cuda_ms(lambda: xconv.fused_xconv_plain(pts, fts, qrs, idx, w, bf16), 1)
        b, n = pts.shape[:2]
        _, p, k = idx.shape
        cf, cin, d = w.w1.shape[1], w.wc.shape[1], w.wc.shape[2]
        cp = cin - cf
        a = xconv.xconv_gemm_operand_bf16(pts, fts, qrs, idx, w).reshape(b * p, k * cin).to(bf16)
        wc = w.wc.reshape(k * cin, d).to(bf16)
        lms = cuda_ms(lambda: torch.matmul(a, wc), reps)
        del a, wc
        per_q = k * (2 * 3 * cf + 2 * cf * cf + 2 * k * cin + 2 * cin * d)
        if w.with_x:
            per_q += 2 * 3 * k * k * k + 2 * 2 * k * k * k
        wbytes = 4 * sum(t.numel() for f, t in vars(w).items()
                         if t is not None and f not in ("wc", "wc_operand", "wc_operand_bf16"))
        nbytes = (4 * b * n * 3 + 2 * b * n * cp + 4 * b * p * (3 + k) + 2 * b * p * d
                  + wbytes + 2 * w.wc.numel())
        flops = float(b * p * per_q)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        add_bound(r, nbytes, flops, BF16_FLOPS_PER_S)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["library_ms"] += lms
        plan = xconv.plan_xconv(b * p, k, cf, cp, d, sms, bf16)
        shape = f"{b}x{p} K{k} Cf{cf} Cin{cin} D{d}"
        r["calls"].append(dict(shape=shape, ms=ms, plain_ms=pms, matmul_ms=lms,
                               tflops=flops / ms * 1e-9, splits=plan.splits,
                               cluster=plan.cluster, bound_ms=bound, bound_share=bound / ms,
                               max_abs_err=err[0], ulps=err[1], not_bit_equal=err[2]))
        print(f"xconv_bf16 {shape}: {ms:.4f} ms, {flops / ms * 1e-9:.2f} TFLOP/s, "
              f"bound {bound:.4f} ms ({bound / ms:.3f} of it), cluster {plan.cluster}, "
              f"{plan.splits} split(s); bf16 matmul of the product {lms:.4f} ms; "
              f"max err {err[0]:.3g} ({err[1]:.2f} ulps), not bit-equal {err[2]:.4f}", flush=True)

    r = row("xconv_epilogue_bf16", "xconv.cu", "xconv_epilogue")
    for (partial, sc, bc, dtype), _ in calls["xconv_split_epilogue"]:
        got = xconv.xconv_split_epilogue(partial, sc, bc, dtype)
        want = xconv.xconv_split_epilogue_plain(partial, sc, bc, dtype)
        err = bf16_compare(got, want, "xconv_epilogue_bf16")
        note(r, err)
        r["not_bit_equal"] += err[2] * got.numel()
        r["elements"] += got.numel()
        ms = cuda_ms(lambda: xconv.xconv_split_epilogue(partial, sc, bc, dtype), reps)
        pms = cuda_ms(lambda: xconv.xconv_split_epilogue_plain(partial, sc, bc, dtype), reps)
        s_, m, d = partial.shape
        add_bound(r, 4 * partial.numel() + 2 * m * d + 8 * d, float(m * d * (s_ + 3)),
                  BF16_FLOPS_PER_S)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["calls"].append(dict(shape=f"{s_}x{m}x{d}", ms=ms, plain_ms=pms))

    # The convs: the op with its wrapper (`ms`) and the kernel alone on the
    # operands the op prepares (`kernel_ms`: the channels-last input padded
    # to 8 channels, the weight arranged once, as the op caches it); cuDNN
    # bf16 on the call's own channels-last input (`library_ms`) and on an
    # NCHW copy (`library_nchw_ms`).
    convs = (("conv_bf16", "conv.cu", "conv", conv.conv3x3_affine_relu,
              conv.conv3x3_affine_relu_plain, lambda x, w: F.conv2d(x, w, padding=1), 1,
              conv.CONV_BF16_KERNEL, "hfr_conv3x3_bf16", False),
             ("convt_bf16", "convt.cu", "convt", conv.convtranspose3x3_affine_relu,
              conv.convtranspose3x3_affine_relu_plain,
              lambda x, w: F.conv_transpose2d(x, w, stride=2), 4,
              conv.CONVT_BF16_KERNEL, "hfr_convt3x3_bf16", True))
    for name, src, base, fn, plain, library, up, kern, cfn, transposed in convs:
        r = row(name, src, base)
        r.update(library_ms=0.0, library_nchw_ms=0.0, kernel_ms=0.0)
        for (x, w, sc, sh), kw in calls[KERNEL_OPS[base]]:
            got, want = fn(x, w, sc, sh, **kw), plain(x, w, sc, sh, **kw)
            if not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"{name}: the output is not channels-last")
            err = bf16_compare(got, want, name)
            note(r, err)
            r["not_bit_equal"] += err[2] * got.numel()
            r["elements"] += got.numel()
            del got, want
            b, cin, h, wd = x.shape
            cout = sc.shape[0]
            w16 = w.to(bf16)
            x_nchw = x.contiguous()
            x8 = conv.channels_last8(x)
            wt = conv.cached_bf16_operand(w, transposed)
            relu = kw.get("relu", True)
            ms = cuda_ms(lambda: fn(x, w, sc, sh, **kw), reps)
            kms = cuda_ms(lambda: conv.launch_bf16(kern, cfn, x8, wt, sc, sh, cout, transposed,
                                                   relu), reps)
            pms = cuda_ms(lambda: plain(x, w, sc, sh, **kw), reps)
            lms = cuda_ms(lambda: library(x, w16), reps)
            lnms = cuda_ms(lambda: library(x_nchw, w16), reps)
            del x_nchw, x8
            flops = 2.0 * 9 * cin * cout * b * h * wd
            nbytes = 2 * (x.numel() + w.numel() + up * b * cout * h * wd) + 8 * cout
            bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
            add_bound(r, nbytes, flops, BF16_FLOPS_PER_S)
            r["ms"] += ms
            r["kernel_ms"] += kms
            r["plain_ms"] += pms
            r["library_ms"] += lms
            r["library_nchw_ms"] += lnms
            shape = f"{b}x{cin}x{h}x{wd}->{cout}"
            r["calls"].append(dict(shape=shape, ms=ms, kernel_ms=kms, plain_ms=pms,
                                   library_ms=lms, library_nchw_ms=lnms, bound_ms=bound,
                                   bound_share=bound / kms, tflops=flops / ms * 1e-9,
                                   kernel_tflops=flops / kms * 1e-9,
                                   library_tflops=flops / lms * 1e-9, ulps=err[1],
                                   not_bit_equal=err[2]))
            print(f"{name} {shape}: {ms:.4f} ms, kernel alone {kms:.4f} ms "
                  f"({flops / kms * 1e-9:.2f} TFLOP/s, {bound / kms:.3f} of its {bound:.4f} ms "
                  f"bound); cuDNN bf16 channels-last {lms:.4f} ms, NCHW {lnms:.4f} ms; max err "
                  f"{err[0]:.3g} ({err[1]:.2f} ulps), not bit-equal {err[2]:.4f}", flush=True)

    r = row("crop_bf16", "crop.cu", "crop")
    for (src, _, _), _ in calls[KERNEL_OPS["crop"]]:
        if src.dtype != bf16:
            raise AssertionError(f"a {src.dtype} crop on the bf16 path")
    crop_row(r, calls[KERNEL_OPS["crop"]], reps)
    for r in rows.values():
        r["not_bit_equal"] = r["not_bit_equal"] / max(r.pop("elements"), 1)
    return finish_rows(rows)


def image_branch_copies(det, inputs):
    """One forward under torch.profiler with the image branch
    (`ImgVggPyr.forward`) in a record_function range: its `aten::copy_`
    calls (each a copy kernel on the card), inside the conv ops (`hfr::*`)
    and outside them, with the op each sits under."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from heterofusionrcnn_torch.models.extractors import img_vgg_pyr

    forward = img_vgg_pyr.ImgVggPyr.forward

    def ranged(self, *args, **kwargs):
        with record_function("image_branch"):
            return forward(self, *args, **kwargs)

    with patched(img_vgg_pyr.ImgVggPyr, "forward", ranged), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det(*inputs)
        torch.cuda.synchronize()
    branch = [e for e in prof.events()
              if e.name == "image_branch" and e.device_type == DeviceType.CPU]

    def copies(e):
        return (e.name == "aten::copy_") + sum(copies(c) for c in e.cpu_children)

    under = {}
    for e in branch:
        for top in e.cpu_children:
            n = copies(top)
            if n:
                under[top.name] = under.get(top.name, 0) + n
    inside = sum(n for k, n in under.items() if k.startswith("hfr::"))
    return dict(inside_conv_ops=inside, outside_conv_ops=sum(under.values()) - inside,
                under=under, ranges=len(branch))


def bf16_small_width_agrees(seed, switches: bool):
    """The `*_unittest` detector in bf16: the RPN's outputs before any top-k
    (stage-1 features, image map, segmentation scores) on the card against
    the CPU's (plain versions), within BF16_MODEL_RTOL |cpu| +
    BF16_MODEL_SCALE_SHARE of each tensor's largest magnitude; the worst
    share of that bound used and the final counts."""
    import torch

    from heterofusionrcnn_torch.configs.presets import rcnn_unittest, rpn_unittest
    from heterofusionrcnn_torch.inference import build_two_stage

    det, inputs = build_two_stage(2, seed, "cpu", rpn_unittest(), rcnn_unittest(),
                                  conv_kernels=switches, crop_kernel=switches,
                                  compute_dtype="bfloat16")
    randomize_batchnorm(det, seed)
    want = det.rpn(*inputs)
    cuda_inputs = [t.to("cuda") for t in inputs]
    got = det.to("cuda").rpn(*cuda_inputs)
    worst = 0.0
    for key in ("rpn_fts", "rpn_img_fts", "img_feature_map", "seg_logits", "seg_softmax"):
        g, w = got[key].float().cpu(), want[key].float()
        bound = BF16_MODEL_RTOL * w.abs() + BF16_MODEL_SCALE_SHARE * float(w.abs().max())
        worst = max(worst, float(((g - w).abs() / bound).max()))
    final = det(*cuda_inputs)["num_final"].cpu().tolist()
    return worst <= 1.0, worst, final


def bf16_phase(kernels, det32, inputs, launches32, handoff, out_root):
    """Step 12 (module docstring): the bf16 detector at batch 4, switches off
    and on, counted, timed in turns against the float32 one, profiled, every
    kernel call held (rows *_bf16), its outputs checked, the small-width
    card/CPU check, and the bf16 RCNN evaluation over step 10's handoff."""
    import torch

    from heterofusionrcnn_torch.configs import config as config_lib
    from heterofusionrcnn_torch.core.rotated_iou import box_3d_iou
    from heterofusionrcnn_torch.experiments import common, run_evaluation
    from heterofusionrcnn_torch.inference import build_two_stage
    from heterofusionrcnn_torch.runtime import evaluator

    t_phase = time.perf_counter()
    report = {}
    dets = {}
    for switches in (False, True):
        d16, inp16 = build_two_stage(BATCH, SEED, "cuda", conv_kernels=switches,
                                     crop_kernel=switches, compute_dtype="bfloat16")
        randomize_batchnorm(d16, SEED)
        if not all(torch.equal(a, c) for a, c in zip(inputs, inp16)):
            raise AssertionError("the bf16 detector has other inputs")
        sd, sd16 = det32.state_dict(), d16.state_dict()
        if sd.keys() != sd16.keys() or not all(
                sd16[k].dtype == sd[k].dtype and torch.equal(sd[k], sd16[k]) for k in sd):
            raise AssertionError("the bf16 detector has other (or non-float32) weights")
        dets[switches] = d16
    det32_on, _ = build_two_stage(BATCH, SEED, "cuda", conv_kernels=True, crop_kernel=True)
    randomize_batchnorm(det32_on, SEED)

    float_kernels = ("xconv", "xconv_epilogue", "conv", "convt", "crop")
    outs = {}
    for switches in (False, True):
        with recording(BF16_OPS) as calls:
            dets[switches](*inputs)
        torch.cuda.synchronize()
        out, launches = counted_forward(dets[switches], inputs, kernels)
        outs[switches] = out
        key = "on" if switches else "off"
        report[f"launches_per_forward_switches_{key}"] = launches
        want = {k: launches32[k] for k in ("knn", "knn_prep", "fps", "nms")}
        want.update({k: 0 for k in float_kernels})
        want["xconv_bf16"] = launches32["xconv"]
        want["xconv_epilogue_bf16"] = len(calls["xconv_split_epilogue"])
        want.update({k: (v if switches else 0) for k, v in BF16_SWITCHED.items()})
        if launches != want:
            raise AssertionError(f"bf16 forward (switches {key}) launches {launches} != {want}")
        report[f"num_final_switches_{key}"] = check_outputs(out, BATCH)
        if switches:
            calls_on = calls
        else:
            del calls
    # KNN, FPS and NMS of the bf16 forward: float32 coordinates and scores,
    # bit-exact against their plain versions.
    for op, name in (("knn_point", "knn"), ("farthest_point_sample", "fps"),
                     ("oriented_nms", "nms")):
        for args, kw in calls_on[op]:
            check_index_exact(name, args, kw)
    report["index_exact_calls"] = {op: len(calls_on[op]) for op in
                                   ("knn_point", "farthest_point_sample", "oriented_nms")}

    turns = {}
    for key, d32, d16 in (("off", det32, dets[False]), ("on", det32_on, dets[True])):
        turns[key] = [cuda_ms(lambda: d(*inputs), ITERS) for d in (d32, d16, d16, d32)]
        print(f"bf16 forward, switches {key}: {(turns[key][1] + turns[key][2]) / 2:.2f} ms per "
              f"batch of {BATCH} against float32's {(turns[key][0] + turns[key][3]) / 2:.2f} "
              f"(turns {' '.join(f'{t:.2f}' for t in turns[key])})", flush=True)
    report["turns_ms_f32_bf16_bf16_f32"] = turns
    report["profile_switches_on"] = profile_forward(dets[True], inputs, top=20)
    report["crop_stage"] = crop_stage(dets[True], inputs, "bf16")
    copies = image_branch_copies(dets[True], inputs)
    report["image_branch_copies_switches_on"] = copies
    print(f"bf16 switches on, copy kernels of the image branch: {copies}", flush=True)
    if copies["inside_conv_ops"] > 1:
        raise AssertionError(f"the bf16 conv ops copy more than the first layer's input: {copies}")
    report["device_busy_share_switches_on"] = (report["profile_switches_on"]["device_busy_ms"]
                                               / ((turns["on"][1] + turns["on"][2]) / 2))
    report["profile_switches_off"] = profile_forward(dets[False], inputs, top=20)
    report["device_busy_share_switches_off"] = (report["profile_switches_off"]["device_busy_ms"]
                                                / ((turns["off"][1] + turns["off"][2]) / 2))

    # The RPN's segmentation logits against the float32 RPN's; the float32
    # detector's final boxes matched by a bf16 box at BEV IoU >= 0.7.
    seg32 = det32.rpn(*inputs)["seg_logits"]
    seg16 = dets[False].rpn(*inputs)["seg_logits"]
    scale = float(seg32.abs().max())
    seg_err = float((seg16 - seg32).abs().max())
    report["seg_logits"] = dict(max_abs_diff=seg_err, f32_scale=scale, share=seg_err / scale)
    print(f"bf16 seg logits: max |bf16 - float32| {seg_err:.4g} at scale {scale:.4g} "
          f"({seg_err / scale:.4f}, bound {SEG_LOGIT_BOUND})", flush=True)
    if seg_err > SEG_LOGIT_BOUND * scale:
        raise AssertionError(f"bf16 seg logits off the float32 ones by {seg_err} at {scale}")
    def matched(ref, other):
        """Final boxes of `ref` matched by a box of `other` at BEV IoU >= 0.7."""
        hit = total = 0
        for b in range(BATCH):
            n_ref, n_other = int(ref["num_final"][b]), int(other["num_final"][b])
            if n_ref and n_other:
                iou = box_3d_iou(ref["final_boxes"][b, :n_ref],
                                 other["final_boxes"][b, :n_other])[1]
                hit += int((iou.max(1).values >= 0.7).sum())
            total += n_ref
        return hit, total

    # A yardstick for that share: the float32 detector with every weight
    # moved by a bf16-sized relative step, 2^-8 N(0, 1).
    out32 = det32(*inputs)
    det32p, _ = build_two_stage(BATCH, SEED, "cuda")
    randomize_batchnorm(det32p, SEED)
    gen = torch.Generator().manual_seed(SEED)
    for prm in det32p.parameters():
        prm.mul_(1 + 2.0 ** -8 * torch.randn(prm.shape, generator=gen).to(prm.device))
    hit, total = matched(out32, outs[False])
    hit_p, total_p = matched(out32, det32p(*inputs))
    report["final_boxes_matched_iou07"] = hit / max(total, 1)
    report["final_boxes_matched_iou07_perturbed_f32"] = hit_p / max(total_p, 1)
    print(f"float32 final boxes matched by a bf16 box at BEV IoU >= 0.7: {hit} of {total} "
          f"(by the float32 detector with its weights moved by 2^-8 N(0, 1): {hit_p} of "
          f"{total_p})", flush=True)
    del out32, outs, det32p

    rows = bf16_rows(calls_on, REPS)
    del calls_on
    for name, r in rows.items():
        r["launches"] = report["launches_per_forward_switches_on"][name]
    if not rows["xconv_epilogue_bf16"]["launches"]:
        del rows["xconv_epilogue_bf16"]
    del dets, det32_on
    torch.cuda.empty_cache()

    for switches in (False, True):
        agree, worst, final = bf16_small_width_agrees(SEED, switches)
        key = "on" if switches else "off"
        report[f"small_width_agrees_switches_{key}"] = [agree, worst, final]
        print(f"bf16 rpn_unittest card vs CPU (switches {key}): worst share of the bound "
              f"{worst:.3f}", flush=True)
        if not agree:
            raise AssertionError(f"bf16 small-width card run disagrees with the CPU run "
                                 f"(switches {key}): {worst}")

    # Val mode: the RCNN's evaluation over step 10's handoff from a pipeline
    # config whose model_config.compute_dtype is "bfloat16", batch 1.
    cfg_dir = os.path.join(out_root, "chip_smoke_bf16_config")
    os.makedirs(cfg_dir, exist_ok=True)
    cfg = common.resolve_config("rcnn_multiclass")
    cfg.model_config.compute_dtype = "bfloat16"
    cfg_path = os.path.join(cfg_dir, "rcnn_multiclass.json")
    config_lib.save_config(cfg, cfg_path)
    root = os.path.join(out_root, "chip_smoke_bf16_eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "rcnn_multiclass"))
    os.symlink(handoff["ckpts"], os.path.join(root, "rcnn_multiclass", "checkpoints"))
    apply = evaluator.RcnnEvaluator._apply
    forwards = []

    def counted_apply(self, batch):
        if self.model.dtype != torch.bfloat16:
            raise AssertionError("the RCNN evaluator's model is not bf16")
        for kern in kernels.values():
            kern.launches = 0
        out = apply(self, batch)
        torch.cuda.synchronize()
        forwards.append({k: kern.launches for k, kern in kernels.items()})
        return out

    with patched(evaluator.RcnnEvaluator, "_apply", counted_apply):
        summary, = run_evaluation.main([
            "--pipeline_config", cfg_path, "--dataset_dir", KITTI_DIR, "--output_root", root,
            "--data_split", "val", "--num_rois", str(RCNN_EVAL_ROIS), "--eval_batch_size", "1",
            "--proposal_dir", handoff["dirs"][0], "--proposal_iou_dir", handoff["dirs"][1],
            "--rpn_feature_dir", handoff["dirs"][2]])
    step = summary["global_step"]
    pred = os.path.join(root, "rcnn_multiclass", "predictions")
    frames = sorted(os.path.splitext(n)[0] for n in os.listdir(
        os.path.join(pred, "final_predictions_and_scores", "val", str(step))))
    if not frames or len(forwards) != len(frames):
        raise AssertionError(f"{len(forwards)} bf16 RCNN eval forwards for {frames}")
    per_forward = {"knn": 4, "fps": 3, "xconv_bf16": 4, "nms": 1}
    for f in forwards:
        got = {k: f[k] for k in per_forward}
        others = {k: v for k, v in f.items()
                  if k not in per_forward and k != "xconv_epilogue_bf16" and v}
        if got != per_forward or others:
            raise AssertionError(f"bf16 RCNN eval forward launches {f}")
    check_rcnn_eval_files(pred, step, frames)
    tstats = summary["inference_time_stats"]
    report["rcnn_eval"] = dict(step=step, frames=len(frames), launches_per_forward=forwards[0],
                               ms_per_frame={k: v * 1e3 for k, v in tstats.items()},
                               avg_cls_acc=summary["avg_cls_acc"])
    print(f"bf16 RCNN eval: {len(frames)} frames, {RCNN_EVAL_ROIS} RoIs a frame, ms per frame "
          f"(host clock) median {tstats['median'] * 1e3:.2f} mean {tstats['mean'] * 1e3:.2f}; "
          f"launches a forward {forwards[0]}", flush=True)
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"bf16 phase: {report['phase_s']:.1f} s", flush=True)
    return report, rows


# Step 13, data parallelism: runs of ranks in spawned processes, each
# joined within DP_DEADLINE_S (a dead rank fails the phase, not the card).
DP_STEPS = 2
DP_DEADLINE_S = 300
# Launched by every rank's train step: the full-width RPN's KNN takes the
# sorted arm (with its prep) for its large sets; the rcnn_unittest RCNN's
# sets are all below KNN_SORTED_MIN_N (the brute arm, RCNN_KERNELS).
DP_KERNELS = ("knn", "knn_prep", "fps")
# The full-width RPN's image branch: its float32 gradients at batch 2
# resolve only to a few hundredths of a tensor's largest |element|. Two
# ranks of one frame each sum in another order than one process: they run
# their convolutions at batch 1 (cuDNN's batch-1 algorithms) and form
# BatchNorm's moments from all-reduced per-frame sums, and the fast
# variance E[x^2] - E[x]^2 cancels in channels of a large mean. Measured on
# an H100 (five runs of `tools/dp_gate_runs.py`): one process at batch 2
# lies up to 0.057 of the largest |element| from the same steps in the
# ranks' order, and as far with only its convolutions frame by frame (the
# convolutions' order moves nothing measurable; BatchNorm's moments move
# it all); the ranks lie 1.8e-5 to 2.8e-3 from the steps in their order.
# So the two gloo ranks are held against this process's steps in the ranks'
# summation order (`frames_as_ranks`), their image-branch gradients within
# DP_IMAGE_GRAD_SHARE x the tensor's largest |element| (every other
# gradient as `params_agree` holds it): the 0.05 they were held to against
# the steps at batch 2, which one of those five runs exceeded. Both
# resolutions are printed every run.
DP_IMAGE_GRAD_SHARE = 5e-2


@contextlib.contextmanager
def frames_as_ranks(moments=True):
    """One process in the summation order of ranks of one frame each: every
    2-D convolution and transposed convolution of a batch of more than one
    frame run frame by frame, forward and backward (cuDNN's batch-1
    algorithms), the frames' outputs stacked; and, with `moments`,
    BatchNorm's training moments from each frame's sums of x and x^2 added
    in frame order (what the ranks' all-reduce adds)."""
    import torch
    import torch.nn.functional as F

    from heterofusionrcnn_torch.models.extractors import layers

    saved = {name: getattr(F, name) for name in ("conv2d", "conv_transpose2d")}
    batch_moments = layers.batch_moments

    def per_frame(fn):
        def run(x, *args, **kwargs):
            if x.dim() != 4 or x.shape[0] == 1:
                return fn(x, *args, **kwargs)
            return torch.cat([fn(x[i:i + 1], *args, **kwargs) for i in range(x.shape[0])])
        return run

    def per_frame_moments(xs, channel_dim, group=None):
        if group is not None or xs.shape[0] == 1:
            return batch_moments(xs, channel_dim, group)
        dims = [d for d in range(xs.dim()) if d != channel_dim % xs.dim()]
        c = xs.shape[channel_dim]
        sums = sum(torch.cat([f.sum(dims), (f * f).sum(dims)]) for f in xs.split(1))
        count = xs.numel() // c
        return sums[:c] / count, sums[c:] / count

    for name, fn in saved.items():
        setattr(F, name, per_frame(fn))
    if moments:
        layers.batch_moments = per_frame_moments
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(F, name, fn)
        layers.batch_moments = batch_moments


def rank_group(rank, world_size, init_method, backend, timeout_s):
    """A spawned rank's process group on the card: at world size 1 a real
    one-rank group (which `initialize_distributed` would not form), else
    `initialize_distributed`'s, NCCL ranks on cuda:LOCAL_RANK (the rank)."""
    import datetime

    import torch
    import torch.distributed as dist

    from heterofusionrcnn_torch.parallel import distributed

    if world_size > 1:
        return distributed.initialize_distributed(rank, world_size, init_method, "cuda",
                                                  backend)["group"]
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init_method, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=torch.device("cuda", 0))
    return dist.group.WORLD


def dp_rank(rank, world_size, init_method, spec_path, out_dir, backend):
    """One rank of step 13 on the card: `run_steps` of the saved spec in a
    group of `backend` (`rank_group`), each step counted and timed
    (`StepMonitor`), one KNN and one FPS call of the second step held
    bit-exact, the all-reduces of the steps counted, then the gradient
    all-reduce timed alone; results to <out_dir>/rank<rank>.pt."""
    import torch
    import torch.distributed as dist

    from heterofusionrcnn_torch.experiments.common import make_rcnn_train_step
    from heterofusionrcnn_torch.ops import grouping, sampling
    from heterofusionrcnn_torch.parallel import distributed
    from heterofusionrcnn_torch.parallel.mesh import all_reduce_flat
    from heterofusionrcnn_torch.runtime.train_state import make_rpn_train_step
    from tests import torch_dp_worker

    spec = torch.load(spec_path, weights_only=False)
    group = rank_group(rank, world_size, init_method, backend, DP_DEADLINE_S)
    try:
        kernels = {"knn": grouping.KNN_KERNEL, "knn_prep": grouping.KNN_PREP_KERNEL,
                   "fps": sampling.FPS_KERNEL}
        monitor = StepMonitor(kernels, make_rpn_train_step if spec["kind"] == "rpn"
                              else make_rcnn_train_step)
        reduced = []
        all_reduce = dist.all_reduce

        def counted(t, *args, **kwargs):
            reduced.append(t.numel() * t.element_size())
            return all_reduce(t, *args, **kwargs)

        with patched(dist, "all_reduce", counted), torch.enable_grad():
            res = torch_dp_worker.run_steps(spec, group, "cuda", monitor.factory)
        for name in ("knn", "fps"):
            check_index_exact(name, *monitor.calls[KERNEL_OPS[name]][0])
        # The step's one all-reduce: every gradient and the loss shares.
        n = sum(t.numel() for t in res["steps"][0]["optimizer"]["state"]["mu"].values())
        buf = torch.zeros(n + len(res["steps"][0]["metrics"]), device="cuda")
        all_reduce_flat([buf], group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            all_reduce_flat([buf], group)
        torch.cuda.synchronize()
        res.update(rank=rank, backend=backend, launches=[s["launches"] for s in monitor.steps],
                   steps_ms=[s["ms"] for s in monitor.steps],
                   all_reduces_per_step=len(reduced) / DP_STEPS,
                   all_reduce_bytes_per_step=sum(reduced) / DP_STEPS,
                   grad_all_reduce_bytes=buf.numel() * buf.element_size(),
                   grad_all_reduce_ms=(time.perf_counter() - t0) * 1e3 / REPS)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown_distributed()


def dp_grads_close(got, want, name):
    """The full-width RPN's gradient tolerance of step 13: PARAM_TOL, and in
    the image branch an atol of DP_IMAGE_GRAD_SHARE x the tensor's largest
    |element| where that is larger."""
    share = DP_IMAGE_GRAD_SHARE if name.startswith("img_vgg_pyr.") else 0.0
    atol = max(PARAM_TOL["atol"], share * float(want.abs().max()))
    return bool(((got - want).abs() <= atol + PARAM_TOL["rtol"] * want.abs()).all())


def step_grads(got, ref):
    """Per step of `got` (each step from `ref`'s state before it), the
    step's gradients read from Adam's first moment."""
    from heterofusionrcnn_torch.runtime.optimizer import ADAM_B1

    out = []
    for i, st in enumerate(got["steps"]):
        before = ref["steps"][i - 1]["optimizer"]["state"]["mu"] if i else None
        out.append({n: (m.cpu() - (ADAM_B1 * before[n] if i else 0.0)) / (1 - ADAM_B1)
                    for n, m in st["optimizer"]["state"]["mu"].items()})
    return out


def grad_shares(got, want):
    """The largest |got - want| of a gradient over its largest |want|, the
    largest of these in the image branch and elsewhere (gradients of 0 in
    exact arithmetic, largest |want| <= 1e-5, aside)."""
    out = {"image branch": 0.0, "other": 0.0}
    for n, w in want.items():
        scale = float(w.abs().max())
        if scale > 1e-5:
            part = "image branch" if n.startswith("img_vgg_pyr.") else "other"
            out[part] = max(out[part], float((got[n] - w).abs().max()) / scale)
    return out


def dp_steps_agree(got, want, lr, grads_close=None):
    """One rank's steps (each from the one-process state before it) against
    the one-process steps: per step the metrics within LOSS_TOL and
    `params_agree` on the module state and on the EMA, the gradients read
    from Adam's first moment. Returns the failures and, per step, the
    elements widened by 2 x lr."""
    from heterofusionrcnn_torch.runtime.optimizer import ADAM_B1

    bad, widened = [], []
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        for key, val in w["metrics"].items():
            if abs(g["metrics"][key] - val) > LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(val):
                bad.append(f"step {i + 1} {key}")
        before = want["steps"][i - 1]["optimizer"]["state"]["mu"] if i else None

        def grads(st):
            return {n: (m - (ADAM_B1 * before[n] if i else 0.0)) / (1 - ADAM_B1)
                    for n, m in st["optimizer"]["state"]["mu"].items()}

        gg, gw = grads(g), grads(w)
        step_bad, noise = params_agree(g["state_dict"], w["state_dict"], gg, gw, lr, grads_close)
        for n in step_bad:  # how far a failing gradient is off, for the message
            if n.startswith("gradient of "):
                d = (gg[n[12:]].cpu() - gw[n[12:]]).abs()
                scale = float(gw[n[12:]].abs().max())
                print(f"step {i + 1} {n}: largest |difference| {float(d.max()):.3g} = "
                      f"{float(d.max()) / scale:.3g} x the largest |gradient| {scale:.3g}; "
                      f"{int((d > PARAM_TOL['atol'] + PARAM_TOL['rtol'] * gw[n[12:]].abs()).sum())}"
                      f" of {d.numel()} outside", flush=True)
        ema_bad, _ = params_agree(g["optimizer"]["ema"], w["optimizer"]["ema"], gg, gw, lr,
                                  grads_close)
        bad += [f"step {i + 1} {n}" for n in step_bad] + [f"step {i + 1} EMA {n}" for n in ema_bad]
        widened.append(sum(noise.values()))
    return bad, widened


def dp_run(spec, world, backend, root, label, grads_close=None, kernels=DP_KERNELS,
           agree=None, in_ranks_order=False):
    """`spec`'s steps in this process (no group) and on `world` ranks of
    `backend` (each step from this process's state before it): the checks
    of step 13 (module docstring; `agree(got, want, lr)` in place of
    `dp_steps_agree`), each rank's steps launching `kernels`. With
    `in_ranks_order` this process runs in the ranks' summation order
    (`frames_as_ranks`); the same steps again from its states at batch 2,
    and with only the convolutions frame by frame, give the resolutions
    printed (`grad_shares` against the steps in the ranks' order), and each
    rank's differences from the steps in its order and at batch 2. Returns
    the report."""
    import torch

    from heterofusionrcnn_torch.parallel.distributed import spawn_ranks
    from tests import torch_dp_worker

    with torch.enable_grad(), (frames_as_ranks() if in_ranks_order
                               else contextlib.nullcontext()):
        want = torch_dp_worker.run_steps(spec, None, "cuda")
    torch.cuda.empty_cache()
    spec = dict(spec, restarts=[None] + [{k: st[k] for k in ("state_dict", "optimizer")}
                                         for st in want["steps"][:-1]])
    resolution = None
    if in_ranks_order:
        with torch.enable_grad():
            batch2 = step_grads(torch_dp_worker.run_steps(spec, None, "cuda"), want)
            with frames_as_ranks(moments=False):
                convs = step_grads(torch_dp_worker.run_steps(spec, None, "cuda"), want)
        torch.cuda.empty_cache()
        ref = step_grads(want, want)
        resolution = {"batch 2": [grad_shares(g, w) for g, w in zip(batch2, ref)],
                      "convolutions frame by frame": [grad_shares(g, w)
                                                      for g, w in zip(convs, ref)]}
        print(f"{label}: this process's steps against the same steps in the ranks' summation "
              "order (frames_as_ranks), largest |difference| / largest |gradient| per step: "
              + "; ".join(f"{form}: " + " | ".join(", ".join(f"{k} {v:.3g}" for k, v in r.items())
                                                   for r in per_step)
                          for form, per_step in resolution.items())
              + f" (the ranks' image branch is held within {DP_IMAGE_GRAD_SHARE} of the steps in "
              "their order)", flush=True)
    out = os.path.join(root, label)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    spec_path = os.path.join(out, "spec.pt")
    torch.save(spec, spec_path)
    t0 = time.perf_counter()
    spawn_ranks(dp_rank, world, args=(spec_path, out, backend), timeout_s=DP_DEADLINE_S,
                rendezvous_dir=out)
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    lr = spec["cfg"].train_config.optimizer.initial_learning_rate
    report = dict(label=label, world=world, backend=backend, wall_s=wall_s,
                  one_process_metrics=[st["metrics"] for st in want["steps"]], ranks=[],
                  in_ranks_order=in_ranks_order, resolution=resolution)
    for res in ranks:
        if in_ranks_order:
            got = step_grads(res, want)
            shares = {"in the ranks' order": [grad_shares(g, w) for g, w in zip(got, ref)],
                      "batch 2": [grad_shares(g, w) for g, w in zip(got, batch2)]}
            print(f"{label} rank {res['rank']}: largest |difference| / largest |gradient| per "
                  "step against the one-process steps " + "; ".join(
                      f"{against}: " + " | ".join(", ".join(f"{k} {v:.3g}" for k, v in r.items())
                                                  for r in per_step)
                      for against, per_step in shares.items()), flush=True)
        bad, widened = (agree(res, want, lr) if agree
                        else dp_steps_agree(res, want, lr, grads_close))
        if bad:
            raise AssertionError(f"{label} rank {res['rank']} differs from one process: {bad[:8]}")
        for i, launched in enumerate(res["launches"]):
            if not all(launched[k] for k in kernels):
                raise AssertionError(f"{label} rank {res['rank']} step {i + 1} launches {launched}")
        share = res["grad_all_reduce_ms"] / res["steps_ms"][-1]  # of the warm step
        report["ranks"].append(dict(
            rank=res["rank"], steps_ms=res["steps_ms"], launches=res["launches"],
            grad_shares=shares if in_ranks_order else None,
            widened=widened, metrics=[st["metrics"] for st in res["steps"]],
            all_reduces_per_step=res["all_reduces_per_step"],
            all_reduce_bytes_per_step=res["all_reduce_bytes_per_step"],
            grad_all_reduce_bytes=res["grad_all_reduce_bytes"],
            grad_all_reduce_ms=res["grad_all_reduce_ms"], grad_all_reduce_share=share))
        print(f"{label} rank {res['rank']}/{world} ({backend}): steps "
              + " ".join(f"{t:.2f}" for t in res["steps_ms"])
              + f" ms; {res['all_reduces_per_step']:.0f} all-reduces a step "
              f"({res['all_reduce_bytes_per_step'] / 1e6:.3f} MB); the gradient all-reduce "
              f"alone {res['grad_all_reduce_bytes'] / 1e6:.3f} MB in "
              f"{res['grad_all_reduce_ms']:.3f} ms ({share:.3f} of the second step); launches "
              "a step "
              + "; ".join(" ".join(f"{k}={v}" for k, v in l.items() if k in kernels)
                          for l in res["launches"])
              + f"; {widened} elements widened by 2 x lr; agrees with one process", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return report


def dp_phase(out_root):
    """Step 13 (module docstring): NCCL at world size 1, two gloo ranks on
    the card at full width (RPN) and at rcnn_unittest width (RCNN), and the
    CLI's guard."""
    from heterofusionrcnn_torch.experiments import common, run_training
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from heterofusionrcnn_torch.runtime.train_state import RPN_BATCH_KEYS
    from tests import torch_dp_worker
    from tests.rcnn_fixtures import grads_agree, write_handoff

    root = os.path.join(out_root, "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    card = card_line()
    print(f"data parallelism on {card}: ranks that share one card say nothing of "
          "multi-card speed; NCCL runs at world size 1 only on a single card", flush=True)
    report = dict(card=card)

    def spec(kind, cfg, batches):
        cfg.train_config.optimizer.use_moving_average = True  # the EMA is held too
        cfg.train_config.optimizer.moving_average_decay = 0.9
        model, _ = torch_dp_worker.build(kind, cfg)
        init_weights(model, SEED)
        return dict(kind=kind, cfg=cfg, state_dict=model.state_dict(), seed=SEED,
                    batches=batches)

    cfg = common.resolve_config("rpn_multiclass", KITTI_DIR)
    dataset = common.build_dataset(cfg, "train", "train")
    dataset.seed(SEED)
    next_batch = common.make_batch_fn(cfg, dataset, "rpn", 2)
    rpn = spec("rpn", cfg, [next_batch() for _ in range(DP_STEPS)])
    if set(rpn["batches"][0]) != set(RPN_BATCH_KEYS):
        raise AssertionError(f"batch keys {sorted(rpn['batches'][0])}")
    report["nccl_world1"] = dp_run(rpn, 1, "nccl", root, "rpn_multiclass_nccl_w1")
    report["gloo_rpn"] = dp_run(rpn, 2, "gloo", root, "rpn_multiclass_gloo_w2", dp_grads_close,
                                in_ranks_order=True)

    cfg = common.resolve_config("rcnn_unittest", KITTI_DIR)
    dataset = common.build_dataset(cfg, "train", "train")
    dataset.seed(SEED)
    dataset.proposal_dir, dataset.proposal_iou_dir, dataset.rpn_feature_dir = write_handoff(
        dataset, os.path.join(root, "rcnn_handoff"))
    next_batch = common.make_batch_fn(cfg, dataset, "rcnn", 2)
    rcnn = spec("rcnn", cfg, [next_batch() for _ in range(DP_STEPS)])
    report["gloo_rcnn"] = dp_run(rcnn, 2, "gloo", root, "rcnn_unittest_gloo_w2", grads_agree,
                                 RCNN_KERNELS)
    if not all(m["rcnn_reg_loss"] > 0 for m in report["gloo_rcnn"]["one_process_metrics"]):
        raise AssertionError("an rcnn_unittest step without a positive RoI")

    started = []
    with patched(run_training, "spawn_ranks", lambda *a, **k: started.append(a)):
        try:
            run_training.main(["--pipeline_config", "rpn_multiclass", "--num_devices", "2",
                               "--dataset_dir", KITTI_DIR, "--output_root", root])
        except ValueError as exc:
            report["cli_guard"] = str(exc)
        else:
            raise AssertionError("run_training --num_devices 2 did not raise on one card")
    if started:
        raise AssertionError("run_training started ranks before its guard")
    print(f"run_training --num_devices 2 on one card: {report['cli_guard']}", flush=True)
    return report


# Step 14, bf16 training (cell I): cell C and cell D with `compute_dtype`
# "bfloat16" through the CLIs, the val forwards after the bf16 steps, one
# bf16 step on the card against the CPU at each stage's unittest width, and
# two gloo ranks in bf16.
BF16_TURN_STEPS = 3            # steps a turn when float32 and bf16 steps are timed in turns
BF16_RCNN_STEPS = 6
# Launched by no bf16 train step: training runs the XConv's layers one by
# one (the fused kernels are inference-only, as in JAX), and no NMS.
BF16_TRAIN_OFF = ("xconv", "xconv_epilogue", "xconv_bf16", "xconv_epilogue_bf16", "nms")
# bf16 resolution, tests/test_torch_parallel.py's bf16 tolerances (two
# evaluations of one bf16 step that sum in other orders): losses within
# 2^-7 relative; a step gradient within BF16_GRAD_SHARE of the tensor's
# largest |element| and BF16_GRAD_L2 in relative L2 norm, per part (the
# image branch, everything else), the biases that a training BatchNorm
# follows (0 in exact arithmetic) aside; a parameter or EMA entry within
# PARAM_TOL plus its Adam update's sensitivity 2 x lr |dg| / sqrt(v_hat),
# at most 2 x lr (the elements at that cap counted); a BatchNorm statistic
# within BF16_STATS_SHARE of its largest |element| and BF16_STATS_ATOL.
BF16_LOSS_RTOL = 2.0 ** -7
BF16_GRAD_SHARE = (0.35, 0.25)
BF16_GRAD_L2 = (0.2, 0.15)
BF16_STATS_SHARE = 1e-2
BF16_STATS_ATOL = 1e-6
BN_FOLLOWED_BIAS = re.compile(r"\.(Conv_0|ConvTranspose_0)\.bias$|\.X_1\.BatchNorm_0\.bias$")


def bf16_params_agree(got, want, grads_got, grads_want, nu, count, lr):
    """State dict `got` against `want` after a bf16 step, at bf16 resolution
    (BF16_GRAD_SHARE and the rest above): `nu` is `want`'s Adam second
    moment after `count` steps. Returns the names outside, the count of
    elements at the 2 x lr cap and the worst gradient (share, L2) per part."""
    import torch

    from heterofusionrcnn_torch.runtime.optimizer import ADAM_B2, ADAM_EPS

    bad, capped, worst = [], 0, [[0.0, 0.0], [0.0, 0.0]]
    noise = {}
    for name, gw in grads_want.items():
        gg = grads_got[name].cpu()
        if gg.dtype != torch.float32:
            bad.append(f"gradient of {name} is {gg.dtype}")
        if BN_FOLLOWED_BIAS.search(name):
            noise[name] = 2 * lr
            continue
        part = 0 if name.startswith("img_vgg_pyr.") else 1
        err = (gg - gw).abs()
        share = float(err.max()) / max(float(gw.abs().max()), 1e-30)
        l2 = float(err.norm()) / max(float(gw.norm()), 1e-30)
        worst[part] = [max(worst[part][0], share), max(worst[part][1], l2)]
        if share > BF16_GRAD_SHARE[part] or l2 > BF16_GRAD_L2[part]:
            bad.append(f"gradient of {name} ({share:.3g} of its largest, L2 {l2:.3g})")
        v_hat = nu[name].cpu() / (1 - ADAM_B2 ** count)
        noise[name] = torch.clamp(2 * lr * err / (torch.sqrt(v_hat) + ADAM_EPS), max=2 * lr)
        capped += int((noise[name] >= 2 * lr).sum())
    for name, w in want.items():
        g = got[name].cpu()
        if not g.is_floating_point():
            continue
        if g.dtype != torch.float32:
            bad.append(f"{name} is {g.dtype}")
            continue
        if name in noise:
            bound = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * w.abs() + noise[name]
        else:  # a BatchNorm statistic
            bound = BF16_STATS_SHARE * float(w.abs().max()) + BF16_STATS_ATOL
        if not bool(((g - w).abs() <= bound).all()):
            bad.append(name)
    return bad, capped, worst


def bf16_dp_steps_agree(got, want, lr):
    """`dp_steps_agree` at bf16 resolution: per step the metrics within
    BF16_LOSS_RTOL, `bf16_params_agree` on the module state and on the EMA
    (the gradients from Adam's first moment). Returns the failures and the
    capped counts."""
    from heterofusionrcnn_torch.runtime.optimizer import ADAM_B1

    bad, capped = [], []
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        for key, val in w["metrics"].items():
            if abs(g["metrics"][key] - val) > BF16_LOSS_RTOL * abs(val):
                bad.append(f"step {i + 1} {key}")
        before = want["steps"][i - 1]["optimizer"]["state"]["mu"] if i else None

        def grads(st):
            return {n: (m - (ADAM_B1 * before[n] if i else 0.0)) / (1 - ADAM_B1)
                    for n, m in st["optimizer"]["state"]["mu"].items()}

        gg, gw = grads(g), grads(w)
        nu = w["optimizer"]["state"]["nu"]
        step_bad, n_cap, _ = bf16_params_agree(g["state_dict"], w["state_dict"], gg, gw, nu,
                                               i + 1, lr)
        ema_bad, _, _ = bf16_params_agree(g["optimizer"]["ema"], w["optimizer"]["ema"], gg, gw,
                                          nu, i + 1, lr)
        bad += [f"step {i + 1} {n}" for n in step_bad] + [f"step {i + 1} EMA {n}" for n in ema_bad]
        capped.append(n_cap)
    return bad, capped


def float32_state(state, ckpt_dir):
    """The names of every floating tensor of a train state (parameters,
    buffers, Adam moments, the EMA) and of the latest checkpoint under
    `ckpt_dir` that is not float32; raises for a checkpoint without tensors."""
    import torch

    from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager

    def floats(tree, prefix):
        if isinstance(tree, torch.Tensor):
            return [(prefix, tree)] if tree.is_floating_point() else []
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in floats(v, f"{prefix}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in floats(v, f"{prefix}/{i}")]
        return []

    saved = floats(CheckpointManager(ckpt_dir).restore_raw(), "checkpoint")
    if not saved:
        raise AssertionError(f"the checkpoint under {ckpt_dir} holds no tensors")
    every = (floats(state.model.state_dict(), "module")
             + floats(state.optimizer.state_dict(), "optimizer") + saved)
    return [name for name, t in every if t.dtype != torch.float32]


def bf16_config(preset, name, root):
    """`preset` with `compute_dtype` "bfloat16", named `name`, checkpoints
    every TRAIN_INTERVAL steps, saved as <root>/<name>.json; returns the
    config and the path."""
    from heterofusionrcnn_torch.configs.config import save_config
    from heterofusionrcnn_torch.experiments import common

    cfg = common.resolve_config(preset, KITTI_DIR)
    cfg.model_config.compute_dtype = "bfloat16"
    cfg.model_config.checkpoint_name = name
    cfg.train_config.checkpoint_interval = TRAIN_INTERVAL
    cfg.train_config.optimizer.use_moving_average = True  # the EMA is held float32 too
    path = os.path.join(root, name + ".json")
    save_config(cfg, path)
    return cfg, path


def check_train_steps(steps, on, off, label):
    """Every monitored step: finite losses, each kernel of `on` launched,
    none of `off`."""
    import numpy as np

    for s in steps:
        if not all(np.isfinite(v) for v in s["losses"].values()):
            raise AssertionError(f"{label}: non-finite losses at step {s['start'] + 1}: "
                                 f"{s['losses']}")
        launched = s["launches"]
        if not all(launched[k] for k in on) or any(launched[k] for k in off):
            raise AssertionError(f"{label} step {s['start'] + 1} launches {launched}")


def timed_steps(step, state, batch, n):
    """ms of each of n steps, host clock between two synchronisations."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def bf16_rpn_train(kernels, root, report):
    """Step 14 (a) and (b): cell C in bf16 through the CLI, its checks, the
    rows of one recorded step, the val forwards, a profiled step, float32
    and bf16 steps in turns and the loss curve. Returns the rows."""
    import copy

    import numpy as np
    import torch

    from heterofusionrcnn_torch.experiments import common, run_training
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from heterofusionrcnn_torch.models.rpn import rpn_loss
    from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
    from heterofusionrcnn_torch.runtime.optimizer import build_optimizer
    from heterofusionrcnn_torch.runtime.train_state import TrainState, make_rpn_train_step

    cfg, cfg_path = bf16_config("rpn_multiclass", "rpn_multiclass_bf16", root)
    argv = ["--pipeline_config", cfg_path, "--data_split", "train", "--output_root", root,
            "--seed", str(SEED)]
    monitor = StepMonitor(kernels, make_rpn_train_step)
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad(), patched(run_training, "make_rpn_train_step", monitor.factory):
        run_training.main(argv + ["--max_iterations", str(TRAIN_STEPS)])
        state = run_training.main(argv + ["--max_iterations", str(TRAIN_RESUMED_TO)])
    rep = dict(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, steps=monitor.steps)
    starts = [s["start"] for s in monitor.steps]
    if starts != list(range(TRAIN_RESUMED_TO)) or state.step != TRAIN_RESUMED_TO:
        raise AssertionError(f"bf16 steps started at {starts}, ended at {state.step}")
    if state.model.dtype != torch.bfloat16:
        raise AssertionError("the bf16 config trained another dtype")
    ckpt_dir = os.path.join(root, "rpn_multiclass_bf16", "checkpoints")
    if CheckpointManager(ckpt_dir).all_steps() != [3, 6, 8]:
        raise AssertionError(f"bf16 checkpoints {CheckpointManager(ckpt_dir).all_steps()}")
    check_train_steps(monitor.steps, TRAIN_KERNELS, BF16_TRAIN_OFF, "bf16 RPN")
    not32 = float32_state(state, ckpt_dir)
    if not32:
        raise AssertionError(f"bf16 training left tensors off float32: {not32[:8]}")
    recorded = monitor.steps[TRAIN_RECORDED_STEP]["launches"]
    calls = monitor.calls
    if expected_launches(calls, TRAIN_KERNELS) != {k: recorded[k] for k in TRAIN_KERNELS}:
        raise AssertionError(f"recorded bf16 step calls do not match its launches {recorded}")
    for (_, xyz, _), _ in calls["knn_point"]:
        if xyz.dtype != torch.float32:
            raise AssertionError(f"a {xyz.dtype} KNN call on the bf16 path")
    step_ms = [s["ms"] for s in monitor.steps]
    rep["median_ms_after_first"] = float(np.median(step_ms[1:]))
    print(f"card: {card_line()}; bf16 RPN train steps ms (batch 2): "
          + " ".join(f"{t:.2f}" for t in step_ms) + f"; peak device memory "
          f"{rep['peak_mem_gb']:.2f} GB; losses of the last: {monitor.steps[-1]['losses']}",
          flush=True)
    rows = {}
    with torch.no_grad():
        knn_rows(rows, calls, REPS, "_bf16_train")
        fps_row(rows, calls, REPS, "_bf16_train", sweeps=False)
    for name in TRAIN_KERNELS:
        rows[name + "_bf16_train"]["launches"] = recorded[name]
    del calls, monitor.calls

    batch, dataset = train_batch(cfg, "cuda")
    rep["val"] = val_check(state, cfg, batch, kernels, bf16=True)
    print(f"bf16 val forwards after the steps: {rep['val']}", flush=True)
    step = make_rpn_train_step(lambda p: rpn_loss(p, cfg.model_config))
    rep["profile_step"] = profile_forward(lambda: step(state, batch), (), top=25)
    rep["device_busy_share"] = rep["profile_step"]["device_busy_ms"] / rep["median_ms_after_first"]
    print(f"bf16 RPN step profile: {rep['profile_step']['device_busy_ms']:.2f} ms of device "
          f"time, busy share {rep['device_busy_share']:.3f} of the median step", flush=True)
    del state
    torch.cuda.empty_cache()

    # Cell C's step in float32 and in bf16 in turns (float32, bf16, bf16,
    # float32), the same weights, batch and config but the dtype.
    states = {}
    for dtype in ("float32", "bfloat16"):
        c = copy.deepcopy(cfg)
        c.model_config.compute_dtype = dtype
        model, loss_fn = common.build_model(c, dataset, "train")
        model = init_weights(model, SEED).cuda()
        opt = build_optimizer(model, c.train_config.optimizer, 1, c.train_config.grad_clip_norm)
        states[dtype] = (make_rpn_train_step(loss_fn), TrainState.create(model, opt, SEED))
    turns = []
    with torch.enable_grad():
        for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
            step, st = states[dtype]
            turns.append((dtype, timed_steps(step, st, batch, BF16_TURN_STEPS)))
    rep["turns"] = turns
    med = {d: float(np.median([t for dd, ts in turns for t in ts[1:] if dd == d]))
           for d in ("float32", "bfloat16")}
    rep["turn_median_ms"] = med
    print("cell C's step in turns (float32, bf16, bf16, float32), ms: "
          + "; ".join(f"{d} " + " ".join(f"{t:.2f}" for t in ts) for d, ts in turns)
          + f"; median after each turn's first: float32 {med['float32']:.2f}, bf16 "
          f"{med['bfloat16']:.2f}", flush=True)
    del states
    torch.cuda.empty_cache()

    curve = loss_curve(copy.deepcopy(cfg), batch, dataset, make_rpn_train_step)
    rep["loss_curve"] = curve
    print("bf16 loss curve (one repeated batch): " + " ".join(f"{v:.4f}" for v in curve),
          flush=True)
    if not curve[-1] < curve[0]:
        raise AssertionError(f"{CURVE_STEPS} bf16 steps on one batch did not lower the loss: "
                             f"{curve}")
    del batch
    report["rpn"] = rep
    return rows


def bf16_rcnn_train(kernels, root, report):
    """Step 14 (c): the handoff from (a)'s bf16 RPN, then `rcnn_multiclass`
    in bf16 through the CLI, counted and timed, the rows of one recorded
    step. Returns the rows."""
    import numpy as np
    import torch

    from heterofusionrcnn_torch.experiments import common, run_training

    rpn_path = os.path.join(root, "rpn_multiclass_bf16.json")
    report["handoff"], dirs = handoff_phase(kernels, root, rpn_path, bf16=True)
    cfg, cfg_path = bf16_config("rcnn_multiclass", "rcnn_multiclass_bf16", root)
    argv = ["--pipeline_config", cfg_path, "--data_split", "train", "--output_root", root,
            "--seed", str(SEED), "--max_iterations", str(BF16_RCNN_STEPS), "--warm_start_from",
            os.path.join(root, "rpn_multiclass_bf16", "checkpoints"), "--proposal_dir", dirs[0],
            "--proposal_iou_dir", dirs[1], "--rpn_feature_dir", dirs[2]]
    monitor = StepMonitor(kernels, common.make_rcnn_train_step)
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad(), patched(run_training, "make_rcnn_train_step", monitor.factory):
        state = run_training.main(argv)
    rep = dict(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, steps=monitor.steps)
    if state.step != BF16_RCNN_STEPS or state.model.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 RCNN ended at step {state.step}, dtype {state.model.dtype}")
    check_train_steps(monitor.steps, RCNN_KERNELS, BF16_TRAIN_OFF, "bf16 RCNN")
    not32 = float32_state(state, os.path.join(root, "rcnn_multiclass_bf16", "checkpoints"))
    if not32:
        raise AssertionError(f"bf16 RCNN training left tensors off float32: {not32[:8]}")
    positive = sum(s["losses"]["rcnn_reg_loss"] > 0 for s in monitor.steps)
    if not positive:
        raise AssertionError("no bf16 RCNN step held a positive RoI")
    recorded = monitor.steps[TRAIN_RECORDED_STEP]["launches"]
    calls = monitor.calls
    if expected_launches(calls, ("knn", "knn_prep", "fps")) != {
            k: recorded[k] for k in ("knn", "knn_prep", "fps")}:
        raise AssertionError(f"recorded bf16 RCNN step calls do not match its launches {recorded}")
    step_ms = [s["ms"] for s in monitor.steps]
    rep.update(steps_with_positive_rois=positive,
               median_ms_after_first=float(np.median(step_ms[1:])))
    print("bf16 RCNN train steps ms (batch 1, 64 RoIs): " + " ".join(f"{t:.2f}" for t in step_ms)
          + f"; peak device memory {rep['peak_mem_gb']:.2f} GB; {positive} steps with a "
          "positive RoI", flush=True)
    rows = {}
    with torch.no_grad():
        knn_rows(rows, calls, REPS, "_bf16_rcnn_train")
        fps_row(rows, calls, REPS, "_bf16_rcnn_train", sweeps=False)
    if rows["knn_prep_bf16_rcnn_train"]["calls"] or recorded["knn_prep"]:
        raise AssertionError("a bf16 RCNN KNN call took the sorted arm")
    del rows["knn_prep_bf16_rcnn_train"]  # not on this path: every set is below 4096 points
    for name in RCNN_KERNELS:
        rows[name + "_bf16_rcnn_train"]["launches"] = recorded[name]
    del calls, monitor.calls, state
    torch.cuda.empty_cache()
    report["rcnn"] = rep
    return rows


def bf16_small_width_train(out_root):
    """Step 14 (d): one bf16 step at `rpn_unittest` and at `rcnn_unittest`
    width on the card against the CPU (`step_agrees(bf16=True)`)."""
    import copy

    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.runtime.trainer import batch_to_device
    from heterofusionrcnn_torch.runtime.train_state import make_rpn_train_step
    from tests.rcnn_fixtures import write_handoff

    out = {}
    cfg = no_dropout(common.resolve_config("rpn_unittest", KITTI_DIR))
    cfg.model_config.compute_dtype = "bfloat16"
    batch, dataset = train_batch(cfg, "cpu", SEED)
    out["rpn_unittest"] = step_agrees(cfg, batch, dataset, make_rpn_train_step, SEED, bf16=True)
    cfg = no_dropout(common.resolve_config("rcnn_unittest", KITTI_DIR))
    cfg.model_config.compute_dtype = "bfloat16"
    dataset = common.build_dataset(cfg, "train", "train")
    dataset.seed(SEED)
    root = os.path.join(out_root, "chip_smoke_bf16_rcnn_unittest")
    shutil.rmtree(root, ignore_errors=True)
    dataset.proposal_dir, dataset.proposal_iou_dir, dataset.rpn_feature_dir = write_handoff(
        dataset, root)
    batch = batch_to_device(common.make_batch_fn(cfg, dataset, "rcnn", 2)(), "cpu")
    out["rcnn_unittest"] = step_agrees(copy.deepcopy(cfg), batch, dataset,
                                       common.make_rcnn_train_step, SEED, bf16=True)
    if not out["rcnn_unittest"][1]["cpu"]["rcnn_reg_loss"] > 0:
        raise AssertionError("the bf16 rcnn_unittest step holds no positive RoI")
    for name, (agree, d) in out.items():
        print(f"{name} bf16 step, card against CPU: losses {d['cuda']} / {d['cpu']}; worst "
              f"gradient (share of its largest, L2) image branch {d['worst'][0]}, elsewhere "
              f"{d['worst'][1]} (bounds {BF16_GRAD_SHARE}, {BF16_GRAD_L2}); {d['capped']} "
              f"elements at the 2 x lr cap ({d['capped_share']:.6f} of the parameters)",
              flush=True)
        if not agree:
            raise AssertionError(f"{name} bf16 train step: card and CPU disagree: "
                                 f"{d['outside'][:8]}")
    return {k: dict(agrees=a, **d) for k, (a, d) in out.items()}


def bf16_train_phase(kernels, out_root):
    """Step 14 (module docstring): bf16 training, cells C and D in bf16 (cell
    I), the val forwards, the unittest-width card/CPU steps and two gloo
    ranks. Returns the report and the kernel rows."""
    from heterofusionrcnn_torch.experiments import common
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from tests import torch_dp_worker
    from tests.rcnn_fixtures import write_handoff

    t_phase = time.perf_counter()
    root = os.path.join(out_root, "chip_smoke_bf16_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    report = dict(card=card_line())
    rows = bf16_rpn_train(kernels, root, report)
    rows.update(bf16_rcnn_train(kernels, root, report))
    report["small_width"] = bf16_small_width_train(out_root)

    cfg = common.resolve_config("rcnn_unittest", KITTI_DIR)
    cfg.model_config.compute_dtype = "bfloat16"
    cfg.train_config.optimizer.use_moving_average = True
    cfg.train_config.optimizer.moving_average_decay = 0.9
    dataset = common.build_dataset(cfg, "train", "train")
    dataset.seed(SEED)
    dataset.proposal_dir, dataset.proposal_iou_dir, dataset.rpn_feature_dir = write_handoff(
        dataset, os.path.join(root, "rcnn_handoff"))
    next_batch = common.make_batch_fn(cfg, dataset, "rcnn", 2)
    model, _ = torch_dp_worker.build("rcnn", cfg)
    init_weights(model, SEED)
    spec = dict(kind="rcnn", cfg=cfg, state_dict=model.state_dict(), seed=SEED,
                batches=[next_batch() for _ in range(DP_STEPS)])
    report["gloo_rcnn"] = dp_run(spec, 2, "gloo", root, "rcnn_unittest_bf16_gloo_w2",
                                 kernels=RCNN_KERNELS, agree=bf16_dp_steps_agree)
    if not all(m["rcnn_reg_loss"] > 0 for m in report["gloo_rcnn"]["one_process_metrics"]):
        raise AssertionError("a bf16 rcnn_unittest step without a positive RoI")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"bf16 training phase: {report['phase_s']:.1f} s", flush=True)
    return report, finish_rows(rows)


# Step 15, the rest of stage 1 (cell J): the PointNet++ RPN, the non-fixed
# NMS path, PointCNN's ids sampling and sorted neighbourhoods, the native
# point-cloud loader.
POINTNET_PER_FORWARD = {"fps": 4, "nms": 1}  # and no KNN, KNN prep or XConv launch
STAGE1_TRAIN_STEPS = 3
STAGE1_FRAMES = ("000001", "000004")         # the fixture frames of (c)'s evaluation
# Card against CPU at `rpn_unittest` width (d): the fused XConv kernel and
# the CPU's plain version differ within the XConv gate a layer; through the
# stacked layers the features are held as `small_width_agrees` holds boxes.
STAGE1_SMALL_RTOL = STAGE1_SMALL_ATOL = 1e-3
STAGE1_OPS = ("query_ball_point", "three_nn", "three_interpolate")


def pointnet_rpn_config(name=None):
    """`rpn_multiclass` with the PointNet++ extractor of the reference's
    rpn_cars_pointnet.config shape (`rpn_pointnet_layers`)."""
    from heterofusionrcnn_torch.configs.presets import rpn_multiclass, rpn_pointnet_layers

    cfg = rpn_multiclass(KITTI_DIR)
    lc = cfg.model_config.layers_config
    lc.pc_extractor_type = "pointnet"
    lc.pc_pointnet = rpn_pointnet_layers()
    if name:
        cfg.model_config.checkpoint_name = name
    return cfg


def stage1_model(cfg, mode, kernels=None):
    """A full-width RpnModel of `cfg` in `mode` on the card, eval, with
    random weights and seeded BatchNorm statistics from SEED."""
    from heterofusionrcnn_torch.inference import CLUSTER_SIZES
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from heterofusionrcnn_torch.models.rpn import RpnModel

    model = RpnModel(cfg.model_config, 3, CLUSTER_SIZES, save_rpn_feature=True, mode=mode)
    return randomize_batchnorm(init_weights(model, SEED), SEED).cuda().eval()


def stage1_inputs(cfg, labels=False):
    """The synthetic seed-SEED batch of 4 on the card; with `labels`, val
    mode's too: a foreground class for about half the points (more than
    NUM_FG_POINT a frame, so the resample needs no wrap-fill), box targets
    and 4 sane GT boxes a frame."""
    import numpy as np
    import torch

    from heterofusionrcnn_torch.inference import random_batch

    batch = random_batch(cfg, BATCH, SEED)
    out = [torch.from_numpy(batch[k]).cuda()
           for k in ("point_cloud", "image_input", "stereo_calib_p2")]
    if labels:
        rng = np.random.default_rng(SEED)
        p = out[0].shape[1]
        segs = np.where(rng.random((BATCH, p)) < 0.5, rng.integers(1, 4, (BATCH, p)), 0)
        regs = np.concatenate([rng.uniform(-30, 30, (BATCH, p, 3)), rng.uniform(1, 4, (BATCH, p, 3)),
                               rng.uniform(-3, 3, (BATCH, p, 1))], -1)
        boxes = np.concatenate([rng.uniform(-30, 30, (BATCH, 4, 3)), rng.uniform(1, 4, (BATCH, 4, 3)),
                                rng.uniform(-3, 3, (BATCH, 4, 1))], -1)
        out += [torch.from_numpy(a.astype(dt)).cuda()
                for a, dt in ((segs, np.int32), (regs, np.float32), (boxes, np.float32))]
    return out


def counted(fn, kernels, ops=()):
    """fn() between zeroing every launch count and reading it, the calls of
    `ops` recorded. Returns (output, launches, calls)."""
    import torch

    for kern in kernels.values():
        kern.launches = 0
    with recording(ops) as calls:
        out = fn()
        torch.cuda.synchronize()
    return out, {k: kern.launches for k, kern in kernels.items()}, calls


def forward_timing(fn):
    """ms (CUDA events, mean of ITERS), the device's busy ms of one profiled
    call and the busy share."""
    ms = cuda_ms(fn, ITERS)
    prof = profile_forward(lambda: fn(), ())
    return dict(ms=ms, device_ms=prof["device_busy_ms"],
                busy_share=prof["device_busy_ms"] / ms, top=prof["top"][:8])


def check_keeps(out, post, label):
    """NMS keeps of a forward: valid slots first, score-sorted, the count
    within `post`, finite boxes."""
    import torch

    n = out["num_proposals_before_padding"]
    if not bool(((n >= 1) & (n <= post)).all()):
        raise AssertionError(f"{label}: keep counts {n.tolist()} outside 1..{post}")
    for b in range(n.shape[0]):
        k = int(n[b])
        s = out["proposal_scores"][b, :k]
        if not (bool(out["proposal_valid"][b, :k].all()) and not bool(out["proposal_valid"][b, k:].any())
                and bool((s[1:] <= s[:-1]).all()) and bool(torch.isfinite(out["proposals"][b]).all())):
            raise AssertionError(f"{label}: frame {b}'s keeps are not valid-first, score-sorted "
                                 f"and finite")
    return n.tolist()


def check_nms_calls(calls, boxes_per_frame, label):
    """Each recorded NMS call over `boxes_per_frame` boxes a frame, its keep
    indices unique within each frame."""
    import torch

    from heterofusionrcnn_torch.ops import nms

    for a, kw in calls["oriented_nms"]:
        bev = a[0]
        if bev.shape[1] != boxes_per_frame:
            raise AssertionError(f"{label}: an NMS call over {bev.shape[1]} boxes a frame, "
                                 f"not {boxes_per_frame}")
        keep, valid = nms.oriented_nms(*a, **kw)
        for f in range(keep.shape[0]):
            kept = keep[f][valid[f]]
            if torch.unique(kept).numel() != kept.numel():
                raise AssertionError(f"{label}: frame {f} keeps an index twice")


def op_device_ms(calls, reps=REPS):
    """Per op of STAGE1_OPS: calls, ms (CUDA events, mean a call over reps)
    and device ms (the profiler's device events, a call) of its recorded
    calls rerun alone."""
    from heterofusionrcnn_torch.models.extractors import pointnet

    out = {}
    for op in STAGE1_OPS:
        fn = getattr(pointnet, op)
        ms = dev = 0.0
        for a, kw in calls[op]:
            ms += cuda_ms(lambda: fn(*a, **kw), reps)
            dev += sum(d for _, d in profiled(lambda: fn(*a, **kw), reps).values()) / reps
        out[op] = dict(calls=len(calls[op]), ms=ms, device_ms=dev)
    return out


def pointnet_forward(kernels, report):
    """Step 15 (a): the PointNet++ RPN in test mode at batch 4. Returns rows."""
    import torch

    from heterofusionrcnn_torch.models.rpn import rpn_fts_channels

    cfg = pointnet_rpn_config()
    model = stage1_model(cfg, "test")
    inputs = stage1_inputs(cfg)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out, launches, calls = counted(
            lambda: model(*inputs), kernels,
            ("farthest_point_sample", "oriented_nms", "knn_point", "fused_xconv") + STAGE1_OPS)
    rep = dict(launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    want = dict(POINTNET_PER_FORWARD, knn=0, knn_prep=0, xconv=0, xconv_epilogue=0)
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"PointNet++ RPN forward launches {launches}, want {want}")
    if expected_launches(calls, ("fps", "nms")) != {"fps": launches["fps"], "nms": launches["nms"],
                                                    "knn_prep": 0}:
        raise AssertionError(f"recorded PointNet++ calls do not match its launches {launches}")
    shapes = [(tuple(a[0].shape), a[1]) for a, _ in calls["farthest_point_sample"]]
    npoints = [sa.npoint for sa in cfg.model_config.layers_config.pc_pointnet.sa_modules]
    p = cfg.model_config.input_config.pc_sample_pts
    if [s[1] for s in shapes] != npoints or shapes[0][0] != (BATCH, p, 3):
        raise AssertionError(f"PointNet++ FPS calls {shapes}, want {p} -> {npoints}")
    width = out["rpn_fts"].shape[-1] + out["rpn_img_fts"].shape[-1]
    if out["rpn_fts"].dtype != torch.float32 or width != rpn_fts_channels(cfg.model_config):
        raise AssertionError(f"PointNet++ features {out['rpn_fts'].dtype}, width {width}")
    rep["num_proposals"] = check_keeps(out, cfg.model_config.rpn_config.rpn_test_post_nms_size,
                                       "PointNet++ RPN")
    with torch.no_grad():
        rep.update(forward_timing(lambda: model(*inputs)))
        rep["ops"] = op_device_ms(calls)
    rows = {}
    with torch.no_grad():
        fps_row(rows, calls, REPS, "_pointnet", sweeps=False, warm_plain=False)
        nms_row(rows, calls, REPS, "_pointnet", sweeps=False, warm_plain=False)
    rows["fps_pointnet"]["launches"] = launches["fps"]
    rows["nms_pointnet"]["launches"] = launches["nms"]
    print(f"card: {card_line()}; PointNet++ RPN test mode, batch {BATCH}: {rep['ms']:.2f} ms, "
          f"device {rep['device_ms']:.2f} ms (busy {rep['busy_share']:.3f}), peak "
          f"{rep['peak_mem_gb']:.2f} GB; launches fps {launches['fps']} nms {launches['nms']}; "
          + "; ".join(f"{op} {d['calls']} calls {d['ms']:.4f} ms, device {d['device_ms']:.4f} ms"
                      for op, d in rep["ops"].items()), flush=True)
    report["pointnet_forward"] = rep
    del model, out, calls
    torch.cuda.empty_cache()
    return rows


def nonfixed_forwards(kernels, report, cell_a_ms):
    """Step 15 (b): `rpn_multiclass` with the non-fixed NMS path, test and
    val mode, batch 4 (one model: its mode and its NMS switch flipped),
    beside the fixed path on the same weights. Returns the nms_nonfixed
    row."""
    import torch

    from heterofusionrcnn_torch.configs.presets import rpn_multiclass
    from heterofusionrcnn_torch.models.rpn import NUM_FG_POINT

    cfg = rpn_multiclass(KITTI_DIR)
    rpn_cfg = cfg.model_config.rpn_config
    rpn_cfg.rpn_fixed_num_proposal_nms = False
    p = cfg.model_config.input_config.pc_sample_pts
    model = stage1_model(cfg, "test")  # holds cfg: rpn_cfg switches its path
    rep, all_calls, launches_total = {}, {"oriented_nms": []}, 0
    for mode, post in (("test", rpn_cfg.rpn_test_post_nms_size),
                       ("val", rpn_cfg.rpn_train_post_nms_size)):
        model.mode = mode
        inputs = stage1_inputs(cfg, labels=mode == "val")
        with torch.no_grad():
            out, launches, calls = counted(lambda: model(*inputs), kernels, ("oriented_nms",))
        if launches["nms"] != 1 or len(calls["oriented_nms"]) != 1:
            raise AssertionError(f"non-fixed {mode} forward launched NMS {launches['nms']} times")
        check_nms_calls(calls, min(NUM_FG_POINT, p), f"non-fixed {mode}")  # nms_row: bit-exact
        m = dict(launches=launches, num_proposals=check_keeps(out, post, f"non-fixed {mode}"))
        if out["rpn_pts"].shape[1] != min(NUM_FG_POINT, p) or out["seg_logits"].shape[1] != p:
            raise AssertionError(f"non-fixed {mode}: rows {out['rpn_pts'].shape} "
                                 f"{out['seg_logits'].shape}")
        if mode == "test":
            def forward(fixed):
                rpn_cfg.rpn_fixed_num_proposal_nms = fixed
                return model(*inputs)

            with torch.no_grad():
                turns = [cuda_ms(lambda: forward(fixed), ITERS)
                         for fixed in (True, False, False, True)]
            rpn_cfg.rpn_fixed_num_proposal_nms = False
            m.update(ms_fixed_nonfixed_turns=turns, cell_a_ms=cell_a_ms)
            print(f"RPN test mode, batch {BATCH}, fixed / non-fixed NMS path in turns: "
                  f"{(turns[0] + turns[3]) / 2:.2f} / {(turns[1] + turns[2]) / 2:.2f} ms (cell A, "
                  f"the two-stage forward on the fixed path: {cell_a_ms:.2f} ms); keeps "
                  f"{m['num_proposals']}", flush=True)
        else:
            print(f"non-fixed val forward: keeps {m['num_proposals']} of {post}", flush=True)
        rep[mode] = m
        all_calls["oriented_nms"] += calls["oriented_nms"]
        launches_total += launches["nms"]
        del out
    del model
    torch.cuda.empty_cache()
    rows = {}
    with torch.no_grad():
        nms_row(rows, all_calls, REPS, "_nonfixed", sweeps=False, warm_plain=False)
    rows["nms_nonfixed"]["launches"] = launches_total
    report["nonfixed"] = rep
    return rows


def fixture_pair(root):
    """A dataset directory under `root` holding the fixture frames and a
    split "two" of STAGE1_FRAMES."""
    data = os.path.join(root, "kitti")
    os.makedirs(data)
    os.symlink(os.path.join(KITTI_DIR, "training"), os.path.join(data, "training"))
    shutil.copy(os.path.join(KITTI_DIR, "train.txt"), os.path.join(data, "train.txt"))
    with open(os.path.join(data, "two.txt"), "w") as f:
        f.write("\n".join(STAGE1_FRAMES) + "\n")
    return data


def pointnet_training(kernels, out_root, report):
    """Step 15 (c): the PointNet++ RPN through `run_training` (batch 2) from
    a saved config, then `run_evaluation --save_rpn_feature` on 2 frames.
    Returns the fps_pointnet_train row."""
    import numpy as np
    import torch

    from heterofusionrcnn_torch.configs.config import save_config
    from heterofusionrcnn_torch.experiments import run_evaluation, run_training
    from heterofusionrcnn_torch.models.rpn import rpn_fts_channels
    from heterofusionrcnn_torch.runtime.train_state import make_rpn_train_step

    root = os.path.join(out_root, "chip_smoke_stage1")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = pointnet_rpn_config("rpn_pointnet")
    cfg.dataset_config.dataset_dir = fixture_pair(root)
    cfg.train_config.max_iterations = STAGE1_TRAIN_STEPS
    cfg_path = os.path.join(root, "rpn_pointnet.json")
    save_config(cfg, cfg_path)
    monitor = StepMonitor(kernels, make_rpn_train_step)
    with torch.enable_grad(), patched(run_training, "make_rpn_train_step", monitor.factory):
        state = run_training.main(["--pipeline_config", cfg_path, "--data_split", "train",
                                   "--output_root", root, "--seed", str(SEED)])
    if state.step != STAGE1_TRAIN_STEPS or not hasattr(state.model, "pc_pointnet"):
        raise AssertionError(f"PointNet++ training ended at step {state.step}")
    check_train_steps(monitor.steps, ("fps",), ("knn", "knn_prep", "xconv", "nms"), "PointNet++")
    recorded = monitor.steps[TRAIN_RECORDED_STEP]["launches"]
    calls = monitor.calls
    if len(calls["farthest_point_sample"]) != recorded["fps"] or recorded["fps"] != 4:
        raise AssertionError(f"PointNet++ train step: {recorded['fps']} FPS launches")
    rows = {}
    with torch.no_grad():
        fps_row(rows, calls, REPS, "_pointnet_train", sweeps=False, warm_plain=False)
    rows["fps_pointnet_train"]["launches"] = recorded["fps"]
    rep = dict(steps=monitor.steps)
    del state, calls, monitor.calls
    torch.cuda.empty_cache()

    for kern in kernels.values():
        kern.launches = 0
    run_evaluation.main(["--pipeline_config", cfg_path, "--output_root", root,
                         "--data_split", "two", "--save_rpn_feature"])
    rep["eval_launches"] = {k: kern.launches for k, kern in kernels.items()}
    feat_dir = os.path.join(root, "rpn_pointnet", "predictions", "rpn_feature", "two",
                            str(STAGE1_TRAIN_STEPS))
    width = rpn_fts_channels(cfg.model_config)
    files = sorted(os.listdir(feat_dir))
    if len(files) != len(STAGE1_FRAMES):
        raise AssertionError(f"PointNet++ handoff files {files}")
    for name in files:
        feats = np.load(os.path.join(feat_dir, name))
        if feats.shape[1] != width + 5 or not np.isfinite(feats).all():
            raise AssertionError(f"PointNet++ handoff {name}: {feats.shape}, width {width} + 5")
    if rep["eval_launches"]["fps"] != 4 * len(STAGE1_FRAMES) or not rep["eval_launches"]["nms"]:
        raise AssertionError(f"PointNet++ evaluation launches {rep['eval_launches']}")
    rep["feature_width"] = width
    print(f"PointNet++ training, batch 2: step ms "
          + " ".join(f"{s['ms']:.2f}" for s in monitor.steps) + "; losses of the last "
          f"{monitor.steps[-1]['losses']}; handoff of {len(files)} frames, features {width} "
          f"wide; evaluation launches {rep['eval_launches']}", flush=True)
    report["pointnet_training"] = rep
    return rows


def small_stage1_agrees(cfg_pointcnn, label, kernels):
    """Step 15 (d): a PointCNN of `cfg_pointcnn` at `rpn_unittest` width, eval
    mode, on the card against the CPU (the same weights and inputs; ids
    sampling takes the same uniforms on both). Returns the report and the
    recorded card calls (KNN, fused XConv, split epilogues)."""
    import torch

    from heterofusionrcnn_torch.models.extractors import pointcnn
    from heterofusionrcnn_torch.models.extractors.layers import init_weights
    from heterofusionrcnn_torch.ops import sampling

    gen = torch.Generator().manual_seed(SEED)
    pts = torch.randn((2, 2048, 3), generator=gen) * 10.0
    fts = torch.rand((2, 2048, 1), generator=gen) - 0.5
    model = randomize_batchnorm(init_weights(pointcnn.PointCNN(cfg_pointcnn, 1), SEED), SEED).eval()
    real = sampling.inverse_density_sampling

    def given(points, k, n, generator):
        """The i-th sampling of a run takes uniforms of seed SEED + i."""
        u = torch.rand(points.shape[:2], generator=torch.Generator().manual_seed(SEED + len(used)))
        used.append(u)
        return real(points, k, n, uniforms=u.to(points.device))

    outs = {}
    for device in ("cpu", "cuda"):
        used = []
        m = model.to(device)
        with torch.no_grad(), patched(pointcnn, "inverse_density_sampling", given):
            if device == "cuda":
                outs[device], launches, calls = counted(
                    lambda: m(pts.cuda(), fts.cuda(), sampling=gen), kernels,
                    ("knn_point", "fused_xconv", "xconv_split_epilogue"))
            else:
                outs[device] = m(pts, fts, sampling=gen)
    (gp, gf), (wp, wf) = outs["cuda"], outs["cpu"]
    if not torch.equal(gp.cpu(), wp):
        raise AssertionError(f"{label}: the card's output points differ from the CPU's")
    err = (gf.cpu() - wf).abs()
    ok = bool((err <= STAGE1_SMALL_ATOL + STAGE1_SMALL_RTOL * wf.abs()).all())
    if not ok:
        raise AssertionError(f"{label}: card and CPU features differ by {float(err.max())}")
    if not (launches["knn"] and launches["xconv"]) or expected_launches(
            calls, ("knn", "xconv", "xconv_epilogue")) != {
            k: launches[k] for k in ("knn", "knn_prep", "xconv", "xconv_epilogue")}:
        raise AssertionError(f"{label}: launches {launches} against the recorded calls")
    for a, kw in calls["knn_point"]:
        check_index_exact("knn", a, kw)
    rep = dict(launches=launches, max_abs_err_card_cpu=float(err.max()), ids_samplings=len(used))
    print(f"{label} at rpn_unittest width, card against CPU: features within "
          f"{float(err.max()):.3g}; launches {launches}", flush=True)
    return rep, calls


def small_width_variants(kernels, report):
    """Step 15 (d): ids sampling and cxyz-sorted neighbourhoods at
    `rpn_unittest` width. Returns rows knn_ids and xconv_sorted (and
    xconv_epilogue_sorted where the sorted model splits a layer)."""
    import copy

    import torch

    from heterofusionrcnn_torch.configs.presets import rpn_unittest
    from heterofusionrcnn_torch.ops import grouping

    base = rpn_unittest().model_config.layers_config.pc_pointcnn
    ids_cfg, sorted_cfg = copy.deepcopy(base), copy.deepcopy(base)
    ids_cfg.sampling = "ids"
    sorted_cfg.sorting_method = "cxyz"
    rep = {}
    rep["ids"], ids_calls = small_stage1_agrees(ids_cfg, "ids-sampling PointCNN", kernels)
    rep["sorted"], sorted_calls = small_stage1_agrees(sorted_cfg, "cxyz-sorted PointCNN", kernels)
    sampled = sum(lp.P not in (-1, base.xconv_layers[i - 1].P if i else None)
                  for i, lp in enumerate(base.xconv_layers))
    if rep["ids"]["ids_samplings"] != sampled or rep["sorted"]["ids_samplings"]:
        raise AssertionError(f"ids samplings {rep['ids']['ids_samplings']}, want {sampled}")
    # The fused XConv took sorted neighbourhoods: each call's idx is its KNN
    # rows reordered, and at least one row moved.
    moved = 0
    for (pts, fts, qrs, idx, w), _ in sorted_calls["fused_xconv"]:
        k = idx.shape[2]
        knn = grouping.knn_point(k, pts, qrs)[1]
        if not torch.equal(idx.sort(-1).values, knn.sort(-1).values):
            raise AssertionError("a sorted XConv call's neighbourhoods are not its KNN rows")
        moved += int((idx != knn).any(-1).sum())
    if not moved:
        raise AssertionError("no sorted XConv call took a reordered neighbourhood")
    rep["sorted"]["rows_reordered"] = moved
    rows = {}
    with torch.no_grad():
        knn_rows(rows, ids_calls, REPS, "_ids")
        xconv_row(rows, sorted_calls, REPS, "_sorted")
        if sorted_calls["xconv_split_epilogue"]:
            epilogue_row(rows, sorted_calls, REPS, "_sorted")
    rows["knn_ids"]["launches"] = rep["ids"]["launches"]["knn"]
    rows["knn_prep_ids"]["launches"] = rep["ids"]["launches"]["knn_prep"]
    if not rows["knn_prep_ids"]["calls"]:
        del rows["knn_prep_ids"]  # every set of this width takes the brute arm
    rows["xconv_sorted"]["launches"] = rep["sorted"]["launches"]["xconv"]
    if "xconv_epilogue_sorted" in rows:
        rows["xconv_epilogue_sorted"]["launches"] = rep["sorted"]["launches"]["xconv_epilogue"]
    report["small_width"] = rep
    return rows


def native_loader_check(report):
    """Step 15 (e): the native loader against the numpy path on every
    fixture frame, on the card's host: points byte-equal, ms a frame each."""
    from heterofusionrcnn_torch.datasets.kitti import image as image_io
    from heterofusionrcnn_torch.datasets.kitti import pointcloud

    training = os.path.join(KITTI_DIR, "training")
    calib_dir, velo_dir = os.path.join(training, "calib"), os.path.join(training, "velodyne")
    frames = sorted(int(f[:-4]) for f in os.listdir(velo_dir) if f.endswith(".bin"))
    pointcloud.get_lidar_point_cloud(frames[0], calib_dir, velo_dir, [1242, 375])  # the build
    times = {"native": [], "numpy": []}
    for idx in frames:
        h, w = image_io.read_png(os.path.join(training, "image_2", "%06d.png" % idx)).shape[:2]
        got = {}
        for name, fn in (("native", pointcloud.get_lidar_point_cloud),
                         ("numpy", pointcloud.get_lidar_point_cloud_numpy)):
            t0 = time.perf_counter()
            got[name] = fn(idx, calib_dir, velo_dir, [w, h])
            times[name].append((time.perf_counter() - t0) * 1e3)
        if got["native"].tobytes() != got["numpy"].tobytes():
            raise AssertionError(f"frame {idx}: the native loader's points differ from numpy's")
    rep = {k: dict(ms_per_frame=sum(v) / len(v), ms=v) for k, v in times.items()}
    rep["frames"] = len(frames)
    print(f"native point-cloud loader on {len(frames)} fixture frames, host of {card_line()}: "
          f"{rep['native']['ms_per_frame']:.3f} ms a frame, numpy {rep['numpy']['ms_per_frame']:.3f}"
          f" ms; points byte-equal", flush=True)
    report["native_loader"] = rep


def stage1_variants_phase(kernels, out_root, cell_a_ms):
    """Step 15 (module docstring), cell J. Returns the report and the rows."""
    t_phase = time.perf_counter()
    report = dict(card=card_line(), part_s={})
    rows = {}
    for part, run in (("a", lambda: rows.update(pointnet_forward(kernels, report))),
                      ("b", lambda: rows.update(nonfixed_forwards(kernels, report, cell_a_ms))),
                      ("c", lambda: rows.update(pointnet_training(kernels, out_root, report))),
                      ("d", lambda: rows.update(small_width_variants(kernels, report))),
                      ("e", lambda: native_loader_check(report))):
        t0 = time.perf_counter()
        run()
        report["part_s"][part] = time.perf_counter() - t0
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"stage-1 variants phase: {report['phase_s']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in report["part_s"].items()) + ")", flush=True)
    return report, finish_rows(rows)


# Step 16, cell K: the workflow tools. (a) tools/torch_run_full_pipeline.py
# in process at full width, each of its four stages counted by kernel (the
# counts zeroed before each CLI call and read after it), the first call of
# each kernel's op recorded and held against its plain version (rows
# *_pipeline); (b) tools/torch_run_eval_sweep.py over (a)'s RCNN
# checkpoints, twice; (c) the label tools on the fixture train split.
PIPELINE_CONFIGS = ("rpn_multiclass", "rcnn_multiclass")
PIPELINE_ARGS = ["--dataset_dir", KITTI_DIR, "--rpn_iterations", "2", "--rcnn_iterations", "2",
                 "--num_rois", "100"]
PIPELINE_OPS = ("knn_point", "farthest_point_sample", "fused_xconv", "xconv_split_epilogue",
                "oriented_nms")
# The kernels each stage must launch and those it must not (besides the
# switched and bf16 kernels, which no stage launches).
PIPELINE_STAGE_KERNELS = {
    "rpn_train": (("knn", "knn_prep", "fps"), ("xconv", "xconv_epilogue", "nms")),
    "rpn_handoff": (("knn", "knn_prep", "fps", "xconv", "nms"), ()),
    "rcnn_train": (("knn", "fps"), ("knn_prep", "xconv", "xconv_epilogue", "nms")),
    "rcnn_eval": (("knn", "fps", "xconv", "nms"), ("knn_prep",)),
}
# The CLI calls of the pipeline, in order, and the stage of each.
PIPELINE_CALLS = ("rpn_train", "rpn_handoff", "rpn_handoff", "rcnn_train", "rcnn_eval")


def pipeline_run(kernels, out_root, report):
    """(a): the pipeline, counted per stage; returns its summary and the
    recorded calls."""
    import numpy as np
    import torch

    from heterofusionrcnn_torch.experiments import common, run_evaluation, run_training
    from heterofusionrcnn_torch.models.rpn import rpn_fts_channels
    from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
    from heterofusionrcnn_torch.utils import format_checker
    from tools import torch_run_full_pipeline

    rpn_name, rcnn_name = PIPELINE_CONFIGS
    root = os.path.join(out_root, "chip_smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    per_call = []

    def counted_cli(fn):
        def cli(argv=None):
            for kern in kernels.values():
                kern.launches = 0
            out = fn(argv)
            torch.cuda.synchronize()
            per_call.append({k: kern.launches for k, kern in kernels.items()})
            return out
        return cli

    with patched(run_training, "main", counted_cli(run_training.main)), \
            patched(run_evaluation, "main", counted_cli(run_evaluation.main)), \
            recording(PIPELINE_OPS, limit=1) as first:
        summary = torch_run_full_pipeline.main(
            ["--rpn_config", rpn_name, "--rcnn_config", rcnn_name, "--output_root", root]
            + PIPELINE_ARGS)
    if len(per_call) != len(PIPELINE_CALLS):
        raise AssertionError(f"the pipeline made {len(per_call)} CLI calls")
    launches = {stage: {k: 0 for k in kernels} for stage in PIPELINE_STAGE_KERNELS}
    for stage, counts in zip(PIPELINE_CALLS, per_call):
        for k, v in counts.items():
            launches[stage][k] += v
    for stage, (need, never) in PIPELINE_STAGE_KERNELS.items():
        got = launches[stage]
        absent = [k for k in need if not got[k]]
        wrong = [k for k, v in got.items() if v and (k in never or k not in SLICE1)]
        if absent or wrong:
            raise AssertionError(f"pipeline stage {stage}: launches {got} (missing {absent}, "
                                 f"unexpected {wrong})")
    total = {k: sum(launches[s][k] for s in launches) for k in SLICE1}
    if not total["xconv_epilogue"]:
        raise AssertionError(f"the pipeline launched no split epilogue: {total}")
    report.update(pipeline=summary, pipeline_launches=launches, pipeline_total_launches=total)
    for stage, secs in summary["stage_s"].items():
        print(f"pipeline stage {stage}: {secs:.1f} s, launches "
              + " ".join(f"{k}={v}" for k, v in launches[stage].items() if k in SLICE1),
              flush=True)

    # Every handoff file and final prediction file in its format; the AP
    # summaries written; both final checkpoints load into the models.
    rpn_step, rcnn_step = summary["rpn_step"], summary["rcnn_step"]
    pred = os.path.join(root, rpn_name, "predictions")
    # Points, intensity, foreground flag and the stage-1 features.
    width = rpn_fts_channels(common.resolve_config(rpn_name).model_config)
    files = 0
    for split in ("train", "val"):
        dirs = torch_run_full_pipeline.handoff_dirs(root, rpn_name, split, rpn_step)
        names = sorted(os.listdir(dirs[0]))
        if not names or sorted(os.listdir(dirs[1])) != names:
            raise AssertionError(f"handoff of {split}: {names}")
        for n in names:
            format_checker.check_proposal_file_format(np.loadtxt(os.path.join(dirs[0], n),
                                                                 ndmin=2))
            feats = np.load(os.path.join(dirs[2], n.replace(".txt", ".npy")))
            if feats.shape[1] != 5 + width or not np.isfinite(feats).all():
                raise AssertionError(f"handoff features of {split}/{n}: {feats.shape}")
            files += 1
    final = os.path.join(root, rcnn_name, "predictions", "final_predictions_and_scores", "val",
                         str(rcnn_step))
    finals = sorted(os.listdir(final))
    if len(finals) != len(sorted(os.listdir(os.path.join(pred, "proposals_and_scores", "val",
                                                          str(rpn_step))))):
        raise AssertionError(f"final predictions {finals}")
    for n in finals:
        format_checker.check_final_prediction_file_format(np.loadtxt(os.path.join(final, n),
                                                                     ndmin=2))
    kitti = os.path.join(root, rcnn_name, "predictions", "kitti_native_eval", "0.1",
                         str(rcnn_step))
    for path in ("ap_summary.json", "results_05_iou/ap_summary.json"):
        with open(os.path.join(kitti, path)) as f:
            if "car_detection_3d" not in json.load(f):
                raise AssertionError(f"{path} has no car AP")
    for name in PIPELINE_CONFIGS:
        cfg = common.resolve_config(name, KITTI_DIR)
        model, _ = common.build_model(cfg, common.build_dataset(cfg, "val", "val"), "val")
        model.load_state_dict(CheckpointManager(os.path.join(root, name, "checkpoints"))
                              .restore_raw()["state_dict"])
    report.update(handoff_files=files, final_files=len(finals))
    print(f"pipeline: RPN step {rpn_step}, RCNN step {rcnn_step}; {files} handoff frames and "
          f"{len(finals)} final prediction files in their formats; both checkpoints load; "
          f"AP {summary['ap'].get('car_detection_3d')}", flush=True)
    return summary, first


def sweep_run(summary, out_root, report):
    """(b): the sweep over (a)'s RCNN checkpoints in a fresh root: every
    step once, nothing on a second run."""
    from heterofusionrcnn_torch.runtime.checkpoint import CheckpointManager
    from tools import torch_run_eval_sweep, torch_run_full_pipeline

    rpn_name, rcnn_name = PIPELINE_CONFIGS
    root = os.path.join(out_root, "chip_smoke_pipeline")
    ckpts = os.path.abspath(os.path.join(root, rcnn_name, "checkpoints"))
    sweep_root = os.path.join(out_root, "chip_smoke_sweep")
    shutil.rmtree(sweep_root, ignore_errors=True)
    os.makedirs(os.path.join(sweep_root, rcnn_name))
    os.symlink(ckpts, os.path.join(sweep_root, rcnn_name, "checkpoints"))
    dirs = torch_run_full_pipeline.handoff_dirs(root, rpn_name, "val", summary["rpn_step"])
    argv = ["--pipeline_config", rcnn_name, "--dataset_dir", KITTI_DIR, "--output_root",
            sweep_root, "--proposal_dir", dirs[0], "--proposal_iou_dir", dirs[1],
            "--rpn_feature_dir", dirs[2]]
    t0 = time.perf_counter()
    first = torch_run_eval_sweep.main(argv)
    report["sweep_s"] = time.perf_counter() - t0
    again = torch_run_eval_sweep.main(argv)
    steps = CheckpointManager(ckpts).all_steps()
    if sorted(s_ for s_, _ in first) != steps or again:
        raise AssertionError(f"the sweep evaluated {first}, then {again}, of steps {steps}")
    report["sweep"] = first
    print(f"sweep: steps {steps} evaluated once each in {report['sweep_s']:.1f} s, none on the "
          f"rerun", flush=True)


def label_tools_run(out_root, report):
    """(c): both label tools on the fixture train split, ms a frame (wall
    clock of the tool, its process pool's start included)."""
    import numpy as np

    from tools import torch_gen_label_clusters, torch_gen_label_segs

    with open(os.path.join(KITTI_DIR, "train.txt")) as f:
        names = f.read().split()
    seg_dir = os.path.join(out_root, "chip_smoke_label_segs")
    shutil.rmtree(seg_dir, ignore_errors=True)
    t0 = time.perf_counter()
    fg = torch_gen_label_segs.main(["--dataset_dir", KITTI_DIR, "--data_split", "train",
                                    "--out_dir", seg_dir, "--workers", "4"])
    seg_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    if sorted(fg) != sorted(names) or not sum(fg.values()):
        raise AssertionError(f"label segs: {fg}")
    for n in names:
        rows = np.load(os.path.join(seg_dir, n + ".npy"))
        if rows.ndim != 2 or rows.shape[1] != 8 or not np.isfinite(rows).all():
            raise AssertionError(f"label segs of {n}: {rows.shape}")
    cache = os.path.join(out_root, "chip_smoke_label_clusters")
    shutil.rmtree(cache, ignore_errors=True)
    t0 = time.perf_counter()
    clusters, stds = torch_gen_label_clusters.main(["--dataset_dir", KITTI_DIR, "--cluster_split",
                                                    "train", "--cache_dir", cache])
    cluster_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    if not all(np.isfinite(c).all() and np.isfinite(s_).all() for c, s_ in zip(clusters, stds)):
        raise AssertionError("label clusters not finite")
    report.update(label_segs_ms_per_frame=seg_ms, label_clusters_ms_per_frame=cluster_ms,
                  label_segs_fg_points=fg)
    print(f"label tools on {len(names)} train frames: segs {seg_ms:.1f} ms a frame (4 spawned "
          f"workers, their start included), clusters {cluster_ms:.2f} ms a frame", flush=True)


def workflow_phase(kernels, out_root):
    """Step 16 (module docstring), cell K. Returns the report and the rows."""
    import torch

    t_phase = time.perf_counter()
    report = dict(card=card_line(), part_s={})
    t0 = time.perf_counter()
    summary, first = pipeline_run(kernels, out_root, report)
    report["part_s"]["a"] = time.perf_counter() - t0
    rows = {}
    with torch.no_grad():
        knn_rows(rows, first, REPS, "_pipeline")
        fps_row(rows, first, REPS, "_pipeline", sweeps=False, warm_plain=False)
        xconv_row(rows, first, REPS, "_pipeline")
        epilogue_row(rows, first, REPS, "_pipeline")
        nms_row(rows, first, REPS, "_pipeline", sweeps=False, warm_plain=False)
    del first
    total = report["pipeline_total_launches"]
    for name in SLICE1:
        rows[name + "_pipeline"]["launches"] = total[name]
    if not rows["knn_pipeline"]["sorted_pairs"]:
        del rows["knn_prep_pipeline"]  # the recorded KNN call took the brute arm
    report["part_s"]["a_rows"] = time.perf_counter() - t0 - report["part_s"]["a"]
    for part, run in (("b", lambda: sweep_run(summary, out_root, report)),
                      ("c", lambda: label_tools_run(out_root, report))):
        t0 = time.perf_counter()
        run()
        report["part_s"][part] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"workflow phase: {report['phase_s']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f}" for k, v in report["part_s"].items()) + ")", flush=True)
    return report, finish_rows(rows)


# Step 17, batch-sharded serving (cell L): cell A's batch-4 detector split
# over the ranks of a process group (`inference.sharded_forward`), each
# rank a spawned process, every run joined within SERVE_DEADLINE_S.
SERVE_DEADLINE_S = 300
# (label, world size, backend, kernel switches)
SERVE_RUNS = (("nccl_w1_switches_off", 1, "nccl", False),
              ("gloo_w2_switches_on", 2, "gloo", True))
# Against one process on the same batch: the JAX test's tolerances
# (tests/test_parallel_extras.py, the fused function sharded over 8
# devices) for the boxes and scores; every other output (classes, valid
# flags, counts) and the zero pattern of the final scores (the keep sets)
# exactly.
SERVE_BOX_TOL = dict(rtol=1e-3, atol=1e-3)
SERVE_SCORE_TOL = dict(rtol=1e-3, atol=1e-4)
SERVE_BOXES = ("proposals", "final_boxes")
SERVE_SCORES = ("proposal_scores", "final_scores")


def float32_kernels():
    """The float32 kernels of the main path, by name: the launch counters."""
    from heterofusionrcnn_torch.ops import conv, cropping, grouping, nms, sampling, xconv

    return {"knn": grouping.KNN_KERNEL, "knn_prep": grouping.KNN_PREP_KERNEL,
            "fps": sampling.FPS_KERNEL, "nms": nms.NMS_KERNEL, "xconv": xconv.XCONV_KERNEL,
            "xconv_epilogue": xconv.XCONV_EPILOGUE_KERNEL, "crop": cropping.CROP_KERNEL,
            "conv": conv.CONV_KERNEL, "convt": conv.CONVT_KERNEL}


def serve_rank(rank, world_size, init_method, spec_path, out_dir, backend):
    """One rank of step 17 on the card (`rank_group`): the spec's detector
    from weights of its own, then rank 0's (`torch_serve_worker.
    replicated_detector`); one sharded forward counted (launches by kernel,
    collectives, peak memory), the forward timed (CUDA events, mean of
    ITERS after that warm call), the gather alone timed on this rank's
    outputs; results to <out_dir>/rank<rank>.pt."""
    import torch

    from heterofusionrcnn_torch.inference import exact_float32, sharded_forward
    from heterofusionrcnn_torch.parallel import distributed
    from heterofusionrcnn_torch.parallel.mesh import gather_rows, shard_batch
    from tests import torch_serve_worker

    spec = torch.load(spec_path, weights_only=False)
    exact_float32()
    group = rank_group(rank, world_size, init_method, backend, SERVE_DEADLINE_S)
    try:
        det = torch_serve_worker.replicated_detector(spec, group, "cuda",
                                                     switches=spec["switches"])
        replicated = all(torch.equal(v.cpu(), spec["state_dict"][k])
                         for k, v in det.state_dict().items())
        inputs = tuple(torch.from_numpy(spec["inputs"][k]).cuda() for k in ("pc", "img", "p2"))

        def forward(*x):
            return sharded_forward(det, *x, group)

        torch.cuda.reset_peak_memory_stats()
        with torch_serve_worker.CountedCollectives() as collectives:
            out, launches = counted_forward(forward, inputs, float32_kernels())
        peak = torch.cuda.max_memory_allocated()
        forward_ms = cuda_ms(lambda: forward(*inputs), ITERS)
        local = shard_batch(dict(zip(("pc", "img", "p2"), inputs)), group)
        local_out = det(local["pc"], local["img"], local["p2"])
        gather_ms = cuda_ms(lambda: gather_rows(local_out, group), REPS)
        torch.save(dict(rank=rank, out={k: v.cpu() for k, v in out.items()}, launches=launches,
                        collectives=collectives.calls, replicated=replicated,
                        peak_gb=peak / 1e9, forward_ms=forward_ms, gather_ms=gather_ms,
                        gather_bytes=sum(v.numel() * v.element_size() for v in out.values())),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown_distributed()


def serve_agrees(got, want, label):
    """A rank's gathered dict against the one-process forward (SERVE_*):
    raises where it differs; returns each entry's largest |difference|."""
    import torch

    diffs = {}
    for key, w in want.items():
        w, g = w.cpu(), got[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {key}: {g.dtype} {tuple(g.shape)} against "
                                 f"{w.dtype} {tuple(w.shape)}")
        diffs[key] = float((g.double() - w.double()).abs().max())
        tol = (SERVE_BOX_TOL if key in SERVE_BOXES else SERVE_SCORE_TOL if key in SERVE_SCORES
               else None)
        if tol is None and not torch.equal(g, w):
            raise AssertionError(f"{label} {key} differs from one process")
        if tol is not None and not torch.allclose(g, w, **tol):
            raise AssertionError(f"{label} {key} differs from one process by {diffs[key]:.3g}")
    if not torch.equal(got["final_scores"] == 0, want["final_scores"].cpu() == 0):
        raise AssertionError(f"{label}: other keep sets than one process")
    return diffs


def serve_phase(det, inputs, kernels, out_root, pipeline):
    """Step 17 (module docstring), cell L. `det` and `inputs` are cell A's
    switches-off detector and batch, `pipeline` step 16's summary (its
    RCNN predictions feed the 3D viewer). Returns the report."""
    import io

    import torch

    from heterofusionrcnn_torch.configs.presets import rcnn_multiclass, rpn_multiclass
    from heterofusionrcnn_torch.inference import CLUSTER_SIZES
    from heterofusionrcnn_torch.parallel.distributed import spawn_ranks
    from tests import torch_serve_worker
    from tools import torch_dataset_stats, torch_show_predictions_3d

    t_phase = time.perf_counter()
    card = card_line()
    print(f"batch-sharded serving on {card}: ranks that share one card say nothing of "
          "multi-card speed; NCCL runs at world size 1 only on a single card", flush=True)
    root = os.path.join(out_root, "chip_smoke_serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rpn_cfg, rcnn_cfg = rpn_multiclass(), rcnn_multiclass()
    rcnn_cfg.model_config.rcnn_config.rcnn_use_rpn_img_feature_map = True  # build_two_stage's
    spec = dict(rpn_cfg=rpn_cfg, rcnn_cfg=rcnn_cfg, cluster_sizes=CLUSTER_SIZES, bev_z_max=70.0,
                state_dict={k: v.cpu() for k, v in det.state_dict().items()},
                inputs={k: t.cpu().numpy() for k, t in zip(("pc", "img", "p2"), inputs)})
    report = dict(card=card, runs={})
    for label, world, backend, switches in SERVE_RUNS:
        t0 = time.perf_counter()
        one = torch_serve_worker.detector(spec, switches=switches).cuda()
        want, want_launches = counted_forward(one, inputs, kernels)
        b = BATCH // world
        local_launches = (counted_forward(one, tuple(t[:b] for t in inputs), kernels)[1]
                          if b != BATCH else want_launches)
        one_ms = cuda_ms(lambda: one(*inputs), ITERS)
        del one
        torch.cuda.empty_cache()
        run_dir = os.path.join(root, label)
        os.makedirs(run_dir)
        spec_path = os.path.join(run_dir, "spec.pt")
        torch.save(dict(spec, switches=switches), spec_path)
        t_ranks = time.perf_counter()
        spawn_ranks(serve_rank, world, args=(spec_path, run_dir, backend),
                    timeout_s=SERVE_DEADLINE_S, rendezvous_dir=run_dir)
        ranks_s = time.perf_counter() - t_ranks
        ranks = [torch.load(os.path.join(run_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
        need = SLICE1 + (tuple(SWITCHED_PER_FORWARD) if switches else ())
        run = dict(world=world, backend=backend, switches=switches, frames_per_rank=b,
                   one_process_ms=one_ms, one_process_launches=want_launches,
                   one_process_launches_at_rank_batch=local_launches, ranks_s=ranks_s, ranks=[])
        for res in ranks:
            r = res["rank"]
            if not res["replicated"]:
                raise AssertionError(f"{label} rank {r}: weights other than rank 0's")
            gathers = dict(dict.fromkeys(torch_serve_worker.COLLECTIVES, 0),
                           all_gather_into_tensor=3)
            if res["collectives"] != gathers:
                raise AssertionError(f"{label} rank {r}: collectives {res['collectives']}")
            if res["launches"] != local_launches or not all(res["launches"][k] for k in need):
                raise AssertionError(f"{label} rank {r}: launches {res['launches']} against one "
                                     f"process's {local_launches} at {b} frames")
            diffs = serve_agrees(res["out"], want, f"{label} rank {r}")
            run["ranks"].append(dict(rank=r, launches=res["launches"], max_abs_diff=diffs,
                                     forward_ms=res["forward_ms"], gather_ms=res["gather_ms"],
                                     gather_bytes=res["gather_bytes"], peak_gb=res["peak_gb"]))
            same = ("the same as" if res["launches"] == want_launches
                    else f"one process at {BATCH} frames: {want_launches}; here")
            print(f"{label} rank {r}/{world} ({backend}, {b} frames): forward "
                  f"{res['forward_ms']:.2f} ms (one process, {BATCH} frames: {one_ms:.2f}); "
                  f"the gather {res['gather_ms']:.3f} ms for {res['gather_bytes']} bytes; peak "
                  f"{res['peak_gb']:.2f} GB; launches {same} one process's at {b} frames ("
                  + " ".join(f"{k}={v}" for k, v in res["launches"].items() if v)
                  + "); largest |difference| from one process "
                  + ", ".join(f"{k} {v:.3g}" if v else f"{k} 0 (bit-equal)"
                              for k, v in diffs.items()) + "; agrees", flush=True)
        run["s"] = time.perf_counter() - t0
        report["runs"][label] = run
        shutil.rmtree(run_dir, ignore_errors=True)

    # The host tools that need no matplotlib (the card's machine has none).
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        torch_dataset_stats.main(["mean", "--dataset_dir", KITTI_DIR])
    mean_line = printed.getvalue().splitlines()[0]
    if not re.fullmatch(r"RGB means: \[\d+\.\d{4}, \d+\.\d{4}, \d+\.\d{4}\]", mean_line):
        raise AssertionError(f"torch_dataset_stats mean printed {printed.getvalue()!r}")
    report["dataset_stats_mean_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scenes = os.path.join(root, "scenes")
    predictions = os.path.join(out_root, "chip_smoke_pipeline", PIPELINE_CONFIGS[1], "predictions")
    with contextlib.redirect_stdout(io.StringIO()):
        torch_show_predictions_3d.main(
            ["--dataset_dir", KITTI_DIR, "--data_split", "val", "--predictions_dir", predictions,
             "--step", str(pipeline["rcnn_step"]), "--out_dir", scenes])
    pages = sorted(os.listdir(scenes))
    frames = sorted(os.listdir(os.path.join(predictions, "final_predictions_and_scores", "val",
                                            str(pipeline["rcnn_step"]))))
    if pages != [f.replace(".txt", ".html") for f in frames]:
        raise AssertionError(f"scene pages {pages} for the frames {frames}")
    boxes = 0
    for page in pages:
        with open(os.path.join(scenes, page)) as f:
            data = json.loads(re.search(r"const DATA = (\{.*?\});\n", f.read(), re.S).group(1))
        if not data["points"] or not data["boxes"]:
            raise AssertionError(f"{page}: {len(data['points'])} points, "
                                 f"{len(data['boxes'])} boxes")
        boxes += len(data["boxes"])
    report["show_predictions_3d_s"] = time.perf_counter() - t0
    print(f"host tools: torch_dataset_stats mean {report['dataset_stats_mean_s']:.2f} s "
          f"({mean_line}); torch_show_predictions_3d {len(pages)} HTML scenes of step 16's RCNN "
          f"predictions ({boxes} boxes) {report['show_predictions_3d_s']:.2f} s", flush=True)
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"serve phase: {report['phase_s']:.1f} s", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs", help="directory for chip_smoke.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, ROOT)
    try:
        from heterofusionrcnn_torch.inference import build_two_stage
        from heterofusionrcnn_torch.ops import conv, cropping, dispatch, xconv
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2

    report = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda}
    print(report["card"], flush=True)

    kernels = float32_kernels()
    # The bf16 entries of the same libraries (step 12), counted apart.
    kernels_bf16 = {"xconv_bf16": xconv.XCONV_BF16_KERNEL,
                    "xconv_epilogue_bf16": xconv.XCONV_EPILOGUE_BF16_KERNEL,
                    "conv_bf16": conv.CONV_BF16_KERNEL, "convt_bf16": conv.CONVT_BF16_KERNEL,
                    "crop_bf16": cropping.CROP_BF16_KERNEL}
    t0 = time.perf_counter()
    dispatch.build_all([*kernels.values(), *kernels_bf16.values()])
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {k: kern.build_log for k, kern in kernels.items()}
    tensor_core = ("conv", "convt", "xconv")
    report["ptxas_conv"] = {k: ptxas_summary(kernels[k].build_log) for k in tensor_core}
    print(f"built {len(kernels)} kernels in {report['build_s']:.1f} s", flush=True)
    for name, fns in report["ptxas_conv"].items():
        for f in fns:
            print(f"ptxas {name}: " + " ".join(f"{k}={v}" for k, v in f.items()), flush=True)
    report["ptxas_knn"] = ptxas_summary(kernels["knn"].build_log)
    for f in report["ptxas_knn"]:
        print("ptxas knn: " + " ".join(f"{k}={v}" for k, v in f.items()), flush=True)
    report["sass_conv"] = {k: sass_mma_counts(kernels[k].lib_path) for k in tensor_core}
    print(f"tensor-core instructions in SASS: {report['sass_conv']}", flush=True)
    if not all(c["HGMMA"] for c in report["sass_conv"].values()):
        raise AssertionError(f"tensor-core kernels without wgmma: {report['sass_conv']}")
    # The bf16 forms of the conv, transposed conv and XConv all run wgmma
    # on bf16 (the XConv library holds both XConv forms: its TF32 HGMMA is
    # the float32 kernel's, its bf16 HGMMA the bf16 kernel's).
    sass = report["sass_conv"]
    if not all(sass[k]["HGMMA_BF16"] for k in ("conv", "convt", "xconv")):
        raise AssertionError(f"bf16 kernels off their tensor-core instructions: {sass}")

    b = BATCH
    det, inputs = build_two_stage(BATCH, SEED, "cuda")
    randomize_batchnorm(det, SEED)
    calls = record_kernel_inputs(det, inputs)
    torch.cuda.synchronize()

    # The main path, switches off, counted: one forward between zeroing and
    # reading.
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted_forward(det, inputs, kernels)
    report["launches_per_forward"] = launches
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    missing = [name for name in SLICE1 if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    recorded = expected_launches(calls, kernels)
    if recorded != launches:
        raise AssertionError(f"recorded kernel calls {recorded} != main-path launches {launches}")
    report["num_final"] = check_outputs(out, b)

    ms = cuda_ms(lambda: det(*inputs), ITERS)
    report["fused_ms_per_batch"] = ms
    report["frames_per_s"] = b / ms * 1e3
    print(f"fused two-stage inference: {ms:.2f} ms per batch of {b}", flush=True)
    report["profile"] = profile_forward(det, inputs)
    report["device_busy_share"] = report["profile"]["device_busy_ms"] / ms

    # The same detector and inputs with both kernel switches on.
    det_on, inputs_on = build_two_stage(BATCH, SEED, "cuda", conv_kernels=True, crop_kernel=True)
    randomize_batchnorm(det_on, SEED)
    sd, sd_on = det.state_dict(), det_on.state_dict()
    if sd.keys() != sd_on.keys() or not all(torch.equal(sd[k], sd_on[k]) for k in sd):
        raise AssertionError("the switches-on detector has other weights")
    if not all(torch.equal(a, c) for a, c in zip(inputs, inputs_on)):
        raise AssertionError("the switches-on detector has other inputs")
    calls_on = record_kernel_inputs(det_on, inputs)
    torch.cuda.synchronize()
    out_on, launches_on = counted_forward(det_on, inputs, kernels)
    report["launches_per_forward_switches_on"] = launches_on
    want_on = dict(SWITCHED_PER_FORWARD, **{k: launches[k] for k in SLICE1})
    if launches_on != want_on:
        raise AssertionError(f"switches-on launches {launches_on} != {want_on}")
    recorded_on = expected_launches(calls_on, kernels)
    if recorded_on != launches_on:
        raise AssertionError(f"recorded calls {recorded_on} != switches-on launches {launches_on}")
    report["num_final_switches_on"] = check_outputs(out_on, b)
    ab = [cuda_ms(lambda: d(*inputs), ITERS) for d in (det, det_on, det_on, det)]
    report["ab_ms_off_on_on_off"] = ab
    print(f"switches off / on: {(ab[0] + ab[3]) / 2:.2f} / {(ab[1] + ab[2]) / 2:.2f} ms "
          f"per batch of {b}", flush=True)
    report["profile_switches_on"] = profile_forward(det_on, inputs)
    report["crop_stage"] = crop_stage(det_on, inputs, "float32")
    del det_on, out_on

    rows = check_kernels(calls, calls_on, REPS)
    del calls, calls_on
    for name, r in rows.items():
        r["launches"] = launches[name] if name in SLICE1 else launches_on[name]
    report["kernels"] = rows

    for switches in (False, True):
        agree, small = small_width_agrees(SEED, switches)
        report[f"small_width_agrees_switches_{'on' if switches else 'off'}"] = [agree, small]
        if not agree:
            raise AssertionError(f"small-width card run disagrees with the CPU run "
                                 f"(switches {'on' if switches else 'off'})")

    report["kitti"] = kitti_phase(kernels, os.path.join(args.out, "chip_smoke_kitti"))
    report["training"], train_rows = training_phase(kernels, args.out)
    rows.update(train_rows)
    report["two_stage_training"], rcnn_rows = two_stage_phase(kernels, args.out)
    rows.update(rcnn_rows)
    report["rcnn_eval"], eval_rows = rcnn_eval_phase(kernels, args.out)
    rows.update(eval_rows)
    report["export"] = export_phase(args.out, launches_on)
    report["bf16"], bf16_kernel_rows = bf16_phase(dict(kernels, **kernels_bf16), det, inputs,
                                                  launches, report["rcnn_eval"].pop("handoff"),
                                                  args.out)
    rows.update(bf16_kernel_rows)
    report["data_parallel"] = dp_phase(args.out)
    report["bf16_training"], bf16_train_rows = bf16_train_phase(dict(kernels, **kernels_bf16),
                                                                args.out)
    rows.update(bf16_train_rows)
    report["stage1_variants"], stage1_rows = stage1_variants_phase(
        kernels, args.out, report["fused_ms_per_batch"])
    rows.update(stage1_rows)
    report["workflow"], workflow_rows = workflow_phase(dict(kernels, **kernels_bf16), args.out)
    rows.update(workflow_rows)
    report["serve"] = serve_phase(det, inputs, kernels, args.out, report["workflow"]["pipeline"])

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # The KNN row's and the bf16 rows' extra keys; the bf16 convs' kernel
    # alone and their NCHW cuDNN yardstick.
    extra = ("bytes_bound_ms", "visited_bound_ms", "visited_share", "ulps", "not_bit_equal",
             "kernel_ms", "library_nchw_ms", "host_us", "cast_launches", "distinct_ms",
             "distinct_kernel_ms", "distinct_bound_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
