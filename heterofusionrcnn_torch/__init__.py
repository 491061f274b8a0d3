"""HeteroFusionRCNN in PyTorch + CUDA for NVIDIA Hopper (H100).

The two-stage LiDAR+camera KITTI detector of `heterofusionrcnn_tpu`,
written in PyTorch, with hand-written `sm_90a` CUDA kernels for the hot
ops of inference: exact KNN, farthest point sampling, the fused XConv,
oriented (rotated-BEV) NMS and, behind switches that are off by default,
the fused 3x3 conv and transposed conv of the VGG pyramid and the RCNN
crop's row gather (`ops/csrc/*.cu`, built with `nvcc` at first use). Every
kernel wrapper dispatches by the device of its input: a CUDA tensor
launches the kernel, a CPU tensor runs the plain PyTorch version beside
it, and nothing falls back from one to the other. The KITTI inference CLI
is `python -m heterofusionrcnn_torch.experiments.run_inference`.

Layouts follow the JAX package at public functions: points (B, N, 3),
images NHWC, box_3d [x, y, z, l, w, h, ry]. Weights are interchangeable
with the flax models through `heterofusionrcnn_torch.convert`.

This package imports neither jax nor `heterofusionrcnn_tpu`.
"""

__version__ = "0.1.0"
