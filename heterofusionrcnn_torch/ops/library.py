"""The port's custom ops: importing this module registers every op of the
namespace `hfr` (`torch.ops.hfr.*`), one for each kernel the main path
reaches. A loaded `torch.export` artifact calls them by name, so it needs
this registration (`runtime.export.load_exported` imports it).

| op | wrapper | kernels (`ops/csrc`) |
| --- | --- | --- |
| `knn` | `grouping.knn_point` | `knn.cu`: brute scan, or prep + sorted search |
| `farthest_point_sample` | `sampling.farthest_point_sample` | `fps.cu` |
| `oriented_nms` | `nms.oriented_nms` | `nms.cu` |
| `fused_xconv` | `xconv.fused_xconv` | `xconv.cu` (+ `xconv_split_epilogue`) |
| `xconv_split_epilogue` | `xconv.xconv_split_epilogue` | `xconv.cu`'s epilogue |
| `crop_gather` | `cropping.crop_gather` | `crop.cu` |
| `conv3x3_affine_relu` | `conv.conv3x3_affine_relu` | `conv.cu` |
| `convtranspose3x3_affine_relu` | `conv.convtranspose3x3_affine_relu` | `convt.cu` |

Each op runs the kernel on CUDA tensors and the plain version on CPU
tensors, chosen by the dispatcher's device key, and has a fake function
that gives its outputs' shapes and dtypes. `fused_xconv`,
`xconv_split_epilogue`, `crop_gather` and the two convs also have a bf16
form (the bf16 serving path), a second C entry of the same source
(`*_bf16`, counted apart), picked by the input's dtype (the XConv's
`compute_dtype`, the epilogue's `out_dtype`); any other dtype raises.
"""

from __future__ import annotations

from heterofusionrcnn_torch.ops import conv, cropping, grouping, nms, sampling, xconv  # noqa: F401

OPS = ("knn", "farthest_point_sample", "oriented_nms", "fused_xconv", "xconv_split_epilogue",
       "crop_gather", "conv3x3_affine_relu", "convtranspose3x3_affine_relu")
