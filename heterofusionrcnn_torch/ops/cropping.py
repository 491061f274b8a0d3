"""Point-cloud RoI crop-and-sample (port of
heterofusionrcnn_tpu/ops/cropping.py `pc_crop_and_sample`).

Per box: the points of its batch element inside the oriented box (three
dot-product interval tests), the first R of them in index order, and for
boxes with fewer members slot j repeats member j % cnt. An empty box gives
index 0 everywhere and non_empty_box_mask False.

The feature rows are gathered by `crop_gather` when the caller asks for it
(`crop_kernel=True`, the port's counterpart of the JAX package's
`HFR_PALLAS_CROP=1`, off by default there too), through the custom op
`hfr::crop_gather`: on CUDA tensors it launches the kernel of
`csrc/crop.cu` (its float32 or its bf16 entry, by the features' dtype),
on CPU tensors it runs the plain indexing gather `crop_gather_plain`,
which is also what runs with the switch off.
"""

from __future__ import annotations

import torch

from heterofusionrcnn_torch.core.geometry import points_in_box_3d
from heterofusionrcnn_torch.ops.dispatch import I, P, CudaKernel, one_device, pointers

_ARGS = [P, P, P, P] + [I] * 6
CROP_KERNEL = CudaKernel("crop.cu", {"hfr_crop_gather": _ARGS}, exact=False)
# The bf16 entry of the same library, counted apart.
CROP_BF16_KERNEL = CudaKernel("crop.cu", {"hfr_crop_gather_bf16": _ARGS}, exact=False,
                              name="crop_bf16")
# Elements of one 16-byte vector, the unit the kernel moves, by dtype.
_VEC = {torch.float32: 4, torch.bfloat16: 8}
_INDEX_DTYPES = (torch.int32, torch.int64)


def crop_gather(src: torch.Tensor, idx: torch.Tensor, box_ind: torch.Tensor) -> torch.Tensor:
    """out[i, r, :] = src[box_ind[i], idx[i, r], :] (port of
    heterofusionrcnn_tpu/ops/pallas_crop.py `crop_gather`).

    Args:
      src (B, N, C) float32 or bf16; idx (Nb, R) int in [0, N); box_ind
      (Nb,) int in [0, B). Indices are not range-checked on the card, which
      takes them int32 or int64 as they are (any other dtype raises), rows
      of whole 16-byte vectors (C % 4 == 0 in float32, C % 8 == 0 in bf16)
      and a 16-byte aligned `src`.
    Returns: (Nb, R, C) in src's dtype.
    """
    return torch.ops.hfr.crop_gather(src, idx, box_ind)


@torch.library.custom_op("hfr::crop_gather", mutates_args=(), device_types="cpu")
def _crop_op(src: torch.Tensor, idx: torch.Tensor, box_ind: torch.Tensor) -> torch.Tensor:
    return crop_gather_plain(src, idx, box_ind)


@_crop_op.register_fake
def _crop_fake(src: torch.Tensor, idx: torch.Tensor, box_ind: torch.Tensor) -> torch.Tensor:
    one_device(src, idx, box_ind)
    return src.new_empty((*idx.shape, src.shape[2]))


@_crop_op.register_kernel("cuda")
def _crop_cuda(src: torch.Tensor, idx: torch.Tensor, box_ind: torch.Tensor) -> torch.Tensor:
    one_device(src, idx, box_ind)
    b, n, c = src.shape
    nb, rows = idx.shape
    vec = _VEC.get(src.dtype)
    if vec is None or c % vec:
        raise ValueError(f"crop kernel takes float32 features with C % 4 == 0 or bf16 with "
                         f"C % 8 == 0, got {src.dtype}, C={c}")
    if box_ind.shape != (nb,):
        raise ValueError(f"box_ind must be ({nb},), got {tuple(box_ind.shape)}")
    if idx.dtype not in _INDEX_DTYPES or box_ind.dtype not in _INDEX_DTYPES:
        raise ValueError(f"crop kernel takes int32 or int64 indices, got {idx.dtype}, "
                         f"{box_ind.dtype}")
    src, idx, box_ind = (t if t.is_contiguous() else t.contiguous() for t in (src, idx, box_ind))
    if src.data_ptr() % 16:
        raise ValueError("crop kernel takes a 16-byte aligned source")
    out = torch.empty((nb, rows, c), dtype=src.dtype, device=src.device)
    kernel, fn = ((CROP_BF16_KERNEL, "hfr_crop_gather_bf16") if src.dtype == torch.bfloat16
                  else (CROP_KERNEL, "hfr_crop_gather"))
    kernel.launch(fn, *pointers(src, idx, box_ind, out), I(nb), I(n), I(rows), I(c),
                  I(idx.dtype == torch.int64), I(box_ind.dtype == torch.int64))
    return out


def crop_gather_plain(src, idx, box_ind):
    b, n, c = src.shape
    nb, rows = idx.shape
    flat = (box_ind.long()[:, None] * n + idx.long()).reshape(-1)
    return src.reshape(b * n, c)[flat].reshape(nb, rows, c)


def first_k_true(mask: torch.Tensor, k: int):
    """Indices of the first k True entries of each row in index order, and
    the count (capped at k). Slots past the count hold the first hit; rows
    without a hit give 0."""
    n = mask.shape[-1]
    ar = torch.arange(n, device=mask.device, dtype=torch.int32)
    key = torch.where(mask, ar, torch.full_like(ar, n))
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    cnt = torch.clamp(mask.sum(dim=-1), max=k).to(torch.int32)
    slot = torch.arange(k, device=mask.device)
    idx = torch.where(slot < cnt[..., None], idx, idx[..., :1])
    return torch.where(idx >= n, torch.zeros_like(idx), idx), cnt


def pc_crop_and_sample(pts, fts, intensities, mask, boxes_corners, box_ind, resize,
                       crop_kernel: bool = False):
    """Crop `resize` points per oriented 3D box; `crop_kernel` gathers the
    feature rows through `crop_gather`.

    Args:
      pts (B, N, 3), fts (B, N, C), intensities (B, N, 1), mask (B, N);
      boxes_corners (Nb, 8, 3); box_ind (Nb,) batch element of each box.
    Returns:
      crop_pts (Nb, R, 3), crop_fts (Nb, R, C), crop_intensities (Nb, R, 1),
      crop_mask (Nb, R), crop_ind (Nb, R) int32, non_empty_box_mask (Nb,).
    """
    b, n, _ = pts.shape
    nb = boxes_corners.shape[0]
    box_ind = box_ind.long()
    inside = points_in_box_3d(pts[box_ind], boxes_corners)  # (Nb, N)
    idx, cnt = first_k_true(inside, resize)
    slot = torch.arange(resize, device=pts.device)[None, :]
    wrapped = torch.where(
        cnt[:, None] > 0, slot % torch.clamp(cnt[:, None], min=1), torch.zeros_like(slot)
    )
    idx = torch.gather(idx, 1, wrapped.long())
    rows = (box_ind[:, None] * n + idx.long()).reshape(-1)
    crop_pts = pts.reshape(b * n, 3)[rows].reshape(nb, resize, 3)
    crop_int = intensities.reshape(b * n, 1)[rows].reshape(nb, resize, 1)
    crop_mask = mask.reshape(b * n)[rows].reshape(nb, resize)
    crop_fts = (crop_gather if crop_kernel else crop_gather_plain)(fts, idx, box_ind)
    return crop_pts, crop_fts, crop_int, crop_mask, idx, cnt > 0
