// RoI feature row gather for the H100 (sm_90a).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_crop.py `crop_gather` /
// `_crop_gather_kernel`: out[i, r, :] = src[box_ind[i], idx[i, r], :], the
// feature half of the RCNN's point crop (400 boxes x 512 rows x 288
// channels at batch 4 on the port's main path).
//
// Design: a pure copy, so it is exact by construction. One block per
// (box, group of kRows rows); each warp copies one row at a time, its 32
// lanes moving consecutive 16-byte vectors (4 float32 or 8 bf16 values; the
// wrapper takes C % 4 == 0, or C % 8 == 0 in bf16, and 16-byte aligned
// tensors only), so every read of a source row and every write of an
// output row is a run of full 32-byte sectors. The kernel moves 16-byte
// vectors whatever the element type: `hfr_crop_gather` (float32 rows) and
// `hfr_crop_gather_bf16` (bf16 rows, the bf16 serving path's `rpn_fts`)
// differ only in the row's length in vectors.
// The box's batch element and the row indices are read by the block
// itself. No shared memory: nothing is reused within a block.
//
// Bound: bytes. Each distinct gathered row is read once and each output
// row written once (plus the indices); rows repeated by the crop's wrap
// fill come from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // rows per block

// Rows of `vecs` 16-byte vectors.
__global__ void __launch_bounds__(kThreads)
crop_gather_kernel(const uint4* __restrict__ src, const int* __restrict__ idx,
                   const int* __restrict__ box_ind, uint4* __restrict__ out,
                   int n, int rows, int vecs) {
  const int box = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint4* base = src + (size_t)box_ind[box] * n * vecs;
  const int r_end = min(rows, (int)(blockIdx.x + 1) * kRows);
  for (int r = blockIdx.x * kRows + warp; r < r_end; r += kWarps) {
    const size_t o = (size_t)box * rows + r;
    const uint4* s4 = base + (size_t)idx[o] * vecs;
    uint4* d4 = out + o * vecs;
    for (int k = lane; k < vecs; k += 32) d4[k] = __ldg(s4 + k);
  }
}

int launch(const void* src, const int* idx, const int* box_ind, void* out, int nb, int n,
           int rows, int vecs, cudaStream_t s) {
  if (nb <= 0 || n <= 0 || rows <= 0 || vecs <= 0 || nb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((rows + kRows - 1) / kRows, nb);
  crop_gather_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(src), idx, box_ind,
                                               static_cast<uint4*>(out), n, rows, vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// src (B, N, C) float32, idx (Nb, R) int32 in [0, N), box_ind (Nb,) int32 in
// [0, B); out (Nb, R, C). C % 4 == 0, src and out 16-byte aligned.
int hfr_crop_gather(const float* src, const int* idx, const int* box_ind,
                    float* out, int nb, int n, int rows, int c, void* stream) {
  if (c <= 0 || c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(src, idx, box_ind, out, nb, n, rows, c / 4, static_cast<cudaStream_t>(stream));
}

// The same with src and out bf16 (2-byte elements); C % 8 == 0.
int hfr_crop_gather_bf16(const void* src, const int* idx, const int* box_ind, void* out,
                         int nb, int n, int rows, int c, void* stream) {
  if (c <= 0 || c % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(src, idx, box_ind, out, nb, n, rows, c / 8, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
