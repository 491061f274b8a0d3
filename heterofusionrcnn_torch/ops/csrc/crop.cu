// RoI feature row gather for the H100 (sm_90a).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_crop.py `crop_gather` /
// `_crop_gather_kernel`: out[i, r, :] = src[box_ind[i], idx[i, r], :], the
// feature half of the RCNN's point crop (400 boxes x 512 rows x 288
// channels at batch 4 on the port's main path, float32 or bf16).
//
// Bound: bytes. A pure copy, exact by construction: each distinct gathered
// row is read once, each output row written once (236 MB of output in
// float32, 118 MB in bf16 at the main path's shape), plus the indices. The
// output's write stream is most of it, and with random weights most boxes
// are empty, so their rows all gather row 0 of their batch element: a few
// source rows are read hundreds of thousands of times.
//
// Design: one block of 256 threads per 32 consecutive output rows (a 1-D
// grid over the Nb * R rows, so no limit on the boxes). The block's 32
// source row offsets are read once into shared memory (32 threads, the
// indices int32 or int64 as the caller has them: no cast kernel), then its
// rows are copied as one flat run of 16-byte vectors: thread t takes
// vectors t, t + 256, ..., kU loads in flight before their stores, so every
// warp instruction moves 512 contiguous bytes of output and the rows' ends
// cost no idle lanes. Loads go through L1 (`ld.global.nc`), where the hot
// rows of empty boxes stay; the output leaves by streaming stores
// (`st.global.cs`, evict-first), so it does not push source rows out of
// L2. 28 registers a thread keep 64 warps an SM in flight. The row length
// in vectors is a run-time value (builds with the main path's 36 and 72 as
// constants measured the same). Both C entries share the kernel: it moves
// 16-byte vectors whatever the element type (C % 4 == 0 in float32,
// C % 8 == 0 in bf16; 16-byte aligned tensors).
//
// Tried on this card and dropped (PERF.md; `tools/crop_ablation.py`):
// rows moved by bulk copies (TMA) through a ring of shared-memory stages on
// a persistent grid of one-warp CTAs, one bulk store per tile. Bulk copies
// read L2, not L1, so the empty boxes' copies of one row queued on the L2
// slice holding it (2.5x slower than this kernel in bf16); reading each
// run of repeated rows once and replicating it in shared memory left one
// warp per CTA doing the replication (still 1.6x slower). Persistent warps
// with 9 loads in flight a lane spilled registers and ran fewer warps
// (1.2-1.8x slower).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // output rows a block
constexpr int kU = 4;      // 16-byte loads in flight a thread

struct Args {
  const uint4* src;       // (B, N, C) rows of `vecs` 16-byte vectors
  const void* idx;        // (Nb, R) int32 or int64
  const void* box_ind;    // (Nb,) int32 or int64
  uint4* out;             // (Nb, R, C)
  long long total;        // Nb * R rows
  int n, rows, vecs, idx64, box64;
};

__device__ __forceinline__ long long load_index(const void* p, long long i, int wide) {
  return wide ? __ldg(static_cast<const long long*>(p) + i) : __ldg(static_cast<const int*>(p) + i);
}

__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(kThreads) crop_gather_kernel(Args a) {
  __shared__ long long s_off[kRows];  // the block's rows' source offsets, in vectors
  const int vecs = a.vecs;
  const long long g0 = (long long)blockIdx.x * kRows;
  const int cnt = (int)min((long long)kRows, a.total - g0);
  if ((int)threadIdx.x < cnt) {
    const long long g = g0 + threadIdx.x;
    s_off[threadIdx.x] =
        (load_index(a.box_ind, g / a.rows, a.box64) * a.n + load_index(a.idx, g, a.idx64)) * vecs;
  }
  __syncthreads();
  const int span = cnt * vecs;
  uint4* dst = a.out + g0 * vecs;
  for (int p0 = threadIdx.x; p0 < span; p0 += kThreads * kU) {
    uint4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = p0 + u * kThreads;
      if (p < span) v[u] = __ldg(a.src + s_off[p / vecs] + p % vecs);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = p0 + u * kThreads;
      if (p < span) st_stream(dst + p, v[u]);
    }
  }
}

int launch(const void* src, const void* idx, const void* box_ind, void* out, int nb, int n,
           int rows, int row_bytes, int idx64, int box64, cudaStream_t s) {
  const long long total = (long long)nb * rows;
  const long long grid = (total + kRows - 1) / kRows;  // a 1-D grid: at most 2^31 - 1 blocks
  if (nb <= 0 || n <= 0 || rows <= 0 || row_bytes <= 0 || row_bytes % 16 || grid > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = row_bytes / 16;
  Args a{static_cast<const uint4*>(src), idx, box_ind, static_cast<uint4*>(out),
         total, n, rows, vecs, idx64, box64};
  crop_gather_kernel<<<(unsigned)grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// src (B, N, C) float32, idx (Nb, R) in [0, N), box_ind (Nb,) in [0, B),
// each int32 or int64 (idx64, box64 say which); out (Nb, R, C). C % 4 == 0,
// src and out 16-byte aligned.
int hfr_crop_gather(const float* src, const void* idx, const void* box_ind, float* out, int nb,
                    int n, int rows, int c, int idx64, int box64, void* stream) {
  if (c <= 0 || c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(src, idx, box_ind, out, nb, n, rows, c * 4, idx64, box64,
                static_cast<cudaStream_t>(stream));
}

// The same with src and out bf16 (2-byte elements); C % 8 == 0.
int hfr_crop_gather_bf16(const void* src, const void* idx, const void* box_ind, void* out, int nb,
                         int n, int rows, int c, int idx64, int box64, void* stream) {
  if (c <= 0 || c % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(src, idx, box_ind, out, nb, n, rows, c * 2, idx64, box64,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
