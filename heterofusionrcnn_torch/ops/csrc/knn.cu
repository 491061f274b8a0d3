// Exact k-nearest neighbours for the H100 (sm_90a).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_knn.py: `_knn_pallas_sorted` /
// `_knn_sorted_kernel_t` (the Morton-sorted tile-skipping arm) and the brute
// arm of `knn_pallas` (`_knn_kernel_t` + `_fold_tile_t`). Both compute the
// same function: for each query, the k candidates with the smallest direct
// squared distance (q - c)^2, ordered by (distance, candidate index).
//
// Design: one thread per query, candidates of the query's batch element
// streamed through shared memory in tiles of kTile points, a register
// top-k kept sorted by insertion. Candidates are visited in index order and
// an equal distance never displaces an earlier entry, which gives the
// (distance, index) order. The distance is rounded term by term
// (((dx*dx) + (dy*dy)) + (dz*dz), no FMA contraction) exactly as the plain
// PyTorch version computes it, so the indices match bit for bit.
//
// Bound: operations. P*N distances of ~9 FP32 operations each; the inputs
// are a few MB. The Morton tile skipping of the TPU kernel (which visits
// only nearby candidate tiles) is not ported yet: every candidate is
// scanned.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ xyz, const float* __restrict__ qrs,
           int* __restrict__ out_idx, float* __restrict__ out_dist, int n,
           int p) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < p;
  const float* cand = xyz + (size_t)b * n * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qq = qrs + ((size_t)b * p + q) * 3;
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int cnt = min(kTile, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const float* c = cand + (size_t)(t0 + i) * 3;
      sx[i] = c[0];
      sy[i] = c[1];
      sz[i] = c[2];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < cnt; ++i) {
      const float dx = __fsub_rn(qx, sx[i]);
      const float dy = __fsub_rn(qy, sy[i]);
      const float dz = __fsub_rn(qz, sz[i]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < bd[K - 1]) {
        bd[K - 1] = d;
        bi[K - 1] = t0 + i;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (bd[s] < bd[s - 1]) {
            const float td = bd[s];
            bd[s] = bd[s - 1];
            bd[s - 1] = td;
            const int ti = bi[s];
            bi[s] = bi[s - 1];
            bi[s - 1] = ti;
          }
        }
      }
    }
  }
  if (!active) return;
  const size_t o = ((size_t)b * p + q) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_idx[o + s] = bi[s];
    out_dist[o + s] = bd[s];
  }
}

template <int K>
cudaError_t launch(const float* xyz, const float* qrs, int* idx, float* dist,
                   int b, int n, int p, cudaStream_t stream) {
  dim3 grid((p + kThreads - 1) / kThreads, b);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(xyz, qrs, idx, dist, n, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xyz (B, N, 3), qrs (B, P, 3) float32; idx (B, P, k) int32, dist (B, P, k).
int hfr_knn(const float* xyz, const float* qrs, int* idx, float* dist, int b,
            int n, int p, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define HFR_KNN_CASE(K) \
  case K:               \
    return launch<K>(xyz, qrs, idx, dist, b, n, p, s);
    HFR_KNN_CASE(1) HFR_KNN_CASE(2) HFR_KNN_CASE(3) HFR_KNN_CASE(4)
    HFR_KNN_CASE(5) HFR_KNN_CASE(6) HFR_KNN_CASE(7) HFR_KNN_CASE(8)
    HFR_KNN_CASE(9) HFR_KNN_CASE(10) HFR_KNN_CASE(11) HFR_KNN_CASE(12)
    HFR_KNN_CASE(13) HFR_KNN_CASE(14) HFR_KNN_CASE(15) HFR_KNN_CASE(16)
#undef HFR_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
