// Oriented (rotated BEV) greedy NMS for the H100 (sm_90a).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_nms.py: `oriented_nms_pallas` /
// `_nms_kernel` with its helpers `_corners_soa` and `_edges_integral`.
// Greedy NMS: take the alive box with the best score (the lowest index on
// ties), suppress every alive box whose rotated BEV IoU with it exceeds the
// threshold, repeat max_keep times; the keep list is padded with -1.
// The IoU is the Green's-theorem line integral of core/rotated_iou.py
// (each box's edges clipped to the other, with the direction-aware
// collinear rule on the second pass).
//
// Design: every frame of the batch in one launch, one block per frame. A
// first pass writes each box's four corners and its area to a scratch
// buffer; each keep step then runs a block-wide argmax over the alive
// scores (registers -> warp shuffles -> shared memory) and one IoU of the
// chosen box against every still-alive box of the frame. Every product and
// sum is rounded on its own (built with --fmad=false), in the order of the
// plain PyTorch version.
//
// Bound: latency and operations of the sequential keep loop: max_keep
// dependent steps on one SM per frame, each ~1130 FP32 and compare
// operations per alive box (two clipping passes of 4 edges x 4 half-planes
// at ~30 each, ~10 more per half-plane for the collinear test of the second
// pass, ~10 for the IoU). The bytes (N*24 in) are negligible.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr int kThreads = 1024;

struct Quad {
  float x[4], z[4];
};

__device__ __forceinline__ Quad corners(float x1, float z1, float x2, float z2,
                                        float ry) {
  const float cx = 0.5f * (x1 + x2);
  const float cz = 0.5f * (z1 + z2);
  const float c = cosf(ry);
  const float s = sinf(ry);
  const float sx[4] = {-0.5f, 0.5f, 0.5f, -0.5f};
  const float sz[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
  Quad q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dx = sx[i] * (x2 - x1);
    const float dz = sz[i] * (z2 - z1);
    q.x[i] = dx * c + dz * s + cx;
    q.z[i] = -dx * s + dz * c + cz;
  }
  return q;
}

// Sum over A's edges of (t1 - t0) * cross(P, Q) for the part of each edge
// inside B (core/rotated_iou.py `_edges_in_poly_integral`).
__device__ __forceinline__ float edges_integral(const Quad& a, const Quad& b,
                                                bool drop_same_dir_collinear) {
  float total = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float px = a.x[e], pz = a.z[e];
    const float qx = a.x[(e + 1) & 3], qz = a.z[(e + 1) & 3];
    float t0 = 0.f, t1 = 1.f;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float hx0 = b.x[h], hz0 = b.z[h];
      const float ex = b.x[(h + 1) & 3] - hx0;
      const float ez = b.z[(h + 1) & 3] - hz0;
      const float d0 = ex * (pz - hz0) - ez * (px - hx0);
      const float d1 = ex * (qz - hz0) - ez * (qx - hx0);
      const float denom = d0 - d1;
      const float t_cross = d0 / (fabsf(denom) > kEps ? denom : 1.f);
      const bool entering = (d0 < 0.f) && (d1 >= 0.f);
      const bool leaving = (d0 >= 0.f) && (d1 < 0.f);
      bool both_out = (d0 < 0.f) && (d1 < 0.f);
      if (drop_same_dir_collinear) {
        const bool collinear = (fabsf(d0) <= kEps) && (fabsf(d1) <= kEps);
        const bool same_dir = (qx - px) * ex + (qz - pz) * ez > 0.f;
        both_out = both_out || (collinear && same_dir);
      }
      t0 = fmaxf(t0, entering ? t_cross : 0.f);
      t1 = fminf(t1, leaving ? t_cross : 1.f);
      t1 = both_out ? -1.f : t1;
    }
    const float span = fmaxf(t1 - t0, 0.f);
    total = total + span * (px * qz - pz * qx);
  }
  return total;
}

__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// boxes (B, N, 5) [x1, z1, x2, z2, ry]; scores (B, N); valid (B, N) or
// null; quads (B, N, 9) scratch; out (B, max_keep).
template <int BPT>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const unsigned char* __restrict__ valid, float* __restrict__ quads,
           int* __restrict__ out, int n, int max_keep, float thresh) {
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_sel;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const size_t base = (size_t)blockIdx.x * n;
  const float* bx = boxes + base * 5;
  float* qd = quads + base * 9;
  int* o = out + (size_t)blockIdx.x * max_keep;

  float sc[BPT];
  unsigned alive = 0u;
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    const int i = tid + j * kThreads;
    sc[j] = -INFINITY;
    if (i < n) {
      const float* r = bx + (size_t)i * 5;
      const Quad q = corners(r[0], r[1], r[2], r[3], r[4]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qd[(size_t)i * 9 + c] = q.x[c];
        qd[(size_t)i * 9 + 4 + c] = q.z[c];
      }
      qd[(size_t)i * 9 + 8] = (r[2] - r[0]) * (r[3] - r[1]);
      sc[j] = scores[base + i];
      if (valid == nullptr || valid[base + i]) alive |= 1u << j;
    }
  }
  __syncthreads();  // quads visible to the block

  for (int step = 0; step < max_keep; ++step) {
    float best = -INFINITY;
    int besti = INT_MAX;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if ((alive >> j) & 1u) take_better(best, besti, sc[j], tid + j * kThreads);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, besti, off);
      take_better(best, besti, ov, oi);
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? s_val[lane] : -INFINITY;
      besti = lane < nwarps ? s_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, besti, off);
        take_better(best, besti, ov, oi);
      }
      if (lane == 0) s_sel = besti == INT_MAX ? -1 : besti;
    }
    __syncthreads();
    const int sel = s_sel;
    if (sel < 0) {
      for (int s = step + tid; s < max_keep; s += kThreads) o[s] = -1;
      return;
    }
    if (tid == 0) o[step] = sel;

    Quad sq;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sq.x[c] = qd[(size_t)sel * 9 + c];
      sq.z[c] = qd[(size_t)sel * 9 + 4 + c];
    }
    const float s_area = qd[(size_t)sel * 9 + 8];
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if (!((alive >> j) & 1u)) continue;
      const int i = tid + j * kThreads;
      if (i == sel) {
        alive &= ~(1u << j);
        continue;
      }
      Quad q;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        q.x[c] = qd[(size_t)i * 9 + c];
        q.z[c] = qd[(size_t)i * 9 + 4 + c];
      }
      const float area = qd[(size_t)i * 9 + 8];
      float ov = edges_integral(sq, q, false);
      ov = ov + edges_integral(q, sq, true);
      ov = fmaxf(0.5f * ov, 0.f);
      const float iou = ov / fmaxf(s_area + area - ov, kEps);
      if (iou > thresh) alive &= ~(1u << j);
    }
  }
}

template <int BPT>
cudaError_t launch(const float* boxes, const float* scores,
                   const unsigned char* valid, float* quads, int* out, int b,
                   int n, int max_keep, float thresh, cudaStream_t stream) {
  nms_kernel<BPT><<<b, kThreads, 0, stream>>>(boxes, scores, valid, quads, out,
                                               n, max_keep, thresh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// N <= 32 * 1024 boxes per frame.
int hfr_nms(const float* boxes, const float* scores, const unsigned char* valid,
            float* quads, int* out, int b, int n, int max_keep, float thresh,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bpt = (n + kThreads - 1) / kThreads;
#define HFR_NMS_CASE(BPT)                                                  \
  if (bpt <= BPT)                                                          \
    return launch<BPT>(boxes, scores, valid, quads, out, b, n, max_keep,   \
                       thresh, s);
  HFR_NMS_CASE(1) HFR_NMS_CASE(2) HFR_NMS_CASE(4) HFR_NMS_CASE(8)
  HFR_NMS_CASE(16) HFR_NMS_CASE(32)
#undef HFR_NMS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
