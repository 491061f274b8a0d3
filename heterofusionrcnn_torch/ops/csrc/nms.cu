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
// Bound: operations and latency of the sequential keep loop: max_keep
// dependent steps, each ~1130 FP32 and compare operations per alive box
// (two clipping passes of 4 edges x 4 half-planes at ~30 each, ~10 more per
// half-plane for the collinear test of the second pass, ~10 for the IoU).
// The bytes (N*25 in) are negligible. One CTA per frame would do the RPN's
// ~9000 IoUs a step on 4 of the card's 132 SMs.
//
// Design: each frame runs on a cluster of C CTAs (1, 2, 4, 8 or 16; the
// wrapper picks C, `ops/nms.py:nms_plan`). CTA r owns the contiguous share
// [r * share, (r + 1) * share) of the frame's boxes, each thread BPT of them
// strided by the block size, their scores (as ordered keys) and alive bits
// in registers. A first pass puts each box's centre, cos, sin and extents
// into shared memory (24 bytes a box, so the RPN's 9000 fit even one CTA),
// where only its thread reads them; each IoU rebuilds the corners from
// them with the plain version's arithmetic. Each keep step
// takes the thread's best alive box and runs the cluster argmax of
// cluster_argmax.cuh with that box's frame as payload, so every thread of
// the cluster gets the chosen box's corners without a global read; every
// CTA then suppresses its own alive boxes. The "nothing alive" exit is the
// same decision in every CTA (they all reduced the same candidates). Every
// product and sum is rounded on its own (built with --fmad=false), in the
// order of the plain PyTorch version, and (max score, min index) is the
// same over any partition, so keep lists match it bit for bit at every C.

#include <cuda_runtime.h>
#include <math.h>

#include "cluster_argmax.cuh"

namespace {

using hfr::Cand;

constexpr float kEps = 1e-8f;
constexpr int kFrame = 6;  // floats of a box in shared memory: cx, cz, c, s, w, h

struct Quad {
  float x[4], z[4];
};

// The corners of a box from its centre, cos, sin and extents (w = x2 - x1,
// h = z2 - z1), CCW in (x, z) from (x1, z1).
__device__ __forceinline__ Quad corners(const float (&f)[kFrame]) {
  const float sx[4] = {-0.5f, 0.5f, 0.5f, -0.5f};
  const float sz[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
  Quad q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dx = sx[i] * f[4];
    const float dz = sz[i] * f[5];
    q.x[i] = dx * f[2] + dz * f[3] + f[0];
    q.z[i] = -dx * f[3] + dz * f[2] + f[1];
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

// Scores as unsigned keys in the order of the floats (-0 taken as +0, so
// the two tie as they compare equal); every score has a key above 0.
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// boxes (B, N, 5) [x1, z1, x2, z2, ry]; scores (B, N); valid (B, N) or
// null; out (B, max_keep). Dynamic shared memory: kFrame * share floats.
template <int BPT>
__global__ void __launch_bounds__(1024)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const unsigned char* __restrict__ valid, int* __restrict__ out, int n,
           int max_keep, float thresh, int share) {
  extern __shared__ float s_frame[];  // [kFrame][share]
  __shared__ hfr::ArgmaxSlots slots;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int csize = static_cast<int>(hfr::cluster_nctarank());
  const int rank = static_cast<int>(hfr::cluster_ctarank());
  const int frame = blockIdx.x / csize;
  const int lo = rank * share;
  const int cnt = min(share, n - lo);  // may be <= 0 for the last CTAs
  const size_t base = (size_t)frame * n;
  int* o = out + (size_t)frame * max_keep;

  unsigned key[BPT];
  unsigned alive = 0u;
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    const int l = tid + j * nt;
    key[j] = 0u;
    if (l < cnt) {
      const size_t i = base + lo + l;
      const float* r = boxes + i * 5;
      const float x1 = r[0], z1 = r[1], x2 = r[2], z2 = r[3], ry = r[4];
      s_frame[0 * share + l] = 0.5f * (x1 + x2);
      s_frame[1 * share + l] = 0.5f * (z1 + z2);
      s_frame[2 * share + l] = cosf(ry);
      s_frame[3 * share + l] = sinf(ry);
      s_frame[4 * share + l] = x2 - x1;
      s_frame[5 * share + l] = z2 - z1;
      key[j] = score_key(scores[i]);
      if (valid == nullptr || valid[i]) alive |= 1u << j;
    }
  }

  hfr::cluster_argmax_begin(slots);

  for (int step = 0; step < max_keep; ++step) {
    Cand mine{0u, hfr::kNoIndex, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
    int mine_l = -1;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      // j rises with the index, so ">" keeps the lowest index of a tie.
      if (((alive >> j) & 1u) && key[j] > mine.key) {
        mine.key = key[j];
        mine_l = tid + j * nt;
      }
    }
    if (mine_l >= 0) {
      mine.idx = static_cast<unsigned>(lo + mine_l);
#pragma unroll
      for (int c = 0; c < kFrame; ++c) mine.v[c] = s_frame[c * share + mine_l];
    }
    const Cand win = hfr::cluster_argmax(slots, step, mine);
    if (win.idx == hfr::kNoIndex) {  // nothing alive in the frame: every CTA stops here
      if (rank == 0)
        for (int s = step + tid; s < max_keep; s += nt) o[s] = -1;
      break;
    }
    if (rank == 0 && tid == 0) o[step] = static_cast<int>(win.idx);

    const Quad sq = corners(win.v);
    const float s_area = win.v[4] * win.v[5];
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if (!((alive >> j) & 1u)) continue;
      const int l = tid + j * nt;
      if (static_cast<unsigned>(lo + l) == win.idx) {
        alive &= ~(1u << j);
        continue;
      }
      float f[kFrame];
#pragma unroll
      for (int c = 0; c < kFrame; ++c) f[c] = s_frame[c * share + l];
      const Quad q = corners(f);
      const float area = f[4] * f[5];
      float ov = edges_integral(sq, q, false);
      ov = ov + edges_integral(q, sq, true);
      ov = fmaxf(0.5f * ov, 0.f);
      const float iou = ov / fmaxf(s_area + area - ov, kEps);
      if (iou > thresh) alive &= ~(1u << j);
    }
  }
  hfr::cluster_argmax_end();
}

using Kernel = void (*)(const float*, const float*, const unsigned char*, int*, int, int, float,
                        int);

Kernel kernel_for(int bpt) {
  switch (bpt) {
    case 1: return nms_kernel<1>;
    case 2: return nms_kernel<2>;
    case 4: return nms_kernel<4>;
    case 8: return nms_kernel<8>;
    case 16: return nms_kernel<16>;
    case 32: return nms_kernel<32>;
    default: return nullptr;
  }
}

cudaError_t config(int b, int n, int cluster, int threads, cudaStream_t stream,
                   cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int* share, Kernel* k) {
  if (n < 1 || n > 32768 || !hfr::valid_cluster(cluster) || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return cudaErrorInvalidValue;
  *share = (n + cluster - 1) / cluster;
  const int need = (*share + threads - 1) / threads;
  int bpt = 1;
  while (bpt < need) bpt *= 2;
  *k = kernel_for(bpt);
  if (*k == nullptr) return cudaErrorInvalidValue;
  const int smem = kFrame * *share * static_cast<int>(sizeof(float));
  return hfr::cluster_config(*k, b * cluster, cluster, threads, smem, stream, cfg, attr);
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// N <= 32768 boxes per frame, each frame on a cluster of `cluster` CTAs of
// `threads` threads (a size of which hfr_nms_clusters finds none fits fails
// to launch); a CTA holds 24 bytes of shared memory per box of its share.
int hfr_nms(const float* boxes, const float* scores, const unsigned char* valid, int* out, int b,
            int n, int max_keep, float thresh, int cluster, int threads, void* stream) {
  if (b < 1 || max_keep < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int share = 0;
  Kernel k = nullptr;
  cudaError_t err =
      config(b, n, cluster, threads, static_cast<cudaStream_t>(stream), cfg, attr, &share, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, k, boxes, scores, valid, out, n, max_keep, thresh, share);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of hfr_nms's launch for frames of N boxes fit on the
// card at once (cudaOccupancyMaxActiveClusters; 0: none), or -(error).
int hfr_nms_clusters(int n, int cluster, int threads) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int share = 0;
  Kernel k = nullptr;
  const cudaError_t err = config(1, n, cluster, threads, 0, cfg, attr, &share, &k);
  return err == cudaSuccess ? hfr::clusters_that_fit(k, cfg) : -static_cast<int>(err);
}

}  // extern "C"
