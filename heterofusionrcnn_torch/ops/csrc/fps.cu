// Farthest point sampling for the H100 (sm_90a).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_fps.py:
// `farthest_point_sample_pallas` / `_fps_kernel`. Iterative max-min FPS:
// slot 0 takes point 0; each next slot takes the point whose squared
// distance to the selected set is largest, the lowest index on ties.
//
// Bound: latency. npoint - 1 dependent iterations, each an update of every
// point's distance to the last pick and an argmax over the set; the
// arithmetic (npoint * N distances) and the bytes (N*12 in, npoint*4 out)
// are far below the card's rates. One CTA per set would give the RPN's 4
// large sets 4 of the card's 132 SMs and 16 points a thread to update and
// compare each iteration.
//
// Design: each set runs on a cluster of C CTAs (1, 2, 4, 8 or 16; the
// wrapper picks C, `ops/sampling.py:fps_plan`). CTA r of the cluster owns
// the contiguous share [r * share, (r + 1) * share) of the set's points,
// each thread PPT of them strided by the block size (so its own points rise
// in index), with their x, y and running min-distance in registers and z in
// registers too up to PPT 4 (at 8 or more points a thread z waits in shared
// memory, where only its thread reads it). An iteration updates the
// distances against the last pick and takes the thread's (max, lowest
// index); the cluster argmax of cluster_argmax.cuh (one CTA barrier, one
// exchange of the CTAs' winners through distributed shared memory) then hands every thread the winner with its coordinates,
// so no thread waits on a global load of the last pick. Distances are >= 0,
// so their bit patterns order as unsigned keys. Every distance is rounded
// term by term (built without FMA contraction) like the plain PyTorch
// version, and (max key, min index) is the same over any partition, so picks
// match it bit for bit at every C.

#include <cuda_runtime.h>
#include <math.h>

#include "cluster_argmax.cuh"

namespace {

using hfr::Cand;

constexpr int kZShared = 8;  // points a thread from which z lives in shared memory

template <int PPT>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint, int share) {
  extern __shared__ float s_z[];  // blockDim.x * PPT when PPT >= kZShared
  __shared__ hfr::ArgmaxSlots slots;
  constexpr bool z_shared = PPT >= kZShared;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int csize = static_cast<int>(hfr::cluster_nctarank());
  const int rank = static_cast<int>(hfr::cluster_ctarank());
  const int set = blockIdx.x / csize;
  const int lo = rank * share;
  const int cnt = min(share, n - lo);  // may be <= 0 for the last CTAs
  const float* pts = xyz + (size_t)set * n * 3;
  int* o = out + (size_t)set * npoint;

  float px[PPT], py[PPT], pz[z_shared ? 1 : PPT], pd[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int l = tid + j * nt;
    float z = 0.f;
    px[j] = py[j] = 0.f;
    pd[j] = -INFINITY;  // never the max
    if (l < cnt) {
      const float* p = pts + (size_t)(lo + l) * 3;
      px[j] = p[0];
      py[j] = p[1];
      z = p[2];
      pd[j] = INFINITY;
    }
    if constexpr (z_shared) {
      s_z[l] = z;  // read back by this thread only
    } else {
      pz[j] = z;
    }
  }
  float lx = pts[0], ly = pts[1], lz = pts[2];
  if (tid == 0 && rank == 0) o[0] = 0;
  hfr::cluster_argmax_begin(slots);

  for (int it = 1; it < npoint; ++it) {
    // A thread without points offers key 0 and kNoIndex: it ties only with
    // a zero distance and then loses on its index.
    Cand mine{0u, hfr::kNoIndex, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
    float best = -INFINITY;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int l = tid + j * nt;
      float z;
      if constexpr (z_shared) {
        z = s_z[l];
      } else {
        z = pz[j];
      }
      const float dx = __fsub_rn(px[j], lx);
      const float dy = __fsub_rn(py[j], ly);
      const float dz = __fsub_rn(z, lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      pd[j] = fminf(pd[j], d);
      if (pd[j] > best) {
        best = pd[j];
        mine.idx = static_cast<unsigned>(lo + l);
        mine.v[0] = px[j];
        mine.v[1] = py[j];
        mine.v[2] = z;
      }
    }
    if (best >= 0.f) mine.key = __float_as_uint(best);
    const Cand win = hfr::cluster_argmax(slots, it - 1, mine);  // rounds from 0
    lx = win.v[0];
    ly = win.v[1];
    lz = win.v[2];
    if (tid == 0 && rank == 0) o[it] = static_cast<int>(win.idx);
  }
  hfr::cluster_argmax_end();
}

using Kernel = void (*)(const float*, int*, int, int, int);

Kernel kernel_for(int ppt) {
  switch (ppt) {
    case 1: return fps_kernel<1>;
    case 2: return fps_kernel<2>;
    case 4: return fps_kernel<4>;
    case 8: return fps_kernel<8>;
    case 16: return fps_kernel<16>;
    case 32: return fps_kernel<32>;
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
  int ppt = 1;
  while (ppt < need) ppt *= 2;
  *k = kernel_for(ppt);
  if (*k == nullptr) return cudaErrorInvalidValue;
  const int smem = ppt >= kZShared ? threads * ppt * static_cast<int>(sizeof(float)) : 0;
  return hfr::cluster_config(*k, b * cluster, cluster, threads, smem, stream, cfg, attr);
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xyz (B, N, 3) float32 -> out (B, npoint) int32, N <= 32768, npoint >= 1;
// each set on a cluster of `cluster` CTAs of `threads` threads (a size of
// which hfr_fps_clusters finds none fits fails to launch).
int hfr_fps(const float* xyz, int* out, int b, int n, int npoint, int cluster, int threads,
            void* stream) {
  if (b < 1 || npoint < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int share = 0;
  Kernel k = nullptr;
  cudaError_t err =
      config(b, n, cluster, threads, static_cast<cudaStream_t>(stream), cfg, attr, &share, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, k, xyz, out, n, npoint, share);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of hfr_fps's launch for sets of N points fit on the
// card at once (cudaOccupancyMaxActiveClusters; 0: none), or -(error).
int hfr_fps_clusters(int n, int cluster, int threads) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int share = 0;
  Kernel k = nullptr;
  const cudaError_t err = config(1, n, cluster, threads, 0, cfg, attr, &share, &k);
  return err == cudaSuccess ? hfr::clusters_that_fit(k, cfg) : -static_cast<int>(err);
}

}  // extern "C"
