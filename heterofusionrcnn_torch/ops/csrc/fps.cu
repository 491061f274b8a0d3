// Farthest point sampling for the H100 (sm_90a).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_fps.py:
// `farthest_point_sample_pallas` / `_fps_kernel`. Iterative max-min FPS:
// slot 0 takes point 0; each next slot takes the point whose squared
// distance to the selected set is largest, the lowest index on ties.
//
// Design: one block per point set. Each thread owns PPT points (strided by
// the block size, so its own points rise in index) and keeps their x, y and
// running min-distance in registers; z waits in shared memory (all four in
// registers spill at 16 points a thread). An iteration updates the
// distances against the last pick and takes the thread's (max, lowest
// index). The block-wide argmax runs on the warp reduction unit: distances
// are >= 0, so their bit patterns order as unsigned integers; one redux.sync
// takes the warp's largest distance, a second the lowest index holding it,
// and warp 0 repeats both over the warps' winners. The distance is rounded
// term by term (no FMA contraction) like the plain PyTorch version, so picks
// match bit for bit.
//
// Bound: latency. npoint dependent iterations, each a block-wide argmax
// (two barriers); the arithmetic (npoint * N distances) and the bytes
// (N*12 in, npoint*4 out) are far below the card's rates.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

// (largest key, lowest index holding it) over the warp; every lane gets it.
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == top ? idx : 0xffffffffu);
  key = top;
}

template <int PPT>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
           int npoint) {
  extern __shared__ float s_z[];  // n
  __shared__ unsigned s_key[32];
  __shared__ unsigned s_idx[32];
  __shared__ int s_sel;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nt + 31) >> 5;
  const float* pts = xyz + (size_t)blockIdx.x * n * 3;
  int* o = out + (size_t)blockIdx.x * npoint;

  float px[PPT], py[PPT], pd[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = tid + j * nt;
    if (i < n) {
      px[j] = pts[i * 3 + 0];
      py[j] = pts[i * 3 + 1];
      s_z[i] = pts[i * 3 + 2];
      pd[j] = INFINITY;
    } else {
      px[j] = py[j] = 0.f;
      pd[j] = -INFINITY;  // never the max
    }
  }
  __syncthreads();

  int last = 0;
  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) o[it] = last;
    const float lx = pts[last * 3 + 0];
    const float ly = pts[last * 3 + 1];
    const float lz = pts[last * 3 + 2];
    float best = -INFINITY;
    int besti = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * nt;
      const float dx = __fsub_rn(px[j], lx);
      const float dy = __fsub_rn(py[j], ly);
      const float dz = __fsub_rn(i < n ? s_z[i] : 0.f, lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      pd[j] = fminf(pd[j], d);
      if (pd[j] > best) {
        best = pd[j];
        besti = i;
      }
    }
    // A thread without points offers key 0, which ties only with a zero
    // distance and then loses on its index (INT_MAX).
    unsigned key = best >= 0.f ? __float_as_uint(best) : 0u;
    unsigned idx = static_cast<unsigned>(besti);
    warp_argmax(key, idx);
    if (lane == 0) {
      s_key[warp] = key;
      s_idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      key = lane < nwarps ? s_key[lane] : 0u;
      idx = lane < nwarps ? s_idx[lane] : 0xffffffffu;
      warp_argmax(key, idx);
      if (lane == 0) s_sel = static_cast<int>(idx);
    }
    __syncthreads();
    last = s_sel;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int* out, int b, int n, int npoint,
                   int threads, cudaStream_t stream) {
  const int bytes = n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<b, threads, bytes, stream>>>(xyz, out, n, npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xyz (B, N, 3) float32 -> out (B, npoint) int32. N <= 32768.
int hfr_fps(const float* xyz, int* out, int b, int n, int npoint,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  const int ppt = (n + threads - 1) / threads;
  if (ppt <= 1) return launch<1>(xyz, out, b, n, npoint, threads, s);
  if (ppt <= 2) return launch<2>(xyz, out, b, n, npoint, threads, s);
  if (ppt <= 4) return launch<4>(xyz, out, b, n, npoint, threads, s);
  if (ppt <= 8) return launch<8>(xyz, out, b, n, npoint, threads, s);
  if (ppt <= 16) return launch<16>(xyz, out, b, n, npoint, threads, s);
  if (ppt <= 32) return launch<32>(xyz, out, b, n, npoint, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
