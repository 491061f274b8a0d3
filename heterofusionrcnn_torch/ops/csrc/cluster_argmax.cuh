// Argmax over a thread-block cluster (sm_90), shared by fps.cu and nms.cu.
//
// Every thread offers one candidate: an unsigned key, an index and up to six
// payload floats (a point's coordinates, a box). The winner is the largest
// key, the lowest index on ties. (max key, then min index) is associative
// and commutative, so any partition of the candidates over threads, warps
// and CTAs picks the same winner as one flat pass over all of them. A
// thread without a candidate offers key 0 and index kNoIndex, which loses
// to every real candidate of key 0 on its index.
//
// Levels: the warp's reduction unit (redux.sync for the largest key, again
// for the lowest index holding it), one CTA barrier over the warps'
// winners, then, in a cluster of C > 1 CTAs, lane r of warp 0 of each CTA
// stores the CTA's winner into its slot in CTA r with st.async, whose bytes
// complete a transaction count on CTA r's mbarrier for the round. Each CTA
// expects C winners' bytes a round and waits on its own mbarrier: a
// point-to-point signal instead of a barrier over every thread of the
// cluster. Every warp of every CTA then reduces the same C candidates, so
// every thread of the cluster holds the same winner and its payload; no
// thread reads another CTA's memory and none waits on global memory.
//
// Slots and mbarriers are double-buffered by the parity of the caller's
// round. A slot of parity p is written again two rounds later, only after
// its writer has received every CTA's winner of the round between, which
// each CTA sends after a CTA barrier that its readers of the slot reach
// after their reads, and after which its mbarrier phase is armed again. A cluster's kernel calls cluster_argmax_begin() before
// its first round (mbarriers initialised, every CTA started) and
// cluster_argmax_end() before it exits (no CTA leaves while another may
// still store into it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hfr {

constexpr unsigned kNoIndex = 0xffffffffu;
constexpr int kMaxCluster = 16;  // non-portable above 8

struct __align__(16) Cand {
  unsigned key, idx;
  float v[6];
};

struct ArgmaxSlots {
  Cand warp[2][32];
  Cand cta[2][kMaxCluster];
  uint64_t landed[2];  // C > 1: this round's C winners have landed in cta[parity]
};

// Constant for the kernel's life, so not volatile: the compiler may keep it.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (a CTA barrier in a cluster of one).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" :::
                   "memory");
}

// (largest key, lowest index holding it) over the warp; every lane gets it.
// Returns the lowest lane holding the winner.
__device__ __forceinline__ int warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  const unsigned low = __reduce_min_sync(0xffffffffu, key == top ? idx : kNoIndex);
  const unsigned holders = __ballot_sync(0xffffffffu, key == top && idx == low);
  key = top;
  idx = low;
  return __ffs(holders) - 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `p`'s counterpart in the cluster's CTA
// `rank` (a pure function of its operands, which the compiler may hoist).
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void store_cand(Cand* dst, const Cand& c) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(__uint_as_float(c.key), __uint_as_float(c.idx), c.v[0], c.v[1]);
  d[1] = make_float4(c.v[2], c.v[3], c.v[4], c.v[5]);
}

__device__ __forceinline__ Cand load_cand(const Cand* src) {
  const float4* s = reinterpret_cast<const float4*>(src);
  const float4 a = s[0], b = s[1];
  return Cand{__float_as_uint(a.x), __float_as_uint(a.y), {a.z, a.w, b.x, b.y, b.z, b.w}};
}

// Stores c at the shared::cluster address dst (another CTA's shared memory);
// its 32 bytes complete transactions on the mbarrier at `bar` (same CTA).
__device__ __forceinline__ void store_cand_async(uint32_t dst, const Cand& c, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dst), "r"(c.key), "r"(c.idx), "r"(__float_as_uint(c.v[0])),
      "r"(__float_as_uint(c.v[1])), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dst + 16), "r"(__float_as_uint(c.v[2])), "r"(__float_as_uint(c.v[3])),
      "r"(__float_as_uint(c.v[4])), "r"(__float_as_uint(c.v[5])), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The winner among slots[0, count), count <= 32, in every lane of the warp.
__device__ __forceinline__ Cand reduce_slots(const Cand* slots, int count, int lane) {
  unsigned key = 0u, idx = kNoIndex;
  if (lane < count) {
    key = slots[lane].key;
    idx = slots[lane].idx;
  }
  return load_cand(slots + warp_argmax(key, idx));
}

// Every thread of every CTA, before the first round.
__device__ __forceinline__ void cluster_argmax_begin(ArgmaxSlots& s) {
  if (cluster_nctarank() == 1) return;
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&s.landed[p])));
      mbar_expect_bytes(&s.landed[p], cluster_nctarank() * sizeof(Cand));  // rounds 0 and 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
}

// Every thread of every CTA, before it exits.
__device__ __forceinline__ void cluster_argmax_end() {
  if (cluster_nctarank() > 1) cluster_sync();
}

// The cluster's winner among every thread's `mine`, returned to every thread
// of the cluster. Every thread of every CTA calls it once per round, with
// rounds numbered 0, 1, 2, ...; blockDim.x is a multiple of 32.
__device__ __forceinline__ Cand cluster_argmax(ArgmaxSlots& s, unsigned round, const Cand& mine) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int csize = static_cast<int>(cluster_nctarank());
  const int p = round & 1;
  unsigned key = mine.key, idx = mine.idx;
  if (warp_argmax(key, idx) == lane) store_cand(&s.warp[p][warp], mine);
  __syncthreads();
  if (csize == 1) return reduce_slots(s.warp[p], nwarps, lane);
  if (warp == 0) {
    const Cand c = reduce_slots(s.warp[p], nwarps, lane);
    if (lane < csize)
      store_cand_async(cluster_addr(&s.cta[p][cluster_ctarank()], lane), c,
                       cluster_addr(&s.landed[p], lane));
  }
  mbar_wait(&s.landed[p], (round >> 1) & 1);
  // Arm the phase of round + 2: one arrival and C winners' bytes complete
  // it. No CTA sends that round before this CTA's next CTA barrier.
  if (threadIdx.x == 0) mbar_expect_bytes(&s.landed[p], csize * sizeof(Cand));
  return reduce_slots(s.cta[p], csize, lane);
}

// Host: the launch of `kernel` as clusters of `c` CTAs of `threads` threads
// over `grid` CTAs with `smem` bytes of dynamic shared memory. Sets the
// kernel's attributes where the launch needs them (dynamic shared memory
// above the 48 KB default, clusters of more than 8 CTAs).
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int grid, int c, int threads, int smem,
                           cudaStream_t stream, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && c > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

// Host: how many clusters of that launch fit on the card at once
// (cudaOccupancyMaxActiveClusters; 0: none), or -(error).
template <typename Kernel>
int clusters_that_fit(Kernel kernel, const cudaLaunchConfig_t& cfg) {
  int fit = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&fit, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? fit : -static_cast<int>(err);
}

// A cluster size the kernels take: 1, 2, 4, 8 or 16.
inline bool valid_cluster(int c) { return c >= 1 && c <= kMaxCluster && (c & (c - 1)) == 0; }

}  // namespace hfr
