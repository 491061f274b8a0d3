// Shared pieces of the tensor-core kernels (conv.cu, convt.cu, xconv.cu):
// the 3xTF32 split, Hopper's warpgroup MMA (`wgmma.mma_async`, sm_90a) on
// TF32 with FP32 accumulators (A from registers or, for xconv.cu, from
// shared memory), the cp.async copies, the tile loaders and mbarriers.
//
// 3xTF32. A TF32 product keeps 11 significant bits of each operand, about
// three decimal digits, too few for a 2304-term sum held to 1e-4 of FP32.
// Each operand is split as v = big + small with big = tf32(v) and small =
// tf32(v - big) (round to nearest, ties away from zero, on the low 13
// mantissa bits), and the product is a_small b_big + a_big b_small +
// a_big b_big; the dropped a_small b_small and the rounding of the small
// parts are about 2^-21 of each product. The wrapper splits the weights
// once per call; the kernels split the activations as they load them into
// registers.
//
// Sums. The tensor cores truncate each MMA's sum toward zero, so products
// accumulated into one register over the whole K would drift toward zero
// by up to one ulp of the running sum per MMA: about 1e-4 of the output
// over the 864 MMAs of K = 2304 (three per k-step), enough to miss the
// 1e-4 gate against FP32. The kernels therefore chain the products of a
// few k-steps in a scratch accumulator that starts from zero and add it to
// the running sum with an FP32 add (round to nearest).
//
// wgmma. One warpgroup (4 warps) multiplies a 64 x 8 A tile from registers
// by an 8 x N B tile from shared memory (m64nNk8, N = 32 or 64). TF32 takes
// shared-memory operands only K-major, so A (pixels x channels, staged
// NCHW with pixels contiguous) comes from registers, where each warp holds
// 16 rows as mma.m16n8k8 does; for lane l, g = l / 4 and t = l % 4:
//   A: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   D: for each n8 block j, d[4j] (row g, col 8j + 2t), d[4j + 1]
//      (g, 8j + 2t + 1), d[4j + 2] (g + 8, 8j + 2t), d[4j + 3]
//      (g + 8, 8j + 2t + 1); warp w holds rows 16 w .. 16 w + 15.
// B is K-major without swizzle: 8 x 4 core matrices (8 output channels x
// 4 k, 128 contiguous bytes), the two k halves 128 bytes apart (the
// descriptor's leading byte offset) and the 8-channel groups 256 bytes
// apart (its stride byte offset). A 32-byte swizzle measured the same.
//
// The wrapper (`ops/conv.py`, `arrange_b`) hands the weight over in that
// layout: [k-step][big, small][8-channel group][k half][8][4] floats, the
// output channels padded with zeros to a multiple of kNAlign, so a block
// copies each (k-step, part) slice of its channel groups as one contiguous
// run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hfr {

constexpr int kNAlign = 64;  // output channels of the arranged weight padded to this

// A staged input plane holds `n` floats; its stride is padded to 8 mod 32
// words, so the 4 x 8 lanes reading an A fragment (channel t, pixel g) hit
// 32 different banks.
__host__ __device__ constexpr int plane_stride(int n) { return (n + 31) / 32 * 32 + 8; }

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small, both TF32 bit patterns.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// Loads the A fragment at `p` (pixel g of the warp's 16, channel t) with
// its partners at +8 pixels and +4 channels (`c4` floats on), and splits it.
__device__ __forceinline__ void load_a(const float* p, int c4, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8], big[1], small[1]);
  split_tf32(p[c4], big[2], small[2]);
  split_tf32(p[c4 + 8], big[3], small[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte copy, zero-filled when !valid (the source is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Stages 8 input channels ci0 .. ci0 + 7 of one image (`xb`, C x H x W):
// rows gy0 .. gy0 + rows - 1 and columns gx0 .. gx0 + cols - 1, zero
// outside the image and for channels >= cin. Plane c of the tile starts at
// dst + c * ps, row r at + r * cols.
template <int kThreads>
__device__ __forceinline__ void load_input_tile(float* dst, const float* xb, int cin, int ci0,
                                                int h, int w, int gy0, int gx0, int rows,
                                                int cols, int ps) {
  const int plane = rows * cols;
  for (int i = threadIdx.x; i < 8 * plane; i += kThreads) {
    const int c = i / plane;
    const int rem = i - c * plane;
    const int r = rem / cols;
    const int col = rem - r * cols;
    const int gy = gy0 + r;
    const int gx = gx0 + col;
    const bool valid = ci0 + c < cin && gy >= 0 && gy < h && gx >= 0 && gx < w;
    const float* src = valid ? xb + ((size_t)(ci0 + c) * h + gy) * w + gx : xb;
    cp_async4(dst + c * ps + r * cols + col, src, valid);
  }
}

// Stages k-steps ks0 .. ks0 + steps - 1 of the arranged weight (`wt`,
// [ks][part][ngt groups][16] float4) for the channel groups ng0 .. ng0 +
// ngn - 1, as [step][part][ngn][16] float4: one B tile per (k-step, part).
template <int kThreads>
__device__ __forceinline__ void load_weight_stage(float4* dst, const float4* wt, int ks0,
                                                  int steps, int ngt, int ng0, int ngn) {
  const int per = ngn * 16;
  for (int i = threadIdx.x; i < 2 * steps * per; i += kThreads) {
    const int sp = i / per;  // 2 * step + part
    const int j = i - sp * per;
    cp_async16(dst + i, wt + ((size_t)(2 * ks0 + sp) * ngt + ng0) * 16 + j);
  }
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a B tile, no swizzle: start address,
// leading byte offset (between the two k halves, 128) and stride byte
// offset (between 8-channel groups, 256), each in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// cp.async writes shared memory through the generic proxy and wgmma reads
// it through the async proxy: this orders the two.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Keeps the compiler from reading accumulators before the wgmma that
// writes them has been waited for.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32) = A (64 x 8, registers) B (8 x 32, desc) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x 64) = A (64 x 8, registers) B (8 x 64, desc) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// tmp[m] = a[m] b in 3xTF32 for the warpgroup's MT row tiles, + tmp[m]
// when accumulate: a_small b_big, a_big b_small and a_big b_big, issued
// tile by tile within each product so the tiles' chains overlap; `big` and
// `small` are the descriptors of the two parts' B tiles.
template <int N, int MT>
__device__ __forceinline__ void wgmma_3xtf32(float (&tmp)[MT][N / 2],
                                             const uint32_t (&a_big)[MT][4],
                                             const uint32_t (&a_small)[MT][4], uint64_t big,
                                             uint64_t small, int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma tile width");
#pragma unroll
  for (int part = 0; part < 3; ++part) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint32_t(&a)[4] = part == 0 ? a_small[m] : a_big[m];
      const uint64_t desc = part == 1 ? small : big;
      const int acc = part == 0 ? accumulate : 1;
      if constexpr (N == 32) {
        wgmma_n32(tmp[m], a, desc, acc);
      } else {
        wgmma_n64(tmp[m], a, desc, acc);
      }
    }
  }
}

// --- A from shared memory (wgmma SS), mbarriers ---------------------------
//
// An A tile (64 rows x 8 k, one TF32 part) staged K-major exactly as a B
// tile is: 8 x 4 core matrices (8 rows x 4 k, 128 contiguous bytes), the
// two k halves 128 bytes apart and the 8-row groups 256 bytes apart, i.e.
// [row / 8][k / 4][row % 8][k % 4] floats; `b_desc` describes it as well.

// d (64 x 128) = A (64 x 8, desc a) B (8 x 128, desc b) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Blocks until the phase of `bar` with the given parity has completed. A
// freshly initialised barrier counts its phase "before 0" (parity 1) as
// completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// --- thread block clusters (sm_90) ---------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The shared::cluster address of `p`'s counterpart in the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t mapa(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Arrive on an mbarrier of any CTA of the cluster (release, cluster scope).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(addr)
               : "memory");
}

// mbar_wait with acquire at cluster scope, for phases completed by
// arrivals from other CTAs of the cluster.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Makes mbarrier initialisations visible to the cluster.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Every thread of every CTA of the cluster (a CTA barrier in a cluster of one).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" :::
                   "memory");
}

// Hand registers between warpgroups (sm_90a): every thread of a warpgroup
// moves to N registers (a multiple of 8).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// Barrier `id` (1..15) over the `count` threads (a multiple of 32) that reach it.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

}  // namespace hfr
