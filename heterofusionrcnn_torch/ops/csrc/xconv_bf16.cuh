// The bf16 form of the fused inference XConv (xconv.cu) for the H100
// (sm_90a): bf16 operands on the tensor cores, float32 sums and affines,
// a bf16 output.
//
// Replaces the `compute_dtype=jnp.bfloat16` form of
// heterofusionrcnn_tpu/ops/pallas_xconv.py `fused_xconv` /
// `_xconv_kernel`, rounding to bf16 exactly where that kernel casts to its
// compute dtype and nowhere else:
//   - the local coordinates before lift-1 and X_0 (pallas_xconv.py:132,
//     :149), the lift-1 output before lift-2 (:138), X_0 and X_1 before
//     X_1 and X_2 (:151, :153), the (X @ in) stacks before Wc (:181);
//   - every weight once (:317-329; the wrapper rounds Wc, composed in
//     float32, when it arranges it: `ops/xconv.py`,
//     `xconv_weight_operand_bf16`);
//   - the gathered features arrive in bf16 (pointcnn.py:302, :320) and are
//     widened exactly; the lifted features f2 and X_2 stay float32;
//   - the output (`out_dtype` defaults to the compute dtype); the split
//     path's partial sums stay float32 and its epilogue rounds.
//
// Bound: operations. The separable conv, 2 P K Cin D FLOPs, is most of the
// work: a GEMM with M = queries, N = D and the contraction (k, c) over
// K Cin, here at the bf16 tensor-core rate.
//
// Design (a simple first form; `mma.sync.m16n8k16` bf16, no warp
// specialisation): one block of 8 warps per (64 queries, BN output
// channels, split of the contraction), BN = 256 for K = 4 and 8 and 128
// for K = 12 (whose Wc stage would not fit shared memory at 256). Steps
// 1-3 below are repeated by each of a layer's D / BN channel tiles, so the
// wider tile does that work half as often. The contraction goes in chunks of
// 16 channels, the lifted chunks first, the lifted and the feature channels
// each padded to a multiple of 16. Per chunk:
//   1. its Wc slice (K x BN rows of 16 bf16) is copied by cp.async;
//   2. its 64 x K input rows of 16 channels are formed in float32: a
//      feature chunk gathered from the bf16 features, a lifted chunk as
//      f2 = BN2(ELU(h @ W2[:, chunk])) on the tensor cores, h = BN1(ELU(
//      local @ W1)) computed into the A fragments as they are needed (h is
//      recomputed for each lifted chunk instead of kept: 64 K Cf values do
//      not fit shared memory at K = 12, Cf = 256);
//   3. (X @ in) for the 64 queries x K neighbours x 16 channels on CUDA
//      cores (X_2 kept in shared memory from the set-up), rounded to bf16
//      into the A tiles;
//   4. K k16 steps of the 64 x BN product, each warp 32 queries x BN / 4
//      channels.
// The epilogue applies ELU and the folded output BatchNorm and writes bf16
// (one split) or writes the float32 partial sums (`plan_xconv` splits the
// contraction of the few-query layers; `hfr_xconv_epilogue_bf16` sums them
// in split order).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_bf16.cuh"
#include "conv_common.cuh"

namespace hfr {
namespace bf16xconv {

using bf16conv::lds32;
using bf16conv::mma_bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 64;        // queries per block
constexpr int kDAlign = 256;   // output channels of the arranged Wc padded to this
constexpr int kKC = 16;        // contraction channels per chunk
constexpr int kPix = 24;       // bf16 per staged A / B row: 16 + 8 pad (conflict-free fragments)
constexpr int kMaxCf = 256;
constexpr int kW2S = kMaxCf + 8;  // bf16 per staged W2 row (one lifted channel, all of h)

struct Args {
  const float* pts;           // (B, N, 3)
  const __nv_bfloat16* fts;   // (B, N, Cp) or null when Cp == 0
  const float* qrs;           // (B, P, 3)
  const int* idx;             // (B, P, K)
  const float* w1;            // (3, Cf)
  const float* s1;            // (Cf)
  const float* b1;
  const float* w2;            // (Cf, Cf)
  const float* s2;
  const float* b2;
  const float* wx0;           // (3K, K*K)
  const float* sx0;           // (K*K)
  const float* bx0;
  const float* wx1;           // (K, K, K)
  const float* sx1;
  const float* bx1;
  const float* wx2;           // (K, K, K)
  const float* sx2;
  const float* bx2;
  const __nv_bfloat16* wt;    // arranged Wc: [chunk][K][Dp][16], Dp % kDAlign == 0
  const float* sc;            // (D)
  const float* bc;
  __nv_bfloat16* out;         // (B, P, D)
  float* partial;             // (splits, B * P, D) when splits > 1
  int b, n, p, cf, cp, d, dp, with_x, splits, vec8;
};

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// exp(x) - 1 for x <= 0, as the TPU kernel computes it (`_elu`).
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : __expf(x) - 1.f; }

// Two values rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Output channels per block.
template <int K>
constexpr int block_n() { return K == 12 ? 128 : 256; }

// Shared memory, in bytes. The X-net's two temporaries (64 x K^2 floats
// each) live over the Wc stage before the chunk loop starts.
template <int K>
struct Layout {
  static constexpr int kBN = block_n<K>();
  static constexpr int kRows = kBM * K;
  static constexpr int XS = K * K + 1;  // s_x2 floats per query (bank spread)
  static constexpr int b = 0;                                    // Wc: K x kBN x kPix bf16
  static constexpr int a = b + K * kBN * kPix * 2;               // A: K x kBM x kPix bf16
  static constexpr int in = a + K * kBM * kPix * 2;              // rows: kRows x 16 floats
  static constexpr int x2 = in + kRows * kKC * 4;                // X_2: kBM x XS floats
  static constexpr int w2 = x2 + (kBM * XS * 4 + 15) / 16 * 16;  // W2 chunk: 16 x kW2S bf16
  static constexpr int lp = w2 + kKC * kW2S * 2;                 // lift-1 (w1 x, y, z, s1)
  static constexpr int lb = lp + kMaxCf * 16;                    // lift-1 shift b1
  static constexpr int xin = lb + kMaxCf * 4;                    // local coords: kRows x 3
  static constexpr int row = xin + (kRows * 12 + 15) / 16 * 16;  // source rows: kRows ints
  static constexpr int bytes = row + kRows * 4;
  static_assert(2 * kBM * K * K * 4 <= a, "X-net temporaries must fit over the Wc stage");
  static_assert(bytes <= 232448, "shared memory");
};

// Blocks an SM holds: two at K = 4 (100 KB of shared memory each; at most
// 128 registers a thread), one at K = 8 and 12.
template <int K>
constexpr int min_blocks() { return K == 4 ? 2 : 1; }

template <int K>
__global__ void __launch_bounds__(kThreads, min_blocks<K>()) xconv_bf16_kernel(Args a) {
  using L = Layout<K>;
  constexpr int kBN = L::kBN;
  constexpr int NT = kBN / 32;  // n8 tiles per warp
  constexpr int kRows = kBM * K;
  constexpr int kKK = K * K;
  constexpr int MT = K / 2;  // lift-2 m16 tiles per warp (4 K of them over 8 warps)
  extern __shared__ __align__(16) unsigned char sm_x16[];
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(sm_x16 + L::b);
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(sm_x16 + L::a);
  float* s_in = reinterpret_cast<float*>(sm_x16 + L::in);
  float* s_x2 = reinterpret_cast<float*>(sm_x16 + L::x2);
  __nv_bfloat16* s_w2 = reinterpret_cast<__nv_bfloat16*>(sm_x16 + L::w2);
  float4* s_lp = reinterpret_cast<float4*>(sm_x16 + L::lp);
  float* s_lb = reinterpret_cast<float*>(sm_x16 + L::lb);
  float* s_xin = reinterpret_cast<float*>(sm_x16 + L::xin);
  int* s_row = reinterpret_cast<int*>(sm_x16 + L::row);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int nq = a.b * a.p;
  const int nf = (a.cf + kKC - 1) / kKC;  // lifted chunks
  const int nch = nf + (a.cp + kKC - 1) / kKC;
  const int cb = blockIdx.z * nch / a.splits;  // this split's chunks [cb, ce)
  const int ce = (blockIdx.z + 1) * nch / a.splits;
  const int cf16 = nf * kKC;

  // --- set-up: neighbour rows, local coordinates (rounded), lift-1
  // parameters (w1 rounded), X.
  for (int r = tid; r < kRows; r += kThreads) {
    const int q = q0 + r / K;
    int row = 0;
    float lx = 0.f, ly = 0.f, lz = 0.f;
    if (q < nq) {
      row = (q / a.p) * a.n + a.idx[(size_t)q * K + r % K];
      const float* pp = a.pts + (size_t)row * 3;
      const float* qq = a.qrs + (size_t)q * 3;
      lx = pp[0] - qq[0];
      ly = pp[1] - qq[1];
      lz = pp[2] - qq[2];
    }
    s_row[r] = row;
    s_xin[r * 3 + 0] = bfr(lx);
    s_xin[r * 3 + 1] = bfr(ly);
    s_xin[r * 3 + 2] = bfr(lz);
  }
  for (int h = tid; h < cf16; h += kThreads) {
    const bool v = h < a.cf;
    s_lp[h] = make_float4(v ? bfr(__ldg(a.w1 + h)) : 0.f, v ? bfr(__ldg(a.w1 + a.cf + h)) : 0.f,
                          v ? bfr(__ldg(a.w1 + 2 * a.cf + h)) : 0.f, v ? __ldg(a.s1 + h) : 0.f);
    s_lb[h] = v ? __ldg(a.b1 + h) : 0.f;
  }
  __syncthreads();
  if (a.with_x) {
    float* x0 = reinterpret_cast<float*>(sm_x16 + L::b);  // kBM x K^2, over the Wc stage
    float* x1 = x0 + kBM * kKK;
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int q = e / kKK, m = e % kKK;
      float acc = 0.f;
      for (int i = 0; i < 3 * K; ++i) acc += s_xin[q * 3 * K + i] * bfr(__ldg(a.wx0 + i * kKK + m));
      x0[e] = bfr(elu(acc) * __ldg(a.sx0 + m) + __ldg(a.bx0 + m));
    }
    __syncthreads();
    // Depthwise over the neighbour axis: out[c*K + j] = sum_k in[k*K + c] * w[k, c, j].
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int q = e / kKK, m = e % kKK, c = m / K, j = m % K;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc += x0[q * kKK + k * K + c] * bfr(__ldg(a.wx1 + (k * K + c) * K + j));
      x1[e] = bfr(elu(acc) * __ldg(a.sx1 + m) + __ldg(a.bx1 + m));
    }
    __syncthreads();
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int q = e / kKK, m = e % kKK, c = m / K, j = m % K;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc += x1[q * kKK + k * K + c] * bfr(__ldg(a.wx2 + (k * K + c) * K + j));
      s_x2[q * L::XS + m] = acc * __ldg(a.sx2 + m) + __ldg(a.bx2 + m);
    }
  }

  // Products: warp (wm, wn) owns queries wm .. wm + 31 and channels
  // n0 + wn .. + kBN / 4 - 1: 2 m16 x NT n8 tiles.
  const int wm = (warp & 1) * 32;
  const int wn = (warp >> 1) * (kBN / 4);
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

#pragma unroll 1
  for (int pos = cb; pos < ce; ++pos) {
    __syncthreads();  // the previous chunk's products are done: every buffer is free
    // 1. The chunk's Wc slice: K x kBN rows of 16 bf16, two 16-byte copies each.
    for (int i = tid; i < K * kBN * 2; i += kThreads) {
      const int row = i >> 1, half = i & 1;
      const int k = row / kBN, nn = row - k * kBN;
      cp_async16(s_b + row * kPix + 8 * half,
                 a.wt + (((size_t)pos * K + k) * a.dp + n0 + nn) * kKC + 8 * half);
    }
    cp_async_commit();

    // 2. The chunk's input rows, float32, into s_in[row][16].
    if (pos < nf) {
      const int c0 = pos * kKC;
      // W2[:, c0 .. c0 + 15], rounded, as [channel][h].
      for (int e = tid; e < kKC * cf16; e += kThreads) {
        const int h = e / kKC, c = e % kKC;
        const bool v = h < a.cf && c0 + c < a.cf;
        s_w2[c * kW2S + h] = __float2bfloat16_rn(v ? __ldg(a.w2 + (size_t)h * a.cf + c0 + c) : 0.f);
      }
      __syncthreads();
      // Lift-2 on the tensor cores: rows (warp + 8 mt) * 16 .., 16
      // channels, contraction over h; the A fragments are lift-1 outputs.
      float xr[MT][2][3];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            xr[mt][hi][c] = s_xin[((warp + 8 * mt) * 16 + g + 8 * hi) * 3 + c];
      float la[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) la[mt][nt][i] = 0.f;
#pragma unroll 1
      for (int hs = 0; hs < cf16; hs += kKC) {
        uint32_t bw[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* bp = s_w2 + (8 * nt + g) * kW2S + hs + 2 * t;
          bw[nt][0] = lds32(bp);
          bw[nt][1] = lds32(bp + 8);
        }
        float4 p4[4];
        float pb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int h = hs + 2 * t + (u & 1) + 8 * (u >> 1);  // k 2t, 2t + 1, 2t + 8, 2t + 9
          p4[u] = s_lp[h];
          pb[u] = s_lb[h];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float hv[2][4];
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              hv[hi][u] = elu(xr[mt][hi][0] * p4[u].x + xr[mt][hi][1] * p4[u].y +
                              xr[mt][hi][2] * p4[u].z) * p4[u].w + pb[u];
          uint32_t af[4];
          af[0] = pack_bf16(hv[0][0], hv[0][1]);
          af[1] = pack_bf16(hv[1][0], hv[1][1]);
          af[2] = pack_bf16(hv[0][2], hv[0][3]);
          af[3] = pack_bf16(hv[1][2], hv[1][3]);
          mma_bf16(la[mt][0], af, bw[0]);
          mma_bf16(la[mt][1], af, bw[1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = (warp + 8 * mt) * 16 + g + 8 * (i >> 1);
            const int c = 8 * nt + 2 * t + (i & 1);
            const int cg = c0 + c;
            s_in[r * kKC + c] =
                cg < a.cf ? elu(la[mt][nt][i]) * __ldg(a.s2 + cg) + __ldg(a.b2 + cg) : 0.f;
          }
    } else {
      const int c0 = (pos - nf) * kKC;
      if (a.vec8) {
        for (int e = tid; e < kRows * 2; e += kThreads) {
          const int r = e >> 1, half = e & 1, c = c0 + 8 * half;
          float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
          if (c < a.cp) {
            const uint4 v =
                __ldg(reinterpret_cast<const uint4*>(a.fts + (size_t)s_row[r] * a.cp + c));
            lo = make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                             __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
            hi = make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
                             __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
          }
          float4* dst = reinterpret_cast<float4*>(s_in + r * kKC + 8 * half);
          dst[0] = lo;
          dst[1] = hi;
        }
      } else {
        for (int e = tid; e < kRows * kKC; e += kThreads) {
          const int r = e / kKC, cc = e % kKC, c = c0 + cc;
          s_in[r * kKC + cc] =
              c < a.cp ? __bfloat162float(a.fts[(size_t)s_row[r] * a.cp + c]) : 0.f;
        }
      }
    }
    __syncthreads();

    // 3. (X @ in) per query and neighbour, rounded into the A tiles
    // [k][query][16]: thread = (query, group of 4 channels).
    {
      const int q = tid >> 2, grp = tid & 3;
      const float* in = s_in + q * K * kKC + 4 * grp;
      float4 v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = *reinterpret_cast<const float4*>(in + j * kKC);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float4 o;
        if (a.with_x) {
          o = make_float4(0.f, 0.f, 0.f, 0.f);
          const float* xk = s_x2 + q * L::XS + k * K;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float x = xk[j];
            o.x += x * v[j].x;
            o.y += x * v[j].y;
            o.z += x * v[j].z;
            o.w += x * v[j].w;
          }
        } else {
          o = v[k];
        }
        *reinterpret_cast<uint2*>(s_a + (k * kBM + q) * kPix + 4 * grp) =
            make_uint2(pack_bf16(o.x, o.y), pack_bf16(o.z, o.w));
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // 4. The chunk's K k16 steps.
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const __nv_bfloat16* sa = s_a + k * kBM * kPix;
      const __nv_bfloat16* sb = s_b + k * kBN * kPix;
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* bp = sb + (wn + 8 * nt + g) * kPix + 2 * t;
        bf[nt][0] = lds32(bp);
        bf[nt][1] = lds32(bp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* ap = sa + (wm + 16 * mt + g) * kPix + 2 * t;
        uint32_t af[4];
        af[0] = lds32(ap);
        af[1] = lds32(ap + 8 * kPix);
        af[2] = lds32(ap + 8);
        af[3] = lds32(ap + 8 * kPix + 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af, bf[nt]);
      }
    }
  }

  // Epilogue: accumulator i of (mt, nt) is query wm + 16 mt + g + 8 (i / 2),
  // channel wn + 8 nt + 2 t + i % 2.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn + 8 * nt + 2 * t;
      if (col >= a.d) continue;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int q = q0 + wm + 16 * mt + g + 8 * hi;
        if (q >= nq) continue;
        const float v0 = acc[mt][nt][2 * hi], v1 = acc[mt][nt][2 * hi + 1];
        if (a.splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)q * a.d + col) =
              __floats2bfloat162_rn(elu(v0) * __ldg(a.sc + col) + __ldg(a.bc + col),
                                    elu(v1) * __ldg(a.sc + col + 1) + __ldg(a.bc + col + 1));
        } else {
          *reinterpret_cast<float2*>(a.partial + ((size_t)blockIdx.z * nq + q) * a.d + col) =
              make_float2(v0, v1);
        }
      }
    }
}

// out (bf16) = BNc(ELU(sum over splits of the float32 partial sums)), the
// splits summed in order; one thread per 4 outputs.
__global__ void xconv_split_epilogue_bf16(const float4* __restrict__ partial,
                                          const float* __restrict__ sc,
                                          const float* __restrict__ bc,
                                          __nv_bfloat162* __restrict__ out, int splits, int nq,
                                          int d) {
  const size_t n4 = (size_t)nq * d / 4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = partial[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = partial[(size_t)z * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int col = (int)(i * 4 % d);
  const float4 c = *reinterpret_cast<const float4*>(sc + col);
  const float4 b = *reinterpret_cast<const float4*>(bc + col);
  out[2 * i] = __floats2bfloat162_rn(elu(s.x) * c.x + b.x, elu(s.y) * c.y + b.y);
  out[2 * i + 1] = __floats2bfloat162_rn(elu(s.z) * c.z + b.z, elu(s.w) * c.w + b.w);
}

template <int K>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<K>;
  cudaError_t err = cudaFuncSetAttribute(xconv_bf16_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  const int nq = a.b * a.p;
  dim3 grid((nq + kBM - 1) / kBM, a.dp / L::kBN, a.splits);
  xconv_bf16_kernel<K><<<grid, kThreads, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace bf16xconv
}  // namespace hfr
