// Fused inference XConv for the H100 (sm_90a), on the tensor cores.
//
// Replaces heterofusionrcnn_tpu/ops/pallas_xconv.py: `fused_xconv` /
// `_xconv_kernel`. For each query point q with neighbours idx[q, :K]:
//   local[j]  = pts[idx[j]] - qrs[q]                         (K, 3)
//   f2[j]     = BN2(ELU(BN1(ELU(local[j] @ W1)) @ W2))        (K, Cf) lifts
//   X         = BNx2(dw2(BNx1(ELU(dw1(BNx0(ELU(vec(local) @ Wx0)))))))
//   in[j]     = [f2[j] | fts[idx[j]]]                         (K, Cin)
//   out[q]    = BNc(ELU(sum_k sum_c (X @ in)[k, c] * Wc[k, c, :]))
// with inference BatchNorm folded to per-channel (scale, shift) pairs and
// Wc the depthwise x pointwise composition of the separable conv.
//
// Bound: operations. The separable conv, 2 P K Cin D FLOPs, is ~96% of the
// work on the main path; it is a GEMM with M = queries, N = D and the
// contraction (k, c) over K Cin. It runs on `wgmma` in 3xTF32
// (conv_common.cuh): three TF32 tensor-core products per FP32-grade
// multiply-add, so the bound is 3 x its operations at 495 TFLOP/s.
//
// Design: one block of four warpgroups per (64 queries, 256 output
// channels, split of the contraction), warp-specialised. The input
// channels go in chunks of 8, lifted and feature channels each padded to a
// multiple of 8; the lifted chunks are spread among the feature chunks
// (`lifted_at`) so that their lifts, the costly part of building A, fall
// between feature chunks whose A is quick to build.
// - Warpgroup 0, the lifter, computes f2 for each lifted chunk ahead of
//   use: lift-1 in registers (eight channels at a time, independent
//   chains), lift-2 against W2[:, chunk], copied one lifted chunk ahead by
//   cp.async. It stores f2 into one of two lifted-chunk buffers (mbarriers
//   lift_full / lift_empty). This is the block's largest CUDA-core load.
// - Warpgroup 1, the mixer, walks the chunks in order: a feature chunk's
//   64 x K neighbour rows are gathered by cp.async up to three feature
//   chunks ahead (K = 4), a lifted chunk is read from the lifter's buffer.
//   It forms X @ in one group of two k-steps (2 neighbours x 8 channels)
//   at a time, splits each value once into TF32 big and small parts and
//   stores both as K-major wgmma tiles into a ring of 4 group slots
//   (mbarriers full / empty per slot).
// - Warpgroups 2 and 3, the consumers, each own 128 of the 256 output
//   channels. Each streams its part of the pre-split, pre-tiled Wc (the
//   wrapper's arranged operand, `ops/xconv.py`) through a ring of cp.async
//   stages of one group each, and per group issues 2 k-steps x 3 products
//   of m64n128k8 with A and B both from shared memory (SS). The 6 products
//   chain in a scratch accumulator from zero, are waited for and added to
//   the FP32 running sum, because the tensor cores truncate their sums.
// The lifter and mixer give registers to the consumers' accumulators
// (setmaxnreg). Lift-2 (2 P K Cf^2 FLOPs) is needed once per query tile,
// but each 256-channel tile needs it: where a layer has an even number of
// channel tiles, pairs of them run as a two-CTA cluster whose lifters take
// alternate lifted chunks and store each into both CTAs' buffers
// (distributed shared memory), halving the lift. Each lifted-chunk buffer
// keeps one producer, so its barrier phases are waited in order.

// Few queries: where the (query, channel) tiles cannot fill the card, the
// wrapper splits the input-channel chunks over blockIdx.z
// (`plan_xconv`); each split writes FP32 partial sums to a scratch the
// wrapper allocates, and `xconv_split_epilogue` sums them in split order
// and applies ELU and the folded output BatchNorm (no atomics: the result
// does not depend on the order blocks run in). With one split the main
// kernel applies the epilogue itself.
//
// Shapes: K in {4, 8, 12}; Cf up to 256; any Cp (Cin up to 1536 on the
// main path); D a multiple of 4 (the arranged weight pads it to 128); any
// number of queries (edges masked); with and without the X-transform.
//
// The bf16 form (`hfr_xconv_bf16`, `hfr_xconv_epilogue_bf16`: the Pallas
// kernel's `compute_dtype=jnp.bfloat16`, the bf16 serving path) is the
// kernel of xconv_bf16.cuh: warp-specialised `wgmma` bf16 on a persistent
// grid of thread-block clusters that form each A chunk once for all of D.

#include "conv_common.cuh"
#include "xconv_bf16.cuh"

#include <math.h>

namespace {

using namespace hfr;

// Warpgroups: 0 lifts, 1 gathers and forms X @ in, 2 and 3 multiply.
constexpr int kThreads = 512;
// Registers per thread after the role split (setmaxnreg; 128 at launch):
// the lifter and the mixer hand some to the consumers' accumulators.
constexpr int kLifterRegs = 112;
constexpr int kMixerRegs = 64;
constexpr int kConsumerRegs = 168;
static_assert(128 * (kLifterRegs + kMixerRegs) + 256 * kConsumerRegs <= 65536, "registers");
constexpr int kBM = 64;        // queries per block
constexpr int kBN = 256;       // output channels per block (128 per consumer)
constexpr int kWN = 128;       // output channels per consumer warpgroup
constexpr int kCC = 8;         // input channels per chunk
constexpr int kRing = 4;       // A group slots
constexpr int kSlot = 2 * 2 * kBM * 8;  // floats per A slot: [k-step][part][64 x 8]
constexpr int kBStage = 2 * 2 * kWN * 8;  // floats per B stage: [k-step][part][128 x 8]
constexpr int kMaxCf = 256;
constexpr int kLP = 8;         // lift-1 parameters per channel: w1 x, y, z, s1, b1, pad

struct XconvArgs {
  const float* pts;   // (B, N, 3)
  const float* fts;   // (B, N, Cp) or null when Cp == 0
  const float* qrs;   // (B, P, 3)
  const int* idx;     // (B, P, K)
  const float* w1;    // (3, Cf)
  const float* s1;    // (Cf)
  const float* b1;
  const float* w2;    // (Cf, Cf)
  const float* s2;
  const float* b2;
  const float* wx0;   // (3K, K*K)
  const float* sx0;   // (K*K)
  const float* bx0;
  const float* wx1;   // (K, K, K)
  const float* sx1;
  const float* bx1;
  const float* wx2;   // (K, K, K)
  const float* sx2;
  const float* bx2;
  const float4* wt;   // arranged Wc: [k-step][big, small][Dp / 8][2][8][4]
  const float* sc;    // (D)
  const float* bc;
  float* out;         // (B, P, D)
  float* partial;     // (splits, B * P, D) when splits > 1
  int b, n, p, cf, cp, d, dp, with_x, splits, vec4;
  int cluster;        // CTAs of a cluster (channel tiles of one query tile)
};

// exp(x) - 1 for x <= 0, as the TPU kernel computes it (pallas_xconv.py
// `_elu`); within 1e-6 of expm1 at these magnitudes.
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : __expf(x) - 1.f; }

// 16-byte copy, zero-filled when !valid (the source is then not read).
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// The contraction's chunk schedule: the nf lifted chunks sit at positions
// floor(i nch / nf) of the nch, spread among the feature chunks, so that
// the lifter's work (on CUDA cores) falls between feature chunks whose
// groups the mixer prepares quickly, and every split gets its share of
// both.
// Returns the lifted chunk at position p, or -1 for the feature chunk
// p - ceil(p nf / nch). Mirrored by `ops/xconv.py` (`chunk_order`).
__device__ __forceinline__ int lifted_at(int p, int nf, int nch) {
  const int i = (p * nf + nch - 1) / nch;
  return i < nf && i * nch / nf == p ? i : -1;
}

// Shared memory, in floats. The X-net's two temporaries (64 x K^2 each)
// live in the A ring and B stages before the pipeline starts.
template <int K>
struct Layout {
  static constexpr int kNSB = K == 4 ? 3 : 2;  // B stages per consumer
  static constexpr int kNG = K == 4 ? 4 : K == 8 ? 2 : 1;  // feature-chunk buffers
  static constexpr int kNL = 2;                 // lifted-chunk buffers
  static constexpr int kNW2 = K == 12 ? 1 : 2;  // W2[:, chunk] buffers
  static constexpr int QS = K * kCC + 4;        // s_in floats per query (bank spread)
  static constexpr int XS = K * K + 1;          // s_x floats per query (bank spread)
  static constexpr int ring = 0;
  static constexpr int bst = ring + kRing * kSlot;
  static constexpr int sin = bst + 2 * kNSB * kBStage;
  static constexpr int slift = sin + kNG * kBM * QS;
  // The local coordinates are read only during the set-up: they share the
  // second lifted-chunk buffer.
  static constexpr int loc = slift + kBM * QS;
  static constexpr int sx = slift + kNL * kBM * QS;
  static constexpr int row = sx + (kBM * XS + 3) / 4 * 4;
  static constexpr int lp = row + kBM * K;
  static constexpr int w2 = lp + kMaxCf * kLP;
  static constexpr int bars = w2 + kNW2 * kMaxCf * kCC;
  static constexpr int bytes = bars * 4 + (2 * kNL + 2 * kRing) * 8;
  static_assert(2 * kBM * K * K <= sin, "X-net temporaries must fit before s_in");
  static_assert(kBM * K * 3 <= kBM * QS, "local coordinates must fit in a lifted-chunk buffer");
  static_assert(bytes <= 232448, "shared memory");
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1) xconv_kernel(XconvArgs a) {
  using L = Layout<K>;
  constexpr int kRows = kBM * K;
  constexpr int kKK = K * K;
  constexpr int kNSB = L::kNSB;
  extern __shared__ __align__(128) float smem[];
  float* s_ring = smem + L::ring;
  float* s_in = smem + L::sin;      // kNG buffers of gathered feature chunks
  float* s_lift = smem + L::slift;  // kNL buffers of lifted chunks
  float* s_x = smem + L::sx;
  float* s_loc = smem + L::loc;
  int* s_row = reinterpret_cast<int*>(smem + L::row);
  float* s_lp = smem + L::lp;
  float* s_w2 = smem + L::w2;  // two buffers of W2[:, chunk]
  uint64_t* lift_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* lift_empty = lift_full + L::kNL;
  uint64_t* full = lift_empty + L::kNL;  // A ring slot stored
  uint64_t* empty = full + kRing;       // A ring slot consumed

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBM;
  const int nq = a.b * a.p;
  const int nf = (a.cf + kCC - 1) / kCC;  // lifted chunks
  const int nch = nf + (a.cp + kCC - 1) / kCC;
  const int cb = blockIdx.z * nch / a.splits;  // this split's positions [cb, ce)
  const int ce = (blockIdx.z + 1) * nch / a.splits;
  // A cluster's CTAs hold the same query tile: each lifts every csize-th
  // lifted chunk and stores it into the lifted-chunk buffers of all of them.
  const int csize = a.cluster;
  const int rank = (int)cluster_ctarank();

  // --- set-up, all threads: neighbour rows, local coordinates, lift-1
  // parameters, barriers, X.
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
    s_loc[r * 3 + 0] = lx;
    s_loc[r * 3 + 1] = ly;
    s_loc[r * 3 + 2] = lz;
  }
  const int cf8 = nf * kCC;  // lift channels padded with zeros (h1 = 0)
  for (int h = tid; h < cf8; h += kThreads) {
    float* lp = s_lp + h * kLP;
    const bool valid = h < a.cf;
    lp[0] = valid ? __ldg(a.w1 + h) : 0.f;
    lp[1] = valid ? __ldg(a.w1 + a.cf + h) : 0.f;
    lp[2] = valid ? __ldg(a.w1 + 2 * a.cf + h) : 0.f;
    lp[3] = valid ? __ldg(a.s1 + h) : 0.f;
    lp[4] = valid ? __ldg(a.b1 + h) : 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i, 128);   // every mixer thread arrives
      mbar_init(empty + i, 256);  // every consumer thread arrives
    }
    for (int i = 0; i < L::kNL; ++i) {
      mbar_init(lift_full + i, 1);         // the chunk's lifter, once
      mbar_init(lift_empty + i, csize);    // each mixer of the cluster, once
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  if (a.with_x) {
    float* x0 = smem;              // kBM x K*K, over the A ring and B stages
    float* x1 = smem + kBM * kKK;
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int t = e / kKK, m = e % kKK;
      float acc = 0.f;
      for (int i = 0; i < 3 * K; ++i) acc += s_loc[t * 3 * K + i] * __ldg(a.wx0 + i * kKK + m);
      x0[e] = elu(acc) * __ldg(a.sx0 + m) + __ldg(a.bx0 + m);
    }
    __syncthreads();
    // Depthwise over the neighbour axis: out[c*K + j] = sum_k in[k*K + c] * w[k, c, j].
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int t = e / kKK, m = e % kKK, c = m / K, j = m % K;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += x0[t * kKK + k * K + c] * __ldg(a.wx1 + (k * K + c) * K + j);
      x1[e] = elu(acc) * __ldg(a.sx1 + m) + __ldg(a.bx1 + m);
    }
    __syncthreads();
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int t = e / kKK, m = e % kKK, c = m / K, j = m % K;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += x1[t * kKK + k * K + c] * __ldg(a.wx2 + (k * K + c) * K + j);
      s_x[t * L::XS + m] = acc * __ldg(a.sx2 + m) + __ldg(a.bx2 + m);
    }
  }
  // The lifter's local coordinates, read before another CTA of the
  // cluster may write into the lifted-chunk buffer that holds them.
  constexpr int kRPT = kRows / 128;  // lifter rows per thread (K / 2)
  float lx[kRPT], ly[kRPT], lz[kRPT];
  if (tid < 128) {
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int r = tid + i * 128;
      lx[i] = s_loc[r * 3 + 0];
      ly[i] = s_loc[r * 3 + 1];
      lz[i] = s_loc[r * 3 + 2];
    }
  }
  // X complete, the ring and B stages free, and every CTA's barriers
  // initialised before another CTA of the cluster arrives on them.
  cluster_sync();

  if (tid < 128) {
    // --- lifter warpgroup: f2 of each lifted chunk of this split, ahead of
    // the mixer, into the lifted-chunk buffers. W2[:, chunk] is copied one
    // lifted chunk ahead where there are two W2 buffers.
    setmaxnreg_dec<kLifterRegs>();
    const int lt = tid;
    auto next_lifted = [&](int p) {
      while (p < ce && lifted_at(p, nf, nch) < 0) ++p;
      return p;
    };
    auto load_w2 = [&](int p, int buf) {
      const int c0 = lifted_at(p, nf, nch) * kCC;
      float* dst = s_w2 + buf * kMaxCf * kCC;
      for (int e = lt; e < cf8 * kCC; e += 128) {
        const int h = e / kCC, c = c0 + e % kCC;
        const bool valid = c < a.cf && h < a.cf;
        cp_async4(dst + e, valid ? a.w2 + (size_t)h * a.cf + c : a.w2, valid);
      }
    };
    auto advance = [&](int p, int steps) {  // `steps` lifted positions on
      for (int i = 0; i < steps && p < ce; ++i) p = next_lifted(p + 1);
      return p;
    };
    // This CTA lifts the lifted chunks m = rank, rank + csize, ... of the
    // split (m counts them in schedule order).
    int p = advance(next_lifted(cb), rank);
    if (p < ce) load_w2(p, 0);
    cp_async_commit();
#pragma unroll 1
    for (int m = rank, it = 0; p < ce; m += csize, ++it) {
      const int pn = advance(p, csize);
      if (L::kNW2 == 2 && pn < ce) load_w2(pn, (it + 1) & 1);
      cp_async_commit();
      if constexpr (L::kNW2 == 2) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      named_bar_sync(1, 128);  // W2[:, chunk] visible
      const float* w2 = s_w2 + (it % L::kNW2) * kMaxCf * kCC;
      const int c0 = lifted_at(p, nf, nch) * kCC;
      float g[kRPT][kCC];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int c = 0; c < kCC; ++c) g[i][c] = 0.f;
      // kHB lift-1 channels at a time (independent chains), then their
      // lift-2 products.
      constexpr int kHB = K == 12 ? 2 : 8;
#pragma unroll 1
      for (int h0 = 0; h0 < cf8; h0 += kHB) {
        float hv[kRPT][kHB];
#pragma unroll
        for (int u = 0; u < kHB; ++u) {
          const float4 q4 = *reinterpret_cast<const float4*>(s_lp + (h0 + u) * kLP);
          const float t1 = s_lp[(h0 + u) * kLP + 4];
#pragma unroll
          for (int i = 0; i < kRPT; ++i)
            hv[i][u] = elu(lx[i] * q4.x + ly[i] * q4.y + lz[i] * q4.z) * q4.w + t1;
        }
#pragma unroll
        for (int u = 0; u < kHB; ++u) {
          const float4 wa = *reinterpret_cast<const float4*>(w2 + (h0 + u) * kCC);
          const float4 wb = *reinterpret_cast<const float4*>(w2 + (h0 + u) * kCC + 4);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) {
            const float v = hv[i][u];
            g[i][0] += v * wa.x;
            g[i][1] += v * wa.y;
            g[i][2] += v * wa.z;
            g[i][3] += v * wa.w;
            g[i][4] += v * wb.x;
            g[i][5] += v * wb.y;
            g[i][6] += v * wb.z;
            g[i][7] += v * wb.w;
          }
        }
      }
      // Buffer m % kNL has one producer (kNL is a multiple of csize), so
      // its phases are waited in order.
      const int lb = m % L::kNL;
      mbar_wait_cluster(lift_empty + lb, ((m / L::kNL) & 1) ^ 1);
      float* out = s_lift + lb * kBM * L::QS;
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const int r = lt + i * 128;
        float f[kCC];
#pragma unroll
        for (int c = 0; c < kCC; ++c)
          f[c] = c0 + c < a.cf ? elu(g[i][c]) * __ldg(a.s2 + c0 + c) + __ldg(a.b2 + c0 + c)
                               : 0.f;
        float* dst = out + (r / K) * L::QS + (r % K) * kCC;
        const float4 lo = make_float4(f[0], f[1], f[2], f[3]);
        const float4 hi = make_float4(f[4], f[5], f[6], f[7]);
        if (csize == 1) {
          *reinterpret_cast<float4*>(dst) = lo;
          *reinterpret_cast<float4*>(dst + 4) = hi;
        } else {
          for (int t = 0; t < csize; ++t) {
            st_cluster(mapa(dst, t), lo);
            st_cluster(mapa(dst + 4, t), hi);
          }
        }
      }
      named_bar_sync(1, 128);  // the chunk is stored; this W2 buffer is free
      if (lt == 0)
        for (int t = 0; t < csize; ++t) mbar_arrive_cluster(mapa(lift_full + lb, t));
      if (L::kNW2 == 1 && pn < ce) load_w2(pn, 0);
      p = pn;
    }
    cp_async_wait<0>();
  } else if (tid < 256) {
    // --- mixer warpgroup: for each chunk of the split, its 64 x K input
    // rows (gathered by cp.async, kNG - 1 feature chunks ahead, or
    // the lifter's buffer), then (X @ in) group by group into the A ring.
    setmaxnreg_dec<kMixerRegs>();
    const int mt = tid - 128;
    auto next_gathered = [&](int p) {
      while (p < ce && lifted_at(p, nf, nch) >= 0) ++p;
      return p;
    };
    auto gather = [&](int p, float* dst) {
      const int c0 = (p - (p * nf + nch - 1) / nch) * kCC;
      if (a.vec4) {
        for (int e = mt; e < kRows * 2; e += 128) {
          const int r = e >> 1, h = e & 1, c = c0 + 4 * h;
          const bool valid = c < a.cp;
          cp_async16z(dst + (r / K) * L::QS + (r % K) * kCC + 4 * h,
                      valid ? a.fts + (size_t)s_row[r] * a.cp + c : a.fts, valid);
        }
      } else {
        for (int e = mt; e < kRows * kCC; e += 128) {
          const int r = e / kCC, cc = e % kCC, c = c0 + cc;
          const bool valid = c < a.cp;
          cp_async4(dst + (r / K) * L::QS + (r % K) * kCC + cc,
                    valid ? a.fts + (size_t)s_row[r] * a.cp + c : a.fts, valid);
        }
      }
    };
    // Feature chunk f of the split lives in buffer f % kNG and is copied
    // kNG - 1 feature chunks ahead, one commit group each.
    int pg = next_gathered(cb);  // next feature chunk to copy
    int ng = 0;                  // feature chunks copied
    for (int i = 0; i < L::kNG - 1; ++i) {  // a group each, empty past the last chunk
      if (pg < ce) {
        gather(pg, s_in + ng * kBM * L::QS);
        pg = next_gathered(pg + 1);
        ++ng;
      }
      cp_async_commit();
    }
    int nfeat = 0;  // feature chunks used
    int nl = 0;  // lifted chunks used
    const int q = mt & 63, hf = mt >> 6;
#pragma unroll 1
    for (int ch = cb; ch < ce; ++ch) {
      const bool lifted = lifted_at(ch, nf, nch) >= 0;
      const float* in_buf;
      if (lifted) {
        const int lb = nl % L::kNL;
        mbar_wait_cluster(lift_full + lb, (nl / L::kNL) & 1);
        in_buf = s_lift + lb * kBM * L::QS;
      } else {
        if (pg < ce) {
          gather(pg, s_in + (ng % L::kNG) * kBM * L::QS);
          pg = next_gathered(pg + 1);
          ++ng;
        }
        cp_async_commit();
        cp_async_wait<L::kNG - 1>();  // feature chunk nfeat has landed
        named_bar_sync(2, 128);       // ... for every mixer thread
        in_buf = s_in + (nfeat % L::kNG) * kBM * L::QS;
        ++nfeat;
      }
      const float* in = in_buf + q * L::QS + 4 * hf;
#pragma unroll 1
      for (int gi = 0; gi < K / 2; ++gi) {
        const int n = (ch - cb) * (K / 2) + gi;  // the group's index in the split
        float4 v[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int k = 2 * gi + kk;
          if (a.with_x) {
            v[kk] = make_float4(0.f, 0.f, 0.f, 0.f);
          } else {
            v[kk] = *reinterpret_cast<const float4*>(in + k * kCC);
          }
        }
        if (a.with_x) {
          const float* xr = s_x + q * L::XS + 2 * gi * K;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float4 u = *reinterpret_cast<const float4*>(in + j * kCC);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const float x = xr[kk * K + j];
              v[kk].x += x * u.x;
              v[kk].y += x * u.y;
              v[kk].z += x * u.z;
              v[kk].w += x * u.w;
            }
          }
        }
        uint4 big[2], small[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          split_tf32(v[kk].x, big[kk].x, small[kk].x);
          split_tf32(v[kk].y, big[kk].y, small[kk].y);
          split_tf32(v[kk].z, big[kk].z, small[kk].z);
          split_tf32(v[kk].w, big[kk].w, small[kk].w);
        }
        const int slot = n % kRing;
        float* dst = s_ring + slot * kSlot + (q >> 3) * 64 + hf * 32 + (q & 7) * 4;
        mbar_wait(empty + slot, ((n / kRing) & 1) ^ 1);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          float* d = dst + kk * (2 * kBM * 8);
          *reinterpret_cast<uint4*>(d) = big[kk];
          *reinterpret_cast<uint4*>(d + kBM * 8) = small[kk];
        }
        fence_proxy_async();
        mbar_arrive(full + slot);
      }
      if (lifted) {
        named_bar_sync(2, 128);  // every mixer thread is done with the buffer
        if (mt == 0) mbar_arrive_cluster(mapa(lift_empty + nl % L::kNL, nl % csize));
        ++nl;
      } else {
        named_bar_sync(2, 128);  // every mixer thread is done with this buffer
      }
    }
    cp_async_wait<0>();
  } else {
    // --- consumer warpgroups ------------------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int w = (tid - 256) >> 7;  // 0, 1: output channels [nb, nb + 128)
    const int ct = tid & 127;
    const int wi = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
    const int nb = blockIdx.y * kBN + w * kWN;
    const bool active = nb < a.dp;
    const int ngt = a.dp / 8;
    const int ng0 = nb / 8;
    const int ngroups = (ce - cb) * (K / 2);
    const int ks0 = cb * K;  // first k-step of this split
    float* s_b = smem + L::bst + w * kNSB * kBStage;

    // B stage of group gi: [k-step][part][16 channel groups x 16 float4].
    auto load_b = [&](int gi) {
      float4* dst = reinterpret_cast<float4*>(s_b + (gi % kNSB) * kBStage);
      const int ks = ks0 + 2 * gi;
      for (int i = ct; i < kBStage / 4; i += 128) {
        const int sp = i >> 8;  // 2 * k-step + part
        const int j = i & 255;
        cp_async16(dst + i, a.wt + ((size_t)(2 * ks + sp) * ngt + ng0) * 16 + j);
      }
    };

    float acc[kWN / 2], tmp[kWN / 2];
#pragma unroll
    for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
    for (int s = 0; s < kNSB - 1; ++s) {
      if (active && s < ngroups) load_b(s);
      cp_async_commit();
    }
#pragma unroll 1
    for (int gi = 0; gi < ngroups; ++gi) {
      cp_async_wait<kNSB - 2>();  // this thread's copies of group gi have landed
      fence_proxy_async();
      named_bar_sync(3 + w, 128);  // ... every thread's; stage (gi - 1) % kNSB is free
      if (active && gi + kNSB - 1 < ngroups) load_b(gi + kNSB - 1);
      cp_async_commit();
      const int slot = gi % kRing;
      mbar_wait(full + slot, (gi / kRing) & 1);
      if (active) {
        const float* sa = s_ring + slot * kSlot;
        const float* sb = s_b + (gi % kNSB) * kBStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* ab = sa + kk * (2 * kBM * 8);
          const float* bb = sb + kk * (2 * kWN * 8);
          wgmma_ss_n128(tmp, b_desc(ab + kBM * 8), b_desc(bb), kk > 0);  // a_small b_big
          wgmma_ss_n128(tmp, b_desc(ab), b_desc(bb + kWN * 8), 1);       // a_big b_small
          wgmma_ss_n128(tmp, b_desc(ab), b_desc(bb), 1);                 // a_big b_big
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(tmp);
      }
      mbar_arrive(empty + slot);
      if (active) {
#pragma unroll
        for (int i = 0; i < kWN / 2; ++i) acc[i] += tmp[i];
      }
    }
    cp_async_wait<0>();

    if (active) {
      // Epilogue. Fragment: warp wi holds rows 16 wi + g (+ 8); for each n8
      // block j, acc[4j + 2hi + e] is (row + 8 hi, column 8j + 2t + e).
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        const int col = nb + 8 * j + 2 * t;
        if (col >= a.d) continue;
        float2 sc = make_float2(0.f, 0.f), bc = sc;
        if (a.splits == 1) {
          sc = *reinterpret_cast<const float2*>(a.sc + col);
          bc = *reinterpret_cast<const float2*>(a.bc + col);
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int q = q0 + 16 * wi + g + 8 * hi;
          if (q >= nq) continue;
          const float v0 = acc[4 * j + 2 * hi], v1 = acc[4 * j + 2 * hi + 1];
          if (a.splits == 1) {
            *reinterpret_cast<float2*>(a.out + (size_t)q * a.d + col) =
                make_float2(elu(v0) * sc.x + bc.x, elu(v1) * sc.y + bc.y);
          } else {
            *reinterpret_cast<float2*>(a.partial + ((size_t)blockIdx.z * nq + q) * a.d + col) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while another of its cluster may write to it
}

// out = BNc(ELU(sum over splits of the partial sums)), the splits summed in
// order; one thread per 4 outputs.
__global__ void xconv_split_epilogue(const float4* __restrict__ partial,
                                     const float* __restrict__ sc,
                                     const float* __restrict__ bc, float4* __restrict__ out,
                                     int splits, int nq, int d) {
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
  out[i] = make_float4(elu(s.x) * c.x + b.x, elu(s.y) * c.y + b.y, elu(s.z) * c.z + b.z,
                       elu(s.w) * c.w + b.w);
}

template <int K>
cudaError_t launch(XconvArgs a, cudaStream_t stream) {
  using L = Layout<K>;
  cudaError_t err = cudaFuncSetAttribute(xconv_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  const int nq = a.b * a.p;
  const int ntiles = (a.dp + kBN - 1) / kBN;
  // Pairs of channel tiles share their lifted chunks; each lifted-chunk
  // buffer then keeps one producer, its phases waited in order.
  static_assert(L::kNL % 2 == 0, "one producer per lifted-chunk buffer");
  a.cluster = ntiles % 2 == 0 ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nq + kBM - 1) / kBM, ntiles, a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, xconv_kernel<K>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K in {4, 8, 12}; Cf <= 256; D a multiple of 4; wt the arranged operand
// of `ops/xconv.py` (`xconv_weight_operand`, D padded to dp, a multiple of
// 128); 1 <= splits <= the number of 8-channel chunks. With splits == 1
// the result goes to out, else the raw partial sums go to partial
// (splits x B*P x D) for hfr_xconv_epilogue. vec4: Cp % 4 == 0 and fts
// 16-byte aligned (16-byte gathers).
int hfr_xconv(const float* pts, const float* fts, const float* qrs, const int* idx,
              const float* w1, const float* s1, const float* b1, const float* w2,
              const float* s2, const float* b2, const float* wx0, const float* sx0,
              const float* bx0, const float* wx1, const float* sx1, const float* bx1,
              const float* wx2, const float* sx2, const float* bx2, const float* wt,
              const float* sc, const float* bc, float* out, float* partial, int b, int n,
              int p, int k, int cf, int cp, int d, int dp, int with_x, int splits, int vec4,
              void* stream) {
  const int nch = (cf + kCC - 1) / kCC + (cp + kCC - 1) / kCC;
  if (d % 4 != 0 || dp % kWN != 0 || dp < d || cf < 1 || cf > kMaxCf || splits < 1 ||
      splits > nch || splits > 65535 || b * p < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  XconvArgs a{pts, fts, qrs, idx, w1, s1, b1, w2, s2, b2, wx0, sx0, bx0, wx1, sx1, bx1,
              wx2, sx2, bx2, reinterpret_cast<const float4*>(wt), sc, bc, out, partial,
              b, n, p, cf, cp, d, dp, with_x, splits, vec4, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4>(a, s);
    case 8:
      return launch<8>(a, s);
    case 12:
      return launch<12>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (B*P, D) = BNc(ELU(sum of the splits' partial sums)).
int hfr_xconv_epilogue(const float* partial, const float* sc, const float* bc, float* out,
                       int splits, int nq, int d, void* stream) {
  if (d % 4 != 0 || splits < 1 || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n4 = (size_t)nq * d / 4;
  const int threads = 256;
  xconv_split_epilogue<<<(unsigned)((n4 + threads - 1) / threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(partial), sc, bc, reinterpret_cast<float4*>(out), splits,
      nq, d);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form (xconv_bf16.cuh): fts (B, N, Cp) bf16, the coordinates and
// the weights float32 (rounded to bf16 in the kernel), wt the arranged bf16
// Wc of `ops/xconv.py` (`xconv_weight_operand_bf16`: D padded to dp, 256
// for D <= 256, else a multiple of 512 up to 1024); out (B, P, D) bf16 with
// splits == 1, else the float32 partial sums into partial for
// hfr_xconv_epilogue_bf16. vec8: Cp % 8 == 0 and fts 16-byte aligned
// (16-byte gathers). A refused launch (shape, cluster, occupancy) returns
// its error.
int hfr_xconv_bf16(const float* pts, const void* fts, const float* qrs, const int* idx,
                   const float* w1, const float* s1, const float* b1, const float* w2,
                   const float* s2, const float* b2, const float* wx0, const float* sx0,
                   const float* bx0, const float* wx1, const float* sx1, const float* bx1,
                   const float* wx2, const float* sx2, const float* bx2, const void* wt,
                   const float* sc, const float* bc, void* out, float* partial, int b, int n,
                   int p, int k, int cf, int cp, int d, int dp, int with_x, int splits,
                   int vec8, void* stream) {
  namespace x16 = hfr::bf16xconv;
  const int nch = (cf + x16::kKC - 1) / x16::kKC + (cp + x16::kKC - 1) / x16::kKC;
  if (d % 4 != 0 || dp < d || (dp != 256 && dp % 512 != 0) || dp > x16::kMaxD || cf < 1 ||
      cf > x16::kMaxCf || splits < 1 || splits > nch || splits > 65535 || b * p < 1 ||
      (splits > 1 && partial == nullptr) || (splits == 1 && out == nullptr) ||
      (cp > 0 && fts == nullptr) || reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  x16::Args a{pts, static_cast<const __nv_bfloat16*>(fts), qrs, idx, w1, s1, b1, w2, s2, b2,
              wx0, sx0, bx0, wx1, sx1, bx1, wx2, sx2, bx2,
              static_cast<const __nv_bfloat16*>(wt), sc, bc, static_cast<__nv_bfloat16*>(out),
              partial, b, n, p, cf, cp, d, dp, with_x, splits, vec8, 1, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return x16::run<4>(a, s);
    case 8:
      return x16::run<8>(a, s);
    case 12:
      return x16::run<12>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (B*P, D) bf16 = BNc(ELU(sum of the splits' float32 partial sums)).
int hfr_xconv_epilogue_bf16(const float* partial, const float* sc, const float* bc, void* out,
                            int splits, int nq, int d, void* stream) {
  if (d % 4 != 0 || splits < 1 || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n4 = (size_t)nq * d / 4;
  const int threads = 256;
  hfr::bf16xconv::xconv_split_epilogue_bf16<<<(unsigned)((n4 + threads - 1) / threads), threads,
                                              0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(partial), sc, bc, static_cast<__nv_bfloat162*>(out),
      splits, nq, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
