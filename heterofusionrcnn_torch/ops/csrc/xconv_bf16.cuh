// The bf16 form of the fused inference XConv (xconv.cu) for the H100
// (sm_90a): bf16 operands on the tensor cores (`wgmma`), float32 sums and
// affines, a bf16 output.
//
// Replaces the `compute_dtype=jnp.bfloat16` form of
// heterofusionrcnn_tpu/ops/pallas_xconv.py `fused_xconv` /
// `_xconv_kernel`, rounding to bf16 exactly where that kernel casts to its
// compute dtype and nowhere else:
//   - the local coordinates before lift-1 and X_0 (pallas_xconv.py:132,
//     :149), the lift-1 output h before lift-2 (:138), X_0 and X_1 before
//     X_1 and X_2 (:151, :153), the (X @ in) stacks before Wc (:181);
//   - every weight once (:317-329; the wrapper rounds Wc, composed in
//     float32, when it arranges it: `ops/xconv.py`,
//     `xconv_weight_operand_bf16`);
//   - the gathered features arrive in bf16 (pointcnn.py:302, :320) and are
//     widened exactly; the lifted features f2 and X_2 stay float32, and
//     X @ in is summed in float32 FMAs on the CUDA cores (:170-178);
//   - the output (`out_dtype` defaults to the compute dtype); the split
//     path's partial sums stay float32 and its epilogue rounds.
//
// Bound: operations. The separable conv, 2 P K Cin D FLOPs, is most of the
// work: a GEMM with M = queries, N = D and the contraction (k, c) over
// K Cin, at the bf16 tensor-core rate. Building its A operand (gather,
// lifts, X-mix) is CUDA-core work of about K FMAs per A element against D
// tensor-core MACs; it fits under the products only when each A element
// is formed once, whatever D is, and beside the products, not between them.
//
// Design. A cluster of C CTAs (along gridDim.x) holds one tile of 64
// queries and covers all of the layer's padded D: each CTA 2 WN output
// channels, WN = 256 (128 where D <= 256), C = Dp / (2 WN) (D 256 and 512:
// 1, D 1024: 2). The grid is persistent: each cluster walks the items
// (query tile, split of the contraction) cluster id, + clusters, ...,
// split-major, so a tile's epilogue overlaps the next tile's first chunks.
// The contraction goes in chunks of 16 input channels, the lifted chunks
// spread among the feature chunks (`lifted_at`, as xconv.cu; `chunk_order`
// in `ops/xconv.py`). Three warpgroups a CTA:
// - Warpgroup 2, the producer, builds A chunk by chunk: the chunk's 64 x K
//   rows of 16 channels (a feature chunk gathered from the bf16 features
//   by cp.async into one of two staging buffers, the next one issued
//   before this one is mixed; a lifted chunk as f2 = BN2(ELU(h @ W2[:, chunk]))
//   on `mma.sync`, W2's slice rounded into shared memory), then (X @ in)
//   in float32 FMAs, X_2 held in registers for the whole tile (thread =
//   query x half: of the channels for K = 4, of the neighbours k for
//   K = 8 and 12), rounded to bf16 into a ring slot of R chunks, K-major as
//   `wgmma` reads it. In a cluster, the producer of CTA r builds the
//   chunks g with g % C == r (g counts every chunk the cluster walks) and
//   stores each into the slot of every CTA of the cluster (distributed
//   shared memory), so each A element is formed once per forward; ring
//   slot s is always filled by CTA s % C (R is a multiple of C). Per tile
//   it first forms the rows, the local coordinates and the X-net (X_0 and
//   X_1 in bf16 over the staging buffers, its weights staged in shared
//   memory once per block).
// - Lift-1: h = BN1(ELU(local @ W1)), rounded, is formed once per (row,
//   tile) and kept in shared memory where 64 K Cf16 values fit beside the
//   rings: K = 4 at Cf <= 128 (64 KB) and K = 8 at Cf <= 64. K = 8 at
//   Cf 128 (128 KB) and every K = 12 layer (192 and 384 KB) do not fit;
//   there h is recomputed into lift-2's A fragments for each lifted chunk,
//   the recompute shared across the cluster (each CTA lifts only the
//   chunks it owns: Cf / 16 / C times a tile). A smaller query tile was
//   not taken: `wgmma` needs 64 rows, and the lifted A itself (64 K Cf
//   values) does not fit either, so h would still be recomputed.
// - Warpgroups 0 and 1, the consumers, each own WN of the CTA's channels.
//   Per chunk they wait for its slot, then per neighbour k one
//   `wgmma.mma_async` m64nWNk16 bf16 (A and B from shared memory, no
//   swizzle: 8 x 16-byte core matrices, stride 128 bytes between 8-row
//   groups, the k16 step's two halves a plane apart), float32
//   accumulators in registers. Wc comes arranged by the wrapper once per
//   weight version as [N tile][chunk][k][half][WN][8] bf16, so each
//   (chunk, k) B tile is one contiguous WN x 32 bytes: one thread of each
//   consumer streams its tiles by bulk copy (`cp.async.bulk`, complete_tx
//   on an mbarrier) through a ring of S stages. A stage is released, and
//   refilled, when the product after it has been waited for; a slot, when
//   its last k's product has (every consumer warp of the cluster arrives
//   on its empty barrier in the CTA that fills it).
// - setmaxnreg: the producer 152 registers, the consumers 176 (from 168).
//   384 threads compile at 168 registers a thread, so m64n256's 128
//   accumulators leave no room for a fourth warpgroup; the producer holds
//   X_2's rows (up to 72 registers) beside the lift, and at 136 registers
//   it spilled and its mix ran several times slower.
// Every mbarrier wait traps after ~2^32 cycles, so a lost stage fails the
// launch instead of hanging the card; a refused cluster launch or
// occupancy returns its error to the op, which raises.
//
// Measured (`tools/xconv_ablation.py --dtype bfloat16`,
// `tools/xconv_bf16_trace.py`, `PERF.md`): where h is kept (K = 4) the
// consumers set the pace, about 1100 cycles a k-step against 128-256 of
// products, most of it between a product's wait and the next Wc stage's
// arrival; where h is recomputed (K = 8 at Cf >= 128, K = 12) the
// producer's lifted chunks do (40-100 thousand cycles each).
//
// A elements formed, per element, on the main path (batch-4 forward,
// `rpn_multiclass` / `rcnn_multiclass`): once for every layer (RPN K 8,
// D 256 / 512 / 1024 at C = 1 / 1 / 2; RCNN K 4 D 512, K 8 D 512 at C = 1,
// K 12 D 1024 twice at C = 2). h formed per (row, tile): once at the RPN's
// Cf 64 layers and the RCNN's first (K 4, Cf 128); Cf / 16 times at the
// RPN's Cf 128 (8) and Cf 256 (16) layers and the RCNN's K 8 (8) and
// K 12 (8 and 16), split among the cluster's CTAs.
//
// Epilogue: ELU and the folded output BatchNorm on the accumulators, bf16
// pairs to the output (one split), or the float32 partial sums
// (`plan_xconv` splits the contraction of the few-query layers;
// `hfr_xconv_epilogue_bf16` sums them in split order).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_bf16.cuh"
#include "conv_common.cuh"

namespace hfr {
namespace bf16xconv {

using bf16conv::bulk_load;
using bf16conv::kmajor_desc;
using bf16conv::lds32;
using bf16conv::mbar_expect_tx;
using bf16conv::mma_bf16;

constexpr int kBM = 64;         // queries per tile (one wgmma M)
constexpr int kKC = 16;         // contraction channels per chunk (one k16 step per neighbour)
constexpr int kMaxCf = 256;
constexpr int kMaxD = 1024;     // output channels the cluster sizes cover
constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kProducerRegs = 152;
constexpr int kConsumerRegs = 176;  // 128 x 152 + 256 x 176 = 384 x 168, the launch's registers
constexpr int kW2P = kMaxCf + 8;    // bf16 per staged W2 row (one lifted channel, all of h)
constexpr int kSmemMax = 232448;

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
  const __nv_bfloat16* wt;    // arranged Wc: [Dp / WN][chunk][K][2][WN][8]
  const float* sc;            // (D)
  const float* bc;
  __nv_bfloat16* out;         // (B, P, D)
  float* partial;             // (splits, B * P, D) when splits > 1
  int b, n, p, cf, cp, d, dp, with_x, splits, vec8;
  int cluster, qtiles, items;  // set by `launch`
};

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// exp(x) - 1 for x <= 0, as the TPU kernel computes it (`_elu`).
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : __expf(x) - 1.f; }

// Two values rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four bf16 (two words) widened exactly.
__device__ __forceinline__ float4 widen4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// The contraction's chunk schedule (xconv.cu's `lifted_at` for 16-channel
// chunks; `ops/xconv.py` `chunk_order`): the lifted chunk at position p,
// or -1 for the feature chunk p - ceil(p nf / nch).
__device__ __forceinline__ int lifted_at(int p, int nf, int nch) {
  const int i = (p * nf + nch - 1) / nch;
  return i < nf && i * nch / nf == p ? i : -1;
}

// mbarrier wait that traps after ~2^32 cycles; with kCluster, acquire at
// cluster scope (phases completed from another CTA of the cluster). The
// time hint lets a waiting thread sleep until the phase completes (up to
// 20 us a try) rather than poll.
template <bool kCluster>
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    if constexpr (kCluster) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2, %3;\n"
          "selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(smem_addr(bar)), "r"(parity), "r"(20000)
          : "memory");
    } else {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
          "selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(smem_addr(bar)), "r"(parity), "r"(20000)
          : "memory");
    }
    if (done) return;
    const long long now = clock64();
    if (start == 0) start = now;
    if (now - start > (1ll << 32)) __trap();
  }
}

// Arrive on one of this CTA's mbarriers, its state not returned.
__device__ __forceinline__ void arrive_cta(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// A ring barrier's wait: CTA scope in a cluster of one.
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity, int cl) {
  if (cl == 1) {
    wait_or_trap<false>(bar, parity);
  } else {
    wait_or_trap<true>(bar, parity);
  }
}

__device__ __forceinline__ void st_cluster_v2(uint32_t addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};" ::"r"(addr), "r"(v.x), "r"(v.y)
               : "memory");
}

// Orders this thread's generic-proxy writes to its own CTA's shared
// memory (cl == 1), or to any CTA's of the cluster, before later
// async-proxy reads (wgmma).
__device__ __forceinline__ void fence_ring_stores(int cl) {
  if (cl == 1) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  } else {
    asm volatile("fence.proxy.async;" ::: "memory");
  }
}

// d (64 x 256) = A (64 x 16, desc a) B (16 x 256, desc b) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int WN>
__device__ __forceinline__ void wgmma_tile(float (&d)[WN / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (WN == 256) {
    wgmma_n256(d, a, b, acc);
  } else {
    bf16conv::wgmma_bf16(d, a, b, acc);
  }
}

// Shared memory of one (K, WN) form, in bytes from a 128-byte aligned base.
template <int K, int WN>
struct Layout {
  static_assert(WN == 128 || WN == 256, "tile width");
  static constexpr int R = K == 4 ? 4 : 2;            // A ring slots (a multiple of the cluster)
  static constexpr int ASLOT = kBM * K * kKC * 2;     // one chunk: [k][half][64][8] bf16
  static constexpr int BST = WN * kKC * 2;            // one (chunk, k) B tile: [half][WN][8] bf16
  static constexpr int QPB = K * 32 + 16;             // bytes per query, bf16 feature staging
  static constexpr int QPF = K * 64 + 16;             // bytes per query, float32 f2 staging
  static constexpr int FBUF = kBM * QPB;
  static constexpr int STG = 2 * FBUF > kBM * QPF ? 2 * FBUF : kBM * QPF;
  static constexpr int HCF = K == 4 ? 128 : K == 8 ? 64 : 0;  // lifted channels h keeps
  static constexpr int HP = HCF + 8;                  // bf16 per h row
  static constexpr int XN = K * K;
  static constexpr int a = 0;
  static constexpr int stg = a + R * ASLOT;
  static constexpr int h = stg + STG;
  static constexpr int w2 = h + (HCF ? kBM * K * HP * 2 : 0);
  static constexpr int lp = w2 + kKC * kW2P * 2;      // lift-1 (w1 x, y, z, s1): float4
  static constexpr int lb = lp + kMaxCf * 16;         // lift-1 shift b1
  static constexpr int xw0 = lb + kMaxCf * 4;         // X_0 weight, bf16 (3K, K^2)
  static constexpr int xw1 = xw0 + (3 * K * XN * 2 + 15) / 16 * 16;  // X_1, X_2 weights (K^3)
  static constexpr int xw2 = xw1 + (K * XN * 2 + 15) / 16 * 16;
  static constexpr int xs = xw2 + (K * XN * 2 + 15) / 16 * 16;       // 6 x K^2 scales, shifts
  static constexpr int row = xs + 6 * XN * 4;         // source rows: 64 K ints
  static constexpr int loc = row + kBM * K * 4;       // local coordinates: 64 K x 3 floats
  static constexpr int fixed = loc + kBM * K * 12;
  static constexpr int FIT = (kSmemMax - 128 - fixed - 64 * 8) / (2 * BST);
  static constexpr int S = FIT < 6 ? FIT : 6;         // B stages per consumer warpgroup
  static constexpr int b = fixed;
  static constexpr int bars = b + 2 * S * BST;        // full[R], empty[R], bfull[2S], bempty[2S]
  static constexpr int bytes = bars + (2 * R + 4 * S) * 8;
  static constexpr int smem = bytes + 128;            // + alignment
  static_assert(S >= 3, "B pipeline depth");
  static_assert(2 * kBM * XN * 2 <= STG, "X-net temporaries must fit in the staging buffers");
  static_assert(smem <= kSmemMax, "shared memory");
};

template <int K, int WN>
__global__ void __launch_bounds__(kThreads, 1) xconv_bf16_kernel(const Args a) {
  using L = Layout<K, WN>;
  constexpr int R = L::R;
  constexpr int S = L::S;
  constexpr int XN = L::XN;
  constexpr int kRows = kBM * K;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* const sm = smem_raw + (((raw + 127) & ~127u) - raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* const empty = full + R;
  uint64_t* const bfull = empty + R;      // [consumer][stage]
  uint64_t* const bempty = bfull + 2 * S;

  const int tid = threadIdx.x;
  const int cl = a.cluster;
  const int rank = (int)cluster_ctarank();
  const int cid = blockIdx.x / cl;
  const int ncl = gridDim.x / cl;
  const int nq = a.b * a.p;
  const int nf = (a.cf + kKC - 1) / kKC;  // lifted chunks
  const int nch = nf + (a.cp + kKC - 1) / kKC;

  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(full + s, 1);            // the filling CTA's producer, once
      mbar_init(empty + s, 8 * cl);      // each consumer warp of the cluster, once
    }
    for (int s = 0; s < 2 * S; ++s) {
      mbar_init(bfull + s, 1);           // the loader's expect_tx (+ the copy's bytes)
      mbar_init(bempty + s, 4);          // each warp of the consumer warpgroup
    }
    fence_mbarrier_init();
  }
  // Every CTA's barriers initialised before another CTA of the cluster
  // arrives on them or stores into its ring.
  cluster_sync();

  if (tid >= 256) {
    // --- producer warpgroup ------------------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    const int pt = tid - 256;
    const int lane = pt & 31, pw = pt >> 5, g = lane >> 2, t = lane & 3;
    const int cf16 = nf * kKC;
    const bool hres = cf16 <= L::HCF;
    uint8_t* const stg = sm + L::stg;
    __nv_bfloat16* const s_h = reinterpret_cast<__nv_bfloat16*>(sm + L::h);
    __nv_bfloat16* const s_w2 = reinterpret_cast<__nv_bfloat16*>(sm + L::w2);
    float4* const s_lp = reinterpret_cast<float4*>(sm + L::lp);
    float* const s_lb = reinterpret_cast<float*>(sm + L::lb);
    __nv_bfloat16* const s_xw0 = reinterpret_cast<__nv_bfloat16*>(sm + L::xw0);
    __nv_bfloat16* const s_xw1 = reinterpret_cast<__nv_bfloat16*>(sm + L::xw1);
    __nv_bfloat16* const s_xw2 = reinterpret_cast<__nv_bfloat16*>(sm + L::xw2);
    float* const s_xs = reinterpret_cast<float*>(sm + L::xs);
    int* const s_row = reinterpret_cast<int*>(sm + L::row);
    float* const s_loc = reinterpret_cast<float*>(sm + L::loc);

    // Once per block: lift-1's parameters (w1 rounded) and the X-net's
    // weights (rounded) with their scales and shifts.
    for (int h = pt; h < cf16; h += 128) {
      const bool v = h < a.cf;
      s_lp[h] = make_float4(v ? bfr(__ldg(a.w1 + h)) : 0.f, v ? bfr(__ldg(a.w1 + a.cf + h)) : 0.f,
                            v ? bfr(__ldg(a.w1 + 2 * a.cf + h)) : 0.f, v ? __ldg(a.s1 + h) : 0.f);
      s_lb[h] = v ? __ldg(a.b1 + h) : 0.f;
    }
    if (a.with_x) {
      for (int i = pt; i < 3 * K * XN; i += 128) s_xw0[i] = __float2bfloat16_rn(__ldg(a.wx0 + i));
      for (int i = pt; i < K * XN; i += 128) {
        s_xw1[i] = __float2bfloat16_rn(__ldg(a.wx1 + i));
        s_xw2[i] = __float2bfloat16_rn(__ldg(a.wx2 + i));
      }
      for (int m = pt; m < XN; m += 128) {
        s_xs[m] = __ldg(a.sx0 + m);
        s_xs[XN + m] = __ldg(a.bx0 + m);
        s_xs[2 * XN + m] = __ldg(a.sx1 + m);
        s_xs[3 * XN + m] = __ldg(a.bx1 + m);
        s_xs[4 * XN + m] = __ldg(a.sx2 + m);
        s_xs[5 * XN + m] = __ldg(a.bx2 + m);
      }
    }
    // The mix: thread = (query q, half s): for K = 4 all K outputs k of
    // channels 8 s .. 8 s + 7 (groups 2 s, 2 s + 1); for K = 8 and 12
    // outputs k = s K / 2 .. of all 16 channels. X_2's rows for those k
    // stay in registers for the tile.
    constexpr int KO = K == 4 ? K : K / 2;
    constexpr int CG = K == 4 ? 2 : 4;
    const int q = pt >> 1, s = pt & 1;
    const int kbase = K == 4 ? 0 : s * KO;
    const int gbase = K == 4 ? 2 * s : 0;
    float xr[KO][K];
#pragma unroll
    for (int ko = 0; ko < KO; ++ko)
#pragma unroll
      for (int j = 0; j < K; ++j) xr[ko][j] = 0.f;

    // Feature chunk at position p into staging buffer fb: 64 x K rows of
    // 16 channels, zero past Cp.
    auto gather = [&](int p, int fb) {
      const int c0 = (p - (p * nf + nch - 1) / nch) * kKC;
      uint8_t* buf = stg + fb * L::FBUF;
      if (a.vec8) {
        for (int e = pt; e < kRows * 2; e += 128) {
          const int r = e >> 1, half = e & 1, c = c0 + 8 * half;
          const bool valid = c < a.cp;
          const __nv_bfloat16* src = valid ? a.fts + (size_t)s_row[r] * a.cp + c : a.fts;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                           smem_addr(buf + (r / K) * L::QPB + (r % K) * 32 + 16 * half)),
                       "l"(src), "r"(valid ? 16 : 0));
        }
      } else {
        for (int e = pt; e < kRows * kKC; e += 128) {
          const int r = e / kKC, cc = e % kKC, c = c0 + cc;
          reinterpret_cast<__nv_bfloat16*>(buf + (r / K) * L::QPB + (r % K) * 32)[cc] =
              c < a.cp ? a.fts[(size_t)s_row[r] * a.cp + c] : __float2bfloat16_rn(0.f);
        }
      }
      cp_async_commit();
    };

    uint32_t g_all = 0;  // chunks the cluster has walked (ring position)
    int nfeat = 0;       // feature chunks this producer has gathered
#pragma unroll 1
    for (int item = cid; item < a.items; item += ncl) {
      const int q0 = (item % a.qtiles) * kBM;
      const int z = item / a.qtiles;
      const int cb = z * nch / a.splits, ce = (z + 1) * nch / a.splits;
      const int nc = ce - cb;
      const int first = (rank - (int)(g_all % cl) + cl) % cl;  // first owned chunk of the item
      if (first >= nc) {
        g_all += nc;
        continue;
      }
      // --- the tile's set-up: rows, local coordinates (rounded), X, h.
      for (int r = pt; r < kRows; r += 128) {
        const int qq = q0 + r / K;
        int row = 0;
        float lx = 0.f, ly = 0.f, lz = 0.f;
        if (qq < nq) {
          row = (qq / a.p) * a.n + __ldg(a.idx + (size_t)qq * K + r % K);
          const float* pp = a.pts + (size_t)row * 3;
          const float* qp = a.qrs + (size_t)qq * 3;
          lx = __ldg(pp) - __ldg(qp);
          ly = __ldg(pp + 1) - __ldg(qp + 1);
          lz = __ldg(pp + 2) - __ldg(qp + 2);
        }
        s_row[r] = row;
        s_loc[r * 3 + 0] = bfr(lx);
        s_loc[r * 3 + 1] = bfr(ly);
        s_loc[r * 3 + 2] = bfr(lz);
      }
      named_bar_sync(1, 128);
      if (a.with_x) {
        __nv_bfloat16* x0 = reinterpret_cast<__nv_bfloat16*>(stg);  // 64 x K^2, over the staging
        __nv_bfloat16* x1 = x0 + kBM * XN;
        for (int e = pt; e < kBM * XN; e += 128) {
          const int qq = e / XN, m = e % XN;
          float acc = 0.f;
          for (int i = 0; i < 3 * K; ++i)
            acc += s_loc[qq * 3 * K + i] * __bfloat162float(s_xw0[i * XN + m]);
          x0[e] = __float2bfloat16_rn(elu(acc) * s_xs[m] + s_xs[XN + m]);
        }
        named_bar_sync(1, 128);
        // Depthwise over the neighbour axis: out[c*K + j] = sum_k in[k*K + c] * w[k, c, j].
        for (int e = pt; e < kBM * XN; e += 128) {
          const int qq = e / XN, m = e % XN, c = m / K, j = m % K;
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k)
            acc += __bfloat162float(x0[qq * XN + k * K + c]) *
                   __bfloat162float(s_xw1[(k * K + c) * K + j]);
          x1[e] = __float2bfloat16_rn(elu(acc) * s_xs[2 * XN + m] + s_xs[3 * XN + m]);
        }
        named_bar_sync(1, 128);
        // X_2 rows kbase .. kbase + KO - 1 of query q, summed over k in order.
#pragma unroll
        for (int ko = 0; ko < KO; ++ko)
#pragma unroll
          for (int j = 0; j < K; ++j) xr[ko][j] = 0.f;
#pragma unroll 1
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int ko = 0; ko < KO; ++ko) {
            const int c = kbase + ko;
            const float x = __bfloat162float(x1[q * XN + k * K + c]);
#pragma unroll
            for (int j = 0; j < K; ++j) xr[ko][j] += x * __bfloat162float(s_xw2[(k * K + c) * K + j]);
          }
        }
#pragma unroll
        for (int ko = 0; ko < KO; ++ko)
#pragma unroll
          for (int j = 0; j < K; ++j)
            xr[ko][j] = xr[ko][j] * s_xs[4 * XN + (kbase + ko) * K + j] + s_xs[5 * XN + (kbase + ko) * K + j];
      }
      if (hres) {
        // h = BN1(ELU(local @ W1)), rounded, for every row: [row][HP] bf16;
        // a row a thread, so the warp reads each lift-1 parameter at once.
        for (int r = pt; r < kRows; r += 128) {
          const float x = s_loc[r * 3], y = s_loc[r * 3 + 1], zc = s_loc[r * 3 + 2];
#pragma unroll 1
          for (int h0 = 0; h0 < cf16; h0 += 8) {
            uint32_t w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 p0 = s_lp[h0 + 2 * u], p1 = s_lp[h0 + 2 * u + 1];
              w[u] = pack_bf16(elu(x * p0.x + y * p0.y + zc * p0.z) * p0.w + s_lb[h0 + 2 * u],
                               elu(x * p1.x + y * p1.y + zc * p1.z) * p1.w + s_lb[h0 + 2 * u + 1]);
            }
            *reinterpret_cast<uint4*>(s_h + r * L::HP + h0) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
      named_bar_sync(1, 128);  // X and h complete, the staging free

      int pending = -1;  // a feature chunk whose gather was issued ahead
#pragma unroll 1
      for (int p = cb + first; p < ce; p += cl) {
        const uint32_t gc = g_all + (p - cb);
        const int slot = gc % R;
        const int li = lifted_at(p, nf, nch);
        const int fb = nfeat & 1;
        if (li < 0) {
          // --- a feature chunk: its rows (gathered ahead where possible).
          if (pending != p) gather(p, fb);
          const int pn = p + cl;
          if (pn < ce && lifted_at(pn, nf, nch) < 0) {
            gather(pn, fb ^ 1);
            pending = pn;
            cp_async_wait<1>();
          } else {
            pending = -1;
            cp_async_wait<0>();
          }
          ++nfeat;
        } else {
          // --- a lifted chunk: f2 = BN2(ELU(h @ W2[:, c0 ..])) into the
          // staging, float32 [query][k][16].
          const int c0 = li * kKC;
          for (int e = pt; e < kKC * cf16; e += 128) {
            const int h = e / kKC, c = e % kKC;
            const bool v = h < a.cf && c0 + c < a.cf;
            s_w2[c * kW2P + h] = __float2bfloat16_rn(v ? __ldg(a.w2 + (size_t)h * a.cf + c0 + c) : 0.f);
          }
          float s2v[2][2], b2v[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cg = c0 + 8 * nt + 2 * t + e;
              s2v[nt][e] = cg < a.cf ? __ldg(a.s2 + cg) : 0.f;
              b2v[nt][e] = cg < a.cf ? __ldg(a.b2 + cg) : 0.f;
            }
          named_bar_sync(1, 128);
          // Warp pw owns the m16 row tiles pw + 4 i, i < K, MG at a time.
          constexpr int MG = 2;
#pragma unroll 1
          for (int i0 = 0; i0 < K; i0 += MG) {
            float la[MG][2][4];
            float xl[MG][2][3];
#pragma unroll
            for (int u = 0; u < MG; ++u) {
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) la[u][nt][i] = 0.f;
#pragma unroll
              for (int hi = 0; hi < 2; ++hi)
#pragma unroll
                for (int c = 0; c < 3; ++c)
                  xl[u][hi][c] = s_loc[(16 * (pw + 4 * (i0 + u)) + g + 8 * hi) * 3 + c];
            }
#pragma unroll 1
            for (int hs = 0; hs < cf16; hs += kKC) {
              uint32_t bw[2][2];
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const __nv_bfloat16* bp = s_w2 + (8 * nt + g) * kW2P + hs + 2 * t;
                bw[nt][0] = lds32(bp);
                bw[nt][1] = lds32(bp + 8);
              }
              if (hres) {
#pragma unroll
                for (int u = 0; u < MG; ++u) {
                  const __nv_bfloat16* hp =
                      s_h + (16 * (pw + 4 * (i0 + u)) + g) * L::HP + hs + 2 * t;
                  const uint32_t af[4] = {lds32(hp), lds32(hp + 8 * L::HP), lds32(hp + 8),
                                          lds32(hp + 8 * L::HP + 8)};
                  mma_bf16(la[u][0], af, bw[0]);
                  mma_bf16(la[u][1], af, bw[1]);
                }
              } else {
                float4 p4[4];
                float pb[4];
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  const int h = hs + 2 * t + (v & 1) + 8 * (v >> 1);  // k 2t, 2t + 1, 2t + 8, 2t + 9
                  p4[v] = s_lp[h];
                  pb[v] = s_lb[h];
                }
#pragma unroll
                for (int u = 0; u < MG; ++u) {
                  float hv[2][4];
#pragma unroll
                  for (int hi = 0; hi < 2; ++hi)
#pragma unroll
                    for (int v = 0; v < 4; ++v)
                      hv[hi][v] = elu(xl[u][hi][0] * p4[v].x + xl[u][hi][1] * p4[v].y +
                                      xl[u][hi][2] * p4[v].z) * p4[v].w + pb[v];
                  const uint32_t af[4] = {pack_bf16(hv[0][0], hv[0][1]), pack_bf16(hv[1][0], hv[1][1]),
                                          pack_bf16(hv[0][2], hv[0][3]), pack_bf16(hv[1][2], hv[1][3])};
                  mma_bf16(la[u][0], af, bw[0]);
                  mma_bf16(la[u][1], af, bw[1]);
                }
              }
            }
#pragma unroll
            for (int u = 0; u < MG; ++u)
#pragma unroll
              for (int hi = 0; hi < 2; ++hi) {
                const int r = 16 * (pw + 4 * (i0 + u)) + g + 8 * hi;
                float* dst = reinterpret_cast<float*>(stg + (r / K) * L::QPF + (r % K) * 64);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
                  *reinterpret_cast<float2*>(dst + 8 * nt + 2 * t) =
                      make_float2(elu(la[u][nt][2 * hi]) * s2v[nt][0] + b2v[nt][0],
                                  elu(la[u][nt][2 * hi + 1]) * s2v[nt][1] + b2v[nt][1]);
              }
          }
        }
        named_bar_sync(1, 128);  // the chunk's rows are staged

        // --- (X @ in) in float32, rounded into the slot of every CTA.
        ring_wait(empty + slot, ((gc / R) & 1) ^ 1, cl);
        const uint8_t* fin = stg + fb * L::FBUF;
        const uint32_t soff = slot * L::ASLOT + (q >> 3) * 128 + (q & 7) * 16;
        auto mix = [&](auto load) {
#pragma unroll 1
          for (int ci = 0; ci < CG; ++ci) {
            const int grp = gbase + ci;  // channels 4 grp .. 4 grp + 3 of the chunk
            float4 acc[KO];
#pragma unroll
            for (int ko = 0; ko < KO; ++ko) acc[ko] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int j = 0; j < K; ++j) {
              const float4 v = load(j, grp);
              if (a.with_x) {
#pragma unroll
                for (int ko = 0; ko < KO; ++ko) {
                  const float x = xr[ko][j];
                  acc[ko].x += x * v.x;
                  acc[ko].y += x * v.y;
                  acc[ko].z += x * v.z;
                  acc[ko].w += x * v.w;
                }
              } else {
#pragma unroll
                for (int ko = 0; ko < KO; ++ko)
                  if (j == kbase + ko) acc[ko] = v;
              }
            }
#pragma unroll
            for (int ko = 0; ko < KO; ++ko) {
              const uint2 val = make_uint2(pack_bf16(acc[ko].x, acc[ko].y), pack_bf16(acc[ko].z, acc[ko].w));
              const uint32_t off = soff + (kbase + ko) * (kBM * 32) + (grp >> 1) * (kBM * 16) + (grp & 1) * 8;
              if (cl == 1) {
                *reinterpret_cast<uint2*>(sm + L::a + off) = val;
              } else {
                for (int r = 0; r < cl; ++r) st_cluster_v2(mapa(sm + L::a + off, r), val);
              }
            }
          }
        };
        if (li >= 0) {
          mix([&](int j, int grp) {
            return *reinterpret_cast<const float4*>(stg + q * L::QPF + j * 64 + grp * 16);
          });
        } else {
          mix([&](int j, int grp) {
            return widen4(*reinterpret_cast<const uint2*>(fin + q * L::QPB + j * 32 + grp * 8));
          });
        }
        fence_ring_stores(cl);
        named_bar_sync(1, 128);  // the slot is stored everywhere; the staging is free
        if (pt == 0) {
          if (cl == 1) {
            arrive_cta(full + slot);
          } else {
            for (int r = 0; r < cl; ++r) mbar_arrive_cluster(mapa(full + slot, r));
          }
        }
      }
      g_all += nc;
    }
    cp_async_wait<0>();
  } else {
    // --- consumer warpgroups -------------------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int c = tid >> 7;  // 0, 1
    const int ct = tid & 127;
    const int cw = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
    const int ntile = rank * 2 + c;  // this warpgroup's WN output channels
    const int n0 = ntile * WN;
    const uint32_t sa = smem_addr(sm + L::a);
    const uint32_t sb = smem_addr(sm + L::b + c * S * L::BST);
    uint64_t* const bf = bfull + c * S;
    uint64_t* const be = bempty + c * S;
    const __nv_bfloat16* const wt = a.wt + (size_t)ntile * nch * K * (WN * kKC);

    // The loader (thread 0): the (item, chunk position, k) steps of this
    // warpgroup's B tiles, S ahead of the products.
    auto split_begin = [&](int item) { return (item / a.qtiles) * nch / a.splits; };
    auto split_end = [&](int item) { return (item / a.qtiles + 1) * nch / a.splits; };
    int ld_item = cid, ld_p = split_begin(cid), ld_k = 0;
    uint32_t bl = 0;
    auto issue = [&]() {
      if (ld_item >= a.items) return;
      const int st = bl % S;
      wait_or_trap<false>(be + st, ((bl / S) & 1) ^ 1);
      const uint32_t bar = smem_addr(bf + st);
      mbar_expect_tx(bar, L::BST);
      bulk_load(sb + st * L::BST, wt + ((size_t)ld_p * K + ld_k) * (WN * kKC), L::BST, bar);
      ++bl;
      if (++ld_k == K) {
        ld_k = 0;
        if (++ld_p == split_end(ld_item)) {
          ld_item += ncl;
          ld_p = split_begin(ld_item);
        }
      }
    };
    if (ct == 0)
      for (int i = 0; i < S; ++i) issue();

    float acc[WN / 2];
    uint32_t gc = 0, bs = 0;
    int pend_st = -1, pend_slot = -1;  // the step whose product the next wait retires
    auto release = [&]() {
      if (lane == 0) {
        arrive_cta(be + pend_st);
        if (pend_slot >= 0) {
          if (cl == 1) {
            arrive_cta(empty + pend_slot);
          } else {
            mbar_arrive_cluster(mapa(empty + pend_slot, pend_slot % cl));
          }
        }
      }
      if (ct == 0) issue();
    };
#pragma unroll 1
    for (int item = cid; item < a.items; item += ncl) {
      const int q0 = (item % a.qtiles) * kBM;
      const int z = item / a.qtiles;
      const int cb = split_begin(item), ce = split_end(item);
#pragma unroll 1
      for (int p = cb; p < ce; ++p, ++gc) {
        const int slot = gc % R;
        ring_wait(full + slot, (gc / R) & 1, cl);
#pragma unroll 1
        for (int k = 0; k < K; ++k, ++bs) {
          const int st = bs % S;
          wait_or_trap<false>(bf + st, (bs / S) & 1);
          wgmma_fence();
          wgmma_tile<WN>(acc, kmajor_desc(sa + slot * L::ASLOT + k * (kBM * 32), kBM * 16, 128),
                         kmajor_desc(sb + st * L::BST, WN * 16, 128), p > cb || k > 0);
          wgmma_commit();
          bf16conv::wgmma_wait<1>();
          if (pend_st >= 0) release();
          pend_st = st;
          pend_slot = k == K - 1 ? slot : -1;
        }
      }
      bf16conv::wgmma_wait<0>();
      release();
      pend_st = -1;
      fence_regs(acc);

      // Epilogue. Accumulator 4 j + 2 hi + e is query 16 cw + g + 8 hi,
      // channel n0 + 8 j + 2 t + e.
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= a.d) continue;
        float2 scv = make_float2(0.f, 0.f), bcv = scv;
        if (a.splits == 1) {
          scv = __ldg(reinterpret_cast<const float2*>(a.sc + col));
          bcv = __ldg(reinterpret_cast<const float2*>(a.bc + col));
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int qq = q0 + 16 * cw + g + 8 * hi;
          if (qq >= nq) continue;
          const float v0 = acc[4 * j + 2 * hi], v1 = acc[4 * j + 2 * hi + 1];
          if (a.splits == 1) {
            *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)qq * a.d + col) =
                __floats2bfloat162_rn(elu(v0) * scv.x + bcv.x, elu(v1) * scv.y + bcv.y);
          } else {
            *reinterpret_cast<float2*>(a.partial + ((size_t)z * nq + qq) * a.d + col) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while another of its cluster may write to it
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

// The persistent launch: clusters of a.dp / (2 WN) CTAs, as many as the
// card holds at once (the occupancy query, kept per cluster size), at most
// one per item. `static`: its kept values stay private to the library that
// holds them (a template's function-local statics would otherwise be
// unique symbols, shared by every copy of the library a process loads).
template <int K, int WN>
static cudaError_t launch(Args a, cudaStream_t stream) {
  using L = Layout<K, WN>;
  static bool attr_set = false;
  static int max_clusters[L::R + 1] = {};
  auto kernel = xconv_bf16_kernel<K, WN>;
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (a.dp % (2 * WN) != 0 || a.dp > kMaxD || L::R % (a.dp / (2 * WN)) != 0)
    return cudaErrorInvalidValue;
  a.cluster = a.dp / (2 * WN);
  const long long nq = (long long)a.b * a.p;
  a.qtiles = (int)((nq + kBM - 1) / kBM);
  const long long items = (long long)a.qtiles * a.splits;
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  a.items = (int)items;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int& clusters = max_clusters[a.cluster];
  if (clusters == 0) {
    cfg.gridDim = dim3(a.cluster);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3((a.items < clusters ? a.items : clusters) * a.cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The C entry's dispatch: WN 128 where the arranged Wc holds one 256-channel
// CTA tile (D <= 256), else 256.
template <int K>
static cudaError_t run(const Args& a, cudaStream_t stream) {
  return a.dp == 256 ? launch<K, 128>(a, stream) : launch<K, 256>(a, stream);
}

}  // namespace bf16xconv
}  // namespace hfr
