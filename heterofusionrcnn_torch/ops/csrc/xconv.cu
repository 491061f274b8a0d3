// Fused inference XConv for the H100 (sm_90a).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_xconv.py: `fused_xconv` /
// `_xconv_kernel`. For each query point q with neighbours idx[q, :K]:
//   local[j]  = pts[idx[j]] - qrs[q]                         (K, 3)
//   f2[j]     = BN2(ELU(BN1(ELU(local[j] @ W1)) @ W2))        (K, Cf) lifts
//   X         = BNx2(dw2(BNx1(ELU(dw1(BNx0(ELU(vec(local) @ Wx0)))))))
//   in[j]     = [f2[j] | fts[idx[j]]]                         (K, Cin)
//   out[q]    = BNc(ELU(sum_k sum_c (X @ in)[k, c] * Wc[k, c, :]))
// with inference BatchNorm folded to per-channel (scale, shift) pairs and
// Wc the depthwise x pointwise composition of the separable conv (folded on
// the host, as the TPU wrapper does).
//
// Design: one block per (tile of 64 queries, tile of 256 output channels),
// 256 threads. The block gathers its neighbour rows and local
// coordinates and builds X in shared memory. It then walks the Cin input
// channels in chunks of 16:
// - a chunk of f2: each thread owns K/4 neighbour rows and all 16 channels,
//   recomputes lift-1 in registers from the row's local coordinates and
//   accumulates lift-2 against W2[:, chunk], which is staged in shared memory
//   (no barrier inside the Cf loop);
// - a chunk of neighbour features: indexed cp.async copies into shared
//   memory (at every N: a gather is an indexed load on this card), issued
//   while the previous chunk's last product stages run.
// Each chunk then feeds two sub-chunks of 8 channels to a shared-memory
// tiled FP32 product: (X @ in) for the K x 8 contraction rows goes to
// shared memory, the matching rows of Wc stream in through a
// double-buffered cp.async pipeline (16 rows per stage), and each thread
// accumulates an 8 x 8 register tile. Nothing of the
// (B, P, K, Cin) intermediates reaches device memory; the only output is
// (B, P, D). No tensor cores yet.
//
// Bound: operations. 2*P*K*Cin*D FLOPs for the separable conv dominate;
// lift-2 (2*P*K*Cf*Cf) is recomputed for every output-channel tile; the
// bytes are the inputs, the weights once and the (P, D) output.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;             // queries per block
constexpr int kBN = 256;            // output channels per block
constexpr int kCC = 16;             // input channels per chunk
constexpr int kSC = 8;              // input channels per sub-chunk of the product
constexpr int kStage = 16;          // contraction rows per Wc pipeline stage
constexpr int kInStride = kCC + 1;  // padded rows (bank spread)
constexpr int kAStride = kBM + 4;   // padded, float4-aligned
constexpr int kLiftParams = 8;      // per lift channel: w1 x, y, z, s1, b1, pad

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
  const float* wc;    // (K, Cin, D)
  const float* sc;    // (D)
  const float* bc;
  float* out;         // (B, P, D)
  int b, n, p, cf, cp, d, with_x;
};

// exp(x) - 1 for x <= 0, as the TPU kernel computes it (pallas_xconv.py
// `_elu`); within 1e-6 of expm1 at these magnitudes.
__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : __expf(x) - 1.f;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int K>
struct Smem {
  static constexpr int kRows = kBM * K;
  static constexpr int w = 2 * kStage * kBN;
  static constexpr int a = K * kSC * kAStride;
  static constexpr int in = kRows * kInStride;
  static constexpr int x = kBM * K * K;
  static constexpr int floats = w + a + in + x + kRows * 3 + kRows;
  static_assert(kBM * K * K <= w + a, "X-net temporaries must fit");
  // A lifted chunk stages W2[:, chunk] and the lift-1 parameters over the
  // product's buffers (s_w, s_a), which are idle while it is lifted.
  static constexpr int max_cf = (w + a) / (kCC + kLiftParams);
};

template <int K>
__global__ void __launch_bounds__(kThreads, K <= 8 ? 2 : 1) xconv_kernel(XconvArgs a) {
  using S = Smem<K>;
  constexpr int kTN = kBN / 32;           // output channels per thread
  constexpr int kRows = S::kRows;
  constexpr int kKK = K * K;
  constexpr int kKR = K * kSC;            // contraction rows per sub-chunk
  constexpr int kStages = kKR / kStage;   // K / 2
  constexpr int kRPT = kRows / kThreads;  // lifted rows per thread (K / 4)
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                      // 2 x kStage x kBN  Wc pipeline
  float* s_a = s_w + S::w;                // kKR x kAStride    (X @ in), query-minor
  float* s_in = s_a + S::a;               // kRows x kInStride chunk inputs
  float* s_x = s_in + S::in;              // kBM x K x K       X
  float* s_loc = s_x + S::x;              // kRows x 3         local coords
  int* s_row = reinterpret_cast<int*>(s_loc + kRows * 3);  // b * N + idx
  float* s_w2 = s_w;                      // Cf x kCC          W2[:, chunk] (lifted chunks)
  float* s_lp = s_w + a.cf * kCC;         // Cf x kLiftParams  lift-1 parameters

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBN;
  const int nq = a.b * a.p;
  const int cin = a.cf + a.cp;
  // Product tile: 8 queries x kTN channels; a warp covers 2 query groups
  // x 16 channel groups.
  const int qg = (warp >> 1) * 2 + (lane >> 4);  // 0..7
  const int dg = (warp & 1) * 16 + (lane & 15);  // 0..31

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
  __syncthreads();

  if (a.with_x) {
    float* x0 = s_in;  // kBM x K*K temporaries
    float* x1 = s_w;   // spans s_w and s_a
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int t = e / kKK, m = e % kKK;
      float acc = 0.f;
      for (int i = 0; i < 3 * K; ++i) acc += s_loc[t * 3 * K + i] * __ldg(a.wx0 + i * kKK + m);
      x0[e] = elu(acc) * a.sx0[m] + a.bx0[m];
    }
    __syncthreads();
    // Depthwise over the neighbour axis: out[c*K + j] = sum_k in[k*K + c] * w[k, c, j].
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int t = e / kKK, m = e % kKK, c = m / K, j = m % K;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += x0[t * kKK + k * K + c] * __ldg(a.wx1 + (k * K + c) * K + j);
      x1[e] = elu(acc) * a.sx1[m] + a.bx1[m];
    }
    __syncthreads();
    for (int e = tid; e < kBM * kKK; e += kThreads) {
      const int t = e / kKK, m = e % kKK, c = m / K, j = m % K;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += x1[t * kKK + k * K + c] * __ldg(a.wx2 + (k * K + c) * K + j);
      s_x[e] = acc * a.sx2[m] + a.bx2[m];
    }
  }

  // Local coordinates of this thread's lifted rows tid + i * kThreads.
  float lx[kRPT], ly[kRPT], lz[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = tid + i * kThreads;
    lx[i] = s_loc[r * 3 + 0];
    ly[i] = s_loc[r * 3 + 1];
    lz[i] = s_loc[r * 3 + 2];
  }

  // Copies chunk c0 of the neighbour features into s_in; complete at the
  // next cp_async_wait_all.
  auto gather = [&](int c0) {
    const int ccn = min(kCC, a.cp - c0);
    for (int e = tid; e < kRows * kCC; e += kThreads) {
      const int r = e / kCC, c = e % kCC;
      float* dst = s_in + r * kInStride + c;
      if (c < ccn) {
        cp_async4(dst, a.fts + (size_t)s_row[r] * a.cp + c0 + c);
      } else {
        *dst = 0.f;
      }
    }
    cp_async_commit();
  };

  float acc[8][kTN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int nf = (a.cf + kCC - 1) / kCC;
  const int nchunks = nf + (a.cp + kCC - 1) / kCC;
  for (int ch = 0; ch < nchunks; ++ch) {
    const bool lifted = ch < nf;
    const int c0 = (lifted ? ch : ch - nf) * kCC;
    const int ccn = min(kCC, (lifted ? a.cf : a.cp) - c0);
    const int cbase = lifted ? 0 : a.cf;
    __syncthreads();  // every buffer free
    if (lifted) {
      for (int e = tid; e < a.cf * kCC; e += kThreads) {
        const int h = e / kCC, c = e % kCC;
        s_w2[e] = c < ccn ? __ldg(a.w2 + (size_t)h * a.cf + c0 + c) : 0.f;
      }
      for (int h = tid; h < a.cf; h += kThreads) {
        float* lp = s_lp + h * kLiftParams;
        lp[0] = __ldg(a.w1 + h);
        lp[1] = __ldg(a.w1 + a.cf + h);
        lp[2] = __ldg(a.w1 + 2 * a.cf + h);
        lp[3] = __ldg(a.s1 + h);
        lp[4] = __ldg(a.b1 + h);
      }
      __syncthreads();
      float g[kRPT][kCC];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int c = 0; c < kCC; ++c) g[i][c] = 0.f;
#pragma unroll 2
      for (int h = 0; h < a.cf; ++h) {
        const float4 p = *reinterpret_cast<const float4*>(s_lp + h * kLiftParams);
        const float t1 = s_lp[h * kLiftParams + 4];
        float wr[kCC];
#pragma unroll
        for (int c = 0; c < kCC; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(s_w2 + h * kCC + c);
          wr[c] = v.x;
          wr[c + 1] = v.y;
          wr[c + 2] = v.z;
          wr[c + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const float hv = elu(lx[i] * p.x + ly[i] * p.y + lz[i] * p.z) * p.w + t1;
#pragma unroll
          for (int c = 0; c < kCC; ++c) g[i][c] += hv * wr[c];
        }
      }
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int c = 0; c < kCC; ++c)
          s_in[(tid + i * kThreads) * kInStride + c] =
              c < ccn ? elu(g[i][c]) * __ldg(a.s2 + c0 + c) + __ldg(a.b2 + c0 + c) : 0.f;
    }  // a gathered chunk's s_in was filled during the previous chunk

    for (int sub = 0; sub * kSC < ccn; ++sub) {
      const bool gather_next = (sub + 1) * kSC >= ccn && ch + 1 >= nf && ch + 1 < nchunks;
      __syncthreads();  // s_in complete; the previous product is done with s_a, s_w
      // (X @ in)[q, k, c] -> s_a[(k*kSC + c) * kAStride + q]
      for (int e = tid; e < kBM * kKR; e += kThreads) {
        const int c = e % kSC, q = (e / kSC) % kBM, k = e / (kSC * kBM);
        const float* in = s_in + q * K * kInStride + sub * kSC + c;
        float s = 0.f;
        if (a.with_x) {
#pragma unroll
          for (int j = 0; j < K; ++j) s += s_x[q * kKK + k * K + j] * in[j * kInStride];
        } else {
          s = in[k * kInStride];
        }
        s_a[(k * kSC + c) * kAStride + q] = s;
      }
      // Wc rows of a stage: contraction row r -> (k, c) = (r / kSC, r % kSC).
      auto load_stage = [&](int st, int buf) {
        float* dst = s_w + buf * kStage * kBN;
        for (int e = tid; e < kStage * (kBN / 4); e += kThreads) {
          const int r = e / (kBN / 4), col = (e % (kBN / 4)) * 4;
          const int kr = st * kStage + r;
          const int k = kr / kSC, c = sub * kSC + kr % kSC;
          if (c < ccn && d0 + col < a.d) {
            cp_async16(dst + r * kBN + col,
                       a.wc + ((size_t)k * cin + cbase + c0 + c) * a.d + d0 + col);
          } else {
            *reinterpret_cast<float4*>(dst + r * kBN + col) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        cp_async_commit();
      };
      load_stage(0, 0);
      for (int st = 0; st < kStages; ++st) {
        cp_async_wait_all();
        __syncthreads();  // stage st (and s_a) visible; stage st-1 consumed
        if (st + 1 < kStages) load_stage(st + 1, (st + 1) & 1);
        // Every thread is past this sub-chunk's X @ in: s_in is free.
        if (st == 0 && gather_next) gather((ch + 1 - nf) * kCC);
        const float* wbuf = s_w + (st & 1) * kStage * kBN;
#pragma unroll 4
        for (int r = 0; r < kStage; ++r) {
          const float* ar = s_a + (st * kStage + r) * kAStride + qg * 8;
          const float4 a0 = *reinterpret_cast<const float4*>(ar);
          const float4 a1 = *reinterpret_cast<const float4*>(ar + 4);
          const float ai[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          float wj[kTN];
#pragma unroll
          for (int j = 0; j < kTN; j += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(wbuf + r * kBN + dg * kTN + j);
            wj[j] = wv.x;
            wj[j + 1] = wv.y;
            wj[j + 2] = wv.z;
            wj[j + 3] = wv.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] += ai[i] * wj[j];
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kTN; j += 4) {
    const int dcol = d0 + dg * kTN + j;
    if (dcol >= a.d) continue;
    const float4 sc = *reinterpret_cast<const float4*>(a.sc + dcol);
    const float4 bc = *reinterpret_cast<const float4*>(a.bc + dcol);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + qg * 8 + i;
      if (q >= nq) continue;
      const float4 o = make_float4(
          elu(acc[i][j]) * sc.x + bc.x, elu(acc[i][j + 1]) * sc.y + bc.y,
          elu(acc[i][j + 2]) * sc.z + bc.z, elu(acc[i][j + 3]) * sc.w + bc.w);
      *reinterpret_cast<float4*>(a.out + (size_t)q * a.d + dcol) = o;
    }
  }
}

template <int K>
cudaError_t launch(const XconvArgs& a, cudaStream_t stream) {
  if (a.cf > Smem<K>::max_cf) return cudaErrorInvalidValue;
  const int bytes = Smem<K>::floats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      xconv_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nq = a.b * a.p;
  dim3 grid((nq + kBM - 1) / kBM, (a.d + kBN - 1) / kBN);
  xconv_kernel<K><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K in {4, 8, 12}; D a multiple of 4; Cf at most Smem<K>::max_cf (432 at
// K = 4); every pointer 16-byte aligned.
int hfr_xconv(const float* pts, const float* fts, const float* qrs,
              const int* idx, const float* w1, const float* s1,
              const float* b1, const float* w2, const float* s2,
              const float* b2, const float* wx0, const float* sx0,
              const float* bx0, const float* wx1, const float* sx1,
              const float* bx1, const float* wx2, const float* sx2,
              const float* bx2, const float* wc, const float* sc,
              const float* bc, float* out, int b, int n, int p, int k, int cf,
              int cp, int d, int with_x, void* stream) {
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  XconvArgs a{pts, fts, qrs, idx, w1, s1, b1, w2, s2, b2, wx0, sx0,
              bx0, wx1, sx1, bx1, wx2, sx2, bx2, wc, sc, bc, out,
              b, n, p, cf, cp, d, with_x};
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

}  // extern "C"
