// The bf16 forms of the fused 3x3 conv (conv.cu) and stride-2 transposed
// conv (convt.cu) for the H100 (sm_90a): NCHW bf16 activations, a bf16
// weight, float32 sums, float32 scale and shift, ReLU, a bf16 output.
//
// Replaces the `compute_dtype=jnp.bfloat16` form of
// heterofusionrcnn_tpu/ops/pallas_conv.py `conv3x3_affine_relu` and
// heterofusionrcnn_tpu/ops/pallas_convtranspose.py
// `convtranspose3x3_affine_relu`: the padded input and the (9 Cin, Cout)
// weight in bf16 (pallas_conv.py:186-187), products accumulated in
// float32 (`preferred_element_type=f32`), then * scale + shift in float32,
// ReLU, and one rounding to bf16.
//
// GEMM: M = pixels (output pixels of the conv, input pixels of the
// transposed conv), N = Cout, K = 9 Cin in chunks of 16 input channels,
// one k16 step per tap. The transposed conv is the polyphase form of
// convt.cu: per input pixel (i, j), tap (a, b) of the port's orientation
// reads x[i - (a == 2)][j - (b == 2)] into output phase (a == 1, b == 1),
// i.e. output pixel (2 i + (a == 1), 2 j + (b == 1)); the four phases keep
// four accumulator sets.
//
// Products: `mma.sync.m16n8k16` bf16 with float32 accumulators (a product
// of two bf16 values is exact in float32). The weight comes arranged by
// the wrapper (`ops/conv.py`, `bf16_weight_operand`) as [chunk][tap][Cout
// padded to 64][16 channels] bf16, so a block copies each (chunk, tap)
// slice of its channels as one run.
//
// Design: one block of 8 warps per (4 rows x 32 columns of pixels) x BN
// output channels x image. Warp w owns row w % 4 of the tile (two m16
// tiles of 16 columns) and BN / 2 channels (BN / 16 n8 tiles). Per chunk
// the block stages the input tile with its one-pixel halo (both sides for
// the conv, the low side for the transposed conv) as [pixel][16 channels]
// bf16, each pixel padded to 24 values (48 bytes: the 8 x 4 lanes of a
// fragment load hit 32 banks), and the chunk's 9 x BN x 16 weights the
// same way. Two stages: the weights of chunk c + 1 come by cp.async and its
// input through registers while the tensor cores work on chunk c (the
// input is transposed from NCHW on the way, which cp.async cannot do).
// The epilogue writes each accumulator pair straight to the output.
//
// Bound: operations at every VGG width but the first layer (bytes):
// 2 * 9 * Cin * Cout operations per output pixel (per input pixel of the
// transposed conv), at the bf16 tensor-core rate. The first layer's 3
// input channels fill one chunk of 16, so its products are 16 / 3 of the
// useful ones.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace hfr {
namespace bf16conv {

constexpr int kThreads = 256;  // 8 warps: 4 rows x 2 channel halves
constexpr int kTH = 4;         // pixel rows per block
constexpr int kTW = 32;        // pixel columns per block
constexpr int kKC = 16;        // input channels per chunk
constexpr int kPix = 24;       // bf16 values per staged pixel or weight row (16 + 8 pad)
constexpr int kNAlignBf = 64;  // output channels of the arranged weight padded to this

// d += a b: m16n8k16, A row-major (16 x 16 bf16), B column-major (16 x 8).
// For lane l, g = l / 4 and t = l % 4: a0 (row g, k 2t, 2t + 1), a1 (g + 8,
// 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8); b0 (k 2t, 2t + 1; column g),
// b1 (k 2t + 8); d0 (row g, column 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
// d3 (g + 8, 2t + 1). The lower k of each pair sits in the low 16 bits.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Staged tile geometry: the conv stages rows y0 - 1 .. y0 + kTH and columns
// x0 - 1 .. x0 + kTW; the transposed conv rows y0 - 1 .. y0 + kTH - 1 and
// columns x0 - 1 .. x0 + kTW - 1.
template <bool kTrans>
struct Geo {
  static constexpr int SH = kTrans ? kTH + 1 : kTH + 2;
  static constexpr int SW = kTrans ? kTW + 1 : kTW + 2;
  static constexpr int PIX = SH * SW;
  static constexpr int A_ELEMS = kKC * PIX;                  // staged input values
  static constexpr int A_PER = (A_ELEMS + kThreads - 1) / kThreads;  // per thread
  static constexpr int A_SIZE = PIX * kPix;                  // bf16 per input stage
};

template <bool kTrans, int BN>
struct Smem {
  static constexpr int B_SIZE = 9 * BN * kPix;  // bf16 per weight stage
  static constexpr int STAGE = Geo<kTrans>::A_SIZE + B_SIZE;
  static constexpr int BYTES = 2 * STAGE * 2;
};

template <bool kTrans, int BN>
__global__ void __launch_bounds__(kThreads)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                 const float* __restrict__ scale, const float* __restrict__ shift,
                 __nv_bfloat16* __restrict__ out, int cin, int cout, int h, int w,
                 int tiles_x, int coutp, int relu) {
  using G = Geo<kTrans>;
  using S = Smem<kTrans, BN>;
  constexpr int PH = kTrans ? 4 : 1;  // output phases
  constexpr int NT = BN / 16;         // n8 tiles per warp
  extern __shared__ __align__(16) __nv_bfloat16 sm_bf[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp & 3;           // tile row of this warp
  const int wn = (warp >> 2) * (BN / 2);  // first channel of this warp in the block
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * BN;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const __nv_bfloat16* xb = x + (size_t)b * cin * h * w;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
  const int chunks = (cin + kKC - 1) / kKC;

  float acc[PH][2][NT][4];
#pragma unroll
  for (int p = 0; p < PH; ++p)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][m][n][i] = 0.f;

  // Input values of chunk c for this thread, zero outside the image and
  // for channels >= cin: element e = ch * PIX + pixel.
  unsigned short pre[G::A_PER];
  auto fetch_a = [&](int c) {
#pragma unroll
    for (int j = 0; j < G::A_PER; ++j) {
      const int e = threadIdx.x + j * kThreads;
      unsigned short v = 0;
      if (e < G::A_ELEMS) {
        const int ch = e / G::PIX;
        const int pix = e - ch * G::PIX;
        const int r = pix / G::SW;
        const int col = pix - r * G::SW;
        const int ci = c * kKC + ch;
        const int gy = y0 - 1 + r;
        const int gx = x0 - 1 + col;
        if (ci < cin && gy >= 0 && gy < h && gx >= 0 && gx < w)
          v = __ldg(xs + ((size_t)ci * h + gy) * w + gx);
      }
      pre[j] = v;
    }
  };
  auto store_a = [&](int stage) {
    unsigned short* sa = reinterpret_cast<unsigned short*>(sm_bf + stage * S::STAGE);
#pragma unroll
    for (int j = 0; j < G::A_PER; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < G::A_ELEMS) {
        const int ch = e / G::PIX;
        const int pix = e - ch * G::PIX;
        sa[pix * kPix + ch] = pre[j];
      }
    }
  };
  // The chunk's weights of this block's channels: 9 taps x BN rows of 16
  // values (32 bytes, two cp.async each).
  auto load_b = [&](int c, int stage) {
    __nv_bfloat16* sb = sm_bf + stage * S::STAGE + G::A_SIZE;
    for (int i = threadIdx.x; i < 9 * BN * 2; i += kThreads) {
      const int row = i >> 1, half = i & 1;  // row = tap * BN + n
      const int tap = row / BN, n = row - tap * BN;
      cp_async16(sb + row * kPix + 8 * half,
                 wt + (((size_t)c * 9 + tap) * coutp + co0 + n) * kKC + 8 * half);
    }
    cp_async_commit();
  };

  load_b(0, 0);
  fetch_a(0);
  store_a(0);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c staged; every warp is done with chunk c - 1
    if (c + 1 < chunks) {
      load_b(c + 1, (c + 1) & 1);
      fetch_a(c + 1);
    }
    const __nv_bfloat16* sa = sm_bf + (c & 1) * S::STAGE;
    const __nv_bfloat16* sb = sa + G::A_SIZE;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ta = tap / 3, tb = tap % 3;
      // Staged row and column of this warp's pixel (row wr, column 0).
      const int sr = kTrans ? wr + 1 - (ta == 2) : wr + ta;
      const int sc = kTrans ? 1 - (tb == 2) : tb;
      const int ph = kTrans ? 2 * (ta == 1) + (tb == 1) : 0;
      uint32_t bf[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* bp = sb + (tap * BN + wn + 8 * n + g) * kPix + 2 * t;
        bf[n][0] = lds32(bp);
        bf[n][1] = lds32(bp + 8);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const __nv_bfloat16* ap = sa + (sr * G::SW + sc + 16 * m + g) * kPix + 2 * t;
        uint32_t af[4];
        af[0] = lds32(ap);
        af[1] = lds32(ap + 8 * kPix);
        af[2] = lds32(ap + 8);
        af[3] = lds32(ap + 8 * kPix + 8);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(acc[ph][m][n], af, bf[n]);
      }
    }
    if (c + 1 < chunks) store_a((c + 1) & 1);
  }

  // Epilogue: scale, shift, ReLU, one rounding; accumulator i of (m, n) is
  // pixel column 16 m + g + 8 (i / 2), channel wn + 8 n + 2 t + i % 2.
  const int y = y0 + wr;
  if (y >= h) return;
  const int ho = kTrans ? 2 * h : h, wo = kTrans ? 2 * w : w;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + wn + 8 * n + 2 * t + e;
      if (co >= cout) continue;
      const float sc = scale[co], sh = shift[co];
      __nv_bfloat16* oc = out + ((size_t)b * cout + co) * ho * wo;
#pragma unroll
      for (int p = 0; p < PH; ++p) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int xi = x0 + 16 * m + g + 8 * hi;
            if (xi >= w) continue;
            float v = acc[p][m][n][2 * hi + e] * sc + sh;
            if (relu) v = fmaxf(v, 0.f);
            const int oy = kTrans ? 2 * y + (p >> 1) : y;
            const int ox = kTrans ? 2 * xi + (p & 1) : xi;
            oc[(size_t)oy * wo + ox] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

template <bool kTrans, int BN>
cudaError_t launch(const void* x, const void* wt, const float* scale, const float* shift,
                   void* out, int b, int cin, int cout, int h, int w, int relu,
                   cudaStream_t stream) {
  using S = Smem<kTrans, BN>;
  cudaError_t err = cudaFuncSetAttribute(conv_bf16_kernel<kTrans, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_y = (h + kTH - 1) / kTH;
  const int coutp = (cout + kNAlignBf - 1) / kNAlignBf * kNAlignBf;
  dim3 grid(tiles_x * tiles_y, (cout + BN - 1) / BN, b);
  conv_bf16_kernel<kTrans, BN><<<grid, kThreads, S::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt), scale, shift,
      static_cast<__nv_bfloat16*>(out), cin, cout, h, w, tiles_x, coutp, relu);
  return cudaGetLastError();
}

}  // namespace bf16conv
}  // namespace hfr
