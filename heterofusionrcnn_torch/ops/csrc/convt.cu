// Fused 3x3 stride-2 SAME transposed convolution + per-channel affine + ReLU
// for the H100 (sm_90a), NCHW float32, output (2H, 2W), as implicit GEMMs on
// the tensor cores.
//
// Replaces heterofusionrcnn_tpu/ops/pallas_convtranspose.py
// `convtranspose3x3_affine_relu` / `_convt_kernel`: the upconv blocks of the
// VGG pyramid's decoder (3 calls per pyramid pass).
//
// Polyphase form. The weight is the port's ConvTranspose2d weight
// (Cin, Cout, 3, 3), which holds the flax kernel flipped in both spatial
// axes. In that orientation input row i reaches output row 2i + a through
// tap a, so per axis
//   out[2i]     = x[i] * w[0] + x[i - 1] * w[2]
//   out[2i + 1] = x[i] * w[1]
// and each output pixel (2i + ey, 2j + ex) is a sub-convolution at input
// resolution. Per input pixel (i, j) the four phases read the shifted
// inputs x[i][j], x[i][j - 1], x[i - 1][j], x[i - 1][j - 1] through 4, 2, 2
// and 1 taps (tap a * 3 + b: row shift -1 for a = 2, row phase 1 for a = 1,
// the same for columns with b), 9 per input pixel as in the forward conv.
//
// GEMMs: four sub-GEMMs that share the staged A tile, no wasted products.
// M = input pixels, N = Cout per phase, K = Cin per tap; the K order is the
// conv's (chunk of 8 input channels, tap, channel in chunk), the weight
// arranged by the wrapper as wgmma B tiles (conv_common.cuh). Per chunk a
// warpgroup loads the A fragment of one shift once and multiplies it with
// the B tile of each tap that reads that shift, into the accumulators of
// the tap's phase. Numerics: 3xTF32 on `wgmma.mma_async` m64n32k8 with FP32
// accumulators (conv_common.cuh); each tap's three products chain in a
// scratch accumulator from zero and are then added to the phase's running
// sum in FP32. Chaining all taps of a phase into one group instead keeps
// the four shifts' A fragments live and spilled, and was slower.
//
// Design: one block of two warpgroups (256 threads) per (4 input rows x 32
// input columns) x 32 output channels x image; each warpgroup owns one
// 64-pixel M tile (2 input rows x 32 columns; warp w rows 16 w .. 16 w +
// 15 = half a row) x 32 channels x 4 phases: 64 FP32 accumulators a thread.
// Input channels go in chunks of 8 through a two-stage cp.async pipeline
// (input tile with a one-pixel halo on the low side, zero outside the
// image, and 9 k-steps x 2 parts of B tiles). The epilogue applies scale,
// shift and ReLU, goes through shared memory by phase, and writes the four
// phases straight to their interleaved output positions (float4 of two
// pixels x two column phases when W is even, so the block stores whole
// 64-column output rows), with no phase planes. The main path's widest
// call (256 -> 128 channels at 4 x 45 x 150 input) is 12 x 5 tiles x 4
// channel blocks x 4 images = 960 blocks, 3.6 waves of two blocks on each
// of the 132 SMs.
//
// Bound: operations. 2 * 9 * Cin * Cout operations per input pixel (the 9
// useful taps), each one three TF32 tensor-core products.
//
// The bf16 form (`hfr_convt3x3_bf16`, the bf16 serving path) is the kernel
// of conv_bf16.cuh in its polyphase mode: channels-last bf16 activations
// loaded by TMA, a bf16 weight, `wgmma` bf16 with float32 sums, a
// channels-last bf16 output.

#include "conv_bf16.cuh"
#include "conv_common.cuh"

namespace {

using namespace hfr;

constexpr int kThreads = 256;        // two warpgroups
constexpr int kTH = 4;               // input rows per block (two per warpgroup)
constexpr int kTW = 32;              // input columns per block
constexpr int kBN = 32;              // output channels per block (per phase)
constexpr int kSW = kTW + 1;         // staged row: columns j0 - 1 .. j0 + 31
constexpr int kPS = plane_stride((kTH + 1) * kSW);
constexpr int kAFloats = 8 * kPS;
constexpr int kBFloats = 9 * 2 * kBN * 8;  // 9 taps x (big, small) B tiles
constexpr int kStage = kAFloats + kBFloats;
constexpr int kEpS = 68;             // epilogue row stride: 64 pixels + 4 (8 t mod 32 banks)
constexpr int kEpi = 2 * 4 * kBN * kEpS;
constexpr int kSmem = 4 * (2 * kStage > kEpi ? 2 * kStage : kEpi);

__global__ void __launch_bounds__(kThreads, 2)
convt3x3_kernel(const float* __restrict__ x, const float4* __restrict__ wt,
                const float* __restrict__ scale, const float* __restrict__ shift,
                float* __restrict__ out, int cin, int cout, int h, int w, int tiles_x,
                int ngt, int relu) {
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = warp >> 2;
  const int wi = warp & 3;
  const int b = blockIdx.z;
  const int ng0 = blockIdx.y * (kBN / 8);
  const int i0 = (blockIdx.x / tiles_x) * kTH;
  const int j0 = (blockIdx.x % tiles_x) * kTW;
  const float* xb = x + (size_t)b * cin * h * w;
  const int chunks = (cin + 7) / 8;

  // Staged row 0 is input row i0 - 1 and column 0 input column j0 - 1: the
  // unshifted pixel (input row 2 wg + wi / 2, column 16 (wi % 2) + g) of
  // this lane, channel t.
  const int a_base = (2 * wg + (wi >> 1) + 1) * kSW + (wi & 1) * 16 + g + 1 + t * kPS;

  // acc[phase ey * 2 + ex]
  float acc[4][kBN / 2];
  float tmp[1][kBN / 2];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[p][i] = 0.f;

  auto load_chunk = [&](int c, int stage) {
    float* sa = smem + stage * kStage;
    load_input_tile<kThreads>(sa, xb, cin, 8 * c, h, w, i0 - 1, j0 - 1, kTH + 1, kSW, kPS);
    load_weight_stage<kThreads>(reinterpret_cast<float4*>(sa + kAFloats), wt, 9 * c, 9, ngt,
                                ng0, kBN / 8);
    cp_async_commit();
  };

  load_chunk(0, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      load_chunk(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const float* sa = smem + (c & 1) * kStage;
    const float* sb = sa + kAFloats;
#pragma unroll
    for (int sft = 0; sft < 4; ++sft) {
      const int sy = sft >> 1, sx = sft & 1;  // row / column shift -1 when set
      uint32_t a_big[1][4], a_small[1][4];
      load_a(sa + a_base - sy * kSW - sx, 4 * kPS, a_big[0], a_small[0]);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ta = tap / 3, tb = tap % 3;
        if ((ta == 2) != (sy == 1) || (tb == 2) != (sx == 1)) continue;
        const int ph = (ta == 1) * 2 + (tb == 1);
        const float* tile = sb + 2 * tap * kBN * 8;
        wgmma_fence();
        wgmma_3xtf32<kBN, 1>(tmp, a_big, a_small, b_desc(tile), b_desc(tile + kBN * 8), 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(tmp[0]);
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[ph][i] += tmp[0][i];
      }
    }
    __syncthreads();
  }

  // Epilogue: affine + ReLU into [warpgroup][phase][32 channels][64 pixels]
  // in the pipeline's shared memory, then interleaved output rows. Block
  // input row r is warpgroup r / 2, its row r % 2.
  float* ep = smem + wg * 4 * kBN * kEpS;
  const int co0 = ng0 * 8;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = 8 * j + 2 * t + e;
      const int co = co0 + cl;
      const float sc = co < cout ? scale[co] : 0.f;
      const float sh = co < cout ? shift[co] : 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float v = acc[p][4 * j + 2 * hi + e] * sc + sh;
          if (relu) v = fmaxf(v, 0.f);
          ep[(p * kBN + cl) * kEpS + 16 * wi + g + 8 * hi] = v;
        }
    }
  }
  __syncthreads();
  const int w2 = 2 * w;
  if (w % 2 == 0) {
    // float4 = output columns 4q .. 4q + 3 = pixels 2q, 2q + 1 x phases ex.
    for (int k = threadIdx.x; k < kBN * kTH * 2 * 16; k += kThreads) {
      const int cl = k / (kTH * 32), r = (k / 32) % kTH, ey = (k / 16) & 1, q = k & 15;
      const int co = co0 + cl, i = i0 + r;
      if (co < cout && i < h && j0 + 2 * q < w) {
        const float* e = smem + (r >> 1) * 4 * kBN * kEpS + cl * kEpS + 32 * (r & 1) + 2 * q;
        const float2 e0 = *reinterpret_cast<const float2*>(e + 2 * ey * kBN * kEpS);
        const float2 e1 = *reinterpret_cast<const float2*>(e + (2 * ey + 1) * kBN * kEpS);
        *reinterpret_cast<float4*>(out + (((size_t)b * cout + co) * 2 * h + 2 * i + ey) * w2 +
                                   2 * j0 + 4 * q) = make_float4(e0.x, e1.x, e0.y, e1.y);
      }
    }
  } else {
    for (int k = threadIdx.x; k < kBN * kTH * 2 * 64; k += kThreads) {
      const int cl = k / (kTH * 128), r = (k / 128) % kTH, ey = (k / 64) & 1, col = k & 63;
      const int px = col >> 1, ex = col & 1;
      const int co = co0 + cl, i = i0 + r;
      if (co < cout && i < h && j0 + px < w)
        out[(((size_t)b * cout + co) * 2 * h + 2 * i + ey) * w2 + 2 * j0 + col] =
            smem[(r >> 1) * 4 * kBN * kEpS + ((2 * ey + ex) * kBN + cl) * kEpS +
                 32 * (r & 1) + px];
    }
  }
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, Cin, H, W), wt the arranged 3xTF32 weight of `ops/conv.py`
// (`convt_weight_operand`), scale/shift (Cout,) float32; out
// (B, Cout, 2H, 2W).
int hfr_convt3x3(const float* x, const float* wt, const float* scale, const float* shift,
                 float* out, int b, int cin, int cout, int h, int w, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(convt3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_y = (h + kTH - 1) / kTH;
  const int ngt = (cout + kNAlign - 1) / kNAlign * (kNAlign / 8);
  dim3 grid(tiles_x * tiles_y, (cout + kBN - 1) / kBN, b);
  convt3x3_kernel<<<grid, kThreads, kSmem, s>>>(x, reinterpret_cast<const float4*>(wt), scale,
                                                shift, out, cin, cout, h, w, tiles_x, ngt, relu);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form (conv_bf16.cuh): x (B, H, W, Cin) bf16 (NHWC in memory, Cin
// a multiple of 8), wt the arranged bf16 weight of `ops/conv.py`
// (`bf16_weight_operand`) for Cout tiles of bn, scale/shift float32; out
// (B, 2H, 2W, Cout) bf16; the persistent grid takes at most `sms` blocks.
int hfr_convt3x3_bf16(const void* x, const void* wt, const float* scale, const float* shift,
                      void* out, int b, int cin, int cout, int h, int w, int relu, int bn,
                      int sms, void* stream) {
  return static_cast<int>(hfr::bf16conv::run<true>(x, wt, scale, shift, out, b, cin, cout, h, w,
                                                  relu, bn, sms,
                                                  static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
