// Fused 3x3 stride-1 SAME convolution + per-channel affine + ReLU for the
// H100 (sm_90a), NCHW float32, as an implicit GEMM on the tensor cores.
//
// Replaces heterofusionrcnn_tpu/ops/pallas_conv.py `conv3x3_affine_relu` /
// `_conv_kernel`: out = relu(conv3x3(x, w) * scale + shift), where
// (scale, shift) is the inference BatchNorm folded with the conv bias. The
// VGG blocks of the image branch (13 calls per pyramid pass).
//
// GEMM: M = output pixels, N = Cout, K = 9 Cin. For Cin >= 8 the K order is
// (chunk of 8 input channels, tap, channel in chunk): k-step ks = 9 c + tap
// multiplies 8 channels of one tap. For Cin < 8 (the first layer's 3) it is
// (channel, tap) flattened, 9 Cin values padded to a multiple of 8 (27 -> 32,
// four k-steps), and all channels are staged at once. The wrapper arranges
// the weight as wgmma B tiles in that order (conv_common.cuh).
//
// Numerics: 3xTF32 on `wgmma.mma_async` m64nNk8 with FP32 accumulators
// (conv_common.cuh): three tensor-core products per FP32-grade
// multiply-add. The products of three k-steps (nine wgmmas, one commit
// group) chain in a scratch accumulator from zero and are then added to
// the running sum in FP32, so the tensor cores' truncated sums never touch
// the running sum. Each group ends in a wait for its wgmmas; groups of one
// or two k-steps were slower on the H100.
//
// Design: one block of two warpgroups (256 threads) per (TH output rows x
// 32 output columns) x BN output channels x image. BN = 64 for Cout > 32:
// each warpgroup owns one 64-pixel M tile (2 rows x 32 columns; warp w
// rows 16 w .. 16 w + 15 = half a row) x 64 channels, TH = 4. BN = 32 for
// Cout <= 32 (the 360x1200 and 180x600 layers): each warpgroup owns two
// M tiles, TH = 8, so a commit group carries as many products as at BN =
// 64. Input channels go in chunks of 8 through a two-stage cp.async
// pipeline: while the wgmmas run on chunk c, chunk c + 1's input tile with
// its one-pixel halo (zero outside the image) and its 9 k-steps x 2 parts
// of B tiles are in flight. The input tile stays NCHW (pixels
// contiguous), its plane stride 8 mod 32 words, so a warp's scalar A
// loads hit 32 banks; each thread splits its A values into TF32 parts in
// registers. Epilogue: scale, shift and ReLU on the accumulators, then a
// shared-memory transpose so the block stores whole 32-pixel rows of each
// channel (float4 stores when W % 4 == 0, scalar otherwise); the raw conv
// output never reaches device memory. Shared memory: 88.6 KB at BN = 64,
// 59.9 KB at BN = 32; with at most 128 registers two blocks (4 warpgroups)
// share an SM. The main path's widest call (256 -> 256 channels at
// 4 x 45 x 150) is 12 x 5 tiles x 4 channel blocks x 4 images = 960
// blocks, 3.6 waves of two blocks on each of the 132 SMs.
//
// Bound: operations at every VGG width but the first layer (bytes, 3 input
// channels): 2 * 9 * Cin * Cout operations per output pixel, each one
// three TF32 tensor-core products.
//
// The bf16 form (`hfr_conv3x3_bf16`, the bf16 serving path) is the kernel
// of conv_bf16.cuh: channels-last bf16 activations loaded by TMA, a bf16
// weight, `wgmma` bf16 with float32 sums, a channels-last bf16 output.

#include "conv_bf16.cuh"
#include "conv_common.cuh"

namespace {

using namespace hfr;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTW = 32;        // output columns per block
constexpr int kSW = kTW + 2;   // staged row: columns x0 - 1 .. x0 + 32
constexpr int kEpS = 68;       // epilogue row stride: 64 pixels + 4 (8 t mod 32 banks)
constexpr int kGroup = 3;      // k-steps per wgmma commit group

template <int BN>
struct Tile {
  static constexpr int MT = BN == 32 ? 2 : 1;            // 64-pixel M tiles per warpgroup
  static constexpr int TH = 4 * MT;                      // output rows per block
  static constexpr int PS = plane_stride((TH + 2) * kSW);
  static constexpr int A_FLOATS = 8 * PS;
  static constexpr int B_FLOATS = 9 * 2 * BN * 8;       // 9 k-steps x (big, small) B tiles
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int EPI = 2 * MT * BN * kEpS;
  static constexpr int SMEM = 4 * (2 * STAGE > EPI ? 2 * STAGE : EPI);
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const float* __restrict__ x, const float4* __restrict__ wt,
               const float* __restrict__ scale, const float* __restrict__ shift,
               float* __restrict__ out, int cin, int cout, int h, int w, int tiles_x,
               int ngt, int relu) {
  using T = Tile<BN>;
  constexpr int MT = T::MT;
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = warp >> 2;
  const int wi = warp & 3;
  const int b = blockIdx.z;
  const int ng0 = blockIdx.y * (BN / 8);
  const int y0 = (blockIdx.x / tiles_x) * T::TH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const float* xb = x + (size_t)b * cin * h * w;
  const bool flat = cin < 8;
  const int chunks = flat ? 1 : (cin + 7) / 8;
  const int steps = flat ? (9 * cin + 7) / 8 : 9;  // k-steps per chunk

  // M tile m of warpgroup wg covers output rows 2 (MT wg + m) and + 1; this
  // lane's pixel of it (tap (0, 0)) is row wi / 2, column 16 (wi % 2) + g.
  const int a_base = (2 * MT * wg + (wi >> 1)) * kSW + (wi & 1) * 16 + g;

  float acc[MT][BN / 2];
  float tmp[MT][BN / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;

  auto load_chunk = [&](int c, int stage) {
    float* sa = smem + stage * T::STAGE;
    load_input_tile<kThreads>(sa, xb, cin, 8 * c, h, w, y0 - 1, x0 - 1, T::TH + 2, kSW, T::PS);
    load_weight_stage<kThreads>(reinterpret_cast<float4*>(sa + T::A_FLOATS), wt, c * steps,
                                steps, ngt, ng0, BN / 8);
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
    const float* sa = smem + (c & 1) * T::STAGE;
    const float* sb = sa + T::A_FLOATS;
#pragma unroll 1
    for (int s0 = 0; s0 < steps; s0 += kGroup) {
      uint32_t a_big[kGroup][MT][4], a_small[kGroup][MT][4];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const int s = s0 + q < steps ? s0 + q : s0;
        // Offsets of this lane's channels k = t and k = t + 4 of k-step s.
        int off0, off4;
        if (flat) {
          const int k0 = 8 * s + t, k1 = k0 + 4;
          const int c0 = k0 / 9, t0 = k0 - 9 * c0;
          const int c1 = k1 / 9, t1 = k1 - 9 * c1;
          off0 = c0 * T::PS + (t0 / 3) * kSW + t0 % 3;
          off4 = c1 * T::PS + (t1 / 3) * kSW + t1 % 3 - off0;
        } else {
          off0 = t * T::PS + (s / 3) * kSW + s % 3;
          off4 = 4 * T::PS;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
          load_a(sa + a_base + 2 * m * kSW + off0, off4, a_big[q][m], a_small[q][m]);
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (s0 + q >= steps) break;
        const float* tile = sb + 2 * (s0 + q) * BN * 8;
        wgmma_3xtf32<BN, MT>(tmp, a_big[q], a_small[q], b_desc(tile), b_desc(tile + BN * 8),
                             q > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        fence_regs(tmp[m]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[m][i] += tmp[m][i];
      }
    }
    __syncthreads();
  }

  // Epilogue: affine + ReLU into [M tile][BN channels][64 pixels] in the
  // pipeline's shared memory, now idle, then whole rows out. Block row r
  // is M tile r / 2, its row r % 2.
  const int co0 = ng0 * 8;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float* ep = smem + (wg * MT + m) * BN * kEpS;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * j + 2 * t + e;
        const int co = co0 + cl;
        const float sc = co < cout ? scale[co] : 0.f;
        const float sh = co < cout ? shift[co] : 0.f;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float v = acc[m][4 * j + 2 * hi + e] * sc + sh;
          if (relu) v = fmaxf(v, 0.f);
          ep[cl * kEpS + 16 * wi + g + 8 * hi] = v;
        }
      }
    }
  }
  __syncthreads();
  if (w % 4 == 0) {
    for (int i = threadIdx.x; i < BN * T::TH * 8; i += kThreads) {
      const int cl = i / (T::TH * 8), r = (i / 8) % T::TH, q = i % 8;
      const int co = co0 + cl, y = y0 + r, xo = x0 + 4 * q;
      if (co < cout && y < h && xo < w)
        *reinterpret_cast<float4*>(out + (((size_t)b * cout + co) * h + y) * w + xo) =
            *reinterpret_cast<const float4*>(smem + ((r >> 1) * BN + cl) * kEpS +
                                             32 * (r & 1) + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < BN * T::TH * 32; i += kThreads) {
      const int cl = i / (T::TH * 32), r = (i / 32) % T::TH, col = i % 32;
      const int co = co0 + cl, y = y0 + r, xo = x0 + col;
      if (co < cout && y < h && xo < w)
        out[(((size_t)b * cout + co) * h + y) * w + xo] =
            smem[((r >> 1) * BN + cl) * kEpS + 32 * (r & 1) + col];
    }
  }
}

template <int BN>
cudaError_t launch(const float* x, const float* wt, const float* scale, const float* shift,
                   float* out, int b, int cin, int cout, int h, int w, int relu,
                   cudaStream_t stream) {
  using T = Tile<BN>;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_y = (h + T::TH - 1) / T::TH;
  const int ngt = (cout + kNAlign - 1) / kNAlign * (kNAlign / 8);
  dim3 grid(tiles_x * tiles_y, (cout + BN - 1) / BN, b);
  conv3x3_kernel<BN><<<grid, kThreads, T::SMEM, stream>>>(
      x, reinterpret_cast<const float4*>(wt), scale, shift, out, cin, cout, h, w, tiles_x, ngt,
      relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, Cin, H, W), wt the arranged 3xTF32 weight of `ops/conv.py`
// (`conv_weight_operand`), scale/shift (Cout,) float32; out (B, Cout, H, W).
int hfr_conv3x3(const float* x, const float* wt, const float* scale, const float* shift,
                float* out, int b, int cin, int cout, int h, int w, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cout <= 32) return launch<32>(x, wt, scale, shift, out, b, cin, cout, h, w, relu, s);
  return launch<64>(x, wt, scale, shift, out, b, cin, cout, h, w, relu, s);
}

// The bf16 form (conv_bf16.cuh): x (B, H, W, Cin) bf16 (NHWC in memory, Cin
// a multiple of 8), wt the arranged bf16 weight of `ops/conv.py`
// (`bf16_weight_operand`) for Cout tiles of bn, scale/shift float32; out
// (B, H, W, Cout) bf16; the persistent grid takes at most `sms` blocks.
int hfr_conv3x3_bf16(const void* x, const void* wt, const float* scale, const float* shift,
                     void* out, int b, int cin, int cout, int h, int w, int relu, int bn,
                     int sms, void* stream) {
  return static_cast<int>(hfr::bf16conv::run<false>(x, wt, scale, shift, out, b, cin, cout, h, w,
                                                   relu, bn, sms,
                                                   static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
