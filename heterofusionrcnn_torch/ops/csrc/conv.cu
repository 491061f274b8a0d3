// Fused 3x3 stride-1 SAME convolution + per-channel affine + ReLU for the
// H100 (sm_90a), NCHW float32.
//
// Replaces heterofusionrcnn_tpu/ops/pallas_conv.py `conv3x3_affine_relu` /
// `_conv_kernel`: out = relu(conv3x3(x, w) * scale + shift), where
// (scale, shift) is the inference BatchNorm folded with the conv bias. The
// VGG blocks of the image branch (13 calls per pyramid pass).
//
// Design: direct convolution, one block per (8 or 16 output rows x 32
// output columns) x (32 or 64 output channels) x image. Input channels go
// in chunks of kCi: the chunk's input tile with its one-pixel halo (zero
// outside the image) and the chunk's weights, pre-transposed by the wrapper
// to (Cin, 3, 3, Cout), are staged in shared memory. Each thread owns 8
// consecutive output columns of one row times 8 output channels (64 FP32
// accumulators): per input channel and kernel row it reads 10 input values
// and, per tap, 8 weights (a broadcast within the warp, whose threads share
// their output channels), then does 192 FMAs. The tile row stride is 35
// floats, so the 32 threads of a warp (8 rows x 4 column groups) hit 32
// different banks. The affine and the ReLU are applied to the accumulators
// before the single store, so the raw conv output never reaches device
// memory.
//
// Bound: operations. 2 * 9 * Cin * Cout FP32 operations per output pixel
// against one read of the input and one write of the output; plain FP32
// FMA, no tensor cores yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 32;   // output columns per block
constexpr int kPX = 8;    // output columns per thread
constexpr int kCG = kTW / kPX;  // column groups per row
constexpr int kCi = 8;    // input channels per chunk
constexpr int kSW = 35;   // shared row stride (>= kTW + 2, odd)

template <int COUT_T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ scale, const float* __restrict__ shift,
               float* __restrict__ out, int cin, int cout, int h, int w,
               int tiles_x, int relu) {
  constexpr int G = COUT_T / 8;        // output-channel groups of 8
  constexpr int PG = kThreads / G;     // pixel groups
  constexpr int TH = PG / kCG;         // output rows per block
  constexpr int SH = TH + 2;
  __shared__ float s_in[kCi * SH * kSW];
  __shared__ __align__(16) float s_w[kCi * 9 * COUT_T];

  const int tid = threadIdx.x;
  const int g = tid / PG;              // one group per warp
  const int pg = tid % PG;
  const int r = pg / kCG;
  const int cg = pg % kCG;
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * COUT_T;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const float* xb = x + (size_t)b * cin * h * w;

  float acc[kPX][8];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[p][c] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += kCi) {
    __syncthreads();
    for (int i = tid; i < kCi * SH * (kTW + 2); i += kThreads) {
      const int ci = i / (SH * (kTW + 2));
      const int rem = i % (SH * (kTW + 2));
      const int yy = rem / (kTW + 2);
      const int xx = rem % (kTW + 2);
      const int gy = y0 - 1 + yy;
      const int gx = x0 - 1 + xx;
      float v = 0.f;
      if (ci0 + ci < cin && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = xb[((size_t)(ci0 + ci) * h + gy) * w + gx];
      s_in[(ci * SH + yy) * kSW + xx] = v;
    }
    for (int i = tid; i < kCi * 9 * COUT_T; i += kThreads) {
      const int co = i % COUT_T;
      const int k = i / COUT_T;        // ci * 9 + tap
      const int ci = k / 9;
      float v = 0.f;
      if (ci0 + ci < cin && co0 + co < cout)
        v = wt[((size_t)(ci0 + ci) * 9 + k % 9) * cout + co0 + co];
      s_w[i] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < kCi; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row = s_in + (ci * SH + r + dy) * kSW + cg * kPX;
        float xv[kPX + 2];
#pragma unroll
        for (int j = 0; j < kPX + 2; ++j) xv[j] = row[j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wp = reinterpret_cast<const float4*>(
              s_w + (ci * 9 + dy * 3 + dx) * COUT_T + g * 8);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kPX; ++p)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[p][c] += xv[p + dx] * wv[c];
        }
      }
    }
  }

  const int y = y0 + r;
  if (y >= h) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int co = co0 + g * 8 + c;
    if (co >= cout) break;
    const float s = scale[co];
    const float t = shift[co];
    float* orow = out + (((size_t)b * cout + co) * h + y) * w;
#pragma unroll
    for (int p = 0; p < kPX; ++p) {
      const int xo = x0 + cg * kPX + p;
      if (xo < w) {
        float v = acc[p][c] * s + t;
        if (relu) v = fmaxf(v, 0.f);
        orow[xo] = v;
      }
    }
  }
}

template <int COUT_T>
cudaError_t launch(const float* x, const float* wt, const float* scale,
                   const float* shift, float* out, int b, int cin, int cout,
                   int h, int w, int relu, cudaStream_t stream) {
  constexpr int TH = (kThreads / (COUT_T / 8)) / kCG;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_y = (h + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, (cout + COUT_T - 1) / COUT_T, b);
  conv3x3_kernel<COUT_T><<<grid, kThreads, 0, stream>>>(
      x, wt, scale, shift, out, cin, cout, h, w, tiles_x, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, Cin, H, W), wt (Cin, 3, 3, Cout), scale/shift (Cout,) float32;
// out (B, Cout, H, W).
int hfr_conv3x3(const float* x, const float* wt, const float* scale,
                const float* shift, float* out, int b, int cin, int cout,
                int h, int w, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cout <= 32) return launch<32>(x, wt, scale, shift, out, b, cin, cout, h, w, relu, s);
  return launch<64>(x, wt, scale, shift, out, b, cin, cout, h, w, relu, s);
}

}  // extern "C"
