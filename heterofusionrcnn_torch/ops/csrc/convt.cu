// Fused 3x3 stride-2 SAME transposed convolution + per-channel affine + ReLU
// for the H100 (sm_90a), NCHW float32, output (2H, 2W).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_convtranspose.py
// `convtranspose3x3_affine_relu` / `_convt_kernel`: the upconv blocks of the
// VGG pyramid's decoder (3 calls per pyramid pass).
//
// Polyphase form. The weight is the port's ConvTranspose2d weight
// (Cin, Cout, 3, 3), which holds the flax kernel flipped in both spatial
// axes, pre-transposed by the wrapper to (Cin, 3, 3, Cout). In that
// orientation input row i reaches output row 2i + a through tap a, so per
// axis
//   out[2i]     = x[i] * w[0] + x[i - 1] * w[2]
//   out[2i + 1] = x[i] * w[1]
// and each output pixel (2i + ey, 2j + ex) is a sub-convolution at input
// resolution with 4, 2, 2 or 1 taps (9 per input pixel, as many as the
// forward conv). All four phases are computed together and written straight
// to their interleaved positions: no phase planes and no interleave pass.
//
// Design: one block per (8 input rows x 16 input columns) x 32 output
// channels x image. Input channels go in chunks of kCi: the chunk's input
// tile with a one-pixel halo on the low side (row i - 1, column j - 1; zero
// outside the image) and its weights are staged in shared memory. Each
// thread owns 4 consecutive input columns of one row times 4 output
// channels times 4 phases (64 FP32 accumulators); per input channel it
// reads 2 x 5 input values and 9 float4 weight vectors (a broadcast within
// the warp) for 144 FMAs. Each thread then writes, per output channel and
// output row, 8 consecutive output columns.
//
// Bound: operations. 2 * 9 * Cin * Cout FP32 operations per input pixel;
// plain FP32 FMA, no tensor cores yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoutT = 32;          // output channels per block
constexpr int kG = kCoutT / 4;      // output-channel groups of 4 (one per warp)
constexpr int kTH = 8;              // input rows per block
constexpr int kPX = 4;              // input columns per thread
constexpr int kCG = 4;              // column groups per row
constexpr int kTW = kPX * kCG;      // input columns per block
constexpr int kCi = 16;             // input channels per chunk
constexpr int kSH = kTH + 1;
constexpr int kSW = kTW + 1;

static_assert(kG * kTH * kCG == kThreads, "thread layout");

__global__ void __launch_bounds__(kThreads)
convt3x3_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ scale, const float* __restrict__ shift,
                float* __restrict__ out, int cin, int cout, int h, int w,
                int tiles_x, int relu) {
  __shared__ float s_in[kCi * kSH * kSW];
  __shared__ __align__(16) float s_w[kCi * 9 * kCoutT];

  const int tid = threadIdx.x;
  const int g = tid / 32;
  const int lane = tid % 32;
  const int r = lane / kCG;
  const int cg = lane % kCG;
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kCoutT;
  const int i0 = (blockIdx.x / tiles_x) * kTH;
  const int j0 = (blockIdx.x % tiles_x) * kTW;
  const float* xb = x + (size_t)b * cin * h * w;

  // acc[ey][ex][p][c]
  float acc[2][2][kPX][4];
#pragma unroll
  for (int ey = 0; ey < 2; ++ey)
#pragma unroll
    for (int ex = 0; ex < 2; ++ex)
#pragma unroll
      for (int p = 0; p < kPX; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[ey][ex][p][c] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += kCi) {
    __syncthreads();
    for (int i = tid; i < kCi * kSH * kSW; i += kThreads) {
      const int ci = i / (kSH * kSW);
      const int rem = i % (kSH * kSW);
      const int gy = i0 - 1 + rem / kSW;
      const int gx = j0 - 1 + rem % kSW;
      float v = 0.f;
      if (ci0 + ci < cin && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = xb[((size_t)(ci0 + ci) * h + gy) * w + gx];
      s_in[i] = v;
    }
    for (int i = tid; i < kCi * 9 * kCoutT; i += kThreads) {
      const int co = i % kCoutT;
      const int k = i / kCoutT;        // ci * 9 + tap
      const int ci = k / 9;
      float v = 0.f;
      if (ci0 + ci < cin && co0 + co < cout)
        v = wt[((size_t)(ci0 + ci) * 9 + k % 9) * cout + co0 + co];
      s_w[i] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < kCi; ++ci) {
      // lo: input row i - 1, hi: input row i; column k holds input column
      // j - 1 + k for the thread's first column j.
      const float* lo_row = s_in + (ci * kSH + r) * kSW + cg * kPX;
      const float* hi_row = lo_row + kSW;
      float lo[kPX + 1], hi[kPX + 1];
#pragma unroll
      for (int k = 0; k < kPX + 1; ++k) {
        lo[k] = lo_row[k];
        hi[k] = hi_row[k];
      }
      float wv[9][4];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 q =
            *reinterpret_cast<const float4*>(s_w + (ci * 9 + t) * kCoutT + g * 4);
        wv[t][0] = q.x;
        wv[t][1] = q.y;
        wv[t][2] = q.z;
        wv[t][3] = q.w;
      }
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        const float x11 = hi[p + 1];   // x[i][j]
        const float x10 = hi[p];       // x[i][j - 1]
        const float x01 = lo[p + 1];   // x[i - 1][j]
        const float x00 = lo[p];       // x[i - 1][j - 1]
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // tap index a * 3 + b: row tap a, column tap b
          acc[0][0][p][c] += x11 * wv[0][c] + x10 * wv[2][c] + x01 * wv[6][c] +
                             x00 * wv[8][c];
          acc[0][1][p][c] += x11 * wv[1][c] + x01 * wv[7][c];
          acc[1][0][p][c] += x11 * wv[3][c] + x10 * wv[5][c];
          acc[1][1][p][c] += x11 * wv[4][c];
        }
      }
    }
  }

  const int i = i0 + r;
  if (i >= h) return;
  const int w2 = 2 * w;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int co = co0 + g * 4 + c;
    if (co >= cout) break;
    const float s = scale[co];
    const float t = shift[co];
#pragma unroll
    for (int ey = 0; ey < 2; ++ey) {
      float* orow = out + (((size_t)b * cout + co) * 2 * h + 2 * i + ey) * w2;
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        const int j = j0 + cg * kPX + p;
        if (j < w) {
#pragma unroll
          for (int ex = 0; ex < 2; ++ex) {
            float v = acc[ey][ex][p][c] * s + t;
            if (relu) v = fmaxf(v, 0.f);
            orow[2 * j + ex] = v;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, Cin, H, W), wt (Cin, 3, 3, Cout), scale/shift (Cout,) float32;
// out (B, Cout, 2H, 2W).
int hfr_convt3x3(const float* x, const float* wt, const float* scale,
                 const float* shift, float* out, int b, int cin, int cout,
                 int h, int w, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_y = (h + kTH - 1) / kTH;
  dim3 grid(tiles_x * tiles_y, (cout + kCoutT - 1) / kCoutT, b);
  convt3x3_kernel<<<grid, kThreads, 0, s>>>(x, wt, scale, shift, out, cin,
                                            cout, h, w, tiles_x, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
