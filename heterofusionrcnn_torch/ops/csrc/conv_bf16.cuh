// The bf16 forms of the fused 3x3 conv (conv.cu) and stride-2 transposed
// conv (convt.cu) for the H100 (sm_90a): channels-last (NHWC in memory)
// bf16 activations, a bf16 weight, float32 sums, float32 scale and shift,
// ReLU, a channels-last bf16 output.
//
// Replaces the `compute_dtype=jnp.bfloat16` form of
// heterofusionrcnn_tpu/ops/pallas_conv.py `conv3x3_affine_relu` and
// heterofusionrcnn_tpu/ops/pallas_convtranspose.py
// `convtranspose3x3_affine_relu`: NHWC input and the (9 Cin, Cout) weight
// in bf16 (pallas_conv.py:186-187), products accumulated in float32
// (`preferred_element_type=f32`), then * scale + shift in float32, ReLU,
// and one rounding to bf16. The layout is the Pallas kernel's own: the
// channels (the contraction) contiguous in each pixel.
//
// GEMM: M = pixels (output pixels of the conv, input pixels of the
// transposed conv), N = Cout, K = 9 Cin in chunks of kKC = 16 input
// channels, one k16 step per tap. The transposed conv is the polyphase form
// of convt.cu: per input pixel (i, j), tap (a, b) of the port's orientation
// reads x[i - (a == 2)][j - (b == 2)] into output phase (a == 1, b == 1),
// i.e. output pixel (2 i + (a == 1), 2 j + (b == 1)); the four phases keep
// four accumulator sets and no product is wasted.
//
// Loads: TMA. One 4-D tensor map per call over the NHWC input, dims
// (C, W, H, B), C a multiple of 8 (the wrapper pads the first layer's 3
// channels to 8, `ops/conv.py`, `channels_last8`), box (8 channels, SW
// columns, SH rows, 1 image). A tile's input with its one-pixel halo (both
// sides for the conv, the low side for the transposed conv) is one box per
// group of 8 channels, landing as [channel group][staged row][staged
// column][8 channels]: a pixel is 16 bytes. Boxes that reach outside the
// image or past C come back zero-filled by the hardware: that is the SAME
// padding, with no bounds tests. The weight comes arranged by the wrapper
// (`bf16_weight_operand`, once per weight version) as [Cout tile][chunk]
// [tap][channel group][output channel][8 channels], so a stage's B is one
// contiguous bulk copy.
//
// Products: `wgmma.mma_async` m64nBNk16 bf16, A and B from shared memory,
// K-major, no swizzle, float32 accumulators in registers. A core matrix is
// 8 pixels (or 8 output channels) x 8 channels, 128 contiguous bytes; the
// stride byte offset between 8-row groups is 128 and the leading byte
// offset (the other 8 channels of the k16 step) is the channel group's
// plane (B: BN x 16 bytes). A wgmma's 64 rows are 64 consecutive pixels of
// one staged row, and a tap's shift moves its start by whole 16-byte
// pixels, so every tap reads the same staged tile.
//
// Design: warp-specialised and persistent. 384 threads: two consumer
// warpgroups and a producer warpgroup of which one thread issues every
// copy (setmaxnreg hands the producer's registers to the consumers). Each
// block walks the tiles blockIdx.x, + gridDim.x, ... (grid = min(tiles,
// SMs)); a tile is TH rows x 64 columns of pixels x BN output channels of
// one image, the BN tiles of one pixel tile adjacent in the order so that
// their input is read from L2. The producer runs over the (tile, chunk)
// stages into a ring of STAGES slots (mbarriers full / empty per slot), so
// the next tile's loads overlap this tile's epilogue. Consumer warpgroup g
// owns MT = TH / 2 rows of the tile: MT m64 tiles (conv) or MT m64 tiles x
// 4 phases (transposed conv; each tap feeds one phase); per stage 9 MT
// wgmmas in one commit group, the slot released when the next group has
// been issued and this one waited for. Epilogue: scale, shift and ReLU in
// float32 on the accumulators, one rounding, bf16 pairs into the
// warpgroup's own shared-memory buffer as NHWC pixels (the transposed
// conv's four phases interleaved there into whole 128-pixel output rows),
// then 16-byte stores of each pixel's BN channels (scalar stores when
// Cout % 8 != 0). Any failure (a refused encode or launch, a shape the
// kernel does not take) is returned to the op, which raises.
//
// Bound: bytes at the full-resolution widths (Cout 32), operations at the
// rest: 2 * 9 * Cin * Cout operations per output pixel (per input pixel of
// the transposed conv) at the bf16 tensor-core rate, against the input,
// weight and output read or written once.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace hfr {
namespace bf16conv {

// --- mma.sync helpers (the bf16 XConv's lift-2, xconv_bf16.cuh) --------------

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

// --- wgmma bf16, TMA, bulk copies -------------------------------------------

// d (64 x 32) = A (64 x 16, desc a) B (16 x 32, desc b) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = A (64 x 16, desc a) B (16 x 64, desc b) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) = A (64 x 16, desc a) B (16 x 128, desc b) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, K-major, no swizzle: start address,
// leading byte offset (between the two 8-channel halves of a k16 step) and
// stride byte offset (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// mbar_wait that faults the launch (a trap, reported by the next
// synchronisation) after about 2^32 cycles, seconds, instead of hanging the
// card should a stage never arrive.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, int parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) start = now;
    if (now - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A box of the tensor map at coordinates (c0, c1, c2, c3), completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --- the kernel -------------------------------------------------------------

constexpr int kKC = 16;           // input channels per stage (one k16 step per tap)
constexpr int kTW = 64;           // pixel columns per tile: one wgmma M tile
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // + the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 = 384 x 168, the launch's registers
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may use

// Tile geometry and shared memory of one (kTrans, BN) form. Accumulators:
// PH x MT x BN / 2 floats a thread, 128 at most.
template <bool kTrans, int BN>
struct Cfg {
  static_assert(BN == 32 || BN == 64 || (BN == 128 && !kTrans), "tile width");
  static constexpr int PH = kTrans ? 4 : 1;                    // output phases
  static constexpr int MT = kTrans ? (BN == 64 ? 1 : 2) : (BN == 32 ? 4 : 2);  // rows a warpgroup
  static constexpr int TH = 2 * MT;                            // rows a tile
  static constexpr int SH = kTrans ? TH + 1 : TH + 2;          // staged rows
  static constexpr int SW = kTrans ? kTW + 1 : kTW + 2;        // staged columns
  static constexpr int BOX = SH * SW * 16;                     // bytes of one input box
  static constexpr int PLANE = (BOX + 127) / 128 * 128;        // its slot: a channel group
  static constexpr int A_BYTES = 2 * PLANE;
  static constexpr int B_BYTES = 9 * 2 * BN * 16;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int PITCH = BN + 8;                         // bf16 per staged output pixel
  static constexpr int OUT_PIX = PH * MT * kTW;                // output pixels a warpgroup
  static constexpr int EPI_BYTES = OUT_PIX * PITCH * 2;        // per warpgroup
  static constexpr int FIT = (kSmemMax - 2 * EPI_BYTES - 1024) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = STAGES * STAGE + 2 * EPI_BYTES + 1024;  // + barriers, alignment
  static_assert(PH * MT * BN / 2 <= 128, "accumulators");
  static_assert(STAGES >= 3, "pipeline depth");
  static_assert(PLANE / 16 < (1 << 14), "leading byte offset");
};

struct Args {
  const __nv_bfloat16* wt;  // the arranged weight (`bf16_weight_operand`)
  const float* scale;
  const float* shift;
  __nv_bfloat16* out;       // (B, Ho, Wo, Cout)
  int cout, h, w, chunks, tiles_x, tiles_y, co_tiles, tiles, relu;
};

// Tile `tile` of the order (image, tile row, tile column, Cout tile), the
// last fastest: image b, first row y0, first column x0, Cout tile co_t.
template <int TH>
__device__ __forceinline__ void tile_origin(const Args& a, int tile, int& b, int& y0, int& x0,
                                            int& co_t) {
  co_t = tile % a.co_tiles;
  int r = tile / a.co_tiles;
  x0 = (r % a.tiles_x) * kTW;
  r /= a.tiles_x;
  y0 = (r % a.tiles_y) * TH;
  b = r / a.tiles_y;
}

// The producer thread: every (tile, chunk) stage of this block, in order,
// into the ring: two input boxes (the chunk's two channel groups) and the
// chunk's weight slice of the tile's Cout tile.
template <bool kTrans, int BN>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const Args& a, uint32_t ring,
                                        uint64_t* full, uint64_t* empty) {
  using C = Cfg<kTrans, BN>;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    int b, y0, x0, co_t;
    tile_origin<C::TH>(a, tile, b, y0, x0, co_t);
    const __nv_bfloat16* wt = a.wt + (size_t)co_t * a.chunks * (C::B_BYTES / 2);
    for (int c = 0; c < a.chunks; ++c, ++it) {
      const int slot = it % C::STAGES;
      mbar_wait_or_trap(&empty[slot], ((it / C::STAGES) & 1) ^ 1);
      const uint32_t bar = smem_addr(&full[slot]);
      const uint32_t dst = ring + slot * C::STAGE;
      mbar_expect_tx(bar, 2 * C::BOX + C::B_BYTES);
      tma_load_4d(dst, xmap, bar, c * kKC, x0 - 1, y0 - 1, b);
      tma_load_4d(dst + C::PLANE, xmap, bar, c * kKC + 8, x0 - 1, y0 - 1, b);
      bulk_load(dst + C::A_BYTES, wt + (size_t)c * (C::B_BYTES / 2), C::B_BYTES, bar);
    }
  }
}

// A consumer warpgroup (wg 0 or 1): the products of its MT rows of every
// tile of this block, then the tile's epilogue through `epi`.
template <bool kTrans, int BN>
__device__ __forceinline__ void consume(const Args& a, uint32_t ring, __nv_bfloat16* epi,
                                        uint64_t* full, uint64_t* empty) {
  using C = Cfg<kTrans, BN>;
  const int wg = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int ho = kTrans ? 2 * a.h : a.h;
  const int wo = kTrans ? 2 * a.w : a.w;
  const bool vec = a.cout % 8 == 0;
  float acc[C::PH][C::MT][BN / 2];
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    int b, y0, x0, co_t;
    tile_origin<C::TH>(a, tile, b, y0, x0, co_t);
    int prev = -1;
    for (int c = 0; c < a.chunks; ++c, ++it) {
      const int slot = it % C::STAGES;
      mbar_wait_or_trap(&full[slot], (it / C::STAGES) & 1);
      const uint32_t sa = ring + slot * C::STAGE;
      const uint32_t sb = sa + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ta = tap / 3, tb = tap % 3;
        const uint64_t bd = kmajor_desc(sb + tap * (2 * BN * 16), BN * 16, 128);
        // Staged row of this warpgroup's first M tile, and staged column,
        // that this tap reads; the output phase it feeds.
        const int sr = kTrans ? wg * C::MT + 1 - (ta == 2) : wg * C::MT + ta;
        const int sc = kTrans ? 1 - (tb == 2) : tb;
        const int ph = kTrans ? 2 * (ta == 1) + (tb == 1) : 0;
        // The first product into each accumulator set starts it from zero.
        const int accumulate = c > 0 || (kTrans ? (ta == 2 || tb == 2) : tap > 0);
#pragma unroll
        for (int m = 0; m < C::MT; ++m) {
          const uint64_t ad = kmajor_desc(sa + ((sr + m) * C::SW + sc) * 16, C::PLANE, 128);
          wgmma_bf16(acc[ph][m], ad, bd, accumulate);
        }
      }
      wgmma_commit();
      // The previous stage's products are done: release its slot.
      if (prev >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = slot;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int p = 0; p < C::PH; ++p)
#pragma unroll
      for (int m = 0; m < C::MT; ++m) fence_regs(acc[p][m]);

    // Epilogue. Accumulator 4 j + 2 h + e of an M tile is its pixel column
    // 16 warp + lane / 4 + 8 h, output channel 8 j + 2 (lane % 4) + e.
    const int co0 = co_t * BN;
    named_bar_sync(1 + wg, 128);  // the buffer's previous tile has been stored
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * (lane % 4);
      const int co = co0 + n;
      const float s0 = co < a.cout ? a.scale[co] : 0.f;
      const float t0 = co < a.cout ? a.shift[co] : 0.f;
      const float s1 = co + 1 < a.cout ? a.scale[co + 1] : 0.f;
      const float t1 = co + 1 < a.cout ? a.shift[co + 1] : 0.f;
#pragma unroll
      for (int p = 0; p < C::PH; ++p)
#pragma unroll
        for (int m = 0; m < C::MT; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float v0 = acc[p][m][4 * j + 2 * hh] * s0 + t0;
            float v1 = acc[p][m][4 * j + 2 * hh + 1] * s1 + t1;
            if (a.relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const int col = 16 * warp + lane / 4 + 8 * hh;
            // Conv: pixel 64 m + col. Transposed conv: output row 2 m + py,
            // output column 2 col + px of the warpgroup's 2 MT x 128 pixels.
            const int pix = kTrans ? (2 * m + (p >> 1)) * (2 * kTW) + 2 * col + (p & 1)
                                   : m * kTW + col;
            *reinterpret_cast<__nv_bfloat162*>(epi + pix * C::PITCH + n) =
                __floats2bfloat162_rn(v0, v1);
          }
    }
    named_bar_sync(1 + wg, 128);
    // Whole pixels out, BN / 8 vectors of 8 channels each.
    constexpr int VP = BN / 8;
    constexpr int RW = kTrans ? 2 * kTW : kTW;  // buffer pixels an output row
    const int row0 = kTrans ? 2 * (y0 + wg * C::MT) : y0 + wg * C::MT;
    const int col0 = kTrans ? 2 * x0 : x0;
    for (int v = tw; v < C::OUT_PIX * VP; v += 128) {
      const int pix = v / VP, q = v % VP;
      const int oy = row0 + pix / RW, ox = col0 + pix % RW;
      const int co = co0 + 8 * q;
      if (oy >= ho || ox >= wo || co >= a.cout) continue;
      const __nv_bfloat16* src = epi + pix * C::PITCH + 8 * q;
      __nv_bfloat16* dst = a.out + ((size_t)(b * ho + oy) * wo + ox) * a.cout + co;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && co + e < a.cout; ++e) dst[e] = src[e];
      }
    }
  }
}

template <bool kTrans, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const Args a) {
  using C = Cfg<kTrans, BN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // [STAGES ring slots][2 epilogue buffers][full, empty barriers], 128-byte aligned.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 127) & ~127u;
  uint8_t* const sm = smem_raw + (ring - raw);
  __nv_bfloat16* const epi = reinterpret_cast<__nv_bfloat16*>(sm + C::STAGES * C::STAGE);
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(sm + C::STAGES * C::STAGE + 2 * C::EPI_BYTES);
  uint64_t* const empty = full + C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    fence_mbarrier_init();
    fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) produce<kTrans, BN>(&xmap, a, ring, full, empty);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<kTrans, BN>(a, ring, epi + (threadIdx.x / 128) * (C::EPI_BYTES / 2), full, empty);
  }
}

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up at run time through the CUDA
// runtime's entry-point query (no -lcuda).
inline cudaError_t encode_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// x (B, H, W, C) bf16, C % 8 == 0, base 16-byte aligned; boxes of 8
// channels x box_w columns x box_h rows x 1 image, zero outside.
inline cudaError_t input_map(CUtensorMap* map, const void* x, int b, int c, int h, int w,
                             int box_w, int box_h) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kTrans, int BN>
cudaError_t launch(const void* x, const void* wt, const float* scale, const float* shift,
                   void* out, int b, int cin, int cout, int h, int w, int relu, int sms,
                   cudaStream_t stream) {
  using C = Cfg<kTrans, BN>;
  CUtensorMap map;
  cudaError_t err = input_map(&map, x, b, cin, h, w, C::SW, C::SH);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_bf16_kernel<kTrans, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  Args a;
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.scale = scale;
  a.shift = shift;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.cout = cout;
  a.h = h;
  a.w = w;
  a.chunks = (cin + kKC - 1) / kKC;
  a.tiles_x = (w + kTW - 1) / kTW;
  a.tiles_y = (h + C::TH - 1) / C::TH;
  a.co_tiles = (cout + BN - 1) / BN;
  const long long tiles = (long long)b * a.tiles_x * a.tiles_y * a.co_tiles;
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.relu = relu;
  const int grid = a.tiles < sms ? a.tiles : sms;
  conv_bf16_kernel<kTrans, BN><<<grid, kThreads, C::SMEM, stream>>>(map, a);
  return cudaGetLastError();
}

// The C entries' checks and the choice among the tile widths the wrapper
// (`ops/conv.py`, `bf16_tile_n`) arranged the weight for.
template <bool kTrans>
cudaError_t run(const void* x, const void* wt, const float* scale, const float* shift, void* out,
                int b, int cin, int cout, int h, int w, int relu, int bn, int sms,
                cudaStream_t stream) {
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || sms <= 0 || cin % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) % 16 != 0)
    return cudaErrorInvalidValue;
  if (cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorInvalidValue;
  if (bn == 32)
    return launch<kTrans, 32>(x, wt, scale, shift, out, b, cin, cout, h, w, relu, sms, stream);
  if (bn == 64)
    return launch<kTrans, 64>(x, wt, scale, shift, out, b, cin, cout, h, w, relu, sms, stream);
  if constexpr (!kTrans) {
    if (bn == 128)
      return launch<kTrans, 128>(x, wt, scale, shift, out, b, cin, cout, h, w, relu, sms, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bf16conv
}  // namespace hfr
