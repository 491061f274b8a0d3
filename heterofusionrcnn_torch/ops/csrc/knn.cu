// Exact k-nearest neighbours for the H100 (sm_90a).
//
// Replaces heterofusionrcnn_tpu/ops/pallas_knn.py: `_knn_pallas_sorted` /
// `_knn_sorted_kernel_t` (the Morton-sorted tile-skipping arm) and the brute
// arm of `knn_pallas` (`_knn_kernel_t` + `_fold_tile_t`). Both arms compute
// the same function: for each query, the k candidates with the smallest
// direct squared distance ((dx*dx + dy*dy) + dz*dz, each term rounded on its
// own, no FMA contraction: the library is built with --fmad=false), ordered
// by (distance, candidate index), exactly as the plain PyTorch version
// `knn_point_plain`. ops/grouping.py:knn_arm picks the arm from the shape.
//
// Brute arm (knn_brute_kernel, small sets): one thread per query, the
// candidates of its batch element streamed through shared memory as float4
// in index order, a register top-k kept sorted by insertion, each run of 32
// candidates scanned in the sorted arm's two passes (below).
//
// Sorted arm (large sets):
//  1. knn_prep_kernel, one block per point set (the candidates of a batch
//     element and, for another query set, its queries): the candidate
//     set's (x, z) bounds, the BEV Morton key of every point of the set on
//     that grid (queries clipped to it), a stable radix sort of (key, index)
//     in shared memory (cub's block-level BlockRadixSort) by the key's top
//     15 bits, then the set in key order: the candidates as float4 (x, y, z,
//     original index as int bits, one 16-byte load a candidate) with a
//     (lo, hi) box per tile of kTile = 32 consecutive candidates, or the
//     queries' order and keys. One launch in place of a key kernel, a
//     stable torch.sort (a dozen launches and memsets through cub's device
//     sort) and a tile kernel: at the main path's sizes the sort's launches
//     cost more host time than the search takes on the card. Sets of up to
//     16384 points (1024 threads x 16 keys); `knn_arm` sends larger ones to
//     the brute arm. Sorting by the top 15 bits (128 x 256 cells) costs
//     three 5-bit passes instead of four; 16384 points fill half of those
//     cells, so a finer order inside a cell does not shape the tiles of 32.
//     The key is `_morton_key_bev`'s: 10 + 10 bits over (x, z) with a scale
//     per axis. A 3D key (10 bits of x, y, z on the largest extent's scale)
//     was no faster on the batch-4 forward's uniform clouds and evaluated
//     more pairs on the KITTI frames, which are flat in y; a tile of 32
//     evaluated fewer pairs than tiles of 64 or 128 and was as fast, and
//     two queries a lane were slower on every call (tools/knn_sweep.py,
//     PERF.md), so the key, the tile and one query a lane are fixed.
//  2. knn_sorted_kernel: one warp per 32 consecutive sorted queries, each
//     query's top-k in registers sorted by (distance, original index). The
//     warp takes its queries' box, starts at the candidate tile at its own
//     position on the curve (the tile where the sorted candidate keys reach
//     its middle query's key), then visits tiles outward (centre, +1, -1,
//     +2, ...). Tiles are tested 32 at a time: each lane computes one tile's
//     lower bound from the warp's query box, `__ballot_sync` keeps those with
//     lb <= kth (kth: the warp's worst k-th distance, a max over its queries
//     of non-negative floats, taken on their bits with `__reduce_max_sync`).
//     Each kept tile is tested again just before its scan, per query: the
//     bound from the query's own point to the tile's box against that
//     query's own k-th distance of the moment; the warp scans the tile if any
//     query passes (`__any_sync`). A warp whose 32 queries straddle a jump of
//     the curve has a large box, but each of its queries needs only the tiles
//     near itself: the per-query test keeps such warps from scanning most of
//     their box, and at the main path's sizes one wave of warps waits for its
//     slowest. A tile is one run of 32 candidates, scanned in two passes: the
//     distances of the whole run against each query's k-th distance as a bit
//     mask, without branches, then only those candidates go through the
//     (branch-free) insert. Inserting per candidate stalled the warp whenever
//     any of its 32 queries took one. Results go straight to the query's
//     original row.
//
// Why skipping is exact. Per axis the bound takes gx = max(lo_c - hi_q,
// lo_q - hi_c, 0) and lb = (gx*gx + gy*gy) + gz*gz, each operation rounded
// to nearest like the distance's. Rounding to nearest is monotone and odd,
// so for every query q of the query box (the warp's, or one point) and
// candidate c of the tile's box gx <= |fl(q.x - c.x)| on each axis, and the
// rounded squares and sums keep the order: lb <= d. A tile with lb > kth
// (or, per query, lb > that query's k-th distance d_k) holds no candidate at
// or below d_k, so none can enter (an entry needs d < d_k, or d == d_k with
// a lower index): skipping it changes nothing. A tile with lb == kth is
// visited, since an equal distance with a lower index still enters. The
// TPU kernel's `_LB_SAFETY` margin is therefore not needed and not kept.
// Every insert compares (d, index) lexicographically, so the result does
// not depend on the order in which tiles are visited, and empty slots hold
// (inf, INT_MAX): nothing is skipped until every query has k candidates
// (kth stays inf), and a candidate at distance inf still enters before an
// empty slot.
//
// Bound: operations for both arms on the pairs they evaluate (9 FP32
// operations a pair); the sorted arm evaluates the pairs of the tiles its
// warps visit (`visited` counts them when the caller passes a counter).
// On an H100 the search's time goes to the instructions of its evaluated
// pairs and their inserts, while calls with few query warps (1024 queries
// of a batch of 4: one warp an SM) are bound by each warp's latency, not
// by the card's rate.

#include <cub/block/block_exchange.cuh>
#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;  // an empty slot sorts after every candidate
constexpr int kBruteThreads = 128;
constexpr int kBruteTile = 1024;
constexpr int kSortedWarps = 4;       // independent warps a block
constexpr int kTile = 32;             // candidates a tile of the sorted arm: one warp's run
constexpr int kRadixBits = 5;         // key bits a pass of the prep's block sort
constexpr int kSortBits = 15;         // the key's top bits the prep sorts by
constexpr int kKeyShift = 20 - kSortBits;  // of the 20-bit BEV key

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A top-k entry: the distance's bits over the candidate index. Distances
// are sums of squares, never negative, so the unsigned order of the 64-bit
// word is the (distance, index) order the plain version sorts by.
__device__ __forceinline__ unsigned long long entry(float d, int i) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)i;
}
__device__ __forceinline__ float entry_dist(unsigned long long e) {
  return __uint_as_float((unsigned)(e >> 32));
}
constexpr unsigned long long kEmpty = (0x7f800000ull << 32) | (unsigned)kNoIndex;  // (inf, INT_MAX)

// Inserts e into the top-k held ascending, without branches: slot s takes
// its left neighbour, e, or keeps its entry.
template <int K>
__device__ __forceinline__ void insert(unsigned long long (&top)[K], unsigned long long e) {
#pragma unroll
  for (int s = K - 1; s > 0; --s)
    top[s] = e < top[s - 1] ? top[s - 1] : (e < top[s] ? e : top[s]);
  top[0] = e < top[0] ? e : top[0];
}

// ------------------------------------------------------------ brute arm --

template <int K>
__global__ void __launch_bounds__(kBruteThreads)
knn_brute_kernel(const float* __restrict__ xyz, const float* __restrict__ qrs,
                 int* __restrict__ out_idx, float* __restrict__ out_dist, int n, int p) {
  __shared__ float4 sc[kBruteTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kBruteThreads + threadIdx.x;
  const bool active = q < p;
  const float* cand = xyz + (size_t)b * n * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qq = qrs + ((size_t)b * p + q) * 3;
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }
  unsigned long long top[K];
#pragma unroll
  for (int s = 0; s < K; ++s) top[s] = kEmpty;

  for (int t0 = 0; t0 < n; t0 += kBruteTile) {
    const int cnt = min(kBruteTile, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kBruteThreads) {
      const float* c = cand + (size_t)(t0 + i) * 3;
      sc[i] = make_float4(c[0], c[1], c[2], 0.f);
    }
    __syncthreads();
    if (!active) continue;
    // Runs of 32 in two passes, as in the sorted arm's scan. Candidates
    // come in index order, so once the top-k is full one at its k-th
    // distance kd has a higher index than the k-th entry and cannot enter:
    // pass 1 tests d < kd, as d <= the float below kd (for kd = +0 that is
    // a NaN, which no distance reaches).
    for (int r0 = 0; r0 < cnt; r0 += 32) {
      const int m = min(32, cnt - r0);
      const unsigned long long last = top[K - 1];
      const float thr =
          last == kEmpty ? INFINITY : __int_as_float(__float_as_int(entry_dist(last)) - 1);
      unsigned hit = 0u;
#pragma unroll 8
      for (int u = 0; u < m; ++u) hit |= (unsigned)(sq_dist(qx, qy, qz, sc[r0 + u]) <= thr) << u;
      while (hit) {
        const int u = __ffs(hit) - 1;
        hit &= hit - 1;
        const unsigned long long e = entry(sq_dist(qx, qy, qz, sc[r0 + u]), t0 + r0 + u);
        if (e < top[K - 1]) insert<K>(top, e);
      }
    }
  }
  if (!active) return;
  const size_t o = ((size_t)b * p + q) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_idx[o + s] = (int)(unsigned)top[s];
    out_dist[o + s] = entry_dist(top[s]);
  }
}

// ---------------------------------------------------------- sorted arm --

__device__ __forceinline__ unsigned part1by1(unsigned v) {
  v &= 0xFFFFu;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// Grid coordinate 0..1023 of v: clip((v - lo) * scale, 0, 1023), truncated.
__device__ __forceinline__ unsigned grid_coord(float v, float lo, float scale) {
  return (unsigned)fminf(fmaxf(__fmul_rn(__fsub_rn(v, lo), scale), 0.f), 1023.f);
}

// `_morton_key_bev` of pt on the grid frame = (lo x, lo z, scale x, scale z).
__device__ __forceinline__ unsigned morton_key(const float* pt, const float (&frame)[4]) {
  return part1by1(grid_coord(pt[0], frame[0], frame[2])) |
         (part1by1(grid_coord(pt[2], frame[1], frame[3])) << 1);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Floats (not NaN) as ints of the same order, for the warp's integer
// min / max reductions (`__reduce_min_sync`, one instruction).
__device__ __forceinline__ int float_order(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float order_float(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

// The sorted arm's prep, one block per point set: blocks 0..B-1 take the
// candidates of batch element b, blocks B..2B-1 (another query set) its
// queries. Each block takes the candidates' (x, z) bounds, the Morton keys
// of its set on that grid, a stable radix sort of (key, index) in shared
// memory by the key's top kSortBits bits (cub::BlockRadixSort), then writes
// the set in key order: the candidates as float4 with their tile boxes, or
// the queries' order and sort keys.
template <int THREADS, int ITEMS>
using PrepSort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, int, kRadixBits>;
template <int THREADS, int ITEMS>
using PrepExchange = cub::BlockExchange<unsigned, THREADS, ITEMS>;

template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
knn_prep_kernel(const float* __restrict__ xyz, const float* __restrict__ qrs,
                float4* __restrict__ cand, float4* __restrict__ boxes, int* __restrict__ skeys,
                int* __restrict__ qperm, int* __restrict__ sqkeys, int b_count, int n, int p) {
  using Sort = PrepSort<THREADS, ITEMS>;
  using Exchange = PrepExchange<THREADS, ITEMS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[THREADS / 32][4];
  __shared__ float frame_s[4];  // lo x, lo z, scale x, scale z
  const bool queries = blockIdx.x >= b_count;
  const int b = queries ? blockIdx.x - b_count : blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* c = xyz + (size_t)b * n * 3;

  // The candidates' bounds over x (a = 0) and z (a = 1, coordinate 2).
  float lo[2] = {INFINITY, INFINITY};
  float hi[2] = {-INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < n; i += THREADS) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float v = c[(size_t)i * 3 + 2 * a];
      lo[a] = fminf(lo[a], v);
      hi[a] = fmaxf(hi[a], v);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      red[warp][a] = lo[a];
      red[warp][2 + a] = hi[a];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      lo[a] = warp_min(lane < THREADS / 32 ? red[lane][a] : INFINITY);
      hi[a] = warp_max(lane < THREADS / 32 ? red[lane][2 + a] : -INFINITY);
    }
    if (lane == 0) {
      // `_morton_key_bev`: 1023 / max(hi - lo, 1e-6) per axis.
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        frame_s[a] = lo[a];
        frame_s[2 + a] = __fdiv_rn(1023.f, fmaxf(__fsub_rn(hi[a], lo[a]), 1e-6f));
      }
    }
  }
  __syncthreads();
  const float frame[4] = {frame_s[0], frame_s[1], frame_s[2], frame_s[3]};

  // Keys computed in the striped arrangement (coalesced loads), moved to
  // the blocked one (thread t holds points t * ITEMS ...), where the sort's
  // tie order is the original index order. Sets shorter than the block are
  // padded with 0xFFFFFFFF, which sorts after every key.
  const int m = queries ? p : n;
  const float* pts = queries ? qrs + (size_t)b * p * 3 : c;
  unsigned keys[ITEMS];
  int vals[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * THREADS + threadIdx.x;
    keys[i] = j < m ? morton_key(pts + (size_t)j * 3, frame) : 0xFFFFFFFFu;
  }
  Exchange(*reinterpret_cast<typename Exchange::TempStorage*>(smem)).StripedToBlocked(keys);
  __syncthreads();  // the exchange's shared memory is the sort's next
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) vals[i] = threadIdx.x * ITEMS + i;
  Sort(*reinterpret_cast<typename Sort::TempStorage*>(smem))
      .SortBlockedToStriped(keys, vals, kKeyShift, kKeyShift + kSortBits);

  if (queries) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int pos = i * THREADS + threadIdx.x;
      if (pos < p) {
        qperm[(size_t)b * p + pos] = vals[i];
        sqkeys[(size_t)b * p + pos] = (int)(keys[i] >> kKeyShift);
      }
    }
    return;
  }
  // The candidates in key order with their boxes. In the striped
  // arrangement the 32 lanes of a warp hold 32 consecutive positions
  // (i * THREADS + 32 * warp + lane): one tile, whose box is a warp
  // reduction.
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int pos = i * THREADS + threadIdx.x;
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    if (pos < n) {
      const float* v = c + (size_t)vals[i] * 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) lo[a] = hi[a] = v[a];
      cand[(size_t)b * n + pos] = make_float4(lo[0], lo[1], lo[2], __int_as_float(vals[i]));
      skeys[(size_t)b * n + pos] = (int)(keys[i] >> kKeyShift);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = order_float(__reduce_min_sync(kFull, float_order(lo[a])));
      hi[a] = order_float(__reduce_max_sync(kFull, float_order(hi[a])));
    }
    if (lane == 0 && pos < n) {
      float4* box = boxes + ((size_t)b * ((n + kTile - 1) / kTile) + pos / kTile) * 2;
      box[0] = make_float4(lo[0], lo[1], lo[2], 0.f);
      box[1] = make_float4(hi[0], hi[1], hi[2], 0.f);
    }
  }
}

// j-th tile visited from `center` outward: center, +1, -1, +2, -2, ...,
// then the longer side alone (`pallas_knn._zigzag_tile`).
__device__ __forceinline__ int zigzag(int j, int center, int ntiles) {
  const int left = center, right = ntiles - 1 - center;
  const int off = (j + 1) >> 1;
  if (j <= 2 * min(left, right)) return (j & 1) ? center + off : center - off;
  return right > left ? center + (j - left) : center - (j - right);
}

__device__ __forceinline__ float axis_gap(float qlo, float qhi, float clo, float chi) {
  return fmaxf(fmaxf(__fsub_rn(clo, qhi), __fsub_rn(qlo, chi)), 0.f);
}

// Lower bound of the kernel's distance between any point of the query box
// (qlo, qhi) and any point of the candidate box (see the note at the top).
__device__ __forceinline__ float box_bound(float qlox, float qloy, float qloz, float qhix,
                                           float qhiy, float qhiz, float4 clo, float4 chi) {
  const float gx = axis_gap(qlox, qhix, clo.x, chi.x);
  const float gy = axis_gap(qloy, qhiy, clo.y, chi.y);
  const float gz = axis_gap(qloz, qhiz, clo.z, chi.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

// qrs == nullptr: the queries are the candidates (same set, p == n), query
// j of the sorted order is cand[j]. Otherwise query j of the sorted order is
// row qperm[j] of qrs, and sqkeys holds the sorted query keys.
template <int K>
__global__ void __launch_bounds__(kSortedWarps * 32)
knn_sorted_kernel(const float4* __restrict__ cand, const float4* __restrict__ boxes,
                  const int* __restrict__ skeys, const float* __restrict__ qrs,
                  const int* __restrict__ qperm, const int* __restrict__ sqkeys,
                  int* __restrict__ out_idx, float* __restrict__ out_dist,
                  unsigned long long* __restrict__ visited, int n, int p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * kSortedWarps + (threadIdx.x >> 5)) * 32;
  if (q0 >= p) return;  // the whole warp
  const int nq = min(32, p - q0);
  const int ntiles = (n + kTile - 1) / kTile;
  const float4* cb = cand + (size_t)b * n;
  const float4* bb = boxes + (size_t)b * ntiles * 2;

  const int pos = q0 + lane;
  const bool act = pos < p;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  int row = 0;
  if (act) {
    if (qrs == nullptr) {
      const float4 c = cb[pos];
      qx = c.x;
      qy = c.y;
      qz = c.z;
      row = __float_as_int(c.w);
    } else {
      row = qperm[(size_t)b * p + pos];
      const float* q = qrs + ((size_t)b * p + row) * 3;
      qx = q[0];
      qy = q[1];
      qz = q[2];
    }
  }
  const float qlox = warp_min(act ? qx : INFINITY), qhix = warp_max(act ? qx : -INFINITY);
  const float qloy = warp_min(act ? qy : INFINITY), qhiy = warp_max(act ? qy : -INFINITY);
  const float qloz = warp_min(act ? qz : INFINITY), qhiz = warp_max(act ? qz : -INFINITY);

  // The tile at the warp's own curve position (its middle query's).
  const int mid = q0 + nq / 2;
  int center;
  if (qrs == nullptr) {
    center = mid / kTile;
  } else {
    // The first sorted candidate key >= the middle query's, by a 32-way
    // search: each round the lanes probe 32 evenly spaced keys of the
    // interval (three rounds for 16384 keys, each one memory latency).
    const int key = sqkeys[(size_t)b * p + mid];
    const int* kb = skeys + (size_t)b * n;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int step = (hi - lo + 31) >> 5;
      const int at = lo + lane * step;
      const int below = __popc(__ballot_sync(kFull, at < hi && kb[at] < key));
      if (below == 0) {
        hi = lo;
      } else {
        const int base = lo;
        lo = base + (below - 1) * step + 1;
        hi = min(hi, base + below * step);
      }
    }
    center = lo / kTile;
  }
  center = min(center, ntiles - 1);

  unsigned long long top[K];
#pragma unroll
  for (int s = 0; s < K; ++s) top[s] = kEmpty;
  float kth = INFINITY;
  unsigned long long pairs = 0;
  __shared__ float4 runs[kSortedWarps][kTile];
  float4* run = runs[threadIdx.x >> 5];
  float4 pre = make_float4(0.f, 0.f, 0.f, 0.f);  // this lane's candidate of tile pre_t
  int pre_t = -1;

  for (int g0 = 0; g0 < ntiles; g0 += 32) {
    const int j = g0 + lane;
    const int t = j < ntiles ? zigzag(j, center, ntiles) : 0;
    const float4 blo = bb[2 * t], bhi = bb[2 * t + 1];  // this lane's tile's box, kept
    const bool pass =
        j < ntiles && box_bound(qlox, qloy, qloz, qhix, qhiy, qhiz, blo, bhi) <= kth;
    unsigned todo = __ballot_sync(kFull, pass);
    // Again, per query: its own point against the box of lane src's tile and
    // its own k-th distance of the moment (tighter than the warp's box and
    // kth). A tile that fails it fails it later too: k-th distances only
    // shrink.
    auto needed = [&](int src) {
      const float4 clo = make_float4(__shfl_sync(kFull, blo.x, src), __shfl_sync(kFull, blo.y, src),
                                     __shfl_sync(kFull, blo.z, src), 0.f);
      const float4 chi = make_float4(__shfl_sync(kFull, bhi.x, src), __shfl_sync(kFull, bhi.y, src),
                                     __shfl_sync(kFull, bhi.z, src), 0.f);
      return __any_sync(kFull, act && box_bound(qx, qy, qz, qx, qy, qz, clo, chi) <=
                                          entry_dist(top[K - 1]));
    };
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int tt = __shfl_sync(kFull, t, src);
      if (!needed(src)) continue;
      const int start = tt * kTile;
      const int m = min(kTile, n - start);
      // The tile is staged in the warp's shared buffer by one coalesced
      // 16-byte load a lane (taken from the prefetch when it holds this
      // tile); the next kept tile that still passes the test (those that
      // fail now are dropped) is loaded into a register meanwhile.
      const float4 mine = tt == pre_t ? pre : (lane < m ? cb[start + lane] : pre);
      int next_t = -1;
      while (next_t < 0 && todo) {
        const int nsrc = __ffs(todo) - 1;
        if (needed(nsrc)) next_t = __shfl_sync(kFull, t, nsrc);
        else todo &= todo - 1;
      }
      if (next_t >= 0 && lane < min(kTile, n - next_t * kTile)) pre = cb[next_t * kTile + lane];
      pre_t = next_t;
      __syncwarp();
      if (lane < m) run[lane] = mine;
      __syncwarp();
      // Pass 1, without branches: the candidates whose distance reaches the
      // query's k-th distance at the tile's start, as bits. Pass 2: those
      // alone go through the insert, which compares (d, index) with the k-th
      // of the moment again.
      unsigned hit = 0u;
      const float kd = entry_dist(top[K - 1]);
#pragma unroll 8
      for (int u = 0; u < m; ++u) hit |= (unsigned)(sq_dist(qx, qy, qz, run[u]) <= kd) << u;
      while (hit) {
        const int u = __ffs(hit) - 1;
        hit &= hit - 1;
        const float4 cu = run[u];
        const unsigned long long e = entry(sq_dist(qx, qy, qz, cu), __float_as_int(cu.w));
        if (e < top[K - 1]) insert<K>(top, e);
      }
      pairs += (unsigned long long)nq * m;
      const float worst = act ? entry_dist(top[K - 1]) : 0.f;
      kth = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(worst)));
    }
  }

  if (act) {
    const size_t o = ((size_t)b * p + row) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_idx[o + s] = (int)(unsigned)top[s];
      out_dist[o + s] = entry_dist(top[s]);
    }
  }
  if (visited != nullptr && lane == 0) atomicAdd(visited, pairs);
}

template <int K>
cudaError_t launch_brute(const float* xyz, const float* qrs, int* idx, float* dist, int b,
                         int n, int p, cudaStream_t stream) {
  dim3 grid((p + kBruteThreads - 1) / kBruteThreads, b);
  knn_brute_kernel<K><<<grid, kBruteThreads, 0, stream>>>(xyz, qrs, idx, dist, n, p);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_sorted(const float4* cand, const float4* boxes, const int* skeys,
                          const float* qrs, const int* qperm, const int* sqkeys, int* idx,
                          float* dist, unsigned long long* visited, int b, int n, int p,
                          cudaStream_t stream) {
  const int warps = (p + 31) / 32;
  dim3 grid((warps + kSortedWarps - 1) / kSortedWarps, b);
  knn_sorted_kernel<K><<<grid, kSortedWarps * 32, 0, stream>>>(
      cand, boxes, skeys, qrs, qperm, sqkeys, idx, dist, visited, n, p);
  return cudaGetLastError();
}

// The prep kernel for sets of up to THREADS x ITEMS points.
template <int THREADS, int ITEMS>
cudaError_t launch_prep(const float* xyz, const float* qrs, float4* cand, float4* boxes,
                        int* skeys, int* qperm, int* sqkeys, int b, int n, int p,
                        cudaStream_t stream) {
  const int smem = sizeof(typename PrepSort<THREADS, ITEMS>::TempStorage) >
                           sizeof(typename PrepExchange<THREADS, ITEMS>::TempStorage)
                       ? sizeof(typename PrepSort<THREADS, ITEMS>::TempStorage)
                       : sizeof(typename PrepExchange<THREADS, ITEMS>::TempStorage);
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_prep_kernel<THREADS, ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  knn_prep_kernel<THREADS, ITEMS><<<qrs == nullptr ? b : 2 * b, THREADS, smem, stream>>>(
      xyz, qrs, cand, boxes, skeys, qperm, sqkeys, b, n, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define HFR_KNN_CASES(CASE)                                              \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)        \
  CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

// Brute arm. xyz (B, N, 3), qrs (B, P, 3) float32; idx (B, P, k) int32,
// dist (B, P, k).
int hfr_knn(const float* xyz, const float* qrs, int* idx, float* dist, int b, int n, int p,
            int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define HFR_KNN_CASE(K) \
  case K:               \
    return launch_brute<K>(xyz, qrs, idx, dist, b, n, p, s);
    HFR_KNN_CASES(HFR_KNN_CASE)
#undef HFR_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Sorted arm, prep. xyz (B, N, 3); qrs (B, P, 3), or NULL for the same set
// (then P == N). Writes cand (B, N, 4) float32 (x, y, z, original index
// bits) in key order, boxes (B, ceil(N / 32), 2, 4) float32, skeys (B, N)
// int32 the sorted keys' top 15 bits and, for another query set, qperm
// (B, P) int32 the queries in key order and sqkeys (B, P) their keys' top
// 15 bits. Sets of up to 16384 points.
int hfr_knn_prep(const float* xyz, const float* qrs, float* cand, float* boxes, int* skeys,
                 int* qperm, int* sqkeys, int b, int n, int p, void* stream) {
  const int m = n > p ? n : p;
  if (n < 1 || m > 16384 || (qrs == nullptr && p != n) ||
      (qrs != nullptr && (qperm == nullptr || sqkeys == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* c = reinterpret_cast<float4*>(cand);
  float4* bx = reinterpret_cast<float4*>(boxes);
  if (m <= 512) return launch_prep<128, 4>(xyz, qrs, c, bx, skeys, qperm, sqkeys, b, n, p, s);
  if (m <= 2048) return launch_prep<256, 8>(xyz, qrs, c, bx, skeys, qperm, sqkeys, b, n, p, s);
  if (m <= 4096) return launch_prep<512, 8>(xyz, qrs, c, bx, skeys, qperm, sqkeys, b, n, p, s);
  return launch_prep<1024, 16>(xyz, qrs, c, bx, skeys, qperm, sqkeys, b, n, p, s);
}

// Sorted arm, search. cand, boxes, skeys from hfr_knn_prep; qrs NULL for
// the same set (then P == N), else (B, P, 3) with qperm and sqkeys from
// hfr_knn_prep; idx (B, P, k), dist (B, P, k) in the queries' own order;
// visited NULL or one uint64 that gains the (query, candidate) pairs
// evaluated.
int hfr_knn_sorted(const float* cand, const float* boxes, const int* skeys, const float* qrs,
                   const int* qperm, const int* sqkeys, int* idx, float* dist,
                   unsigned long long* visited, int b, int n, int p, int k, void* stream) {
  if (n < 1 || (qrs == nullptr && p != n) ||
      (qrs != nullptr && (qperm == nullptr || sqkeys == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* c = reinterpret_cast<const float4*>(cand);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  switch (k) {
#define HFR_KNN_CASE(K) \
  case K:               \
    return launch_sorted<K>(c, bx, skeys, qrs, qperm, sqkeys, idx, dist, visited, b, n, p, s);
    HFR_KNN_CASES(HFR_KNN_CASE)
#undef HFR_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef HFR_KNN_CASES

}  // extern "C"
