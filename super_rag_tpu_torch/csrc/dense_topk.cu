// Fused dense scoring + tile-local top-kt for Hopper (sm_90a).
//
// Replaces the TPU kernel the JAX package's ops/pallas_topk.py:36 _make_kernel
// (driven by pallas_dense_topk, :106).  For each logical tile of `tile`
// corpus rows and each query b it computes
//
//   s[b, t] = q[b] . c[t]             int8 x int8 -> int32, or f32 sums
//           * qscale[b]               (int8 x int8 mode only)
//           * row_scale[t]            (int8 corpora)
//   s       = 2 s - norms_sq[t]       (L2)
//   s       = -inf                    (mask[t] == 0, or t >= n: padding)
//
// and then the tile's top-kt as the reference takes it: values descending,
// lowest column first among ties, and once only -inf is left every further
// slot is (-inf, column 0).  Output: vals/ids [num_tiles, B, kt],
// ids = tile*T + col.
//
// Three variants, chosen by shape in the wrapper (ops/dense_topk.py
// kernel_variant), counted by the wrapper per route and mode:
//
// * dense_topk_tcs_kernel, the tensor cores for every mode but f32 at
//   kt <= 128 and any D (the served searches, calibration, deep per-tile
//   lists, remote embeddings of 1,536 to 4,096 dimensions): int8 x int8
//   on mma.sync.m16n8k32.s8, bf16 queries on m16n8k16.bf16 with f32 sums,
//   over bf16 rows or over int8 codes widened exactly to bf16 in registers
//   (ldmatrix -> s8x4_to_bf16x2, the k order permuted alike for queries
//   and codes).  A block of 32 queries walks its slice of a tile in
//   256-row chunks (8 warps of 16 queries x 64 rows, a 4-stage cp.async
//   ring of 64-byte k-slices); the chunk's epilogued scores go to shared
//   memory, and a warp per query takes their top-kp (kp = kt rounded up
//   to a power of two, >= 8) over 64-bit (value, column) keys held 8 a
//   lane -- kt rounds of a warp max for kt <= 8, bitonic networks above --
//   merging it into the query's running list; a chunk none of whose keys
//   beats the list's kt-th is skipped.  Where the tiles alone would leave
//   SMs idle, each tile's rows split over up to 8 blocks of a cluster,
//   whose lists merge through distributed shared memory.  Up to D = 1024
//   the block's queries are held whole in shared memory; above it (the
//   query block alone would be 98,816 B at D = 1,536 in bf16, 197,120 B at
//   3,072) they stream through a ring of their own, one 64-byte k-slice a
//   row a stage (128 in the int8-codes mode) beside the corpus's, so
//   shared memory is 94-135 KB whatever D; only the block's live queries
//   are loaded (rows past B are zeros written once), so at B = 1 a stage
//   adds one row.  What bounds it: at the served shapes (16,384 rows of
//   D = 256 at B = 64; 8,224 rows of D = 1,536 at B = 1, 25.3 MB of bf16
//   rows, 0.0075 ms at 3.35 TB/s) the launch, the ring's latency and the
//   selection, not bytes or tensor operations: the split puts 128 blocks
//   on the 132 SMs at D = 256 and 40 (33 with rows) at the 1,536-wide
//   collection's 5 tiles, each keeping three of a 256-row chunk's 48
//   stages in flight (0.047-0.054 ms on an H100, 6-7x the bytes bound).
//   No split of D and a k loop whose order is fixed by D alone (the same
//   in both forms): a query's sums are the same bits alone or in any batch
//   and any split; the selection is exact, so int8 x int8 is bit-equal to
//   the plain version.
// * dense_topk_tc_kernel, the int8 x int8 mode with register lists (its
//   whole query block in shared memory), for kt <= 8 and D <= 1024 where
//   the grid of tiles already fills the card
//   (the 1M and 10M flat search_hybrid):
//   mma.sync.m16n8k32.s32.s8.s8 fed by ldmatrix from padded shared memory
//   (row strides of 16 mod 32 bytes, so the 8 rows of an ldmatrix hit 8
//   distinct bank groups).  A block keeps its whole [queries, D] block in
//   shared memory and walks its tile in row chunks; corpus k-slices of 128
//   bytes stream through a 3-stage cp.async ring, so the next two slices
//   load while the tensor cores work on this one.  The grid puts the query
//   blocks of a tile next to each other, so a tile is read from HBM once
//   and from L2 by its neighbours.  The int32 sums are exact; the epilogue
//   takes them in the reference's order (__fmul_rn by qscale, then
//   row_scale, then 2 s - norm, then the mask), so the result is bit-equal
//   to the plain version whatever the block shape.  No score tile is kept:
//   each thread carries a running top-kt (registers, KT in {1, 2, 4, 8}) of
//   the columns it owns across the tile's chunks; at the tile's end the
//   four lanes that share a query merge with a fixed xor-shuffle tree and
//   the warps that share it through shared memory, in the order above.
//   Block shapes (timed on an H100 at the smoke's shapes): for kt <= 2,
//   128 queries x 256-row chunks in 16 warps of 32 queries x 64 rows, one
//   block an SM (2.3 ms at B = 512, where 64 x 128 blocks of 16 x 64 warp
//   tiles took 3.6 ms: wider warp tiles halve the ldmatrix bytes per mma;
//   still ~6x the operation bound: the fragments' shared-memory reads and
//   the per-column epilogue, not the tensor cores, set its pace);
//   for kt 3..8, whose longer lists do not fit beside that tile's
//   registers, or D > 896, 64 queries x 128 rows in 8 warps of 16 x 64, two
//   blocks an SM.
// * dense_topk_kernel, the rest: f32 queries (whose only tensor-core path,
//   TF32, cannot hold the f32 tolerance) and kt > 128: the first
//   version, dp4a or FMA on CUDA cores from shared memory with a 4 x 4
//   register tile per thread and the [16 x tile] score tile in shared
//   memory.
//
// Modes (dense_topk_launch):
//   int8 x int8 : q int8 [B, D] + qscale f32 [B]; corpus int8
//   int8 corpus, bf16 queries; bf16 corpus, bf16 queries; f32 x f32.
// Requirements checked by the Python wrapper: D % 16 == 0, 16-byte aligned
// row-major operands, tile <= 2048 (SIMT variant); the launches refuse
// the rest (cudaErrorInvalidValue).  What bounds the work
// at its largest: the corpus read (N x D bytes in int8, ~0.77 GB at
// 1M x 768: 0.23 ms at 3.35 TB/s) at small batches, and the int8 work
// (2 B N D operations: 0.40 ms at 1,979 TOP/s) at batch 512.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "sm90_util.cuh"

namespace {

constexpr int QB = 16;        // queries per block
constexpr int RC = 128;       // corpus rows per staged chunk
constexpr int KW = 64;        // 32-bit words per staged row chunk
constexpr int SW = KW + 1;    // padded smem row stride (bank-conflict free)
constexpr int THREADS = 128;  // 4 warps: warp w owns queries 4w..4w+3

template <typename T> struct VecElems;
template <> struct VecElems<int8_t> { static constexpr int value = 16; };
template <> struct VecElems<__nv_bfloat16> { static constexpr int value = 8; };
template <> struct VecElems<float> { static constexpr int value = 4; };

// Stage one 16-byte vector of `src` into 32-bit smem words: raw int8 quads
// for the dp4a path, one f32 per element otherwise.
template <typename T, bool DP4A>
__device__ __forceinline__ void stage_vec(const T* src, uint32_t* dst) {
  const int4 v = *reinterpret_cast<const int4*>(src);
  if constexpr (DP4A) {
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (sizeof(T) == 1) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = __float_as_uint(static_cast<float>(e[i]));
  } else if constexpr (sizeof(T) == 2) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __float_as_uint(__bfloat162float(e[i]));
  } else {
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
}

using sm90::better;

template <typename TQ, typename TC, bool DP4A>
__global__ void __launch_bounds__(THREADS)
dense_topk_kernel(const TQ* __restrict__ q, const float* __restrict__ qscale,
                  const TC* __restrict__ c, const float* __restrict__ scales,
                  const float* __restrict__ norms, const uint8_t* __restrict__ mask,
                  int B, int N, int D, int tile, int kt,
                  float* __restrict__ out_vals, int* __restrict__ out_ids) {
  extern __shared__ uint32_t smem[];
  uint32_t* sq = smem;                       // [QB][SW]
  uint32_t* sc = sq + QB * SW;               // [RC][SW]
  float* ss = reinterpret_cast<float*>(sc + RC * SW);  // [QB][tile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * QB;
  const int tile_idx = blockIdx.y;
  const long long base = static_cast<long long>(tile_idx) * tile;

  constexpr int KC = DP4A ? 4 * KW : KW;     // elements per staged k-chunk
  constexpr int EQ = VecElems<TQ>::value;
  constexpr int EC = VecElems<TC>::value;
  constexpr int WQ = DP4A ? 4 : EQ;          // smem words per 16-byte vector
  constexpr int WC = DP4A ? 4 : EC;

  for (int rc0 = 0; rc0 < tile; rc0 += RC) {
    using Acc = typename std::conditional<DP4A, int, float>::type;
    Acc acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < D; k0 += KC) {
      const int ce = min(KC, D - k0);
      const int nvq = ce / EQ, nvc = ce / EC;
      for (int idx = tid; idx < QB * nvq; idx += THREADS) {
        const int r = idx / nvq, v = idx - r * nvq;
        uint32_t* dst = sq + r * SW + v * WQ;
        if (b0 + r < B) {
          stage_vec<TQ, DP4A>(q + static_cast<long long>(b0 + r) * D + k0 + v * EQ, dst);
        } else {
#pragma unroll
          for (int w = 0; w < WQ; ++w) dst[w] = 0u;
        }
      }
      for (int idx = tid; idx < RC * nvc; idx += THREADS) {
        const int r = idx / nvc, v = idx - r * nvc;
        const int col = rc0 + r;
        const long long t = base + col;
        uint32_t* dst = sc + r * SW + v * WC;
        if (col < tile && t < N) {
          stage_vec<TC, DP4A>(c + t * D + k0 + v * EC, dst);
        } else {
#pragma unroll
          for (int w = 0; w < WC; ++w) dst[w] = 0u;
        }
      }
      __syncthreads();
      const int nw = DP4A ? ce / 4 : ce;
      const uint32_t* qrow = sq + (4 * warp) * SW;
      const uint32_t* crow = sc + lane * SW;
#pragma unroll 4
      for (int kk = 0; kk < nw; ++kk) {
        uint32_t qv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qrow[i * SW + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = crow[j * 32 * SW + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (DP4A) {
              acc[i][j] = __dp4a(static_cast<int>(qv[i]), static_cast<int>(cv[j]), acc[i][j]);
            } else {
              acc[i][j] = fmaf(__uint_as_float(qv[i]), __uint_as_float(cv[j]), acc[i][j]);
            }
          }
      }
      __syncthreads();
    }

    // epilogue, in the reference's order: (s * qscale) * row_scale, then
    // 2 s - norm, then the mask; rows past N are padding and score -inf
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = rc0 + lane + 32 * j;
      if (col >= tile) continue;
      const long long t = base + col;
      const bool live = t < N && (mask == nullptr || mask[t] != 0);
      const float rs = (scales != nullptr && t < N) ? scales[t] : 1.0f;
      const float nn = (norms != nullptr && t < N) ? norms[t] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = 4 * warp + i;
        float s;
        if constexpr (DP4A) {
          const float qs = (b0 + qi < B) ? qscale[b0 + qi] : 0.0f;
          s = __fmul_rn(__int2float_rn(acc[i][j]), qs);
        } else {
          s = acc[i][j];
        }
        if (scales != nullptr) s = __fmul_rn(s, rs);
        if (norms != nullptr) s = __fsub_rn(__fmul_rn(2.0f, s), nn);
        ss[qi * tile + col] = live ? s : -INFINITY;
      }
    }
  }
  __syncthreads();

  // tile-local top-kt: each lane caches the best of the columns it owns
  // (lane, lane + 32, ...); a round reduces the 32 candidates, writes the
  // winner, suppresses it, and only the owning lane rescans.
  for (int i = 0; i < 4; ++i) {
    const int qi = 4 * warp + i;
    const int b = b0 + qi;
    if (b >= B) break;
    float* row = ss + qi * tile;
    float bv = -INFINITY;
    int bc = 0x7fffffff;
    for (int col = lane; col < tile; col += 32) {
      const float v = row[col];
      if (better(v, col, bv, bc)) { bv = v; bc = col; }
    }
    const long long out0 = (static_cast<long long>(tile_idx) * B + b) * kt;
    for (int r = 0; r < kt; ++r) {
      float wv = bv;
      int wc = bc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, wc, off);
        if (better(ov, oc, wv, wc)) { wv = ov; wc = oc; }
      }
      if (lane == 0) {
        out_vals[out0 + r] = wv;
        out_ids[out0 + r] = static_cast<int>(base + wc);
      }
      if ((wc & 31) == lane) {
        row[wc] = -INFINITY;
        bv = -INFINITY;
        bc = 0x7fffffff;
        for (int col = lane; col < tile; col += 32) {
          const float v = row[col];
          if (better(v, col, bv, bc)) { bv = v; bc = col; }
        }
      }
      __syncwarp();
    }
  }
}

template <typename TQ, typename TC, bool DP4A>
int launch(const void* q, const float* qscale, const void* c, const float* scales,
           const float* norms, const uint8_t* mask, int B, int N, int D, int tile,
           int num_tiles, int kt, float* out_vals, int* out_ids, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (QB * SW + RC * SW) + sizeof(float) * QB * tile;
  auto kern = dense_topk_kernel<TQ, TC, DP4A>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + QB - 1) / QB, num_tiles);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), qscale, static_cast<const TC*>(c), scales, norms,
      mask, B, N, D, tile, kt, out_vals, out_ids);
  return static_cast<int>(cudaGetLastError());
}

// ---- tensor-core variant: int8 x int8, kt <= 8 ------------------------------

namespace tc {

constexpr int MAX_D = 1024;

// A block holds QB queries and walks its tile in chunks of RC rows; warp
// tiles are 16 * MT queries x 64 rows; corpus k-slices of KS bytes stream
// through an NST-stage cp.async ring; MINB blocks are meant to share an SM.
template <int QB_, int RC_, int MT_, int KS_, int NST_, int MINB_>
struct Cfg {
  static constexpr int QB = QB_, RC = RC_, MT = MT_, KS = KS_, NST = NST_, MINB = MINB_;
  static constexpr int CS = KS + 16;  // corpus row stride: 16 mod 32 bytes
  static constexpr int WARPS_M = QB / (16 * MT);
  static constexpr int WARPS_N = RC / 64;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;

  // query row stride: D rounded up to a stage, + 16 bytes (16 mod 32: the
  // 8 rows of an ldmatrix land in 8 distinct bank groups)
  __host__ __device__ static int query_stride(int D) { return (D + KS - 1) / KS * KS + 16; }

  __host__ static size_t smem_bytes(int D, int kt_cap) {
    const size_t ring = static_cast<size_t>(NST) * RC * CS;
    const size_t merge = static_cast<size_t>(WARPS_N - 1) * QB * kt_cap * 8;
    return static_cast<size_t>(QB) * query_stride(D) + (ring > merge ? ring : merge);
  }
};

// the configurations the port runs (chosen by timing on an H100; the note
// at the top of this file): for kt <= 2, 128 queries and 256-row chunks in
// 16 warps of 32 queries x 64 rows (two blocks' worth of registers, one
// block an SM); for kt 3..8, or where that block's shared memory does not
// fit (D > 896), 64 queries and 128-row chunks in 8 warps of 16 x 64
using Wide = Cfg<128, 256, 2, 128, 3, 1>;
using Narrow = Cfg<64, 128, 1, 128, 3, 2>;
constexpr size_t SMEM_MAX = 232448;  // an H100 block's dynamic shared memory

template <typename G, int KT>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
dense_topk_tc_kernel(const int8_t* __restrict__ q, const float* __restrict__ qscale,
                     const int8_t* __restrict__ c, const float* __restrict__ scales,
                     const float* __restrict__ norms, const uint8_t* __restrict__ mask,
                     int B, int N, int D, int tile, int kt, float* __restrict__ out_vals,
                     int* __restrict__ out_ids) {
  constexpr int QB = G::QB, RC = G::RC, MT = G::MT, KS = G::KS, NST = G::NST, CS = G::CS;
  constexpr int WARPS_M = G::WARPS_M, WARPS_N = G::WARPS_N, THREADS = G::THREADS;
  constexpr int NL = 2 * MT;  // running lists per thread (queries it owns)
  extern __shared__ __align__(16) uint8_t smem[];
  const int QS = G::query_stride(D);
  uint8_t* sq = smem;                 // [QB][QS]
  uint8_t* sc = smem + QB * QS;       // ring: [NST][RC][CS]; merge lists after the loop

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WARPS_M;      // query group: queries 16 MT wm ..
  const int wn = warp / WARPS_M;      // row group: chunk rows 64 wn .. 64 wn + 63
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int b0 = blockIdx.x * QB;
  const int tile_idx = blockIdx.y;
  const long long base = static_cast<long long>(tile_idx) * tile;

  const int nks = (D + KS - 1) / KS;
  const int total = (tile + RC - 1) / RC * nks;

  // the query block, once: rows past B and bytes past D are zeros
  {
    const int vpr = (QS - 16) / 16;
    for (int idx = tid; idx < QB * vpr; idx += THREADS) {
      const int r = idx / vpr, kb = (idx - r * vpr) * 16;
      const bool ok = b0 + r < B && kb < D;
      sm90::cp_async16(sq + r * QS + kb,
                       ok ? q + static_cast<long long>(b0 + r) * D + kb : q, ok ? 16 : 0);
    }
  }
  auto load_stage = [&](int s) {
    const int r0 = s / nks * RC;
    const int k0 = s % nks * KS;
    uint8_t* dst = sc + (s % NST) * (RC * CS);
    for (int idx = tid; idx < RC * (KS / 16); idx += THREADS) {
      const int r = idx / (KS / 16), kb = k0 + (idx % (KS / 16)) * 16;
      const int col = r0 + r;
      const long long t = base + col;
      const bool ok = col < tile && t < N && kb < D;
      sm90::cp_async16(dst + r * CS + (kb - k0), ok ? c + t * D + kb : c, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < total) load_stage(s);
    sm90::cp_async_commit();
  }

  // this thread's queries: list l = 2 mt + h is query 16 (MT wm + mt) + gid + 8 h
  int ql[NL];
  float qsc[NL];
  float lv[NL][KT];
  int lc[NL][KT];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    ql[l] = (MT * wm + l / 2) * 16 + gid + 8 * (l & 1);
    qsc[l] = b0 + ql[l] < B ? qscale[b0 + ql[l]] : 0.0f;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      lv[l][i] = -INFINITY;
      lc[l][i] = 0x7fffffff;
    }
  }
  int acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  // per-lane ldmatrix row offsets (see the m16n8k32 fragment layouts)
  const uint8_t* a_row =
      sq + ((MT * wm) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QS + (lane >> 4) * 16;
  const int b_off = (wn * 64 + (lane & 7) + (lane >> 4) * 8) * CS + ((lane >> 3) & 1) * 16;

  for (int s = 0; s < total; ++s) {
    sm90::cp_async_wait<NST - 2>();
    __syncthreads();
    if (s + NST - 1 < total) load_stage(s + NST - 1);
    sm90::cp_async_commit();

    const int ks = s % nks;
    const int k0 = ks * KS;
    const uint8_t* buf = sc + (s % NST) * (RC * CS) + b_off;
    const int nsub = min(KS / 32, (D - k0 + 31) / 32);
#pragma unroll
    for (int sub = 0; sub < KS / 32; ++sub) {
      if (sub < nsub) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) sm90::ldmatrix_x4(a_row + mt * 16 * QS + k0 + sub * 32, a[mt]);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bb[4];
          sm90::ldmatrix_x4(buf + jp * 16 * CS + sub * 32, bb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            sm90::mma_s8_16832(acc[mt][2 * jp], a[mt], bb[0], bb[1]);
            sm90::mma_s8_16832(acc[mt][2 * jp + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }

    if (ks == nks - 1) {
      // the chunk's sums are complete: epilogue in the reference's order,
      // then into the running lists
      const int r0 = s / nks * RC + wn * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = r0 + j * 8 + tig * 2 + e;
          if (col < tile) {
            const long long t = base + col;
            const bool live = t < N && (mask == nullptr || mask[t] != 0);
            const float rs = (scales != nullptr && t < N) ? scales[t] : 1.0f;
            const float nn = (norms != nullptr && t < N) ? norms[t] : 0.0f;
#pragma unroll
            for (int l = 0; l < NL; ++l) {
              float v = __fmul_rn(__int2float_rn(acc[l / 2][j][2 * (l & 1) + e]), qsc[l]);
              if (scales != nullptr) v = __fmul_rn(v, rs);
              if (norms != nullptr) v = __fsub_rn(__fmul_rn(2.0f, v), nn);
              sm90::list_insert<KT>(lv[l], lc[l], live ? v : -INFINITY, col);
            }
          }
#pragma unroll
          for (int l = 0; l < NL; ++l) acc[l / 2][j][2 * (l & 1) + e] = 0;
        }
      }
    }
  }

  // the four lanes of a query (tig 0..3): a fixed xor-shuffle tree; each
  // step takes the partner's whole list before inserting it
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float ov[KT];
      int oc[KT];
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        ov[i] = __shfl_xor_sync(0xffffffffu, lv[l][i], m);
        oc[i] = __shfl_xor_sync(0xffffffffu, lc[l][i], m);
      }
#pragma unroll
      for (int i = 0; i < KT; ++i) sm90::list_insert<KT>(lv[l], lc[l], ov[i], oc[i]);
    }
  }

  // the warps of a query group (wn = 0 .. WARPS_N - 1) through shared
  // memory: warps wn > 0 post their lists, warp 0 merges them in wn order
  sm90::cp_async_wait<0>();
  __syncthreads();
  float* mv = reinterpret_cast<float*>(sc);                    // [WARPS_N - 1][QB][KT]
  int* mc = reinterpret_cast<int*>(sc) + (WARPS_N - 1) * QB * KT;
  if (WARPS_N > 1) {
    if (wn > 0 && tig == 0) {
#pragma unroll
      for (int l = 0; l < NL; ++l)
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const int o = ((wn - 1) * QB + ql[l]) * KT + i;
          mv[o] = lv[l][i];
          mc[o] = lc[l][i];
        }
    }
    __syncthreads();
  }
  if (wn == 0 && tig == 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      for (int w = 1; w < WARPS_N; ++w)
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const int o = ((w - 1) * QB + ql[l]) * KT + i;
          sm90::list_insert<KT>(lv[l], lc[l], mv[o], mc[o]);
        }
      const int b = b0 + ql[l];
      if (b < B) {
        const long long out0 = (static_cast<long long>(tile_idx) * B + b) * kt;
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          if (i < kt) {
            out_vals[out0 + i] = lv[l][i];
            out_ids[out0 + i] = static_cast<int>(base + (lv[l][i] == -INFINITY ? 0 : lc[l][i]));
          }
        }
      }
    }
  }
}

template <typename G, int KT>
int launch_kt(const int8_t* q, const float* qscale, const int8_t* c, const float* scales,
              const float* norms, const uint8_t* mask, int B, int N, int D, int tile,
              int num_tiles, int kt, float* out_vals, int* out_ids, cudaStream_t stream) {
  const size_t smem = G::smem_bytes(D, KT);
  auto kern = dense_topk_tc_kernel<G, KT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + G::QB - 1) / G::QB, num_tiles);  // the query blocks of a tile run together
  kern<<<grid, G::THREADS, smem, stream>>>(q, qscale, c, scales, norms, mask, B, N, D, tile, kt,
                                           out_vals, out_ids);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
int launch_default(const int8_t* q, const float* qscale, const int8_t* c, const float* scales,
                   const float* norms, const uint8_t* mask, int B, int N, int D, int tile,
                   int num_tiles, int kt, float* out_vals, int* out_ids, cudaStream_t s) {
  if constexpr (KT <= 2) {
    if (Wide::smem_bytes(D, KT) <= SMEM_MAX)
      return launch_kt<Wide, KT>(q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles, kt,
                                 out_vals, out_ids, s);
  }
  return launch_kt<Narrow, KT>(q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles, kt,
                               out_vals, out_ids, s);
}

int launch(const void* q, const float* qscale, const void* c, const float* scales,
           const float* norms, const uint8_t* mask, int B, int N, int D, int tile,
           int num_tiles, int kt, float* out_vals, int* out_ids, cudaStream_t s) {
  if (kt < 1 || kt > 8 || D > MAX_D || D % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const int8_t* ci = static_cast<const int8_t*>(c);
  if (kt == 1)
    return launch_default<1>(qi, qscale, ci, scales, norms, mask, B, N, D, tile, num_tiles, kt,
                             out_vals, out_ids, s);
  if (kt == 2)
    return launch_default<2>(qi, qscale, ci, scales, norms, mask, B, N, D, tile, num_tiles, kt,
                             out_vals, out_ids, s);
  if (kt <= 4)
    return launch_default<4>(qi, qscale, ci, scales, norms, mask, B, N, D, tile, num_tiles, kt,
                             out_vals, out_ids, s);
  return launch_default<8>(qi, qscale, ci, scales, norms, mask, B, N, D, tile, num_tiles, kt,
                           out_vals, out_ids, s);
}

}  // namespace tc

// ---- tensor-core variant with sorted selection ------------------------------
//
// Every tensor-core mode (int8 x int8 on m16n8k32 s8; bf16 queries on bf16
// rows or on int8 codes widened exactly to bf16, m16n8k16 with f32 sums),
// kt <= 128, and a tile's rows split over the blocks of one cluster.
//
// A block holds QB queries and walks its slice of the tile in chunks of RC
// rows; the chunk's corpus k-slices stream through a cp.async ring (and,
// above D = MAX_D, the query block's k-slices through a ring of their own,
// stage by stage beside them, so that no shared memory grows with D), the
// chunk's epilogued f32 scores go to shared memory (over the drained ring),
// and a warp per query takes the chunk's top-KP over (value, column) keys
// (rounds of a warp max, or bitonic networks) and merges it into the
// query's running list in shared memory.  A chunk none of whose keys beats the list's kt-th is
// skipped.  The S blocks of a tile (a cluster along z) then merge their
// lists through distributed shared memory: block r takes the queries
// q = r (mod S).  The top-kt of a union under a strict total order is the
// same whatever the split, so the result depends on the logical tile only.
namespace tcs {

constexpr int QB = 32;         // queries per block: 2 warp rows of 16
constexpr int RC = 256;        // corpus rows per chunk: 4 warp columns of 64
constexpr int KS = 64;         // corpus bytes of a row per ring stage
constexpr int NST = 4;         // ring stages (82 KB: two blocks an SM where
                               // the query block is small or streamed, so
                               // the clusters of a launch are resident
                               // together)
constexpr int CS = KS + 16;    // ring row stride: 16 mod 32 bytes
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int E = RC / 32;     // keys per lane in the selection
constexpr int SS = RC + 8;     // score row stride (floats): conflict-free float2 stores
constexpr int MAX_KT = 128;
constexpr int MAX_SLICES = 8;  // a portable cluster
constexpr int MAX_D = 1024;    // the resident query block (32 x 2,064 B at bf16)
// the streamed form: int32 sums of int8 x int8 are exact while
// D * 127^2 < 2^31 (the quantizer's codes), i.e. to D = 133,143; 2^16
// keeps them exact for any int8 codes (D * 128^2 <= 2^30)
constexpr int MAX_D_STREAMED = 65536;

using u64 = unsigned long long;

// query bytes of one ring stage (the int8-codes mode's bf16 queries are
// twice its code bytes), and the padding of a query row: + 16 (ldmatrix
// rows: 16 mod 32) or, for the int8-codes mode whose query fragments are
// 8-byte loads, + 32 (four rows cover 128 bytes)
__host__ __device__ constexpr int stage_query_bytes(int mode) { return mode == 1 ? 2 * KS : KS; }
__host__ __device__ constexpr int query_pad(int mode) { return mode == 1 ? 32 : 16; }

// query row stride in bytes: the whole row rounded up to one stage of
// query bytes (resident), or one stage (streamed), + the padding
__host__ __device__ inline int query_stride(int mode, int D, bool streamed) {
  const int stage = stage_query_bytes(mode);
  const int bytes = mode == 0 ? D : 2 * D;
  return (streamed ? stage : (bytes + stage - 1) / stage * stage) + query_pad(mode);
}

// resident: [QB] query rows + the corpus ring + the lists; streamed: a
// query ring of NST stages beside the corpus ring, nothing that grows with D
inline size_t smem_bytes(int mode, int D, int kp, bool streamed) {
  return static_cast<size_t>(streamed ? NST : 1) * QB * query_stride(mode, D, streamed) +
         static_cast<size_t>(NST) * RC * CS + static_cast<size_t>(QB) * kp * sizeof(u64);
}

// (value, column) as one key whose unsigned order is the reference's:
// value descending, then lowest column first; -inf (masked, padding) is
// the empty key 0, below every real key; -0 counts as +0, as == does
__device__ __forceinline__ u64 make_key(float v, int col) {
  uint32_t u = __float_as_uint(v);
  if (v == -INFINITY) return 0ull;
  if ((u << 1) == 0u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<uint32_t>(~col);
}

__device__ __forceinline__ float key_value(u64 k) {
  const uint32_t u = static_cast<uint32_t>(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_col(u64 k) { return static_cast<int>(~static_cast<uint32_t>(k)); }

// Bitonic networks over the KP = G * E keys of a group of G lanes (element
// i = g * E + j: lane g of the group, register j).  A stage compares pairs
// (i, i ^ d); the pair's lower element keeps the larger key where
// i & kk == 0 (kk: the length of the runs being built; 0 in a merge).
template <int D>
__device__ __forceinline__ void stage_in_lane(u64 (&k)[E], int kk, int g) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if ((j & D) == 0) {
      const bool desc = ((g * E + j) & kk) == 0;
      const u64 a = k[j], b = k[j | D];
      if (desc ? a < b : a > b) {
        k[j] = b;
        k[j | D] = a;
      }
    }
  }
}

__device__ __forceinline__ void stage(u64 (&k)[E], int kk, int d, int g) {
  if (d >= E) {
    const int m = d / E;
    const bool lower = (g & m) == 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const u64 o = __shfl_xor_sync(0xffffffffu, k[j], m);
      const bool desc = ((g * E + j) & kk) == 0;
      k[j] = (lower == desc) ? (o > k[j] ? o : k[j]) : (o < k[j] ? o : k[j]);
    }
  } else if (d == 4) {
    stage_in_lane<4>(k, kk, g);
  } else if (d == 2) {
    stage_in_lane<2>(k, kk, g);
  } else {
    stage_in_lane<1>(k, kk, g);
  }
}

// a bitonic sequence of KP keys, sorted descending
__device__ __forceinline__ void merge_cascade(u64 (&k)[E], int kp, int g) {
  for (int d = kp >> 1; d > 0; d >>= 1) stage(k, 0, d, g);
}

// keys k (sorted, group layout) <- the top KP of k and the sorted list L
__device__ __forceinline__ void merge_list(u64 (&k)[E], const u64* L, int kp, int g) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const u64 o = L[kp - 1 - (g * E + j)];
    k[j] = o > k[j] ? o : k[j];
  }
  merge_cascade(k, kp, g);
}

// kt <= E: the warp's 32 * E keys (any order) -> their top kt, sorted, in
// registers 0 .. kt - 1 of every lane (the rest empty): kt rounds of a
// warp-wide max, whose owner drops it and takes its next best
__device__ __forceinline__ void warp_top_rounds(u64 (&k)[E], int kt) {
  u64 best = k[0];
#pragma unroll
  for (int j = 1; j < E; ++j) best = k[j] > best ? k[j] : best;
  u64 out[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    out[r] = 0ull;
    if (r < kt) {
      u64 w = best;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const u64 o = __shfl_xor_sync(0xffffffffu, w, off);
        w = o > w ? o : w;
      }
      out[r] = w;
      if (best == w) {  // the owner (or, once w is empty, every lane: no-op)
#pragma unroll
        for (int j = 0; j < E; ++j) k[j] = k[j] == w ? 0ull : k[j];
        best = k[0];
#pragma unroll
        for (int j = 1; j < E; ++j) best = k[j] > best ? k[j] : best;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) k[j] = out[j];
}

// the warp's 32 * E keys (any order) -> their top KP, sorted, in every group
__device__ __forceinline__ void warp_top(u64 (&k)[E], int kp, int lane) {
  const int G = kp / E;
  const int g = lane & (G - 1);
  for (int kk = 2; kk <= kp; kk <<= 1)
    for (int d = kk >> 1; d > 0; d >>= 1) stage(k, kk, d, g);
  // groups pairwise: my run against the partner's, reversed, then merge
  for (int m = G; m < 32; m <<= 1) {
    const int src = ((lane ^ m) & ~(G - 1)) | (G - 1 - g);
    u64 o[E];
#pragma unroll
    for (int j = 0; j < E; ++j) o[j] = __shfl_sync(0xffffffffu, k[E - 1 - j], src);
#pragma unroll
    for (int j = 0; j < E; ++j) k[j] = o[j] > k[j] ? o[j] : k[j];
    merge_cascade(k, kp, g);
  }
}

// STREAMED: the query block's k-slices stream through a ring of their
// own beside the corpus's (D > MAX_D), else the block is held whole
template <int MODE, bool STREAMED>
__global__ void __launch_bounds__(THREADS, 2)
dense_topk_tcs_kernel(const void* __restrict__ q, const float* __restrict__ qscale,
                      const void* __restrict__ c, const float* __restrict__ scales,
                      const float* __restrict__ norms, const uint8_t* __restrict__ mask,
                      int B, int N, int D, int tile, int kt, int kp, int slice_rows,
                      float* __restrict__ out_vals, int* __restrict__ out_ids) {
  namespace cg = cooperative_groups;
  using Acc = typename std::conditional<MODE == 0, int, float>::type;
  constexpr int QK = stage_query_bytes(MODE);
  extern __shared__ __align__(16) uint8_t smem[];
  const int QS = query_stride(MODE, D, STREAMED);
  uint8_t* sq = smem;                                        // [QB][QS] or [NST][QB][QS]
  uint8_t* ring = smem + (STREAMED ? NST : 1) * QB * QS;     // [NST][RC][CS]
  float* ss = reinterpret_cast<float*>(ring);                // [QB][SS], after a chunk
  u64* lists = reinterpret_cast<u64*>(ring + NST * RC * CS);  // [QB][kp]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;         // queries 16 wm ..
  const int wn = warp >> 1;        // chunk rows 64 wn ..
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int b0 = blockIdx.x * QB;
  const int nb = min(QB, B - b0);  // the block's live queries (streamed form)
  const int tile_idx = blockIdx.y;
  const int slice = blockIdx.z;
  const int S = gridDim.z;
  const long long base = static_cast<long long>(tile_idx) * tile;
  const int r_begin = slice * slice_rows;
  const int r_end = min(tile, r_begin + slice_rows);
  const int rowc = MODE == 2 ? 2 * D : D;  // corpus bytes a row
  const int rowq = MODE == 0 ? D : 2 * D;  // query bytes a row
  const int nks = (rowc + KS - 1) / KS;
  const uint8_t* cb = static_cast<const uint8_t*>(c);
  const uint8_t* qb = static_cast<const uint8_t*>(q);

  if constexpr (STREAMED) {
    // query rows past B are zeros in every stage, written once: the
    // stage loads below fill rows < B only
    for (int i = tid; i < NST * QB * (QS / 16); i += THREADS) {
      if (i / (QS / 16) % QB >= nb) reinterpret_cast<uint4*>(sq)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    // the query block, once (committed with the first chunk's first stage):
    // rows past B and bytes past D are zeros
    const int vpr = (QS - query_pad(MODE)) / 16;
    for (int idx = tid; idx < QB * vpr; idx += THREADS) {
      const int r = idx / vpr, kb = (idx - r * vpr) * 16;
      const bool ok = b0 + r < B && kb < rowq;
      sm90::cp_async16(sq + r * QS + kb, ok ? qb + static_cast<long long>(b0 + r) * rowq + kb : qb,
                       ok ? 16 : 0);
    }
  }
  for (int i = tid; i < QB * kp; i += THREADS) lists[i] = 0ull;
  float qsc[2] = {0.0f, 0.0f};
  if constexpr (MODE == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + wm * 16 + gid + 8 * h;
      qsc[h] = b < B ? qscale[b] : 0.0f;
    }
  }

  const uint8_t* a_row =
      sq + (wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QS + (lane >> 4) * 16;
  const int b_off = (wn * 64 + (lane & 7) + (lane >> 4) * 8) * CS + ((lane >> 3) & 1) * 16;
  const int G = kp / E;

  for (int r0 = r_begin; r0 < r_end; r0 += RC) {
    auto load_stage = [&](int s) {
      const int kb0 = s * KS;
      uint8_t* dst = ring + (s % NST) * (RC * CS);
      for (int idx = tid; idx < RC * (KS / 16); idx += THREADS) {
        const int r = idx / (KS / 16), kb = kb0 + (idx % (KS / 16)) * 16;
        const int col = r0 + r;
        const long long t = base + col;
        const bool ok = col < r_end && t < N && kb < rowc;
        sm90::cp_async16(dst + r * CS + (kb - kb0), ok ? cb + t * rowc + kb : cb, ok ? 16 : 0);
      }
      if constexpr (STREAMED) {
        // the live queries' bytes of the same k-slice; bytes past D zeros
        const int qb0 = s * QK;
        uint8_t* qdst = sq + (s % NST) * (QB * QS);
        for (int idx = tid; idx < nb * (QK / 16); idx += THREADS) {
          const int r = idx / (QK / 16), kb = qb0 + (idx % (QK / 16)) * 16;
          const bool ok = kb < rowq;
          sm90::cp_async16(qdst + r * QS + (kb - qb0),
                           ok ? qb + static_cast<long long>(b0 + r) * rowq + kb : qb, ok ? 16 : 0);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) {
      if (s < nks) load_stage(s);
      sm90::cp_async_commit();
    }
    Acc acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;

    for (int s = 0; s < nks; ++s) {
      sm90::cp_async_wait<NST - 2>();
      __syncthreads();
      if (s + NST - 1 < nks) load_stage(s + NST - 1);
      sm90::cp_async_commit();
      const uint8_t* buf = ring + (s % NST) * (RC * CS) + b_off;
      const int qstage = (s % NST) * (QB * QS);  // the streamed form's query stage
#pragma unroll
      for (int sub = 0; sub < KS / 32; ++sub) {
        const int kb = s * KS + sub * 32;  // corpus byte of this 32-byte step
        if (kb < rowc) {
          if constexpr (MODE == 1) {
            // int8 codes: one ldmatrix.x4 holds 16 rows x 32 codes (two k16
            // steps of two n-tiles), widened to bf16 in registers; the
            // k order within a k16 step is permuted (logical 2t + j <-
            // physical 4t + j, 8 + 2t + j <- 4t + 2 + j) the same way for
            // the queries, whose fragments are then 8-byte loads
            uint32_t bb[4][4];
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) sm90::ldmatrix_x4(buf + jp * 16 * CS + sub * 32, bb[jp]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (kb + h * 16 < rowc) {
                // the resident rows hold the whole query, a stage its k-slice
                const uint8_t* qa =
                    STREAMED ? sq + qstage + (wm * 16 + gid) * QS + 2 * (sub * 32 + h * 16) + tig * 8
                             : sq + (wm * 16 + gid) * QS + 2 * (kb + h * 16) + tig * 8;
                const uint2 lo = *reinterpret_cast<const uint2*>(qa);
                const uint2 hi = *reinterpret_cast<const uint2*>(qa + 8 * QS);
                const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
                for (int jp = 0; jp < 4; ++jp) {
                  uint32_t x0, x1;
                  sm90::s8x4_to_bf16x2(bb[jp][h], x0, x1);
                  sm90::mma_bf16_16816(acc[2 * jp], a, x0, x1);
                  sm90::s8x4_to_bf16x2(bb[jp][2 + h], x0, x1);
                  sm90::mma_bf16_16816(acc[2 * jp + 1], a, x0, x1);
                }
              }
            }
          } else {
            uint32_t a[4];
            sm90::ldmatrix_x4(STREAMED ? a_row + qstage + sub * 32 : a_row + kb, a);
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
              uint32_t bb[4];
              sm90::ldmatrix_x4(buf + jp * 16 * CS + sub * 32, bb);
              if constexpr (MODE == 0) {
                sm90::mma_s8_16832(acc[2 * jp], a, bb[0], bb[1]);
                sm90::mma_s8_16832(acc[2 * jp + 1], a, bb[2], bb[3]);
              } else {
                sm90::mma_bf16_16816(acc[2 * jp], a, bb[0], bb[1]);
                sm90::mma_bf16_16816(acc[2 * jp + 1], a, bb[2], bb[3]);
              }
            }
          }
        }
      }
    }
    sm90::cp_async_wait<0>();
    __syncthreads();

    // the chunk's scores over the drained ring, in the reference's order:
    // (s * qscale) * row_scale, then 2 s - norm, then the mask
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = wn * 64 + j * 8 + 2 * tig + e;
        const int col = r0 + cc;
        const long long t = base + col;
        const bool live = col < r_end && t < N && (mask == nullptr || mask[t] != 0);
        const float rs = (scales != nullptr && live) ? scales[t] : 1.0f;
        const float nn = (norms != nullptr && live) ? norms[t] : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v;
          if constexpr (MODE == 0) {
            v = __fmul_rn(__int2float_rn(acc[j][2 * h + e]), qsc[h]);
          } else {
            v = acc[j][2 * h + e];
          }
          if (scales != nullptr) v = __fmul_rn(v, rs);
          if (norms != nullptr) v = __fsub_rn(__fmul_rn(2.0f, v), nn);
          ss[(wm * 16 + gid + 8 * h) * SS + cc] = live ? v : -INFINITY;
        }
      }
    }
    __syncthreads();

    // a warp per query: the chunk's top-kp merged into the running list
    for (int qi = warp; qi < QB && b0 + qi < B; qi += WARPS) {
      const float* row = ss + qi * SS + lane * E;
      const float4 v0 = *reinterpret_cast<const float4*>(row);
      const float4 v1 = *reinterpret_cast<const float4*>(row + 4);
      const float v[E] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      u64* L = lists + qi * kp;
      const u64 thr = L[kt - 1];
      u64 k[E];
      bool any = false;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        k[j] = make_key(v[j], r0 + lane * E + j);
        any |= k[j] > thr;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      if (kp == E)
        warp_top_rounds(k, kt);  // kt <= 8: cheaper than a network of 8
      else
        warp_top(k, kp, lane);
      merge_list(k, L, kp, lane & (G - 1));
      __syncwarp();
      if (lane < G) {
#pragma unroll
        for (int j = 0; j < E; ++j) L[lane * E + j] = k[j];
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // the tile's slices, through distributed shared memory: block r merges
  // the lists of queries r, r + S, ... in slice order and writes them
  sm90::cp_async_wait<0>();  // an empty slice never waited for its queries
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  {
    const int g = lane & (G - 1);
    int m = 0;
    for (int qi = slice; qi < QB && b0 + qi < B; qi += S, ++m) {
      if (m % WARPS != warp) continue;
      u64 k[E];
      const u64* L0 = cluster.map_shared_rank(lists, 0) + qi * kp;
#pragma unroll
      for (int j = 0; j < E; ++j) k[j] = L0[g * E + j];
      for (int r = 1; r < S; ++r) merge_list(k, cluster.map_shared_rank(lists, r) + qi * kp, kp, g);
      if (lane < G) {
        const long long out0 = (static_cast<long long>(tile_idx) * B + b0 + qi) * kt;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int i = lane * E + j;
          if (i < kt) {
            // once only -inf is left, every further slot is (-inf, column 0)
            out_vals[out0 + i] = k[j] == 0ull ? -INFINITY : key_value(k[j]);
            out_ids[out0 + i] = static_cast<int>(base + (k[j] == 0ull ? 0 : key_col(k[j])));
          }
        }
      }
    }
  }
  cluster.sync();  // no block leaves while another still reads its lists
}

template <int MODE, bool STREAMED>
int launch_mode(const void* q, const float* qscale, const void* c, const float* scales,
                const float* norms, const uint8_t* mask, int B, int N, int D, int tile,
                int num_tiles, int kt, int kp, int slices, int slice_rows, float* out_vals,
                int* out_ids, cudaStream_t stream) {
  const size_t smem = smem_bytes(MODE, D, kp, STREAMED);
  auto kern = dense_topk_tcs_kernel<MODE, STREAMED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  // the query blocks of a tile slice run together, so the slice is read
  // from HBM once and from L2 by its neighbours
  cfg.gridDim = dim3((B + QB - 1) / QB, num_tiles, slices);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = slices;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, q, qscale, c, scales, norms, mask, B, N, D, tile, kt, kp,
                           slice_rows, out_vals, out_ids);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool STREAMED>
int launch_form(int mode, const void* q, const float* qscale, const void* c, const float* scales,
                const float* norms, const uint8_t* mask, int B, int N, int D, int tile,
                int num_tiles, int kt, int kp, int slices, int slice_rows, float* out_vals,
                int* out_ids, cudaStream_t s) {
  switch (mode) {
    case 0:
      return launch_mode<0, STREAMED>(q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles,
                                      kt, kp, slices, slice_rows, out_vals, out_ids, s);
    case 1:
      return launch_mode<1, STREAMED>(q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles,
                                      kt, kp, slices, slice_rows, out_vals, out_ids, s);
    case 2:
      return launch_mode<2, STREAMED>(q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles,
                                      kt, kp, slices, slice_rows, out_vals, out_ids, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(int mode, const void* q, const float* qscale, const void* c, const float* scales,
           const float* norms, const uint8_t* mask, int B, int N, int D, int tile,
           int num_tiles, int kt, int slices, int slice_rows, int streamed, float* out_vals,
           int* out_ids, cudaStream_t s) {
  if (kt < 1 || kt > MAX_KT || D > (streamed ? MAX_D_STREAMED : MAX_D) || D % 16 != 0 ||
      slices < 1 || slices > MAX_SLICES || slice_rows < 1 || slice_rows % RC != 0 ||
      static_cast<long long>(slices) * slice_rows < tile)
    return static_cast<int>(cudaErrorInvalidValue);
  int kp = E;
  while (kp < kt) kp <<= 1;
  if (streamed)
    return launch_form<true>(mode, q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles,
                             kt, kp, slices, slice_rows, out_vals, out_ids, s);
  return launch_form<false>(mode, q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles, kt,
                            kp, slices, slice_rows, out_vals, out_ids, s);
}

}  // namespace tcs

}  // namespace

// mode: 0 = int8 x int8, 1 = int8 corpus + bf16 queries,
//       2 = bf16 corpus + bf16 queries, 3 = f32 x f32.
// Null scales / norms / mask pointers mean the feature is absent.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dense_topk_launch(int mode, const void* q, const float* qscale,
                                 const void* c, const float* scales, const float* norms,
                                 const uint8_t* mask, int B, int N, int D, int tile,
                                 int num_tiles, int kt, float* out_vals, int* out_ids,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch<int8_t, int8_t, true>(q, qscale, c, scales, norms, mask, B, N, D,
                                          tile, num_tiles, kt, out_vals, out_ids, s);
    case 1:
      return launch<__nv_bfloat16, int8_t, false>(q, qscale, c, scales, norms, mask, B, N,
                                                  D, tile, num_tiles, kt, out_vals, out_ids, s);
    case 2:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(q, qscale, c, scales, norms, mask,
                                                         B, N, D, tile, num_tiles, kt,
                                                         out_vals, out_ids, s);
    case 3:
      return launch<float, float, false>(q, qscale, c, scales, norms, mask, B, N, D, tile,
                                         num_tiles, kt, out_vals, out_ids, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core variant (int8 x int8, kt <= 8, D <= 1024, D % 16 == 0);
// same operands as dense_topk_launch's mode 0.  Returns the cudaError_t of
// the launch (0 = success); cudaErrorInvalidValue outside its shapes.
extern "C" int dense_topk_tc_launch(const void* q, const float* qscale, const void* c,
                                    const float* scales, const float* norms,
                                    const uint8_t* mask, int B, int N, int D, int tile,
                                    int num_tiles, int kt, float* out_vals, int* out_ids,
                                    void* stream) {
  return tc::launch(q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles,
                                 kt, out_vals, out_ids, static_cast<cudaStream_t>(stream));
}

// The tensor-core variant with sorted selection: modes 0 (int8 x int8),
// 1 (int8 codes, bf16 queries) and 2 (bf16 x bf16), 1 <= kt <= 128,
// D % 16 == 0; each tile's rows split into `slices` slices of
// `slice_rows` rows (a multiple of 256), the blocks of one cluster
// (slices <= 8, slices * slice_rows >= tile).  `streamed` = 0 holds the
// query block whole in shared memory (D <= 1024); 1 streams its k-slices
// through a ring beside the corpus's (D <= 65536: int32 sums exact), the
// same sums in the same order, so the same bits.  Same operands and output
// as dense_topk_launch.  Returns the cudaError_t of the launch (0 =
// success); cudaErrorInvalidValue outside its shapes.
extern "C" int dense_topk_tcs_launch(int mode, const void* q, const float* qscale, const void* c,
                                     const float* scales, const float* norms,
                                     const uint8_t* mask, int B, int N, int D, int tile,
                                     int num_tiles, int kt, int slices, int slice_rows,
                                     int streamed, float* out_vals, int* out_ids, void* stream) {
  return tcs::launch(mode, q, qscale, c, scales, norms, mask, B, N, D, tile, num_tiles, kt, slices,
                     slice_rows, streamed, out_vals, out_ids, static_cast<cudaStream_t>(stream));
}
