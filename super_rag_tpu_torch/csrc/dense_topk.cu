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
// What bounds it on an H100: the corpus read (N x D bytes in int8, ~0.77 GB
// at 1M x 768: 0.23 ms at 3.35 TB/s) at small batches, and the int8 work
// (2 B N D operations: 0.40 ms at 1,979 TOP/s) at batch 512.
//
// Two variants, chosen by shape in the wrapper (ops/dense_topk.py
// kernel_variant), each with its own launch counter:
//
// * dense_topk_tc_kernel, the int8 x int8 mode (the flat search_hybrid's)
//   for kt <= 8 and D <= 1024, on the int8 tensor cores:
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
// * dense_topk_kernel, every other mode and kt (bf16 / f32 queries, which
//   search_dense and calibration run, and kt > 8): the first version, dp4a
//   or FMA on CUDA cores from shared memory with a 4 x 4 register tile per
//   thread and the [16 x tile] score tile in shared memory.
//
// Modes (dense_topk_launch):
//   int8 x int8 : q int8 [B, D] + qscale f32 [B]; corpus int8
//   int8 corpus, bf16 queries; bf16 corpus, bf16 queries; f32 x f32.
// Requirements checked by the Python wrapper: D % 16 == 0, 16-byte aligned
// row-major operands, tile <= 2048 (SIMT variant).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
