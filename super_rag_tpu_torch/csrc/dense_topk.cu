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
// * dense_topk_tc_kernel, the int8 x int8 mode with register lists, for
//   kt <= 8 at any D (to 65,536) where its work items (a tile against a
//   block of 128 queries) fill the card: the 1M and 10M flat
//   search_hybrid, the reranked batch behind the encoder, each rank's
//   shard, the 1M x 1,536 wide corpus.  Built for Hopper (the design note
//   above namespace tc): a persistent grid of one block an SM walks the
//   work items tile by tile; a producer warp keeps a 6-stage TMA ring of
//   128-byte k-slices (128 queries and 128 corpus rows, 128-byte swizzle,
//   zeros past D and the last row, so any D % 16 == 0 streams the same
//   way) and each chunk's row data (scales, norms, mask) in slots of their
//   own, which a second warp folds (NaN scales for dead rows); two
//   consumer warpgroups of 64 queries each run
//   wgmma.m64n128k32.s32.s8.s8 from shared memory, and take a chunk's
//   scores into their register lists during the next chunk's products
//   (the sums move to a second register array).  The int32 sums are
//   exact; the epilogue takes them in the reference's order (__fmul_rn by
//   qscale, then row_scale, then 2 s - norm, then the mask), so the result
//   is bit-equal to the plain version whatever the block shape.  A thread
//   visits its columns in increasing order, so a new score enters its list
//   only by beating an entry strictly (ties keep the lower column), with
//   selects and no branch; at the item's end the four lanes of a query
//   merge with a fixed xor-shuffle tree.  What bounds it on an H100 (80GB
//   HBM3, 700 W): the epilogue's issue rate (about half a consumer warp's
//   cycles), not the tensor cores or the ring: ~0.9 ms at 1M x 768, B =
//   512 (operation bound 0.40; the mma.sync form it replaces took 2.43),
//   ~9 ms at 10M (bound 3.98; 23.0 before), ~1.45 ms at 1M x 1,536 (bound
//   0.80; the sorted-selection route took 7.7), ~0.21 ms at 1M x 256, B =
//   32 (bytes bound 0.078; 0.38 before): scripts/ab_dense_topk.py,
//   scripts/tune_dense_topk.py and PERF.md §6.
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

// ---- register-list variant: int8 x int8, kt <= 8, any D ---------------------
//
// A persistent grid (a block an SM) walks work items (tile, block of QB
// queries) in tile-major order, each tile in chunks of BN rows.  Warpgroup
// 0 is the producer: one thread keeps a ring of NST stages filled by TMA,
// each stage one 128-byte k-slice of the block's queries and of a chunk's
// rows (128-byte swizzle, zeros past D and past the last row), completing
// on the stage's mbarrier, and loads each chunk's row data (scales, norms,
// mask: [1, N] maps) into one of NM slots, where a second warp folds the
// mask and the tile's end into the scales (NaN for a dead row), aligned
// for the epilogue's paired loads.  Warpgroups 1 and 2 each own 64
// of the block's queries and run wgmma.m64nBNk32.s32.s8.s8 from shared
// memory on every stage.  At a chunk's end its sums move to a second
// register array; the next chunk's first PIECES k-slices are each followed
// by a piece of that chunk's epilogue, so the warps take one chunk's scores
// while the tensor cores work on the next (a wgmma issue blocks while they
// are busy: without the interleaving, products and epilogue take turns).
// The epilogue takes each of a thread's 2 queries x BN/4 columns into its
// two running top-KT register lists, merged over the four lanes of a query
// at the item's end.
//
// ptxas serializes every wgmma of a kernel (each issue waits for the last
// to finish: C7518 in its -v report) where a wgmma, or a read of registers
// that a wgmma in flight may still write, lies on a path it cannot prove
// uniform, or where the accumulators are touched between an issue and its
// wait.  So: every warpgroup issues every product (one of padding queries
// multiplies TMA's zeros; a phase with no k-slice, an A block of zeros),
// the epilogue reads a copy of the sums that no wgmma writes, the pieces
// are unrolled phases (a switch on the k-slice compiles to an indirect
// jump, which counts as divergent), and the epilogue has no branch on the
// launch's flags (absent row data is filled in its slots).
namespace tc {

constexpr int QB = 128;          // queries a work item: 64 a consumer warpgroup
constexpr int KS = 128;          // bytes of a row a ring stage (one swizzle row)
constexpr int THREADS = 384;     // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int CONSUMER_WARPS = 8;
constexpr int NM = 3;            // row-data slots: an epilogue's, the next chunk's, one ahead
constexpr int PIECES = 4;        // an epilogue in pieces, after each of the next chunk's issues
constexpr int MAX_D = 65536;     // int32 sums of any int8 codes exact (D * 128^2 <= 2^30)
constexpr size_t SMEM_MAX = 232448;  // an H100 block's dynamic shared memory
// which row maps a launch has (the rest are absent: scale 1, no norm, all kept)
constexpr int HAS_SCALES = 1, HAS_NORMS = 2, HAS_MASK = 4;

constexpr int BN = 128;          // corpus rows a chunk: the wgmma's N
constexpr int NST = 6;           // ring stages
constexpr int Q_BYTES = QB * KS;
constexpr int STAGE = Q_BYTES + BN * KS;  // 32 KB
// a chunk's row data, from its first row rounded down to 16 (a TMA box
// starts on 16 bytes): two boxes of BN each of mask bytes, scales and
// norms, each array on a 128-byte boundary
constexpr int SLOT = 2 * BN * (1 + 4 + 4);
static_assert(BN % 128 == 0 && BN / 8 % PIECES == 0, "whole pieces, 128-byte row arrays");
// a chunk's row data as the epilogue reads it, from its first row: the
// scales with the mask and the tile's end folded in (NaN for a dead row:
// NaN beats no entry of a list), then the norms
constexpr int FOLDED = 2 * BN * 4;
// a warpgroup's A operand of zeros (64 rows of a k-slice): the product a
// phase with no k-slice to take issues, so that every wgmma is issued on a
// uniform path
constexpr int ZERO_A = 64 * KS;
// 1,024 bytes of slack to put the ring on the swizzle's 1,024-byte period,
// the ring, the zero block, the row-data slots and their folded forms,
// then a full and an empty barrier a stage, and a full, a folded and an
// empty barrier a slot
constexpr size_t SMEM = 1024 + static_cast<size_t>(NST) * STAGE + ZERO_A + NM * (SLOT + FOLDED) +
                        (2 * NST + 3 * NM) * 8;
static_assert(SMEM <= SMEM_MAX, "the ring does not fit a block's shared memory");

// rows of tile t that are scanned: all but the last tile's, tile
__device__ __forceinline__ int tile_rows(int t, int tile, int N) { return min(tile, N - t * tile); }

// (v, c) into a sorted register list whose columns are all below c (a
// thread visits its columns in increasing order): v enters before the
// first entry it beats strictly (an equal value keeps its lower column
// ahead), the entries it beats move down one; -inf enters nowhere.  No
// branch: every slot is a select on the old list's compares.
template <int KT>
__device__ __forceinline__ void list_push(float (&lv)[KT], int (&lc)[KT], float v, int c) {
  bool beat[KT];
#pragma unroll
  for (int i = 0; i < KT; ++i) beat[i] = v > lv[i];
#pragma unroll
  for (int i = KT - 1; i > 0; --i) {
    lv[i] = beat[i - 1] ? lv[i - 1] : (beat[i] ? v : lv[i]);
    lc[i] = beat[i - 1] ? lc[i - 1] : (beat[i] ? c : lc[i]);
  }
  lv[0] = beat[0] ? v : lv[0];
  lc[0] = beat[0] ? c : lc[0];
}

// piece P of a chunk's epilogue: column groups j in [P JP, P JP + JP) of
// `acc`, in the reference's order (__fmul_rn by qscale, then row_scale, then
// 2 s - norm as one fma with two = 2: 2 s is exact; where a launch has no
// scales or norms its slots hold 1 and 0, and two is 1: x 1 and 1 s - 0 are
// exact), from the folded row data (`fs`: the scales, NaN for a dead row,
// whose score then enters no list; `fn`: the norms), a pair of columns a
// load.  Selects, no branch: neighbouring scores overlap, and the reads of
// the accumulators stay on a path ptxas knows is uniform
template <int P, int JP, int KT, int R>
__device__ __forceinline__ void epilogue_piece(const int (&acc)[R], float (&lv)[2][KT],
                                               int (&lc)[2][KT], const float (&qsc)[2],
                                               const float* fs, const float* fn, int r0, int cq,
                                               float two) {
#pragma unroll
  for (int jj = 0; jj < JP; ++jj) {
    const int j = P * JP + jj;
    const float2 r = *reinterpret_cast<const float2*>(fs + 8 * j + cq);
    const float2 nn = *reinterpret_cast<const float2*>(fn + 8 * j + cq);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), qsc[h]),
                            e ? r.y : r.x);
        v = __fmaf_rn(two, v, -(e ? nn.y : nn.x));
        list_push<KT>(lv[h], lc[h], v, r0 + 8 * j + cq + e);
      }
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
dense_topk_tc_kernel(__grid_constant__ const CUtensorMap qmap,
                     __grid_constant__ const CUtensorMap cmap,
                     __grid_constant__ const CUtensorMap smap,
                     __grid_constant__ const CUtensorMap nmap,
                     __grid_constant__ const CUtensorMap mmap, int maps,
                     const float* __restrict__ qscale, int B, int N, int D, int tile,
                     int num_tiles, int kt, float* __restrict__ out_vals,
                     int* __restrict__ out_ids) {
  constexpr int R = BN / 2;             // accumulator registers a thread
  constexpr int JP = BN / 8 / PIECES;   // column groups of 8 a piece
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t ring = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t zero_a = ring + NST * STAGE;  // on the swizzle's period too
  // slot m at rows0 + m SLOT: mask bytes [2 BN], then scales [2 BN], then norms [2 BN]
  const uint32_t rows0 = zero_a + ZERO_A;
  const uint8_t* rows0_ptr = smem + (rows0 - sm90::smem_addr(smem));
  // slot m's folded form at folded0_ptr + m FOLDED / 4: scales [BN], norms [BN]
  float* folded0_ptr = reinterpret_cast<float*>(const_cast<uint8_t*>(rows0_ptr) + NM * SLOT);
  const uint32_t full0 = rows0 + NM * (SLOT + FOLDED);  // stage s's full barrier: full0 + 8 s
  const uint32_t empty0 = full0 + NST * 8;
  const uint32_t rfull0 = empty0 + NST * 8;  // slot m's: rfull0 + 8 m
  const uint32_t rready0 = rfull0 + NM * 8;  // its folded form's
  const uint32_t rempty0 = rready0 + NM * 8;
  const int qblocks = (B + QB - 1) / QB;
  const int items = num_tiles * qblocks;
  const int nks = (D + KS - 1) / KS;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    for (int m = 0; m < NM; ++m) {
      sm90::mbar_init(rfull0 + 8 * m, 1);
      sm90::mbar_init(rready0 + 8 * m, 32);
      sm90::mbar_init(rempty0 + 8 * m, CONSUMER_WARPS);
    }
    sm90::mbar_init_fence();
  }
  // the row arrays a launch does not load hold mask 1, scale 1 and norm 0
  // in every slot, for good; the zero block, seen by the tensor cores
  for (int i = threadIdx.x; i < NM * 2 * BN; i += THREADS) {
    uint8_t* slot = const_cast<uint8_t*>(rows0_ptr) + i / (2 * BN) * SLOT;
    const int k = i % (2 * BN);
    if (!(maps & HAS_MASK)) slot[k] = 1;
    if (!(maps & HAS_SCALES)) reinterpret_cast<float*>(slot + 2 * BN)[k] = 1.0f;
    if (!(maps & HAS_NORMS)) reinterpret_cast<float*>(slot + 10 * BN)[k] = 0.0f;
  }
  for (int i = threadIdx.x; i < ZERO_A / 16; i += THREADS)
    reinterpret_cast<uint4*>(const_cast<uint8_t*>(rows0_ptr) - ZERO_A)[i] = make_uint4(0, 0, 0, 0);
  sm90::fence_proxy_async();
  __syncthreads();

  if (wg == 0) {
    // the producer: the consumers' sequence of slots and stages, item by item
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch_map(&qmap);
      sm90::tma_prefetch_map(&cmap);
      const uint32_t row_bytes = 2 * BN * ((maps & HAS_SCALES ? 4 : 0) +
                                           (maps & HAS_NORMS ? 4 : 0) + (maps & HAS_MASK ? 1 : 0));
      int s = 0, m = 0;
      uint32_t ph = 0, rph = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int t = it / qblocks;
        const int b0 = (it - t * qblocks) * QB;
        const int nch = (tile_rows(t, tile, N) + BN - 1) / BN;
        for (int ch = 0; ch < nch; ++ch) {
          const int row = t * tile + ch * BN;
          sm90::mbar_wait(rempty0 + 8 * m, rph ^ 1);
          const uint32_t slot = rows0 + m * SLOT;
          const uint32_t bar = rfull0 + 8 * m;
          sm90::mbar_arrive_expect_tx(bar, row_bytes);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = (row & ~15) + h * BN;
            if (maps & HAS_MASK) sm90::tma_load_2d(slot + h * BN, &mmap, bar, x, 0);
            if (maps & HAS_SCALES) sm90::tma_load_2d(slot + (2 + 4 * h) * BN, &smap, bar, x, 0);
            if (maps & HAS_NORMS) sm90::tma_load_2d(slot + (10 + 4 * h) * BN, &nmap, bar, x, 0);
          }
          if (++m == NM) {
            m = 0;
            rph ^= 1;
          }
          for (int ks = 0; ks < nks; ++ks) {
            sm90::mbar_wait(empty0 + 8 * s, ph ^ 1);
            const uint32_t st = ring + s * STAGE;
            sm90::mbar_arrive_expect_tx(full0 + 8 * s, STAGE);
            sm90::tma_load_2d(st, &qmap, full0 + 8 * s, ks * KS, b0);
            sm90::tma_load_2d(st + Q_BYTES, &cmap, full0 + 8 * s, ks * KS, row);
            if (++s == NST) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      // the folding warp: each chunk's row data as the epilogue reads it,
      // aligned to the chunk's first row; a row is dead when masked or past
      // the tile's scanned rows
      const int lane = threadIdx.x - 32;
      int m = 0;
      uint32_t rph = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int t = it / qblocks;
        const int rows = tile_rows(t, tile, N);
        const int nch = (rows + BN - 1) / BN;
        for (int ch = 0; ch < nch; ++ch) {
          sm90::mbar_wait(rfull0 + 8 * m, rph);
          const int off = (t * tile + ch * BN) & 15;  // the chunk's first row in its slot
          const uint8_t* mk = rows0_ptr + m * SLOT + off;
          const float* rs = reinterpret_cast<const float*>(rows0_ptr + m * SLOT + 2 * BN) + off;
          const float* rn = rs + 2 * BN;
          float* fs = folded0_ptr + m * (FOLDED / 4);
          for (int c = lane; c < BN; c += 32) {
            fs[c] = mk[c] != 0 && ch * BN + c < rows ? rs[c] : __int_as_float(0x7fc00000);
            fs[BN + c] = rn[c];
          }
          sm90::mbar_arrive(rready0 + 8 * m);
          if (++m == NM) {
            m = 0;
            rph ^= 1;
          }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;  // queries 64 cw .. 64 cw + 63 of the block
    const int ctid = threadIdx.x - 128 * wg;
    const int lane = ctid & 31;
    // this thread's queries qr and qr + 8; its columns of each group of 8:
    // cq and cq + 1 (the wgmma accumulator layout: acc[4 j + 2 h + e] is
    // query qr + 8 h, column 8 j + cq + e)
    const int qr = cw * 64 + (ctid >> 5) * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const uint32_t a_off = cw * (64 * KS);
    const float two = maps & HAS_NORMS ? 2.0f : 1.0f;
    int acc[R], prv[R];  // the products in flight; the last chunk's sums for its epilogue
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = prv[i] = 0;
    float qsc[2];
    float lv[2][KT];
    int lc[2][KT];
    // the lists and query scales of the item whose chunks' epilogues come next
    auto start_item = [&](int b0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + qr + 8 * h;
        qsc[h] = b < B ? qscale[b] : 0.0f;
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          lv[h][i] = -INFINITY;
          lc[h][i] = 0x7fffffff;
        }
      }
    };
    // the four lanes of a query (lane & 3): a fixed xor-shuffle tree; each
    // step takes the partner's whole list before inserting it; then the
    // item's rows of the output
    auto finish_item = [&](int t, int b0) {
#pragma unroll
      for (int mm = 1; mm <= 2; mm <<= 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ov[KT];
          int oc[KT];
#pragma unroll
          for (int i = 0; i < KT; ++i) {
            ov[i] = __shfl_xor_sync(0xffffffffu, lv[h][i], mm);
            oc[i] = __shfl_xor_sync(0xffffffffu, lc[h][i], mm);
          }
#pragma unroll
          for (int i = 0; i < KT; ++i) sm90::list_insert<KT>(lv[h], lc[h], ov[i], oc[i]);
        }
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = b0 + qr + 8 * h;
          if (b < B) {
            const long long out0 = (static_cast<long long>(t) * B + b) * kt;
#pragma unroll
            for (int i = 0; i < KT; ++i) {
              if (i < kt) {
                out_vals[out0 + i] = lv[h][i];
                out_ids[out0 + i] = t * tile + (lv[h][i] == -INFINITY ? 0 : lc[h][i]);
              }
            }
          }
        }
      }
    };

    int s = 0, m = 0;
    uint32_t ph = 0, rph = 0;
    int held = -1;  // the stage whose products may still be reading it
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int t = it / qblocks;
      const int b0 = (it - t * qblocks) * QB;
      const bool active = b0 + cw * 64 < B;  // a warpgroup of padding queries: no epilogue
      const int rows = tile_rows(t, tile, N);
      const int nch = (rows + BN - 1) / BN;
      start_item(b0);
      // chunk ch's products into acc, chunk ch - 1's epilogue from prv in
      // pieces between the issues; a last pass issues nothing and takes the
      // item's last chunk's epilogue.  Every branch here is uniform: a
      // wgmma or an accumulator read that ptxas cannot prove uniform makes
      // it serialize every wgmma of the kernel
      for (int ch = 0; ch <= nch; ++ch) {
        const bool issue = ch < nch, epi = ch > 0;
        const int pm = m == 0 ? NM - 1 : m - 1;  // chunk ch - 1's row-data slot
        const uint32_t prph = m == 0 ? rph ^ 1 : rph;
        const int r0 = (ch - 1) * BN;
        const float* fs = folded0_ptr + pm * (FOLDED / 4);  // its folded row data
        const float* fn = fs + BN;
        // k-slice ks's products, issued by every warpgroup (one of padding
        // queries too: its rows are TMA's zeros) whatever the phase: where
        // there is no k-slice (the pass that only takes an epilogue, or D
        // below PIECES k-slices) on the zero block.  No access to acc between
        // an issue and its wait
        auto issue_stage = [&](int ks, bool real) {
          if (real) sm90::mbar_wait(full0 + 8 * s, ph);
          const uint32_t st = ring + s * STAGE;
          const uint64_t da = sm90::wgmma_desc_sw128(real ? st + a_off : zero_a);
          const uint64_t db = sm90::wgmma_desc_sw128(st + Q_BYTES);
          sm90::fence_regs(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int k = 0; k < KS / 32; ++k)  // + 32 bytes a step: + 2 in the descriptor
            sm90::wgmma_s8_n128(acc, da + 2 * k, db + 2 * k, (ks > 0 || k > 0) ? 1 : 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the held stage's products are done
          sm90::fence_regs(acc);
          if (real) {
            if (held >= 0 && lane == 0) sm90::mbar_arrive(empty0 + 8 * held);
            held = s;
            if (++s == NST) {
              s = 0;
              ph ^= 1;
            }
          }
        };
        // the first PIECES k-slices, each followed by a piece of chunk ch -
        // 1's epilogue (unrolled: a piece's accumulator indices are
        // constants, and a switch would be an indirect jump, which ptxas
        // counts as divergent), then the chunk's other k-slices
        auto phase = [&](auto piece) {
          constexpr int P = decltype(piece)::value;
          issue_stage(P, issue && P < nks);
          if (epi && P == 0) sm90::mbar_wait(rready0 + 8 * pm, prph);
          // a warpgroup of padding queries skips it: prv is no wgmma's
          // register, so this branch costs the pipeline nothing
          if (epi && active) epilogue_piece<P, JP>(prv, lv, lc, qsc, fs, fn, r0, cq, two);
        };
        static_assert(PIECES == 4, "a phase a piece");
        phase(std::integral_constant<int, 0>{});
        phase(std::integral_constant<int, 1>{});
        phase(std::integral_constant<int, 2>{});
        phase(std::integral_constant<int, 3>{});
        for (int ks = PIECES; ks < (issue ? nks : 0); ++ks) issue_stage(ks, true);
        if (epi) {
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(rempty0 + 8 * pm);
        }
        // the chunk's sums are complete: its last stage goes back, and its
        // accumulators move over for its epilogue during the next chunk
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
#pragma unroll
        for (int i = 0; i < R; ++i) prv[i] = acc[i];
        if (issue) {
          if (lane == 0) sm90::mbar_arrive(empty0 + 8 * held);
          held = -1;
          if (++m == NM) {
            m = 0;
            rph ^= 1;
          }
        }
      }
      if (active) finish_item(t, b0);
    }
  }
}

template <int KT>
int launch_kt(const CUtensorMap* m, int maps, int q_box, int c_box, const float* qscale, int B,
              int N, int D, int tile, int num_tiles, int kt, int grid, float* out_vals,
              int* out_ids, cudaStream_t stream) {
  // the maps' boxes are what each stage's and slot's expected bytes count
  if (q_box != QB || c_box != BN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = SMEM;
  auto kern = dense_topk_tc_kernel<KT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], m[4], maps, qscale, B, N, D, tile,
                                        num_tiles, kt, out_vals, out_ids);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* const* maps_in, int q_box, int c_box, const float* qscale, int B, int N,
           int D, int tile, int num_tiles, int kt, int grid, float* out_vals, int* out_ids,
           cudaStream_t s) {
  if (kt < 1 || kt > 8 || D > MAX_D || D % 16 != 0 || B < 1 || N < 1 || tile < 1 ||
      num_tiles != (N + tile - 1) / tile || grid < 1 || maps_in[0] == nullptr ||
      maps_in[1] == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // by value into the kernel's parameters (64-byte aligned copies); an
  // absent row map stays zeros and its bit of `maps` clear
  CUtensorMap m[5];
  memset(m, 0, sizeof(m));
  int maps = 0;
  for (int i = 0; i < 5; ++i) {
    if (maps_in[i] == nullptr) continue;
    memcpy(&m[i], maps_in[i], sizeof(CUtensorMap));
    if (i >= 2) maps |= 1 << (i - 2);  // HAS_SCALES, HAS_NORMS, HAS_MASK
  }
  // lists of 2 for kt <= 2 (the main path's depth), of 8 above
  if (kt <= 2)
    return launch_kt<2>(m, maps, q_box, c_box, qscale, B, N, D, tile, num_tiles, kt, grid,
                        out_vals, out_ids, s);
  return launch_kt<8>(m, maps, q_box, c_box, qscale, B, N, D, tile, num_tiles, kt, grid,
                      out_vals, out_ids, s);
}

// cuTensorMapEncodeTiled from the driver the runtime loaded (no link
// dependency on libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
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

// A tensor map of the register-list variant, written (128 bytes, a
// CUtensorMap) to `map`.  d > 0: a row-major int8 [rows, d] array at
// `base` (d % 16 == 0) in boxes of 128 bytes x box_rows rows with the
// 128-byte swizzle; d = 0: a vector of `rows` elements of elem_bytes (4:
// f32 scales or norms, 1: mask bytes) in boxes of box_rows (a [1, rows]
// matrix: load its boxes at (x, 0)).  Zeros outside
// the array.  `base` 16-byte aligned.  Returns 0, cudaErrorInvalidValue
// outside those shapes, 1000 + the CUresult of a failed encode, or 999
// where the driver has no cuTensorMapEncodeTiled.
extern "C" int dense_topk_tc_map(void* map, const void* base, long long rows, int d,
                                 int elem_bytes, int box_rows) {
  const bool matrix = d > 0;
  if (rows < 1 || rows > 0x7fffffffLL || box_rows < 1 || box_rows > 256 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      (matrix ? (d % 16 != 0 || elem_bytes != 1)
              : ((elem_bytes != 1 && elem_bytes != 4) || box_rows * elem_bytes % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return 999;
  CUtensorMap m;
  CUresult r;
  if (matrix) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(tc::KS), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem_strides[2] = {1, 1};
    r = encode(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
               elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    // a [1, rows] matrix: the driver refuses rank-1 maps with no strides;
    // the one stride (16-byte multiple) is never stepped
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(rows), 1};
    const cuuint64_t strides[1] = {(static_cast<cuuint64_t>(rows) * elem_bytes + 15) / 16 * 16};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t elem_strides[2] = {1, 1};
    r = encode(&m, elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
               2, const_cast<void*>(base), dims, strides, box, elem_strides,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  memcpy(map, &m, sizeof(CUtensorMap));
  return 0;
}

// The register-list variant (int8 x int8, 1 <= kt <= 8, D % 16 == 0, D <=
// 65536).  Tensor maps from dense_topk_tc_map: qmap, the queries [B, D]
// (q_box = 128 rows a box); cmap, the corpus's first N rows (c_box = the
// chunk's rows, 256); smap, nmap, mmap, the row scales, norms (L2) and
// mask bytes of those rows in boxes of c_box, each null where absent.
// The rest as dense_topk_launch's mode 0, and `grid` blocks walking the
// ceil(B / 128) x num_tiles work items.  Returns the cudaError_t of the
// launch (0 = success); cudaErrorInvalidValue outside its shapes or for
// boxes other than the kernel's.
extern "C" int dense_topk_tc_launch(const void* qmap, const void* cmap, const void* smap,
                                    const void* nmap, const void* mmap, int q_box, int c_box,
                                    const float* qscale, int B, int N, int D, int tile,
                                    int num_tiles, int kt, int grid, float* out_vals,
                                    int* out_ids, void* stream) {
  const void* maps[5] = {qmap, cmap, smap, nmap, mmap};
  return tc::launch(maps, q_box, c_box, qscale, B, N, D, tile, num_tiles, kt, grid, out_vals,
                    out_ids, static_cast<cudaStream_t>(stream));
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
