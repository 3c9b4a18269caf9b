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
// Two kernels, both on the tensor cores, chosen by shape in the wrapper
// (ops/dense_topk.py kernel_variant), counted by the wrapper per route and
// mode:
//
// * dense_topk_tcs_kernel, every mode at every kt and any D to 65,536
//   (every bf16 and f32 collection, the served searches, calibration,
//   deep per-tile lists, search_dense(k > 128) at the exact per-tile
//   depth, int8 calls too small to fill the card, remote embeddings of
//   1,536 to 4,096 dimensions), in one form at every D.  Built for
//   Hopper (the design note above namespace tcs): a block of 16, 64 or
//   128 queries (the wgmma's N) against a slice of a tile in chunks of
//   128 corpus rows (the wgmma's M, 64 a consumer warpgroup); a producer warp keeps a TMA ring of 128-byte k-slices of
//   the rows and the queries; wgmma.m64nNk32.s8 (int8 x int8),
//   m64nNk16.bf16 with f32 sums (bf16 queries on bf16 rows, or on int8
//   codes widened exactly to bf16 in shared memory), or, for f32, three
//   m64nNk8.tf32 products a k8 step on round-to-nearest tf32 planes (x = hi
//   + lo: hi x hi + hi x lo + lo x hi, each product exact, f32 sums; the
//   rows' planes made in registers from the ring, the queries' by
//   sm90::tf32_planes_kernel first); the epilogued scores
//   go to a buffer of their own, while the ring keeps loading, from which
//   the consumers' threads keep each query's kt best in register lists
//   (kt <= 8), or twelve warps merge the few scores above a query's
//   list's kt-th into its sorted list by rank (kt <= 128); deeper (the
//   deep selection) the block keeps its slice's scores whole and a warp a
//   query takes them to its kt best at the end: a radix select of the
//   kt-th key, a compaction, a bitonic sort.  Where the tiles alone
//   would leave SMs idle, each tile's rows split over up to 8 blocks of a
//   cluster, whose lists merge through distributed shared memory.  What
//   bounds it: at scale (1M x 768 bf16 at B = 512: 1.9 ms on an H100
//   against the tensor cores' 0.81) the L2 stream of the k-slices (each
//   128-row chunk re-reads the query block) and the epilogue and
//   selection, which the products do not overlap; at the served shapes
//   (16,384 x 256 at B = 64; 8,224 x 1,536 at B = 1: 19-52 us) the
//   launch, the ring's latency and the selection of a slice's first
//   chunk, not bytes or tensor operations (scripts/ab_dense_topk.py,
//   PERF.md §6).  In f32 (1M x 768 at B = 512: ~7.1 ms against the three
//   products' 4.77) the ring's depth: a stage of 128 queries' two planes
//   and 128 rows is 48 KB, and three fit beside the scores and register
//   lists (with two it took 9.3 ms; the sorted lists, kt > 8, leave room
//   for two).  No split of
//   D and a k loop whose order is fixed by D alone: a query's sums are the
//   same bits alone or in any batch and any split; the selection is exact,
//   so int8 x int8 is bit-equal to the plain version.
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
//
// Modes (dense_topk_tcs_launch):
//   0 int8 x int8 : q int8 [B, D] + qscale f32 [B]; corpus int8
//   1 int8 corpus, bf16 queries; 2 bf16 corpus, bf16 queries; 3 f32 x f32.
// Requirements checked by the Python wrapper: D % 16 == 0, 16-byte aligned
// row-major operands; the launches refuse the rest
// (cudaErrorInvalidValue).  What bounds the work at its largest: the
// corpus read (N x D bytes in int8, ~0.77 GB at 1M x 768: 0.23 ms at 3.35
// TB/s) at small batches, and the int8 work (2 B N D operations: 0.40 ms
// at 1,979 TOP/s) at batch 512.

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
            sm90::wgmma_s8<128>(acc, da + 2 * k, db + 2 * k, (ks > 0 || k > 0) ? 1 : 0);
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
// Every mode (int8 x int8 on wgmma m64nNk32 s8; bf16 queries on bf16 rows,
// or on int8 codes widened exactly to bf16, on m64nNk16 bf16 with f32 sums;
// f32 on three m64nNk8 tf32 products, below), every kt, any D to 65,536,
// and a tile's rows split over the blocks of one cluster.
//
// The f32 mode (3).  One TF32 product keeps 11 significant bits, too few
// for the float modes' tolerance (D 2^-23 (max|s| + 1)); three keep it.
// Each operand splits into two tf32 planes, x = h + l with h =
// tf32_rna(x), l = x - h (exact) and l' = tf32_rna(l), and x y ~ h g + h
// m' + l' g: the products are exact, what is dropped (l m, and the
// roundings of l and m) is at most ~3 2^-22 |x||y|, so a sum is within ~3
// 2^-22 sum |x_i||y_i| plus its f32 accumulation.  The rows' planes are
// made in the consumers' registers from each ring stage (wgmma with A from
// registers: no buffer to rewrite, so no wait for the products before
// it); the queries' are a [2B, D] array made once a call, whose hi and lo
// boxes a stage holds side by side.  A k-slice holds 32 f32: four k8 steps
// of three products each, committed step by step, so that a step's
// registers are rewritten only after the wait that covers the step before
// it.
//
// A block takes QN queries (16, 64 or 128: the wgmma's N, chosen by the
// batch and the shared-memory budget) against one slice of one tile, in
// chunks of R = 128 corpus rows (the wgmma's M: 64 rows a consumer
// warpgroup).  Warp 12 keeps a ring of `nst` stages filled by TMA, each one
// 128-byte k-slice of the chunk's rows and of the query block (128-byte
// swizzle; zeros past D and past the last row, so any D % 16 == 0 streams
// the same way, and a query's k order is fixed by D alone).  Consumer
// warpgroups 0 and 1 run wgmma from shared memory on every stage (mode 1
// first widens its 64 rows' codes into a bf16 buffer of its own:
// s8x4_to_bf16x2, exact; mode 3 takes its rows' planes as A from
// registers), then take the chunk's epilogue in the
// reference's order (__fmul_rn by qscale, then the row scale, then 2 s -
// norm as one fma with two = 2; a dead row's scale is NaN, so its score
// enters no list) into a score buffer [QN][SR] that does not alias the
// ring, so the loads run on during the selection.  At kt <= 8 the
// consumers' 256 threads, 256 / QN a query, keep the 2 (kt <= 2) or 8 best
// of their share of the chunks in registers (a thread visits its columns
// in increasing order, so a score enters only by beating an entry
// strictly), merged by a xor-shuffle tree at the slice's end.  Deeper lists are kept sorted in
// shared memory: the consumers' threads flag the queries one of whose
// scores beats the query's list's kt-th by value (the list holds lower
// columns only, so an equal value keeps its place): the skip test of a
// chunk none of whose keys beats the kt-th, which most chunks of a slice
// pass.  The 12 warps other than the producer take the flagged queries in
// turn, a lane four of the chunk's scores, and keep the survivors.  The survivors are sorted (by counting, or a bitonic network of
// the chunk's 128 where more than 32 survive, as in a slice's first chunk)
// and merged into the sorted list by rank: each key's place is its index
// plus the number of keys above it in the other list (binary searches).
// At the slice's end the S blocks of a tile (a cluster along z) merge
// their lists: block r copies the lists of queries q = r (mod S) from
// every block's shared memory, then merges them in slice order.  The
// top-kt of a union under a strict total order is the same whatever the
// split, so the result depends on the logical tile only.
//
// The deep selection (kt > 128, the first version's SIMT route: kt
// serial rounds of max / suppress a query, 0.82 ms at 16,384 x 256 f32,
// B = 64, kt 129 on an H100).  The sorted lists would need kp keys a
// query (up to 2,048) and merge copies of (QN + 8) kp keys, so instead
// the block keeps its whole slice's scores ([QN][slice_rows + 4] f32:
// 128 KB at 16 queries x 2,048 rows), each chunk's epilogue writing its
// own columns, with no selection and no barrier during the scan.  At the
// end, split, block r copies the slices' scores of the queries it owns
// from every block of the cluster (a tile row in tile order) over its
// ring; then a warp a query runs select_deep on the tile's row (radix
// select of the kt-th key, compaction, bitonic sort), as many warps at
// once as the sort buffers fit in the ring (and, split, the block's own
// scores).  The geometry (ops/dense_topk.py tcs_deep_geometry) takes the
// sorted lists' query block and split where they fit, else more or fewer
// slices, at 16 or 64 queries a block (its own forms, DEEP: the sorted
// lists' forms keep their registers).  The same epilogue's bits are
// selected under the same order, so a query's list at kt 129 begins with
// its kt-128 list.  The int32 sums
// are exact; the float modes' f32 sums run through the same wgmma steps in
// the same order for a query in any batch.
namespace tcs {

constexpr int R = 128;              // corpus rows a chunk: the wgmma's M, 64 a consumer warpgroup
constexpr int KS = 128;             // bytes of a row a k-slice (one 128-byte swizzle row)
constexpr int SR = R + 4;           // score row stride (floats): conflict-free stores, float4 reads
constexpr int WARPS = 13;           // warpgroups 0 and 1 compute, all but warp 12 select; 12 loads
constexpr int THREADS = 32 * WARPS;
constexpr int CONSUMER_WARPS = 8;
constexpr int WORKERS = 12;         // warps that select: the 8 consumers and 4 more
constexpr int E = 8;                // keys a lane in the lists' merge
constexpr int LIST = 8;             // kt <= LIST: register lists (of 2 or 8) in the consumers' threads
constexpr int MAX_KT = 128;         // sorted lists; deeper kt: the deep selection (select_deep)
constexpr int MAX_SLICES = 8;       // a portable cluster
constexpr int MAX_STAGES = 4;
constexpr int MAX_D = 65536;        // int32 sums of any int8 codes exact (D * 128^2 <= 2^30)
constexpr int HALF = 64 * KS;       // mode 1: 64 rows x 64 bf16, one swizzled half of a k-slice
constexpr int WIDE = 2 * 2 * HALF;  // mode 1: both warpgroups' widened codes
constexpr size_t SMEM_MAX = 232448;  // an H100 block's dynamic shared memory

using u64 = unsigned long long;

// a ring stage: a k-slice of the chunk's R rows (128 codes, 64 bf16 or 32
// f32) and of the block's qn queries (mode 1: 128 bf16 in two 64-element
// boxes; mode 3: 32 f32 of each of the queries' two tf32 planes)
__host__ __device__ constexpr int stage_bytes(int mode, int qn) {
  return R * KS + (mode == 1 || mode == 3 ? 2 : 1) * qn * KS;
}

__host__ __device__ inline int kp_of(int kt) {
  int kp = E;
  while (kp < kt) kp <<= 1;
  return kp;
}

// kt above MAX_KT: the block keeps its slice's scores whole and selects
// each query's kt best once the scan is done (select_deep)
__host__ __device__ inline bool deep(int kt) { return kt > MAX_KT; }

// the deep selection's sort buffer: min(kt, tile) keys rounded up to a
// power of two, at least 256 (a warp's registers' 8 a lane)
__host__ __device__ inline int deep_kp(int kt, int tile) {
  const int kp = kp_of(kt < tile ? kt : tile);
  return kp < 256 ? 256 : kp;
}

// the selecting warps' scratch, 128 keys a warp: only the sorted lists
// above the register lists (LIST < kt <= MAX_KT) merge through it
__host__ __device__ inline int scratch_keys(int kt) {
  return kt > LIST && !deep(kt) ? WORKERS * R : 0;
}

// the score buffer's row stride (floats): a chunk's (SR), or in the deep
// selection the whole slice's (slice_rows + 4: conflict-free stores, rows
// 16-byte aligned)
__host__ __device__ inline int score_stride(int kt, int slice_rows) {
  return deep(kt) ? slice_rows + 4 : SR;
}

// 1,024 bytes of slack to put the ring on the swizzle's 1,024-byte period,
// the ring, mode 1's widened codes, the scores [qn][score_stride] f32, the
// sorted lists [qn][kp] (none in the deep selection), the selecting warps'
// scratch, the queries' thresholds, scales and flags, and a full and an
// empty barrier a stage
__host__ __device__ inline size_t smem_bytes(int mode, int qn, int kt, int nst, int slice_rows) {
  return 1024 + static_cast<size_t>(nst) * stage_bytes(mode, qn) + (mode == 1 ? WIDE : 0) +
         static_cast<size_t>(qn) * score_stride(kt, slice_rows) * 4 +
         (deep(kt) ? 0 : static_cast<size_t>(qn) * kp_of(kt) * 8) +
         static_cast<size_t>(scratch_keys(kt)) * 8 + static_cast<size_t>(qn) * 12 +
         static_cast<size_t>(nst) * 16;
}

// the merge copies the lists of a block's queries from every block of the
// cluster, (qn + MAX_SLICES) x kp keys at most, over the ring, the
// widened codes and the scores
__host__ __device__ inline bool merge_fits(int mode, int qn, int kt, int nst) {
  return static_cast<size_t>(qn + MAX_SLICES) * kp_of(kt) * 8 <=
         static_cast<size_t>(nst) * stage_bytes(mode, qn) + (mode == 1 ? WIDE : 0) +
             static_cast<size_t>(qn) * SR * 4;
}

// the deep selection's room once the scan is done.  Split over a cluster
// (slices > 1), a block first copies the scores of the queries it owns
// (ceil(qn / slices) of them) from every block of the cluster, over its
// ring and widened codes (its own scores are still being read); then each
// selecting warp takes a sort buffer of kp keys (deep_warp_bytes; its
// radix histogram lies over the buffer's start before the keys are
// written) after the copies, in the ring, the widened codes and, split,
// its own scores.  At least one warp must find room
__host__ __device__ inline size_t deep_gather_bytes(int qn, int slices, int slice_rows) {
  return slices > 1 ? static_cast<size_t>((qn + slices - 1) / slices) * slices * slice_rows * 4
                    : 0;
}

__host__ __device__ inline size_t deep_warp_bytes(int kt, int tile) {
  return static_cast<size_t>(deep_kp(kt, tile)) * 8;
}

__host__ __device__ inline size_t deep_region_bytes(int mode, int qn, int nst, int slices,
                                                    int slice_rows) {
  return static_cast<size_t>(nst) * stage_bytes(mode, qn) + (mode == 1 ? WIDE : 0) +
         (slices > 1 ? static_cast<size_t>(qn) * (slice_rows + 4) * 4 : 0);
}

__host__ __device__ inline bool deep_fits(int mode, int qn, int kt, int tile, int nst, int slices,
                                          int slice_rows) {
  const size_t gather = deep_gather_bytes(qn, slices, slice_rows);
  return gather <= static_cast<size_t>(nst) * stage_bytes(mode, qn) + (mode == 1 ? WIDE : 0) &&
         gather + deep_warp_bytes(kt, tile) <=
             deep_region_bytes(mode, qn, nst, slices, slice_rows);
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

// the upper half of make_key: a score's value as an unsigned key in the
// reference's order, 0 for -inf and for NaN (a dead row's score)
__device__ __forceinline__ uint32_t value_key(float v) {
  if (!(v > -INFINITY)) return 0u;
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A bitonic stage over a warp's 256 keys in registers, element i = base +
// 32 j + lane in k[j]: pairs (i, i ^ d), the lower keeping the larger key
// where i & kk == 0 (kk: the length of the runs being built), across
// lanes by shuffles (d < 32) or within a lane (d = 32, 64, 128)
template <int DJ>
__device__ __forceinline__ void wide_in_lane(u64 (&k)[8], int kk, int base, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if ((j & DJ) == 0) {
      const bool desc = ((base + 32 * j + lane) & kk) == 0;
      const u64 a = k[j], b = k[j | DJ];
      if (desc ? a < b : a > b) {
        k[j] = b;
        k[j | DJ] = a;
      }
    }
  }
}

__device__ __forceinline__ void wide_stage(u64 (&k)[8], int kk, int d, int base, int lane) {
  if (d >= 32) {
    if (d == 32)
      wide_in_lane<1>(k, kk, base, lane);
    else if (d == 64)
      wide_in_lane<2>(k, kk, base, lane);
    else
      wide_in_lane<4>(k, kk, base, lane);
    return;
  }
  const bool lower = (lane & d) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const u64 o = __shfl_xor_sync(0xffffffffu, k[j], d);
    const bool desc = ((base + 32 * j + lane) & kk) == 0;
    k[j] = (o > k[j]) == (lower == desc) ? o : k[j];
  }
}

// keys[0 .. m) (m a power of two >= 256) sorted descending by one warp:
// each 256-key block sorted in registers (its runs' directions those of
// the whole network), then each merge level's stages of d >= 256 across
// the buffer in shared memory and its stages of d < 256 block by block
// in registers; loads and stores lane by lane, conflict-free
__device__ __forceinline__ void sort_keys(u64* keys, int m, int lane) {
  // levels 2 .. 256: each 256-key block in registers
  for (int base = 0; base < m; base += 256) {
    u64 k[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = keys[base + 32 * j + lane];
    for (int kk = 2; kk <= 256; kk <<= 1)
      for (int d = kk >> 1; d > 0; d >>= 1) wide_stage(k, kk, d, base, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) keys[base + 32 * j + lane] = k[j];
  }
  __syncwarp();
  // levels 512 .. m: pair (lo, lo + d), lo with a zero at bit d
  for (int kk = 512; kk <= m; kk <<= 1) {
    for (int d = kk >> 1; d >= 256; d >>= 1) {
      for (int i = lane; i < m / 2; i += 32) {
        const int lo = 2 * i - (i & (d - 1));
        const u64 a = keys[lo], b = keys[lo + d];
        if ((lo & kk) == 0 ? a < b : a > b) {
          keys[lo] = b;
          keys[lo + d] = a;
        }
      }
      __syncwarp();
    }
    for (int base = 0; base < m; base += 256) {
      u64 k[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) k[j] = keys[base + 32 * j + lane];
      for (int d = 128; d > 0; d >>= 1) wide_stage(k, kk, d, base, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) keys[base + 32 * j + lane] = k[j];
    }
    __syncwarp();
  }
}

// The deep selection (kt > MAX_KT), a warp a query: the n scores of `row`
// (a tile's columns 0 .. n - 1, in shared memory) to the query's kt best,
// sorted, into out_vals / out_ids (base + column; (-inf, base) past the
// live keys).  With at most kt live keys, all of them; else first the
// kt-th value key exactly, by a radix select from the top, 8 bits a pass:
// a histogram (`hist`, 256 counters, over the start of `keys`) of the keys
// that share the bits found so far, warp-aggregated (__match_any_sync),
// then the bin that holds the kt-th; `need` is then how many keys of that
// value to take, lowest columns first.  Then one pass in column order
// compacts the keys above it and the first `need` equal to it into `keys`
// (ballots keep the order), and a bitonic network sorts them (sort_keys:
// a power of two >= the count, at least 256; `keys` holds deep_kp).  O(n)
// work a query, spread over the lanes, in place of kt serial rounds of
// the first version's max / suppress
__device__ __noinline__ void select_deep(const float* row, int n, int kt, u64* keys,
                                         uint32_t* hist, int lane, float* out_vals,
                                         int* out_ids, long long base) {
  const unsigned below = (1u << lane) - 1u;
  uint32_t prefix = 0u, need = static_cast<uint32_t>(kt);
  int live = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    live += __popc(__ballot_sync(0xffffffffu, c < n && value_key(row[c]) != 0u));
  }
  const bool all = live <= kt;  // at most kt live keys: take them all
  for (int p = 0; p < 4 && !all; ++p) {
    const int shift = 24 - 8 * p;
    const uint32_t hmask = p == 0 ? 0u : ~0u << (shift + 8);
    for (int i = lane; i < 256; i += 32) hist[i] = 0u;
    __syncwarp();
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int c = c0 + lane;
      const uint32_t vk = c < n ? value_key(row[c]) : 0u;
      const bool in = vk != 0u && (vk & hmask) == prefix;
      const unsigned act = __ballot_sync(0xffffffffu, in);
      if (in) {
        const uint32_t dg = (vk >> shift) & 255u;
        const unsigned peers = __match_any_sync(act, dg);
        if ((peers & below) == 0u) atomicAdd(hist + dg, static_cast<uint32_t>(__popc(peers)));
      }
    }
    __syncwarp();
    // lane l holds bins 8 l .. 8 l + 7; incl: the keys in bins 8 l and up
    uint32_t h[8], sum = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = hist[8 * lane + j];
      sum += h[j];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t up = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += up;
    }
    // the lane whose bins hold the need-th key from the top, then its bin
    const uint32_t above = incl - sum;
    const bool mine = above < need && need <= incl;
    const int src = __ffs(__ballot_sync(0xffffffffu, mine)) - 1;
    int dg = -1;
    uint32_t left = 0u, acc = above;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (dg < 0 && acc + h[j] >= need) {
        dg = 8 * lane + j;
        left = need - acc;
      }
      acc += h[j];
    }
    dg = __shfl_sync(0xffffffffu, dg, src);
    need = __shfl_sync(0xffffffffu, left, src);
    prefix |= static_cast<uint32_t>(dg) << shift;
    __syncwarp();  // every lane has read the histogram (the keys overwrite it)
  }
  // the kept keys in column order: above the kt-th value, then the first
  // `need` equal to it
  int cnt = 0;
  uint32_t eq_seen = 0u;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    const uint32_t vk = c < n ? value_key(row[c]) : 0u;
    bool take;
    if (all) {
      take = vk != 0u;
    } else {
      const bool eq = vk == prefix;
      const unsigned be = __ballot_sync(0xffffffffu, eq);
      take = vk > prefix || (eq && eq_seen + __popc(be & below) < need);
      eq_seen += __popc(be);
    }
    const unsigned bt = __ballot_sync(0xffffffffu, take);
    if (take)
      keys[cnt + __popc(bt & below)] = (static_cast<u64>(vk) << 32) | static_cast<uint32_t>(~c);
    cnt += __popc(bt);
  }
  int m = 256;
  while (m < cnt) m <<= 1;
  for (int i = cnt + lane; i < m; i += 32) keys[i] = 0ull;
  __syncwarp();
  sort_keys(keys, m, lane);
  for (int i = lane; i < kt; i += 32) {
    const u64 k = i < cnt ? keys[i] : 0ull;
    out_vals[i] = k == 0ull ? -INFINITY : key_value(k);
    out_ids[i] = static_cast<int>(base + (k == 0ull ? 0 : key_col(k)));
  }
  __syncwarp();  // the keys are rewritten by the warp's next query
}

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
      k[j] = (o > k[j]) == (lower == desc) ? o : k[j];
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

// the number of keys of a[0 .. len) above x: a sorted descending, its
// keys distinct but the empty ones at its end
__device__ __forceinline__ int count_above(const u64* a, int len, u64 x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// the warp's 128 keys (element 4 lane + j in k[j]) sorted descending: a
// bitonic network, pairs across lanes by shuffles
__device__ __forceinline__ void sort128(u64 (&k)[4], int lane) {
#pragma unroll
  for (int kk = 2; kk <= 128; kk <<= 1) {
#pragma unroll
    for (int d = kk >> 1; d > 0; d >>= 1) {
      if (d >= 4) {
        const int m = d >> 2;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const u64 o = __shfl_xor_sync(0xffffffffu, k[j], m);
          const bool desc = ((4 * lane + j) & kk) == 0;
          // keep the larger where lower == desc (the keys are distinct
          // but the empty ones, which are equal anyway)
          k[j] = (o > k[j]) == (lower == desc) ? o : k[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((j & d) == 0) {
            const bool desc = ((4 * lane + j) & kk) == 0;
            const u64 x = k[j], y = k[j | d];
            if (desc ? x < y : x > y) {
              k[j] = y;
              k[j | d] = x;
            }
          }
        }
      }
    }
  }
}

// a warp: the chunk's 128 scores of one query (srow, columns c0 ..) into
// its sorted list L of kt keys (zeros empty) and its threshold, the value
// of L's kt-th key (-inf while L is not full).  A score survives only by
// beating the threshold (L holds lower columns only); the survivors,
// sorted in scr (128 keys: by counting up to 32, else a bitonic network),
// and L merge by rank.  Only kt > 8 comes here: the register lists take
// the rest
__device__ __forceinline__ void select_chunk(const float* srow, u64* L, float* thr_q, int kt,
                                             int c0, int lane, u64* scr) {
  const float4 v4 = *reinterpret_cast<const float4*>(srow + 4 * lane);
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  const float thr = *thr_q;
  u64 k[4];
  unsigned bal[4];
  int s = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool p = v[e] > thr;
    k[e] = p ? make_key(v[e], c0 + 4 * lane + e) : 0ull;
    bal[e] = __ballot_sync(0xffffffffu, p);
    s += __popc(bal[e]);
  }
  if (s == 0) return;
  if (s <= 32) {
    // compacted, then sorted by counting (the keys are distinct)
    const unsigned below = (1u << lane) - 1u;
    int base = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k[e] != 0ull) scr[base + __popc(bal[e] & below)] = k[e];
      base += __popc(bal[e]);
    }
    __syncwarp();
    const u64 x = lane < s ? scr[lane] : 0ull;
    int r = 0;
    for (int i = 0; i < s; ++i) r += scr[i] > x;
    __syncwarp();
    if (lane < s) scr[r] = x;
  } else {
    sort128(k, lane);  // the empty keys sink to the end
    if (L[0] == 0ull) {
      // an empty list (a slice's first chunk): the sorted keys are its kt
      // best, written in place
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * lane + j < kt) L[4 * lane + j] = k[j];
      __syncwarp();
      if (lane == 0) {
        const u64 y = L[kt - 1];
        *thr_q = y != 0ull ? key_value(y) : -INFINITY;
      }
      __syncwarp();
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) scr[4 * lane + j] = k[j];
  }
  __syncwarp();
  // each key's place in the merged list: its index plus the keys above it
  // in the other list; those at kt or beyond drop out
  const int sl = min(s, kt);
  u64 ly[4], cx[4];
  int lp[4], cp[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = lane + 32 * r;
    ly[r] = i < kt ? L[i] : 0ull;
    lp[r] = ly[r] != 0ull ? i + count_above(scr, s, ly[r]) : kt;
    cx[r] = i < sl ? scr[i] : 0ull;
    cp[r] = cx[r] != 0ull ? i + count_above(L, kt, cx[r]) : kt;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (lp[r] < kt) L[lp[r]] = ly[r];
    if (cp[r] < kt) L[cp[r]] = cx[r];
  }
  __syncwarp();
  if (lane == 0) {
    const u64 y = L[kt - 1];
    *thr_q = y != 0ull ? key_value(y) : -INFINITY;
  }
  __syncwarp();
}

// mode 1: a warpgroup's 64 rows (64 wg ..) of a stage's 128 codes (a
// 128-byte swizzled row each) as bf16 in `wide`: two 64 x 128-byte halves
// (k 0-63, 64-127) in the layout a TMA load with the 128-byte swizzle leaves
__device__ __forceinline__ void widen(const uint8_t* codes, uint8_t* wide, int wg, int ctid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = ctid + 128 * i;  // 16 codes: row r, 16-byte unit c
    const int r = u >> 3, c = u & 7;
    const int rr = 64 * wg + r;
    const uint4 v = *reinterpret_cast<const uint4*>(codes + rr * KS + ((c ^ (rr & 7)) << 4));
    uint32_t o[8];
    sm90::s8x4_to_bf16x2(v.x, o[0], o[1]);
    sm90::s8x4_to_bf16x2(v.y, o[2], o[3]);
    sm90::s8x4_to_bf16x2(v.z, o[4], o[5]);
    sm90::s8x4_to_bf16x2(v.w, o[6], o[7]);
    uint8_t* dst = wide + (c >> 2) * HALF + r * KS;
    const int u0 = (2 * c) & 7;  // its two 16-byte units in the half's row
    *reinterpret_cast<uint4*>(dst + ((u0 ^ (r & 7)) << 4)) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + (((u0 + 1) ^ (r & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// kt <= L: a thread's share of a chunk's row of scores (every PARTS-th
// group of four columns from `part`, columns c0 ..) into its register list
// of the L best.  It visits its columns in increasing order, so a score
// enters only by beating an entry strictly, and only a group with a score
// above the list's kt-th (thr) is pushed: what it skips could only take
// places past kt
template <int L, int PARTS>
__device__ __forceinline__ void scan_row(float (&lv)[L], int (&lc)[L], float& thr,
                                         const float* row, int c0, int part, int kt) {
  for (int g = part; g < R / 4; g += PARTS) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * g);
    if (fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)) > thr) {
      tc::list_push<L>(lv, lc, v.x, c0 + 4 * g);
      tc::list_push<L>(lv, lc, v.y, c0 + 4 * g + 1);
      tc::list_push<L>(lv, lc, v.z, c0 + 4 * g + 2);
      tc::list_push<L>(lv, lc, v.w, c0 + 4 * g + 3);
#pragma unroll
      for (int i = 0; i < L; ++i) thr = i == kt - 1 ? lv[i] : thr;
    }
  }
}

// a query's PARTS lists (lanes of one warp) merged by a fixed xor-shuffle
// tree, then, by its part 0, its kt best into its sorted list L as keys
template <int L, int PARTS>
__device__ __forceinline__ void finish_rows(float (&lv)[L], int (&lc)[L], u64* list, bool first,
                                            int kt) {
#pragma unroll
  for (int mm = 1; mm < PARTS; mm <<= 1) {
    float ov[L];
    int oc[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      ov[i] = __shfl_xor_sync(0xffffffffu, lv[i], mm);
      oc[i] = __shfl_xor_sync(0xffffffffu, lc[i], mm);
    }
#pragma unroll
    for (int i = 0; i < L; ++i) sm90::list_insert<L>(lv, lc, ov[i], oc[i]);
  }
  if (first) {
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (i < kt) list[i] = make_key(lv[i], lc[i]);
  }
}

template <int MODE, int QN, typename Acc>
__device__ __forceinline__ void mma(Acc (&acc)[QN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (MODE == 0)
    sm90::wgmma_s8<QN>(acc, da, db, scale_d);
  else
    sm90::wgmma_bf16<QN>(acc, da, db, scale_d);
}

template <int MODE, int QN, bool DEEP>
__global__ void __launch_bounds__(THREADS, 1)
dense_topk_tcs_kernel(__grid_constant__ const CUtensorMap qmap,
                      __grid_constant__ const CUtensorMap cmap,
                      const float* __restrict__ qscale, const float* __restrict__ scales,
                      const float* __restrict__ norms, const uint8_t* __restrict__ mask,
                      int B, int N, int D, int tile, int kt, int kp, int nst, int slice_rows,
                      float* __restrict__ out_vals, int* __restrict__ out_ids) {
  namespace cg = cooperative_groups;
  using Acc = typename std::conditional<MODE == 0, int, float>::type;
  constexpr int NR = QN / 2;  // accumulator registers a thread
  constexpr int STAGE = stage_bytes(MODE, QN);
  constexpr int Q_OFF = R * KS;  // a stage's query box(es), after its rows
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (sm90::smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = sm90::smem_addr(smem);
  uint8_t* wide = smem + nst * STAGE;
  // DEEP (kt > MAX_KT, a form of its own, QN 16 or 64): the slice's scores
  // kept whole and selected at the end
  constexpr bool dp = DEEP;
  const int sp = DEEP ? slice_rows + 4 : SR;
  float* scores = reinterpret_cast<float*>(wide + (MODE == 1 ? WIDE : 0));  // [QN][sp]
  u64* lists = reinterpret_cast<u64*>(scores + QN * sp);  // [QN][kp] (none in the deep selection)
  u64* scratch = lists + (dp ? 0 : QN * kp);              // [WORKERS][R] (LIST < kt <= MAX_KT)
  float* thr = reinterpret_cast<float*>(scratch + scratch_keys(kt));  // [QN]
  float* qsc = thr + QN;                                                    // [QN]
  int* flag = reinterpret_cast<int*>(qsc + QN);  // [QN]: a score of the chunk beats the list
  const uint32_t full0 = sm90::smem_addr(flag + QN);  // stage s's full barrier: full0 + 8 s
  const uint32_t empty0 = full0 + 8 * nst;
  u64* gathered = reinterpret_cast<u64*>(smem);  // the merge's copies, over the ring

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * QN;
  const int nb = min(QN, B - b0);  // the block's live queries
  const int tile_idx = blockIdx.y;
  const int slice = blockIdx.z;
  const int S = gridDim.z;
  const long long base = static_cast<long long>(tile_idx) * tile;
  const int rows = static_cast<int>(min(static_cast<long long>(tile), N - base));  // scanned
  const int r_begin = slice * slice_rows;
  const int r_lim = min(rows, r_begin + slice_rows);
  const int nch = r_lim > r_begin ? (r_lim - r_begin + R - 1) / R : 0;
  const int kslice = KS / (MODE == 3 ? 4 : MODE == 2 ? 2 : 1);  // elements of a row a k-slice
  const int nks = (D + kslice - 1) / kslice;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    sm90::mbar_init_fence();
  }
  if (!dp)
    for (int i = tid; i < QN * kp; i += THREADS) lists[i] = 0ull;
  for (int i = tid; i < QN; i += THREADS) {
    thr[i] = -INFINITY;
    qsc[i] = (MODE == 0 && i < nb) ? qscale[b0 + i] : 0.0f;
  }
  __syncthreads();

  // kt <= 8: the consumers' 256 threads, 256 / QN a query, each keep the
  // best of their share of every chunk in registers: lists of 2 for kt <=
  // 2 (a default collection's depth at scale), of 8 above
  constexpr int PARTS = 256 / QN;
  const int lq = tid / PARTS, lpart = tid % PARTS;
  float lv2[2], lv8[LIST], thr2 = -INFINITY, thr8 = -INFINITY;
  int lc2[2], lc8[LIST];
#pragma unroll
  for (int i = 0; i < LIST; ++i) {
    lv8[i] = -INFINITY;
    lc8[i] = 0x7fffffff;
    if (i < 2) {
      lv2[i] = -INFINITY;
      lc2[i] = 0x7fffffff;
    }
  }
  auto scan_lists = [&](int ch) {
    if (lq < nb) {
      const float* row = scores + lq * SR;
      const int c0 = r_begin + ch * R;
      if (kt <= 2)
        scan_row<2, PARTS>(lv2, lc2, thr2, row, c0, lpart, kt);
      else
        scan_row<LIST, PARTS>(lv8, lc8, thr8, row, c0, lpart, kt);
    }
  };
  // the selection of a chunk, in two passes.  First the consumers' 256
  // threads, 256 / QN a query, flag the queries one of whose scores beats
  // the list's kt-th (most chunks of a slice flag none)
  auto flag_queries = [&]() {
    const int q = lq, part = lpart;
    int any = 0;
    if (q < nb) {
      const float th = thr[q];
      const float* row = scores + q * SR;
      for (int g = part; g < R / 4; g += PARTS) {
        const float4 v = *reinterpret_cast<const float4*>(row + 4 * g);
        any |= fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)) > th;
      }
    }
#pragma unroll
    for (int o = 1; o < PARTS; o <<= 1) any |= __shfl_xor_sync(0xffffffffu, any, o);
    if (part == 0) flag[q] = any;
  };
  // then the flagged queries merge their survivors, a selecting warp each
  // in turn
  auto merge_flagged = [&](int ch) {
    const int c0 = r_begin + ch * R;
    int seen = 0;
    for (int b = 0; b < nb; b += 32) {
      unsigned m = __ballot_sync(0xffffffffu, b + lane < nb && flag[b + lane] != 0);
      while (m != 0u) {
        const int qi = b + __ffs(m) - 1;
        m &= m - 1u;
        if (seen++ % WORKERS == warp)
          select_chunk(scores + qi * SR, lists + qi * kp, thr + qi, kt, c0, lane,
                       scratch + warp * R);
      }
    }
  };

  if (warp == WARPS - 1) {
    // the producer: every chunk's k-slices, in the consumers' order
    if (lane == 0) {
      sm90::tma_prefetch_map(&qmap);
      sm90::tma_prefetch_map(&cmap);
      int s = 0;
      uint32_t ph = 0;
      for (int ch = 0; ch < nch; ++ch) {
        const int row = static_cast<int>(base) + r_begin + ch * R;
        for (int ks = 0; ks < nks; ++ks) {
          sm90::mbar_wait(empty0 + 8 * s, ph ^ 1);
          const uint32_t st = ring + s * STAGE;
          const uint32_t bar = full0 + 8 * s;
          sm90::mbar_arrive_expect_tx(bar, STAGE);
          sm90::tma_load_2d(st, &cmap, bar, ks * kslice, row);
          if constexpr (MODE == 1) {
            sm90::tma_load_2d(st + Q_OFF, &qmap, bar, ks * KS, b0);
            sm90::tma_load_2d(st + Q_OFF + QN * KS, &qmap, bar, ks * KS + KS / 2, b0);
          } else if constexpr (MODE == 3) {
            // the [2B, D] planes: hi in rows 0 .. B - 1, lo in rows B ..
            sm90::tma_load_2d(st + Q_OFF, &qmap, bar, ks * kslice, b0);
            sm90::tma_load_2d(st + Q_OFF + QN * KS, &qmap, bar, ks * kslice, B + b0);
          } else {
            sm90::tma_load_2d(st + Q_OFF, &qmap, bar, ks * kslice, b0);
          }
          if (++s == nst) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else if (warp >= CONSUMER_WARPS) {
    // the other selecting warps: the consumers' barriers, chunk by chunk
    // (the deep selection has none: each chunk's scores have their own place)
    for (int ch = 0; ch <= nch && !dp; ++ch) {
      if (ch > 0 && kt > LIST) {
        sm90::named_barrier(1, 32 * WORKERS);  // the flags of chunk ch - 1
        merge_flagged(ch - 1);
      }
      sm90::named_barrier(1, 32 * WORKERS);  // the lists hold chunk ch - 1
      if (ch == nch) break;
      sm90::named_barrier(1, 32 * WORKERS);  // the scores hold chunk ch
    }
  } else {
    // the consumers: warpgroup wg takes rows 64 wg .. of every chunk; this
    // thread rows rr0 and rr0 + 8, queries 8 j + 2 t + e
    const int wg = warp >> 2;
    const int t = lane & 3;
    const int rr0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const uint32_t a_off = wg * 64 * KS;
    uint8_t* my_wide = wide + wg * 2 * HALF;
    const uint32_t wide_s = sm90::smem_addr(my_wide);
    const float two = norms != nullptr ? 2.0f : 1.0f;
    Acc acc[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0;
    int s = 0, rel = 0, pending = 0;  // the next stage; the oldest issued one not released
    uint32_t ph = 0;
    // stages whose products are done go back to the producer, all but `keep`
    auto release = [&](int keep) {
      while (pending > keep) {
        if (lane == 0) sm90::mbar_arrive(empty0 + 8 * rel);
        if (++rel == nst) rel = 0;
        --pending;
      }
    };
    // k-slice ks of the current chunk's products, issued and committed
    auto issue_stage = [&](int ks) {
      sm90::mbar_wait(full0 + 8 * s, ph);
      const uint32_t st = ring + s * STAGE;
      if constexpr (MODE == 3) {
        // four k8 steps of 32 bytes (+ 2 in the descriptor), each its own
        // group of three products, always in this order: hi x hi, hi x lo,
        // lo x hi.  The rows' planes are made here, in registers (A from
        // registers: this thread's rows rr0 and rr0 + 8, columns t and t +
        // 4 of the step, from the stage's swizzled rows); the queries'
        // planes are the stage's two boxes.  A step's registers are
        // rewritten only after the wait that covers the step before it
        const float* rows = reinterpret_cast<const float*>(smem + s * STAGE);
        const uint64_t dh = sm90::wgmma_desc_sw128(st + Q_OFF);
        const uint64_t dl = sm90::wgmma_desc_sw128(st + Q_OFF + QN * KS);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = rr0 + 8 * (i & 1);
            const int c = 8 * k + t + 4 * (i >> 1);
            const float x = rows[r * 32 + (((c >> 2) ^ (r & 7)) << 2) + (c & 3)];
            hi[i] = sm90::tf32_rna(x);
            lo[i] = sm90::tf32_rna(__fsub_rn(x, __uint_as_float(hi[i])));
          }
          sm90::fence_regs(hi);
          sm90::fence_regs(lo);
          sm90::fence_regs(acc);
          sm90::wgmma_fence();
          sm90::wgmma_tf32<QN>(acc, hi, dh + 2 * k, (ks > 0 || k > 0) ? 1 : 0);
          sm90::wgmma_tf32<QN>(acc, hi, dl + 2 * k, 1);
          sm90::wgmma_tf32<QN>(acc, lo, dh + 2 * k, 1);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the step before: its registers are free
          sm90::fence_regs(acc);
        }
      } else if constexpr (MODE == 1) {
        sm90::wgmma_wait<0>();  // the widened codes are rewritten
        sm90::fence_regs(acc);
        release(0);
        widen(smem + s * STAGE, my_wide, wg, tid & 127);
        sm90::fence_proxy_async();
        sm90::named_barrier(2 + wg, 128);
        const uint64_t da = sm90::wgmma_desc_sw128(wide_s);
        const uint64_t db = sm90::wgmma_desc_sw128(st + Q_OFF);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k)  // two halves of 64 k, four k16 steps each
          mma<MODE, QN>(acc, da + (k >> 2) * (HALF >> 4) + 2 * (k & 3),
                        db + (k >> 2) * ((QN * KS) >> 4) + 2 * (k & 3),
                        (ks > 0 || k > 0) ? 1 : 0);
        sm90::wgmma_commit();
      } else {
        const uint64_t da = sm90::wgmma_desc_sw128(st + a_off);
        const uint64_t db = sm90::wgmma_desc_sw128(st + Q_OFF);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)  // + 32 bytes a step: + 2 in the descriptor
          mma<MODE, QN>(acc, da + 2 * k, db + 2 * k, (ks > 0 || k > 0) ? 1 : 0);
        sm90::wgmma_commit();
      }
      ++pending;
      if (++s == nst) {
        s = 0;
        ph ^= 1;
      }
    };
    for (int ch = 0; ch <= nch; ++ch) {
      if (!dp) {
        if (ch > 0 && kt <= LIST) {
          scan_lists(ch - 1);
        } else if (ch > 0) {
          flag_queries();
          sm90::named_barrier(1, 32 * WORKERS);  // the flags of chunk ch - 1
          merge_flagged(ch - 1);
        }
        sm90::named_barrier(1, 32 * WORKERS);  // the lists hold chunk ch - 1
      }
      if (ch == nch) break;
      // the chunk's row data, folded: a dead row (masked, past the slice or
      // the scanned rows) scales by NaN
      float rs[2], nn[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = r_begin + ch * R + rr0 + 8 * h;
        const long long tt = base + col;
        const bool live = col < r_lim && (mask == nullptr || mask[tt] != 0);
        rs[h] = live ? (scales != nullptr ? scales[tt] : 1.0f) : __int_as_float(0x7fc00000);
        nn[h] = live && norms != nullptr ? norms[tt] : 0.0f;
      }
      for (int ks = 0; ks < nks; ++ks) {
        issue_stage(ks);
        sm90::wgmma_wait<1>();  // all but the last stage's products are done
        sm90::fence_regs(acc);
        release(1);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      release(0);
      float* chunk_scores = scores + (dp ? ch * R : 0);  // the deep selection: the slice's columns
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * j + 2 * t + e;
          const float qs = MODE == 0 ? qsc[q] : 1.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v;
            if constexpr (MODE == 0)
              v = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), qs);
            else
              v = acc[4 * j + 2 * h + e];
            chunk_scores[q * sp + rr0 + 8 * h] = __fmaf_rn(two, __fmul_rn(v, rs[h]), -nn[h]);
          }
        }
      }
      if (!dp) sm90::named_barrier(1, 32 * WORKERS);  // the scores hold chunk ch
    }
    if (kt <= 2)
      finish_rows<2, PARTS>(lv2, lc2, lists + lq * kp, lpart == 0 && lq < nb, kt);
    else if (kt <= LIST)
      finish_rows<LIST, PARTS>(lv8, lc8, lists + lq * kp, lpart == 0 && lq < nb, kt);
  }

  // the tile's slices: block r copies the lists of queries r, r + S, ..
  // from every block of the cluster (distributed shared memory), then
  // merges them in slice order and writes them
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int owned = nb > slice ? (nb - slice + S - 1) / S : 0;
  if constexpr (DEEP) {
    // the deep selection: split, block r first copies the slices' scores of
    // queries r, r + S, .. from every block (a row of S slice_rows columns,
    // in tile order), over its ring and widened codes; then a warp a query
    const int gs = S * slice_rows;
    float* gathered_rows = reinterpret_cast<float*>(smem);
    if (S > 1) {
      const int per = slice_rows / 4;
      for (int idx = tid; idx < owned * S * per; idx += THREADS) {
        const int m = idx / (S * per), r = idx / per % S, i = idx % per;
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(scores, r) + (slice + S * m) * sp);
        reinterpret_cast<float4*>(gathered_rows + m * gs + r * slice_rows)[i] = src[i];
      }
    }
    cluster.sync();  // every copy made: the block's own scores are free when split
    const size_t gather = deep_gather_bytes(QN, S, slice_rows);
    const size_t room = deep_region_bytes(MODE, QN, nst, S, slice_rows) - gather;
    const size_t per_warp = deep_warp_bytes(kt, tile);
    const int sel = room / per_warp < WARPS ? static_cast<int>(room / per_warp) : WARPS;
    if (warp < sel) {
      u64* keys = reinterpret_cast<u64*>(smem + gather + warp * per_warp);
      uint32_t* hist = reinterpret_cast<uint32_t*>(keys);  // read before the keys are written
      for (int m = warp; m < owned; m += sel) {
        const int qi = slice + S * m;
        const float* row = S > 1 ? gathered_rows + m * gs : scores + qi * sp;
        const long long out0 = (static_cast<long long>(tile_idx) * B + b0 + qi) * kt;
        select_deep(row, rows, kt, keys, hist, lane, out_vals + out0, out_ids + out0, base);
      }
    }
    return;
  }
  if (S > 1) {
    for (int idx = tid; idx < owned * S * kp; idx += THREADS) {
      const int m = idx / (S * kp), r = idx / kp % S, i = idx % kp;
      gathered[idx] = cluster.map_shared_rank(lists, r)[(slice + S * m) * kp + i];
    }
  }
  cluster.sync();  // every copy made: no block reads another's lists any more
  const int G = kp / E;
  const int g = lane & (G - 1);
  for (int m = warp; m < owned; m += WARPS) {
    const int qi = slice + S * m;
    const u64* Lm = S > 1 ? gathered + m * S * kp : lists + qi * kp;
    u64 k[E];
#pragma unroll
    for (int j = 0; j < E; ++j) k[j] = Lm[g * E + j];
    for (int r = 1; r < S; ++r) merge_list(k, Lm + r * kp, kp, g);
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

template <int MODE, int QN, bool DEEP>
int launch_qn(const CUtensorMap& qmap, const CUtensorMap& cmap, const float* qscale,
              const float* scales, const float* norms, const uint8_t* mask, int B, int N, int D,
              int tile, int num_tiles, int kt, int kp, int nst, int slices, int slice_rows,
              float* out_vals, int* out_ids, cudaStream_t stream) {
  const size_t smem = smem_bytes(MODE, QN, kt, nst, slice_rows);
  auto kern = dense_topk_tcs_kernel<MODE, QN, DEEP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  // the query blocks of a tile slice run together, so the slice is read
  // from HBM once and from L2 by its neighbours
  cfg.gridDim = dim3((B + QN - 1) / QN, num_tiles, slices);
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
  err = cudaLaunchKernelEx(&cfg, kern, qmap, cmap, qscale, scales, norms, mask, B, N, D, tile, kt,
                           kp, nst, slice_rows, out_vals, out_ids);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(int qn, const CUtensorMap& qmap, const CUtensorMap& cmap, const float* qscale,
                const float* scales, const float* norms, const uint8_t* mask, int B, int N, int D,
                int tile, int num_tiles, int kt, int kp, int nst, int slices, int slice_rows,
                float* out_vals, int* out_ids, cudaStream_t s) {
  const bool dp = deep(kt);
  switch (qn) {
    case 16:
      return (dp ? launch_qn<MODE, 16, true> : launch_qn<MODE, 16, false>)(
          qmap, cmap, qscale, scales, norms, mask, B, N, D, tile, num_tiles, kt, kp, nst, slices,
          slice_rows, out_vals, out_ids, s);
    case 64:
      return (dp ? launch_qn<MODE, 64, true> : launch_qn<MODE, 64, false>)(
          qmap, cmap, qscale, scales, norms, mask, B, N, D, tile, num_tiles, kt, kp, nst, slices,
          slice_rows, out_vals, out_ids, s);
    case 128:  // no deep form: the deep geometry takes 16 or 64 queries a block
      if (dp) return static_cast<int>(cudaErrorInvalidValue);
      return launch_qn<MODE, 128, false>(qmap, cmap, qscale, scales, norms, mask, B, N, D, tile,
                                         num_tiles, kt, kp, nst, slices, slice_rows, out_vals,
                                         out_ids, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(int mode, const void* qmap_in, const void* cmap_in, int q_box, int c_box,
           const float* qscale, const float* scales, const float* norms, const uint8_t* mask,
           int B, int N, int D, int tile, int num_tiles, int kt, int qn, int nst, int slices,
           int slice_rows, float* out_vals, int* out_ids, cudaStream_t s) {
  if (mode < 0 || mode > 3 || kt < 1 || D < 16 || D > MAX_D || D % 16 != 0 ||
      B < 1 || N < 1 || tile < 1 || num_tiles != (N + tile - 1) / tile || q_box != qn ||
      c_box != R || nst < 2 || nst > MAX_STAGES || slices < 1 || slices > MAX_SLICES ||
      slice_rows < R || slice_rows % R != 0 || static_cast<long long>(slices) * slice_rows < tile ||
      qmap_in == nullptr || cmap_in == nullptr || (mode == 0 && qscale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = deep(kt) ? deep_kp(kt, tile) : kp_of(kt);
  if (smem_bytes(mode, qn, kt, nst, slice_rows) > SMEM_MAX ||
      !(deep(kt) ? deep_fits(mode, qn, kt, tile, nst, slices, slice_rows)
                 : merge_fits(mode, qn, kt, nst)))
    return static_cast<int>(cudaErrorInvalidValue);
  // by value into the kernel's parameters (64-byte aligned copies)
  CUtensorMap qmap, cmap;
  memcpy(&qmap, qmap_in, sizeof(CUtensorMap));
  memcpy(&cmap, cmap_in, sizeof(CUtensorMap));
  switch (mode) {
    case 0:
      return launch_mode<0>(qn, qmap, cmap, qscale, scales, norms, mask, B, N, D, tile, num_tiles,
                            kt, kp, nst, slices, slice_rows, out_vals, out_ids, s);
    case 1:
      return launch_mode<1>(qn, qmap, cmap, qscale, scales, norms, mask, B, N, D, tile, num_tiles,
                            kt, kp, nst, slices, slice_rows, out_vals, out_ids, s);
    case 2:
      return launch_mode<2>(qn, qmap, cmap, qscale, scales, norms, mask, B, N, D, tile, num_tiles,
                            kt, kp, nst, slices, slice_rows, out_vals, out_ids, s);
    default:
      return launch_mode<3>(qn, qmap, cmap, qscale, scales, norms, mask, B, N, D, tile, num_tiles,
                            kt, kp, nst, slices, slice_rows, out_vals, out_ids, s);
  }
}

}  // namespace tcs

}  // namespace

// A tensor map of the tensor-core variants, written (128 bytes, a
// CUtensorMap) to `map`.  d > 0: a row-major [rows, d] matrix at `base` of
// int8 (elem_bytes 1), bf16 (2) or f32 (4) elements, d % 16 == 0, in boxes
// of 128 bytes (128, 64 or 32 elements) x box_rows rows with the 128-byte
// swizzle;
// d = 0: a vector of `rows` elements of elem_bytes (4: f32 scales or norms,
// 1: mask bytes) in boxes of box_rows (a [1, rows] matrix: load its boxes
// at (x, 0)).  Zeros outside the array.  `base` 16-byte aligned.  Returns
// 0, cudaErrorInvalidValue outside those shapes, 1000 + the CUresult of a
// failed encode, or 999 where the driver has no cuTensorMapEncodeTiled.
extern "C" int dense_topk_tc_map(void* map, const void* base, long long rows, int d,
                                 int elem_bytes, int box_rows) {
  const bool matrix = d > 0;
  if (rows < 1 || rows > 0x7fffffffLL || box_rows < 1 || box_rows > 256 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      (matrix ? (d % 16 != 0 || (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4))
              : ((elem_bytes != 1 && elem_bytes != 4) || box_rows * elem_bytes % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return 999;
  CUtensorMap m;
  CUresult r;
  if (matrix) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * elem_bytes};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(tc::KS / elem_bytes),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem_strides[2] = {1, 1};
    r = encode(&m,
               elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
               2, const_cast<void*>(base), dims, strides, box,
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

// Mode 3's query planes for dense_topk_tcs_launch: q, a row-major [B, D] f32
// array (count = B D elements, a multiple of 4, 16-byte aligned), into out
// [2B, D]: rows 0 .. B - 1 tf32_rna(q), rows B .. 2B - 1 tf32_rna(q - that).
// Returns the cudaError_t of the launch.
extern "C" int dense_topk_tf32_planes(const float* q, float* out, long long count,
                                      void* stream) {
  return sm90::tf32_planes(q, out, count, static_cast<cudaStream_t>(stream));
}

// The register-list variant (int8 x int8, 1 <= kt <= 8, D % 16 == 0, D <=
// 65536).  Tensor maps from dense_topk_tc_map: qmap, the queries [B, D]
// (q_box = 128 rows a box); cmap, the corpus's first N rows (c_box = the
// chunk's rows, 256); smap, nmap, mmap, the row scales, norms (L2) and
// mask bytes of those rows in boxes of c_box, each null where absent.
// qscale [B] f32 (the queries' scales), out_vals / out_ids [num_tiles, B,
// kt] (f32, int32: tile * tile + column), and `grid` blocks walking the
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
// 1 (int8 codes, bf16 queries), 2 (bf16 x bf16) and 3 (f32 x f32), 1 <= kt
// (above 128 the deep selection, within the shared memory that
// tcs::deep_fits asks for), D % 16 == 0, D <= 65536.  Tensor maps from dense_topk_tc_map:
// qmap, the queries [B, D] (int8 in mode 0, bf16 in modes 1 and 2; in mode
// 3 the [2B, D] f32 planes of dense_topk_tf32_planes) in boxes of q_box =
// qn rows; cmap, the corpus's first N rows (int8 in modes 0 and 1, bf16 in
// mode 2, f32 in mode 3) in boxes of c_box = 128 rows.  `shape` holds twelve ints, {q_box, c_box,
// B, N, D, tile, num_tiles, kt, qn, nst, slices, slice_rows} (one argument,
// which a caller builds once a shape): qn (16, 64 or 128) queries a block,
// nst (2 to 4) ring stages, within the block's 232,448 bytes of shared
// memory (tcs::smem_bytes); each tile's rows split into `slices` slices of
// `slice_rows` rows (a multiple of 128), the blocks of one cluster (slices
// <= 8, slices * slice_rows >= tile).  qscale [B] (mode 0), the row
// scales, L2 norms and keep-mask bytes [N] (each null where absent) and the
// output [num_tiles, B, kt] (f32 values, int32 ids: tile * tile + column).
// Returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue outside its shapes.
extern "C" int dense_topk_tcs_launch(int mode, const void* qmap, const void* cmap,
                                     const int* shape, const float* qscale, const float* scales,
                                     const float* norms, const uint8_t* mask, float* out_vals,
                                     int* out_ids, void* stream) {
  if (shape == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int* h = shape;
  return tcs::launch(mode, qmap, cmap, h[0], h[1], qscale, scales, norms, mask, h[2], h[3], h[4],
                     h[5], h[6], h[7], h[8], h[9], h[10], h[11], out_vals, out_ids,
                     static_cast<cudaStream_t>(stream));
}
