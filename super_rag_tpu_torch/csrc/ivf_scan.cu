// IVF cluster-tile scoring for Hopper (sm_90a): the kernel of the IVF
// dense tier, called by super_rag_tpu_torch/ops/ivf_topk.py.
//
// It computes, for a query b and a slot c of a cluster tile t,
//
//   s = dot(q[b], values[t, c, :])      f32 sum of exact products: bf16
//                                       queries x int8 codes / bf16 values,
//                                       or f32 x f32 (three TF32 products)
//   s = s * scales[t, c]                (int8 values)
//   s = s + cs[b, t]                    (residual coding: the probe score)
//   s = -inf  where row_ids[t, c] < 0 or mask[row_ids[t, c]] == 0
//
// with __fmul_rn / __fadd_rn in the reference's order, so a result differs
// from the plain PyTorch version only in the dot product's summation
// order (the tensor cores' own).  Each (query, slot) sum runs in an order
// fixed by D alone, never by the batch, so a query scores alike in any
// batch.  Top-k stays in the caller (stable_topk over the candidate array).
//
// One kernel body, ivf_tc_kernel, serves both routes of the JAX package's
// ops/pallas_ivf.py in every values mode (0 int8, 1 bf16, 2 f32), with a
// query-list policy:
//   - the union route replaces :93 _make_union_kernel (driven by
//     _union_scores, :163): the whole query block against every tile of
//     the batch's probe union, out [B, U, C];
//   - the per-query route replaces :48 _make_kernel (the per-query probe
//     stream inside pallas_ivf_topk, :201): each query against its own
//     probed tiles, out [B, nprobe, C].
// Mosaic kept the epilogue out of both; here it is fused.
//
// Both are bound by bytes on an H100.  The union reads its U tiles once
// and writes [B, U, C] f32 (512 tiles of 1280 x 768 at B = 32: 0.59 GB,
// 0.177 ms at 3.35 TB/s) against 3.2e10 operations (0.033 ms at the bf16
// tensor-core peak).  The per-query route at B = 512, nprobe 16 needs
// each distinct probed tile once (<= 1024 tiles, 1.06 GB, 0.316 ms); a
// grid of one block per (query, probe), as the TPU kernel's and the
// first port's was, reads every query's own tiles instead: 8.05 GB, a
// 2.40 ms floor, and L2 caught little of what neighbouring blocks shared
// (that SIMT kernel took 6.3 ms for int8 values, 8.5 ms for f32 ones).
//
// The kernel runs the tensor cores: mma.sync.m16n8k16 bf16 (modes 0, 1)
// or m16n8k8 tf32 (mode 2) with f32 accumulators, tile rows as M and
// queries as N.  A block holds RB rows of one tile and QN queries (Cfg;
// the shapes by timing, below).  The query lists:
//   - UnionList: queries z * QN .. z * QN + QN - 1 against union tile u (at
//     B = 32 the whole batch, so every union tile is read from HBM once);
//     out[b, u, :];
//   - GroupList: the per-query route turned tile-major.  The wrapper
//     stably sorts the (query, probe) pairs by tile and cuts each tile's
//     run into groups of at most QN pairs (ops/ivf_topk.py probe_groups,
//     on the device); a block takes one group, finding its tile by a
//     binary search over the per-tile group offsets, and writes
//     out[b, j, :] for each pair (b, j).  So a tile is streamed once for
//     every QN queries that probed it, and the groups of one tile are
//     neighbours in the grid, in flight together, sharing it through L2.
//     The grid is an upper bound on the group count from shapes alone
//     (blocks past the last group exit), so nothing is read back to the
//     host.  On an H100 80GB HBM3 at 700 W, at the smoke's shape (B = 512,
//     nprobe 16, C = 1280, D = 768 int8, 1023 distinct tiles, ~8 pairs a
//     tile) it took 0.508 ms at 128 rows x 16 pairs against 0.541-0.704 ms
//     at the other shapes of {128, 256} x {8, 16, 32} (tune_ivf_probe.py),
//     where the one-block-per-(query, probe) SIMT kernel took 6.315 ms.
// Slices of the rows (KSB bytes), and the matching query slices, stream
// through an NST-stage cp.async ring; each row load asks L2 for the row's
// next 256 bytes, which later stages read.  int8 codes stay int8 in
// shared memory (ldmatrix) and are widened to bf16 in registers with
// integer and bf16x2 arithmetic, exactly (|code| <= 128; sm90_util.cuh
// s8x4_to_bf16x2).  The scores go through shared memory so each query's
// rows leave in 16-byte coalesced streaming stores, with the epilogue
// applied there; a row's scale and liveness are loaded before the main
// loop.  The MMA adds in its own order, not an FMA chain's, so the scores
// differ from the plain version's within the summation tolerance; that
// order is fixed by D alone (no split of D, no atomics, a column's sum
// independent of the other columns, a block shape never changing it), so
// a query scores bit-alike alone, inside any batch, and on either route.
// On an H100 at the smoke's shapes an earlier union version that stored
// from the accumulators in 32-byte pieces took 0.42 ms; staging through
// shared memory, streaming stores and the L2 prefetch brought it to 0.34
// ms.  Deeper or wider rings, a persistent grid and bulk (TMA) copies per
// row were slower.
//
// The f32 mode (2), as dense_topk's: one TF32 product keeps 11
// significant bits, too few for the float tolerance D 2^-23 (max|s| + 1);
// three keep it.  Each operand splits into round-to-nearest tf32 planes,
// x = h + l (h = tf32_rna(x), l' = tf32_rna(x - h)), and each k8 step
// runs mma.sync.m16n8k8 tf32 three times, h g + h m' + l' g: the products
// are exact and what is dropped is ~3 2^-22 |x||y| a product.  The rows'
// planes are made in registers from the f32 ring stage; the queries' are
// a [2B, D] array made by ivf_tf32_planes first (on either route), a
// stage holding both planes' rows.  The three products stay far under the
// bytes (~0.16 ms at 495 TFLOP/s for B = 512 x 16 probes of 1,024 x 768
// tiles, against 0.97 ms of bytes), so the mode is bound by bytes too.
// f32 rows are 4x the bytes of int8 ones, so the f32 stages have shapes of
// their own: UnionShape<float> (scripts/tune_ivf_union.py) and
// GroupShape<float> (tune_ivf_probe.py --f32).  The first versions were
// SIMT kernels of f32 FMAs on the CUDA cores: the union's took 1.23 ms
// device at 512 tiles x 1,024 rows x 768, B 32 on an H100, against a 0.50
// ms bytes bound, the per-query one (a block per (query, probe), a warp a
// row) 8.52 ms at 1,024 tiles x 1,024 x 768, B 512, 16 probes, against a
// 0.97 ms bound, where the tensor-core body takes 1.13 ms
// (tune_ivf_probe.py --f32; PERF.md §6).
//
// Requirements checked by the Python wrapper: D % 16 == 0, contiguous
// 16-byte aligned operands, probe and union tile ids in [0, nlist).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90_util.cuh"

namespace {

// ---- the tensor-core kernel: both routes, every values mode ----

namespace utc {

// RB tile rows per block (32 per warp), QN queries per block (the N side,
// a multiple of 8, fixed: never chosen by B), KSB bytes of each value row
// per stage, NST stages.  f32 values (TV = float) take f32 queries as two
// tf32 planes, so a stage holds 2 QN query rows: the hi planes, then the lo
template <typename TV, int RB_, int QN_, int KSB_, int NST_>
struct Cfg {
  static constexpr int RB = RB_, QN = QN_, KSB = KSB_, NST = NST_;
  static constexpr int THREADS = RB;  // RB / 32 warps
  static constexpr bool F32 = sizeof(TV) == 4;
  static constexpr int KE = KSB / static_cast<int>(sizeof(TV));  // elements of D per stage
  // value row stride: int8 rows are read by ldmatrix (16 mod 32 bytes: 8
  // rows, 8 bank groups); bf16 and f32 rows by 8-byte loads (32 mod 64: 4
  // rows, 32 banks)
  static constexpr int AS = sizeof(TV) == 1 ? KSB + 16 : KSB + 32;
  static constexpr int QE = F32 ? 4 : 2;                // bytes of a query element
  static constexpr int QROWS = F32 ? 2 * QN : QN;       // query rows a stage
  static constexpr int QSB = KE * QE + 32;  // query row stride (bytes), as the value rows'
  static constexpr int QV = KE * QE / 16;   // 16-byte pieces of a query row a stage
  static constexpr int QLOADS = (QROWS * QV + THREADS - 1) / THREADS;  // of them a thread
  static constexpr int STAGE = RB * AS + QROWS * QSB;
  static constexpr int OS = RB + 4;  // f32 stride of the [QN][RB] output stage
  static constexpr int SMEM = NST * STAGE > QN * OS * 4 ? NST * STAGE : QN * OS * 4;
};

// the configurations the port runs (chosen by timing on an H100:
// tune_ivf_probe.py, scripts/tune_ivf_union.py, PERF.md); a block shape
// never changes a column's MMA order, so both routes give the same bits
template <typename TV> struct UnionShape { using type = Cfg<TV, 256, 32, 64, 4>; };
// f32: 256 rows x 32 queries, 128-byte slices (32 f32), 2 stages (102 KB:
// two blocks an SM); 0.667 ms at 512 tiles x 1,024 x 768, B 32 against
// 0.677-1.468 for the other shapes of scripts/tune_ivf_union.py (H100)
template <> struct UnionShape<float> { using type = Cfg<float, 256, 32, 128, 2>; };
template <typename TV> using UnionCfg = typename UnionShape<TV>::type;
template <typename TV> struct GroupShape { using type = Cfg<TV, 128, 16, 64, 4>; };
// f32: 128 rows x 16 pairs, 128-byte slices (32 f32), 2 stages (51 KB);
// 1.131 ms at 1,024 tiles x 1,024 x 768, B 512, 16 probes against 1.140
// (256 rows, the same slices), 1.146 (3 stages), 1.157-1.199 (64-byte
// slices, 3 or 4 stages) and 1.202-1.526 for the other shapes of
// tune_ivf_probe.py --f32 (H100): 8 pairs a group make 1.4x the groups,
// 32 pad most groups of the ~8 pairs a tile has
template <> struct GroupShape<float> { using type = Cfg<float, 128, 16, 128, 2>; };
template <typename TV> using GroupCfg = typename GroupShape<TV>::type;

// the operands both routes share; q: bf16 [B, D], or for f32 values the
// queries' tf32 planes [2B, D] (sm90::tf32_planes)
struct Scan {
  const void* q;
  const void* values;
  const float* scales;
  const float* cs;
  const int* row_ids;
  const uint8_t* mask;
  int B, C, D, nlist;
  float* out;
};

// Query lists.  block() fills a Block for this CUDA block (false: no work),
// and Block::query(n, row) gives the query of column n (-1: none) and the
// output row, of C scores, that its scores go to.

// union route: queries z * QN + n against union tile union_ids[u];
// out[b, u, :]
struct UnionList {
  const int* union_ids;
  int U;
  struct Block {
    long long tile;
    int b0, B, U, u;
    __device__ __forceinline__ int query(int n, long long& row) const {
      const int b = b0 + n;
      row = static_cast<long long>(b) * U + u;
      return b < B ? b : -1;
    }
  };
  template <int QN>
  __device__ __forceinline__ bool block(int B_, Block& k) const {
    k.u = blockIdx.x;
    k.tile = union_ids[k.u];
    k.b0 = blockIdx.z * QN;
    k.B = B_;
    k.U = U;
    return true;
  }
};

// per-query route: group blockIdx.x of the work list, up to QN (query,
// probe) pairs p = b * nprobe + j on one tile; out[b, j, :] is out row p
struct GroupList {
  const int* order;      // [B * nprobe] pair ids, stably sorted by tile
  const int* pair_off;   // [nlist + 1]: tile t's pairs are order[pair_off[t] .. pair_off[t + 1])
  const int* group_off;  // [nlist + 1]: tile t's groups are group_off[t] .. group_off[t + 1] - 1
  int nlist, nprobe;
  struct Block {
    long long tile;
    const int* pairs;
    int count, nprobe;
    __device__ __forceinline__ int query(int n, long long& row) const {
      if (n >= count) return -1;
      const int p = pairs[n];
      row = p;
      return p / nprobe;
    }
  };
  template <int QN>
  __device__ __forceinline__ bool block(int, Block& k) const {
    const int g = blockIdx.x;
    if (g >= group_off[nlist]) return false;  // the grid is an upper bound
    int lo = 0, hi = nlist;  // group_off[lo] <= g < group_off[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (group_off[mid] <= g) lo = mid;
      else hi = mid;
    }
    const int first = pair_off[lo] + (g - group_off[lo]) * QN;
    k.tile = lo;
    k.pairs = order + first;
    k.count = min(QN, pair_off[lo + 1] - first);
    k.nprobe = nprobe;
    return true;
  }
};

// One block: RB rows of one tile against the QN queries its list gives,
// D in stages of KE elements.  Tile rows are the MMA's M, queries its N.
// Within each 16-wide k step the MMA's k order is permuted (logical
// 2t + j <- physical 4t + j, logical 8 + 2t + j <- physical 4t + 2 + j),
// the same for values and queries, so a lane's A and B fragments are 4
// consecutive elements: one ldmatrix serves int8 codes, which are widened
// to bf16 in registers.
template <typename TV, typename L, typename List>
__global__ void __launch_bounds__(L::THREADS, 2)
ivf_tc_kernel(const Scan a, const List list) {
  constexpr int KE = L::KE, KSB = L::KSB, NST = L::NST, RB = L::RB, OS = L::OS;
  constexpr int QN = L::QN, QV = L::QV, THREADS = L::THREADS;
  extern __shared__ __align__(16) uint8_t smem[];
  typename List::Block blk;
  if (!list.template block<QN>(a.B, blk)) return;
  const int C = a.C, D = a.D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int c0 = blockIdx.y * RB;
  const long long tile = blk.tile;
  const long long row_bytes = static_cast<long long>(D) * sizeof(TV);
  const uint8_t* vt = reinterpret_cast<const uint8_t*>(a.values) + tile * C * row_bytes;
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(a.q);
  const int nst = (D + KE - 1) / KE;

  // the 16-byte pieces of query rows this thread stages (the same piece of
  // the same row in every stage): their sources, null where the column has
  // no query.  Staged row r holds plane r / QN of column r % QN (f32: hi,
  // then lo, [2B, D]; else the one bf16 plane)
  const uint8_t* qsrc[L::QLOADS];
#pragma unroll
  for (int i = 0; i < L::QLOADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / QV;
    long long row;
    const int b = idx < L::QROWS * QV ? blk.query(r % QN, row) : -1;
    qsrc[i] = b >= 0 ? qb + ((r / QN) * static_cast<long long>(a.B) + b) * L::QE * D +
                           (idx % QV) * 16
                     : nullptr;
  }

  auto load_stage = [&](int s) {
    uint8_t* sv = smem + (s % NST) * L::STAGE;
    uint8_t* sqs = sv + RB * L::AS;
    const long long kb0 = static_cast<long long>(s) * KSB;  // byte offset in a value row
    for (int idx = tid; idx < RB * (KSB / 16); idx += THREADS) {
      const int r = idx / (KSB / 16), v = idx % (KSB / 16);
      const long long kb = kb0 + v * 16;
      const bool ok = c0 + r < C && kb < row_bytes;
      // the row's next slices follow in later stages: have L2 fetch 256 bytes
      sm90::cp_async16_l2_256(sv + r * L::AS + v * 16, ok ? vt + (c0 + r) * row_bytes + kb : vt,
                              ok ? 16 : 0);
    }
    const long long qb0 = static_cast<long long>(s) * KE * L::QE;  // byte offset in a query row
#pragma unroll
    for (int i = 0; i < L::QLOADS; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < L::QROWS * QV) {
        const int r = idx / QV, v = idx % QV;
        const bool ok = qsrc[i] != nullptr && qb0 + v * 16 < static_cast<long long>(L::QE) * D;
        sm90::cp_async16(sqs + r * L::QSB + v * 16, ok ? qsrc[i] + qb0 : qb, ok ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nst) load_stage(s);
    sm90::cp_async_commit();
  }

  // this thread's 4 output rows (for queries tid / (RB / 4) + 4 i): their
  // scales and liveness, loaded now so the loads hide behind the main loop
  const int r4 = (tid % (RB / 4)) * 4;
  float rs[4];
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + r4 + j;
    rs[j] = 1.0f;
    live[j] = false;
    if (c < C) {
      const long long slot = tile * C + c;
      const int rid = a.row_ids[slot];
      live[j] = rid >= 0 && (a.mask == nullptr || a.mask[rid] != 0);
      if (a.scales != nullptr) rs[j] = a.scales[slot];
    }
  }
  float acc[2][QN / 8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < QN / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  const int a_lane = (lane & 7) + ((lane >> 3) & 1) * 8;

  for (int s = 0; s < nst; ++s) {
    sm90::cp_async_wait<NST - 2>();
    __syncthreads();
    if (s + NST - 1 < nst) load_stage(s + NST - 1);
    sm90::cp_async_commit();

    const uint8_t* sv = smem + (s % NST) * L::STAGE;
    const uint8_t* sqs = sv + RB * L::AS;
    const int nk16 = min(KE, D - s * KE) / 16;  // D % 16 == 0: no partial step
    if constexpr (L::F32) {
      // f32: each k8 step of the stage's KE elements runs three m16n8k8 tf32
      // products a (row block, query block), always hi x hi, hi x lo, lo x
      // hi: the rows' planes made here in registers from the f32 values,
      // the queries' read from their two staged planes.  Within the step
      // the k order is permuted alike for both sides (logical t <- physical
      // 2t, t + 4 <- 2t + 1), so a lane's two elements are one 8-byte load
#pragma unroll
      for (int k8 = 0; k8 < KE / 8; ++k8) {
        if (k8 < 2 * nk16) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint8_t* row = sv + (warp * 32 + mi * 16 + gid) * L::AS + k8 * 32 + tig * 8;
            const float2 x0 = *reinterpret_cast<const float2*>(row);
            const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * L::AS);
            const float xs[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[mi][e] = sm90::tf32_rna(xs[e]);
              al[mi][e] = sm90::tf32_rna(__fsub_rn(xs[e], __uint_as_float(ah[mi][e])));
            }
          }
#pragma unroll
          for (int ni = 0; ni < QN / 8; ++ni) {
            const uint2 bh = *reinterpret_cast<const uint2*>(sqs + (ni * 8 + gid) * L::QSB +
                                                             k8 * 32 + tig * 8);
            const uint2 bl = *reinterpret_cast<const uint2*>(
                sqs + (QN + ni * 8 + gid) * L::QSB + k8 * 32 + tig * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              sm90::mma_tf32_1688(acc[mi][ni], ah[mi], bh.x, bh.y);
              sm90::mma_tf32_1688(acc[mi][ni], ah[mi], bl.x, bl.y);
              sm90::mma_tf32_1688(acc[mi][ni], al[mi], bh.x, bh.y);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int k32 = 0; k32 < KE / 32; ++k32) {
        if (2 * k32 < nk16) {
          // int8: one ldmatrix.x4 holds 16 rows x 32 codes: regs 0 / 1 are
          // rows gid / gid + 8 of the even k16 step, regs 2 / 3 of the odd one
          uint32_t r4v[2][4];
          if constexpr (sizeof(TV) == 1) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              sm90::ldmatrix_x4(sv + (warp * 32 + mi * 16 + a_lane) * L::AS + k32 * 32 +
                                    (lane >> 4) * 16,
                                r4v[mi]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k16 = 2 * k32 + h;
            if (k16 < nk16) {
              uint32_t af[2][4];
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                if constexpr (sizeof(TV) == 1) {
                  sm90::s8x4_to_bf16x2(r4v[mi][2 * h], af[mi][0], af[mi][2]);
                  sm90::s8x4_to_bf16x2(r4v[mi][2 * h + 1], af[mi][1], af[mi][3]);
                } else {
                  const uint8_t* row = sv + (warp * 32 + mi * 16 + gid) * L::AS + k16 * 32 + tig * 8;
                  const uint2 lo = *reinterpret_cast<const uint2*>(row);
                  const uint2 hi = *reinterpret_cast<const uint2*>(row + 8 * L::AS);
                  af[mi][0] = lo.x;
                  af[mi][2] = lo.y;
                  af[mi][1] = hi.x;
                  af[mi][3] = hi.y;
                }
              }
#pragma unroll
              for (int ni = 0; ni < QN / 8; ++ni) {
                const uint2 bq = *reinterpret_cast<const uint2*>(sqs + (ni * 8 + gid) * L::QSB +
                                                                 k16 * 32 + tig * 8);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) sm90::mma_bf16_16816(acc[mi][ni], af[mi], bq.x, bq.y);
              }
            }
          }
        }
      }
    }
  }

  // scores through shared memory, so each query's rows leave in 16-byte
  // coalesced stores, streamed past L2 (nothing reads them back soon),
  // with the epilogue applied on the way
  sm90::cp_async_wait<0>();
  __syncthreads();
  float* so = reinterpret_cast<float*>(smem);  // [QN][OS]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < QN / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        so[(ni * 8 + tig * 2 + (e & 1)) * OS + warp * 32 + mi * 16 + gid + (e >> 1) * 8] =
            acc[mi][ni][e];
  __syncthreads();

  const bool vec = (C & 3) == 0 && c0 + r4 + 3 < C;
#pragma unroll
  for (int i = 0; i < QN / 4; ++i) {
    const int n = tid / (RB / 4) + 4 * i;
    long long orow;
    const int b = blk.query(n, orow);
    if (b < 0) break;
    const float add = a.cs != nullptr ? a.cs[static_cast<long long>(b) * a.nlist + tile] : 0.0f;
    const float4 raw = *reinterpret_cast<const float4*>(so + n * OS + r4);
    const float xs[4] = {raw.x, raw.y, raw.z, raw.w};
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = xs[j];
      if (a.scales != nullptr) x = __fmul_rn(x, rs[j]);
      if (a.cs != nullptr) x = __fadd_rn(x, add);
      v[j] = live[j] ? x : -INFINITY;
    }
    float* dst = a.out + orow * C + c0 + r4;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + r4 + j < C) __stcs(dst + j, v[j]);
    }
  }
}

template <typename TV, typename L, typename List>
int launch(const Scan& a, const List& list, dim3 grid, cudaStream_t stream) {
  auto kern = ivf_tc_kernel<TV, L, List>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, L::THREADS, L::SMEM, stream>>>(a, list);
  return static_cast<int>(cudaGetLastError());
}

template <typename TV, typename L>
int launch_union(const Scan& a, const int* union_ids, int U, cudaStream_t stream) {
  const dim3 grid(U, (a.C + L::RB - 1) / L::RB, (a.B + L::QN - 1) / L::QN);
  return launch<TV, L>(a, UnionList{union_ids, U}, grid, stream);
}

// max_groups: an upper bound on the groups (ceil(B * nprobe / QN) +
// min(nlist, B * nprobe)), the grid's x
template <typename TV, typename L>
int launch_groups(const Scan& a, const int* order, const int* pair_off, const int* group_off,
                  int nprobe, int max_groups, cudaStream_t stream) {
  const dim3 grid(max_groups, (a.C + L::RB - 1) / L::RB, 1);
  return launch<TV, L>(a, GroupList{order, pair_off, group_off, a.nlist, nprobe}, grid, stream);
}

// the per-query route in one values mode: the work list must have been cut
// into groups of the mode's own QN
template <typename TV>
int launch_mode_groups(const Scan& a, const int* order, const int* pair_off,
                       const int* group_off, int max_groups, int qg, int nprobe,
                       cudaStream_t stream) {
  if (qg != GroupCfg<TV>::QN) return static_cast<int>(cudaErrorInvalidValue);
  return launch_groups<TV, GroupCfg<TV>>(a, order, pair_off, group_off, nprobe, max_groups,
                                         stream);
}

}  // namespace utc

}  // namespace

// mode: 0 = int8 values + bf16 queries, 1 = bf16 values + bf16 queries,
//       2 = f32 values + f32 queries.  Both routes take every mode on the
//       tensor cores (mode 2 as three tf32 products, its queries the tf32
//       planes of ivf_tf32_planes).  Null scales / cs / mask pointers mean
//       the step is absent.  Each returns the cudaError_t of its launch (0
//       = success).

// The union route on the tensor cores, every mode, same operands (mode 2:
// q the [2B, D] tf32 planes of the f32 queries, ivf_tf32_planes).
extern "C" int ivf_union_tc_launch(int mode, const void* q, const int* union_ids,
                                   const void* values, const float* scales, const float* cs,
                                   const int* row_ids, const uint8_t* mask, int B, int U, int C,
                                   int D, int nlist, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const utc::Scan a{q, values, scales, cs, row_ids, mask, B, C, D, nlist, out};
  switch (mode) {
    case 0:
      return utc::launch_union<int8_t, utc::UnionCfg<int8_t>>(a, union_ids, U, s);
    case 1:
      return utc::launch_union<__nv_bfloat16, utc::UnionCfg<__nv_bfloat16>>(a, union_ids, U, s);
    case 2:
      return utc::launch_union<float, utc::UnionCfg<float>>(a, union_ids, U, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 mode's query planes: q, a row-major [B, D] f32 array (count = B
// D elements, a multiple of 4, 16-byte aligned), into out [2B, D]: rows 0
// .. B - 1 tf32_rna(q), rows B .. 2B - 1 tf32_rna(q - that).  Returns the
// cudaError_t of the launch.
extern "C" int ivf_tf32_planes(const float* q, float* out, long long count, void* stream) {
  return sm90::tf32_planes(q, out, count, static_cast<cudaStream_t>(stream));
}

// The per-query route on the tensor cores, every mode: the union's
// operands (mode 2: q the [2B, D] tf32 planes) with the work list
// (ops/ivf_topk.py probe_groups) in place of the union.  qg is the group
// size the list was cut with; it must equal the mode's QN.
extern "C" int ivf_probe_tc_launch(int mode, const void* q, const int* order,
                                   const int* pair_off, const int* group_off, int max_groups,
                                   int qg, const void* values, const float* scales,
                                   const float* cs, const int* row_ids, const uint8_t* mask,
                                   int B, int nprobe, int C, int D, int nlist, float* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const utc::Scan a{q, values, scales, cs, row_ids, mask, B, C, D, nlist, out};
  switch (mode) {
    case 0:
      return utc::launch_mode_groups<int8_t>(a, order, pair_off, group_off, max_groups, qg,
                                             nprobe, s);
    case 1:
      return utc::launch_mode_groups<__nv_bfloat16>(a, order, pair_off, group_off, max_groups,
                                                    qg, nprobe, s);
    case 2:
      return utc::launch_mode_groups<float>(a, order, pair_off, group_off, max_groups, qg,
                                            nprobe, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
