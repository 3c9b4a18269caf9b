// IVF cluster-tile scoring for Hopper (sm_90a): the two kernels of the IVF
// dense tier, called by super_rag_tpu_torch/ops/ivf_topk.py.
//
// Both compute, for a query b and a slot c of a cluster tile t,
//
//   s = dot(q[b], values[t, c, :])      f32 sum of exact products: bf16
//                                       queries x int8 codes / bf16 values,
//                                       or f32 x f32
//   s = s * scales[t, c]                (int8 values)
//   s = s + cs[b, t]                    (residual coding: the probe score)
//   s = -inf  where row_ids[t, c] < 0 or mask[row_ids[t, c]] == 0
//
// with __fmul_rn / __fadd_rn in the reference's order, so a result differs
// from the plain PyTorch version only in the dot product's summation
// order (an FMA chain, or the tensor cores' own).  Each (query, slot) sum runs in an order fixed by D alone, never
// by the batch, so a query scores alike in any batch.  Top-k stays in the
// caller (stable_topk over the candidate array).
//
// The union kernel replaces the TPU kernel of the JAX package's
// ops/pallas_ivf.py:93 _make_union_kernel (driven by _union_scores, :163):
// the whole query block against every tile of the batch's probe union,
// out [B, U, C].  Mosaic kept the epilogue out of that kernel; here it is
// fused.  What bounds it on an H100: the union's bytes (U*C*D int8 + the
// [B, U, C] f32 output; 512 tiles of 1280 x 768 at B = 32 is 0.59 GB,
// 0.177 ms at 3.35 TB/s), well above its 3.2e10 operations' 0.033 ms at
// the bf16 tensor-core peak.  Two variants (ops/ivf_topk.py union_variant):
//
// * ivf_union_tc_kernel (modes 0 and 1: int8 or bf16 values, bf16
//   queries) on the bf16 tensor cores, mma.sync.m16n8k16 with f32
//   accumulators.  Tile rows are M, queries N; one block holds 32 queries
//   (at B = 32 the whole batch, so every union tile is read from HBM once)
//   and 256 rows of one tile, two blocks an SM.  64-byte slices of the rows,
//   and the matching query slices, stream through a 4-stage cp.async ring;
//   each row load asks L2 for the row's next 256 bytes, which later stages
//   read.  int8 codes stay int8 in shared memory (ldmatrix) and are widened
//   to bf16 in registers with integer and bf16x2 arithmetic, exactly
//   (|code| <= 128; sm90_util.cuh s8x4_to_bf16x2).  The scores go through
//   shared memory so each query's rows leave in 16-byte coalesced streaming
//   stores, with the epilogue applied there; a row's scale and liveness are
//   loaded before the main loop.  The MMA adds in its own order, not an FMA
//   chain's, so the scores differ from the plain version's within the
//   summation tolerance; that order is fixed by D alone (a fixed 32-query
//   block, no split of D, no atomics), so a query scores bit-alike alone
//   and inside any batch.  On an H100 at the smoke's shapes an earlier
//   version that stored from the accumulators in 32-byte pieces took
//   0.42 ms, of which the stores were a large share; staging through shared
//   memory, streaming stores and the L2 prefetch brought it to 0.34 ms.
//   Deeper or wider rings, 128-row blocks, a persistent grid and bulk (TMA)
//   copies per row were slower.
// * ivf_union_kernel (mode 2, f32 x f32: TF32 would not keep the
//   tolerance), the first version: one block per (tile, 128 rows, 32
//   queries), 64-element slices staged in shared memory as f32, a 4 x 4
//   register tile of f32 FMAs per thread.
//
// ivf_probe_kernel replaces the TPU kernel of ops/pallas_ivf.py:48
// _make_kernel (the per-query probe stream inside pallas_ivf_topk, :201):
// one block per (query, probe), a matvec of the query against its probed
// [C, D] tile, out [B, nprobe, C].  It is bound by bytes: a query reads
// its own nprobe tiles, so at B = 512, nprobe 16 it streams 8 GB of tiles
// (2.4 ms at 3.35 TB/s) where the least work reads each distinct tile once
// (<= 1.0 GB, 0.31 ms); L2 serves what neighbouring blocks share.  Each
// warp scores one row at a time: its lanes read the row's 16-byte vectors
// side by side (coalesced), keep their slice of the query in registers,
// and reduce with a fixed xor-shuffle tree; four rows are in flight per
// warp to keep loads outstanding.
//
// Requirements checked by the Python wrapper: D % 16 == 0 (and D <= 1024
// for the per-query kernel), contiguous 16-byte aligned operands.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90_util.cuh"

namespace {

template <typename T> struct VecElems;  // elements per 16-byte vector
template <> struct VecElems<int8_t> { static constexpr int value = 16; };
template <> struct VecElems<__nv_bfloat16> { static constexpr int value = 8; };
template <> struct VecElems<float> { static constexpr int value = 4; };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }

// one 16-byte vector of `src` as VecElems<T> floats
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  const int4 v = *reinterpret_cast<const int4*>(src);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < VecElems<T>::value; ++i) dst[i] = to_f32<T>(e[i]);
}

__device__ __forceinline__ float epilogue(float s, long long slot, int b, long long tile,
                                          int nlist, const float* scales, const float* cs,
                                          const int* row_ids, const uint8_t* mask) {
  const int rid = row_ids[slot];
  const bool live = rid >= 0 && (mask == nullptr || mask[rid] != 0);
  if (scales != nullptr) s = __fmul_rn(s, scales[slot]);
  if (cs != nullptr) s = __fadd_rn(s, cs[static_cast<long long>(b) * nlist + tile]);
  return live ? s : -INFINITY;
}

// ---- union kernel, SIMT variant (mode 2: f32 x f32) ------------------------------------------------------------

constexpr int U_QB = 32;       // queries per block
constexpr int U_RC = 128;      // tile rows per block
constexpr int U_KC = 64;       // elements of D per staged slice
constexpr int U_SW = U_KC + 1;  // padded shared row stride (conflict-free reads)
constexpr int U_THREADS = 256;  // thread (ty, tx): queries ty + 8i, rows tx + 32j

template <typename TQ, typename TV>
__global__ void __launch_bounds__(U_THREADS)
ivf_union_kernel(const TQ* __restrict__ q, const int* __restrict__ union_ids,
                 const TV* __restrict__ values, const float* __restrict__ scales,
                 const float* __restrict__ cs, const int* __restrict__ row_ids,
                 const uint8_t* __restrict__ mask, int B, int U, int C, int D,
                 int nlist, float* __restrict__ out) {
  __shared__ float sq[U_QB * U_SW];
  __shared__ float sr[U_RC * U_SW];
  constexpr int EQ = VecElems<TQ>::value;
  constexpr int EV = VecElems<TV>::value;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int u = blockIdx.x;
  const int c0 = blockIdx.y * U_RC;
  const int b0 = blockIdx.z * U_QB;
  const long long tile = union_ids[u];
  const TV* vt = values + tile * static_cast<long long>(C) * D;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += U_KC) {
    const int ce = min(U_KC, D - k0);
    const int nvq = ce / EQ, nvv = ce / EV;
    for (int idx = tid; idx < U_QB * nvq; idx += U_THREADS) {
      const int r = idx / nvq, v = idx - r * nvq;
      float* dst = sq + r * U_SW + v * EQ;
      if (b0 + r < B) {
        load_vec<TQ>(q + static_cast<long long>(b0 + r) * D + k0 + v * EQ, dst);
      } else {
#pragma unroll
        for (int w = 0; w < EQ; ++w) dst[w] = 0.0f;
      }
    }
    for (int idx = tid; idx < U_RC * nvv; idx += U_THREADS) {
      const int r = idx / nvv, v = idx - r * nvv;
      float* dst = sr + r * U_SW + v * EV;
      if (c0 + r < C) {
        load_vec<TV>(vt + static_cast<long long>(c0 + r) * D + k0 + v * EV, dst);
      } else {
#pragma unroll
        for (int w = 0; w < EV; ++w) dst[w] = 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < ce; ++kk) {
      float a[4], r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 8 * i) * U_SW + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = sr[(tx + 32 * j) * U_SW + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], r[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + tx + 32 * j;
    if (c >= C) continue;
    const long long slot = tile * C + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty + 8 * i;
      if (b >= B) continue;
      out[(static_cast<long long>(b) * U + u) * C + c] =
          epilogue(acc[i][j], slot, b, tile, nlist, scales, cs, row_ids, mask);
    }
  }
}

// ---- union kernel, tensor-core variant (modes 0 and 1) ------------------------

namespace utc {

constexpr int QB = 32;       // queries per block: the N side, fixed (never chosen by B)

// RB tile rows per block (32 per warp), KSB bytes of each value row per
// stage, NST stages
template <typename TV, int RB_, int KSB_, int NST_>
struct Cfg {
  static constexpr int RB = RB_, KSB = KSB_, NST = NST_;
  static constexpr int THREADS = RB;  // RB / 32 warps
  static constexpr int KE = KSB / static_cast<int>(sizeof(TV));  // elements of D per stage
  // value row stride: int8 rows are read by ldmatrix (16 mod 32 bytes: 8
  // rows, 8 bank groups); bf16 rows by 8-byte loads (32 mod 64: 4 rows,
  // 32 banks)
  static constexpr int AS = sizeof(TV) == 1 ? KSB + 16 : KSB + 32;
  static constexpr int QSB = KE * 2 + 32;  // bf16 query row stride (bytes)
  static constexpr int STAGE = RB * AS + QB * QSB;
  static constexpr int OS = RB + 4;  // f32 stride of the [QB][RB] output stage
  static constexpr int SMEM = NST * STAGE > QB * OS * 4 ? NST * STAGE : QB * OS * 4;
};

// the configuration the port runs (chosen by timing on an H100; the note
// at the top of this file)
template <typename TV> using Default = Cfg<TV, 256, 64, 4>;

// One block: RB rows of one union tile against QB queries, D in stages of
// KE elements.  Tile rows are the MMA's M, queries its N.  Within each
// 16-wide k step the MMA's k order is permuted (logical 2t + j <- physical
// 4t + j, logical 8 + 2t + j <- physical 4t + 2 + j), the same for values
// and queries, so a lane's A and B fragments are 4 consecutive elements:
// one ldmatrix serves int8 codes, which are widened to bf16 in registers.
template <typename TV, typename L>
__global__ void __launch_bounds__(L::THREADS, 2)
ivf_union_tc_kernel(const __nv_bfloat16* __restrict__ q, const int* __restrict__ union_ids,
                    const TV* __restrict__ values, const float* __restrict__ scales,
                    const float* __restrict__ cs, const int* __restrict__ row_ids,
                    const uint8_t* __restrict__ mask, int B, int U, int C, int D, int nlist,
                    float* __restrict__ out) {
  constexpr int KE = L::KE, KSB = L::KSB, NST = L::NST, RB = L::RB, OS = L::OS;
  constexpr int THREADS = L::THREADS;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int u = blockIdx.x;
  const int c0 = blockIdx.y * RB;
  const int b0 = blockIdx.z * QB;
  const long long tile = union_ids[u];
  const long long row_bytes = static_cast<long long>(D) * sizeof(TV);
  const uint8_t* vt = reinterpret_cast<const uint8_t*>(values) + tile * C * row_bytes;
  const int nst = (D + KE - 1) / KE;

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
    const long long qb0 = static_cast<long long>(s) * KE * 2;  // byte offset in a query row
    constexpr int QV = KE * 2 / 16;
    for (int idx = tid; idx < QB * QV; idx += THREADS) {
      const int r = idx / QV, v = idx % QV;
      const long long kb = qb0 + v * 16;
      const bool ok = b0 + r < B && kb < 2LL * D;
      sm90::cp_async16(sqs + r * L::QSB + v * 16,
                       ok ? reinterpret_cast<const uint8_t*>(q) + (b0 + r) * 2LL * D + kb
                          : reinterpret_cast<const uint8_t*>(q),
                       ok ? 16 : 0);
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
      const int rid = row_ids[slot];
      live[j] = rid >= 0 && (mask == nullptr || mask[rid] != 0);
      if (scales != nullptr) rs[j] = scales[slot];
    }
  }
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
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
            uint32_t a[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if constexpr (sizeof(TV) == 1) {
                sm90::s8x4_to_bf16x2(r4v[mi][2 * h], a[mi][0], a[mi][2]);
                sm90::s8x4_to_bf16x2(r4v[mi][2 * h + 1], a[mi][1], a[mi][3]);
              } else {
                const uint8_t* row = sv + (warp * 32 + mi * 16 + gid) * L::AS + k16 * 32 + tig * 8;
                const uint2 lo = *reinterpret_cast<const uint2*>(row);
                const uint2 hi = *reinterpret_cast<const uint2*>(row + 8 * L::AS);
                a[mi][0] = lo.x;
                a[mi][2] = lo.y;
                a[mi][1] = hi.x;
                a[mi][3] = hi.y;
              }
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const uint2 bq = *reinterpret_cast<const uint2*>(sqs + (ni * 8 + gid) * L::QSB +
                                                               k16 * 32 + tig * 8);
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) sm90::mma_bf16_16816(acc[mi][ni], a[mi], bq.x, bq.y);
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
  float* so = reinterpret_cast<float*>(smem);  // [QB][OS]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        so[(ni * 8 + tig * 2 + (e & 1)) * OS + warp * 32 + mi * 16 + gid + (e >> 1) * 8] =
            acc[mi][ni][e];
  __syncthreads();

  const bool vec = (C & 3) == 0 && c0 + r4 + 3 < C;
#pragma unroll
  for (int i = 0; i < QB / 4; ++i) {
    const int n = tid / (RB / 4) + 4 * i;
    const int b = b0 + n;
    if (b >= B) break;
    const float add = cs != nullptr ? cs[static_cast<long long>(b) * nlist + tile] : 0.0f;
    const float4 raw = *reinterpret_cast<const float4*>(so + n * OS + r4);
    const float xs[4] = {raw.x, raw.y, raw.z, raw.w};
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = xs[j];
      if (scales != nullptr) x = __fmul_rn(x, rs[j]);
      if (cs != nullptr) x = __fadd_rn(x, add);
      v[j] = live[j] ? x : -INFINITY;
    }
    float* dst = out + (static_cast<long long>(b) * U + u) * C + c0 + r4;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + r4 + j < C) __stcs(dst + j, v[j]);
    }
  }
}

template <typename TV>
int launch(const void* q, const int* union_ids, const void* values, const float* scales,
           const float* cs, const int* row_ids, const uint8_t* mask, int B, int U, int C,
           int D, int nlist, float* out, cudaStream_t stream) {
  using L = Default<TV>;
  constexpr int smem = L::SMEM;
  auto kern = ivf_union_tc_kernel<TV, L>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(U, (C + L::RB - 1) / L::RB, (B + QB - 1) / QB);
  kern<<<grid, L::THREADS, smem, stream>>>(static_cast<const __nv_bfloat16*>(q), union_ids,
                                           static_cast<const TV*>(values), scales, cs, row_ids,
                                           mask, B, U, C, D, nlist, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace utc

// ---- per-query kernel ----------------------------------------------------------

constexpr int P_THREADS = 256;  // 8 warps, each scoring one row at a time
constexpr int P_MAXD = 1024;
constexpr int P_ROWS = 4;  // rows in flight per warp

template <typename TQ, typename TV>
__global__ void __launch_bounds__(P_THREADS)
ivf_probe_kernel(const TQ* __restrict__ q, const int* __restrict__ probes,
                 const TV* __restrict__ values, const float* __restrict__ scales,
                 const float* __restrict__ cs, const int* __restrict__ row_ids,
                 const uint8_t* __restrict__ mask, int B, int nprobe, int C, int D,
                 int nlist, float* __restrict__ out) {
  constexpr int EV = VecElems<TV>::value;
  constexpr int NCH = P_MAXD / EV / 32;  // 16-byte vectors per lane, at most
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = probes[static_cast<long long>(b) * nprobe + j];
  const TV* vt = values + tile * static_cast<long long>(C) * D;
  const int nvec = D / EV;

  // this lane's slice of the query: elements of vectors lane, lane + 32, ...
  float qr[NCH][EV];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int v = lane + 32 * ch;
#pragma unroll
    for (int e = 0; e < EV; ++e)
      qr[ch][e] = v < nvec ? to_f32<TQ>(q[static_cast<long long>(b) * D + v * EV + e]) : 0.0f;
  }

  for (int c = warp * P_ROWS; c < C; c += 8 * P_ROWS) {
    float part[P_ROWS];
#pragma unroll
    for (int r = 0; r < P_ROWS; ++r) part[r] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int v = lane + 32 * ch;
      if (v >= nvec) continue;
      float x[P_ROWS][EV];
#pragma unroll
      for (int r = 0; r < P_ROWS; ++r) {
        if (c + r < C) {
          load_vec<TV>(vt + static_cast<long long>(c + r) * D + v * EV, x[r]);
        } else {
#pragma unroll
          for (int e = 0; e < EV; ++e) x[r][e] = 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < P_ROWS; ++r)
#pragma unroll
        for (int e = 0; e < EV; ++e) part[r] = fmaf(qr[ch][e], x[r][e], part[r]);
    }
#pragma unroll
    for (int r = 0; r < P_ROWS; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
    }
    if (lane < P_ROWS && c + lane < C) {
      float s = part[0];
#pragma unroll
      for (int r = 1; r < P_ROWS; ++r)
        if (lane == r) s = part[r];
      out[(static_cast<long long>(b) * nprobe + j) * C + c + lane] =
          epilogue(s, tile * C + c + lane, b, tile, nlist, scales, cs, row_ids, mask);
    }
  }
}

template <typename TQ, typename TV>
int launch_union(const void* q, const int* union_ids, const void* values, const float* scales,
                 const float* cs, const int* row_ids, const uint8_t* mask, int B, int U,
                 int C, int D, int nlist, float* out, cudaStream_t stream) {
  const dim3 grid(U, (C + U_RC - 1) / U_RC, (B + U_QB - 1) / U_QB);
  ivf_union_kernel<TQ, TV><<<grid, U_THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), union_ids, static_cast<const TV*>(values), scales, cs,
      row_ids, mask, B, U, C, D, nlist, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TV>
int launch_probe(const void* q, const int* probes, const void* values, const float* scales,
                 const float* cs, const int* row_ids, const uint8_t* mask, int B, int nprobe,
                 int C, int D, int nlist, float* out, cudaStream_t stream) {
  const dim3 grid(B, nprobe);
  ivf_probe_kernel<TQ, TV><<<grid, P_THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), probes, static_cast<const TV*>(values), scales, cs,
      row_ids, mask, B, nprobe, C, D, nlist, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 = int8 values + bf16 queries, 1 = bf16 values + bf16 queries,
//       2 = f32 values + f32 queries.  The union kernel takes mode 2 in
//       ivf_union_launch and modes 0 and 1 in ivf_union_tc_launch.
// Null scales / cs / mask pointers mean the step is absent.
// Each returns the cudaError_t of its launch (0 = success).
extern "C" int ivf_union_launch(int mode, const void* q, const int* union_ids,
                                const void* values, const float* scales, const float* cs,
                                const int* row_ids, const uint8_t* mask, int B, int U, int C,
                                int D, int nlist, float* out, void* stream) {
  if (mode != 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_union<float, float>(q, union_ids, values, scales, cs, row_ids, mask, B, U, C, D,
                                    nlist, out, static_cast<cudaStream_t>(stream));
}

extern "C" int ivf_probe_launch(int mode, const void* q, const int* probes,
                                const void* values, const float* scales, const float* cs,
                                const int* row_ids, const uint8_t* mask, int B, int nprobe,
                                int C, int D, int nlist, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_probe<__nv_bfloat16, int8_t>(q, probes, values, scales, cs, row_ids,
                                                 mask, B, nprobe, C, D, nlist, out, s);
    case 1:
      return launch_probe<__nv_bfloat16, __nv_bfloat16>(q, probes, values, scales, cs,
                                                        row_ids, mask, B, nprobe, C, D,
                                                        nlist, out, s);
    case 2:
      return launch_probe<float, float>(q, probes, values, scales, cs, row_ids, mask, B,
                                        nprobe, C, D, nlist, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The union kernel's tensor-core variant (modes 0 and 1), same operands.
extern "C" int ivf_union_tc_launch(int mode, const void* q, const int* union_ids,
                                   const void* values, const float* scales, const float* cs,
                                   const int* row_ids, const uint8_t* mask, int B, int U, int C,
                                   int D, int nlist, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0:
      return utc::launch<int8_t>(q, union_ids, values, scales, cs, row_ids, mask, B, U, C, D,
                                 nlist, out, s);
    case 1:
      return utc::launch<__nv_bfloat16>(q, union_ids, values, scales, cs, row_ids, mask, B, U,
                                        C, D, nlist, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
