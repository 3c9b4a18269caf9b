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
// order.  Each (query, slot) sum runs in an order fixed by D alone, never
// by the batch, so a query scores alike in any batch.  Top-k stays in the
// caller (stable_topk over the candidate array).
//
// ivf_union_kernel replaces the TPU kernel of the JAX package's
// ops/pallas_ivf.py:93 _make_union_kernel (driven by _union_scores, :163):
// the whole query block against every tile of the batch's probe union,
// out [B, U, C].  Mosaic kept the epilogue out of that kernel; here it is
// fused.  What bounds it on an H100: the union's bytes, read once per
// 32-query block (U*C*D int8 + the [B, U, C] f32 output; 512 tiles of
// 1280 x 768 at B = 32 is 0.59 GB, 0.175 ms at 3.35 TB/s), well above its
// 3.2e10 operations' 0.033 ms at the bf16 tensor-core peak.  This first
// version does no tensor-core work: one block per (tile, 128 rows, 32
// queries) stages 64-element slices of its rows and queries in shared
// memory (16-byte coalesced row loads) and each thread keeps a 4 x 4
// register tile of f32 FMAs.  Rows are read once per query block; the
// small query block is re-read from L2 by each row block.
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

// ---- union kernel ------------------------------------------------------------

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
//       2 = f32 values + f32 queries.
// Null scales / cs / mask pointers mean the step is absent.
// Each returns the cudaError_t of its launch (0 = success).
extern "C" int ivf_union_launch(int mode, const void* q, const int* union_ids,
                                const void* values, const float* scales, const float* cs,
                                const int* row_ids, const uint8_t* mask, int B, int U, int C,
                                int D, int nlist, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_union<__nv_bfloat16, int8_t>(q, union_ids, values, scales, cs, row_ids,
                                                 mask, B, U, C, D, nlist, out, s);
    case 1:
      return launch_union<__nv_bfloat16, __nv_bfloat16>(q, union_ids, values, scales, cs,
                                                        row_ids, mask, B, U, C, D, nlist,
                                                        out, s);
    case 2:
      return launch_union<float, float>(q, union_ids, values, scales, cs, row_ids, mask, B,
                                        U, C, D, nlist, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
