// Fused dense scoring + tile-local top-kt for Hopper (sm_90a).
//
// Replaces the TPU kernel the JAX package's ops/pallas_topk.py:36 _make_kernel
// (driven by pallas_dense_topk, :106).  For each logical tile of `tile`
// corpus rows and each query b it computes
//
//   s[b, t] = q[b] . c[t]             int8 x int8 -> int32 (dp4a), or f32 sums
//           * qscale[b]               (int8 x int8 mode only)
//           * row_scale[t]            (int8 corpora)
//   s       = 2 s - norms_sq[t]       (L2)
//   s       = -inf                    (mask[t] == 0, or t >= n: padding)
//
// and then runs kt rounds of max / first-argmax / suppress over the tile's
// scores, as the reference does: values descending, lowest column first
// among ties, and once only -inf is left every further round yields
// (-inf, column 0).  Output: vals/ids [num_tiles, B, kt], ids = tile*T + col.
//
// What bounds it on an H100: the corpus read (N x D bytes in int8, ~0.77 GB
// at 1M x 768: 0.23 ms at 3.35 TB/s) for small batches, and the int8 work
// (2 B N D operations: 0.40 ms at 1,979 TOP/s) at batch 512.  This first
// version uses no tensor cores: dp4a (or FMA) from shared memory with a
// 4 x 4 register tile per thread, so it is bound by the CUDA-core integer
// rate and shared-memory bandwidth, far above the bound.  What the design
// does about the bytes: each block keeps its whole [16 x tile] score tile in
// shared memory and writes only the kt winners, so the corpus is read once
// per 16-query block (neighbouring query blocks of a tile run together and
// share it through L2) and no score matrix ever reaches device memory.
// wgmma / TMA / a persistent grid are later work.
//
// Modes (template parameters):
//   int8 x int8 : q int8 [B, D] + qscale f32 [B]; corpus int8
//   int8 corpus, bf16 queries; bf16 corpus, bf16 queries; f32 x f32.
// Requirements checked by the Python wrapper: D % 16 == 0, 16-byte aligned
// row-major operands, tile <= 2048.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ bool better(float v1, int c1, float v2, int c2) {
  return v1 > v2 || (v1 == v2 && c1 < c2);
}

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
