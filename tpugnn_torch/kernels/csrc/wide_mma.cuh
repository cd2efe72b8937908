// Tile products of the wide rounds kernels (wide_rounds.cu: K1, K2a, K2b and
// K5 at W = 256, 384 or 512 columns), on the tensor cores with the
// primitives of rounds_mma.cuh: bf16 mma.sync.m16n8k16 with f32
// accumulation, and f32 as three TF32 products (3xTF32) on m16n8k8.
//
// A block is W threads: W / 32 warps, warp w owning the 32 columns [32 w,
// 32 w + 32) (four n-tiles of 8) of every product, over a tile of TR = 32
// rows (two m-tiles of 16).  The A operand is a row-major buffer in shared
// memory with a leading dimension (`lda`, in elements): the states (LDF = W
// + 4 floats, or LDH = W + 8 bf16 a row, so that the 8 rows of a fragment
// fall on distinct banks).  The weights come from global memory (L2), packed
// once a call in fragment order (fused_decoder.py: tf32_split_pack and
// bf16_frag_pack at width W): for k-step s and n-tile j a lane reads its B
// fragment with one load, a float4 {hi w[8s+t][8j+g], hi w[8s+t+4][8j+g], lo
// .., lo ..} in f32, a uint2 {w[16s+2t][n], w[16s+2t+1][n], w[16s+2t+8][n],
// w[16s+2t+9][n]} (n = 8j + g) in bf16.
//
// Accumulators: acc[m][j][e] is row 16 m + g + 8 (e >> 1), column 32 w + 8 j
// + 2 t + (e & 1) of the tile (lane = 4 g + t), as the fragment layout of
// mma.sync gives it.  In f32 each 16-row k-slab's three products go to a
// fresh accumulator that is added to acc on the CUDA cores (the tensor cores'
// f32 accumulation truncates; PERF.md §6).
#pragma once

#include "rounds_mma.cuh"

namespace rounds {
namespace wide {

typedef __nv_bfloat16 bf16;
constexpr int TR = 32;       // rows of a tile
constexpr int MT = TR / 16;  // m-tiles of a tile
constexpr int NJ = 4;        // n-tiles of a warp (32 columns)
constexpr int WMAX = 512;    // the widest pack the kernels take

// the A-buffer row stride of a state type at width W, in elements
template <typename T>
__host__ __device__ inline int ld_of(int W);
template <>
__host__ __device__ inline int ld_of<float>(int W) { return W + 4; }
template <>
__host__ __device__ inline int ld_of<bf16>(int W) { return W + 8; }

__host__ __device__ inline size_t tile_bytes(int ld, size_t elem) {
  return align16(size_t(TR) * ld * elem);
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// round an f32 value to the state type and back
template <typename T>
__device__ __forceinline__ float rnd_t(float v) { return to_f<T>(from_f<T>(v)); }

__device__ __forceinline__ void zero_acc(float (&acc)[MT][NJ][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// Rows [0, n) of a row-major [*][W] array into a TR-row buffer of stride ld
// (zeros past n), the whole block, 16 bytes a thread at a time.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int n, int W) {
  constexpr int V = 16 / sizeof(T);
  const int upr = W / V;
  for (int u = threadIdx.x; u < TR * upr; u += blockDim.x) {
    const int r = u / upr, c = (u - r * upr) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) v = *reinterpret_cast<const uint4*>(src + size_t(r) * W + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// acc (+)= A[0:TR, 0:K] @ Wp[0:K, this warp's 32 columns], A f32 (stride
// lda), Wp the split pack of one [K][W] matrix; 3xTF32.
__device__ __forceinline__ void mma_rows(float (&acc)[MT][NJ][4], const float* A, int lda,
                                         const float* __restrict__ Wp, int K, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = W / 8;
  const float4* wp = reinterpret_cast<const float4*>(Wp) + size_t(NJ * warp) * 32 + lane;
#pragma unroll 1
  for (int s16 = 0; s16 < K / 16; ++s16) {
    uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* a = A + (16 * m) * lda + 16 * s16 + 8 * kk + t;
        tf32::split(a[g * lda], ah[m][kk][0], al[m][kk][0]);
        tf32::split(a[(g + 8) * lda], ah[m][kk][1], al[m][kk][1]);
        tf32::split(a[g * lda + 4], ah[m][kk][2], al[m][kk][2]);
        tf32::split(a[(g + 8) * lda + 4], ah[m][kk][3], al[m][kk][3]);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float4 w[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        w[kk] = __ldg(wp + (size_t(2 * s16 + kk) * ntiles + j) * 32);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t wh0 = __float_as_uint(w[kk].x), wh1 = __float_as_uint(w[kk].y);
          const uint32_t wl0 = __float_as_uint(w[kk].z), wl1 = __float_as_uint(w[kk].w);
          tf32::mma_tf32(c, al[m][kk], wh0, wh1);
          tf32::mma_tf32(c, ah[m][kk], wl0, wl1);
          tf32::mma_tf32(c, ah[m][kk], wh0, wh1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += c[e];
      }
    }
  }
}

// The same with A in bf16 (stride lda) and Wp the bf16 fragment pack.
__device__ __forceinline__ void mma_rows(float (&acc)[MT][NJ][4], const bf16* A, int lda,
                                         const bf16* __restrict__ Wp, int K, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = W / 8;
  const uint2* wp = reinterpret_cast<const uint2*>(Wp) + size_t(NJ * warp) * 32 + lane;
#pragma unroll 2
  for (int s = 0; s < K / 16; ++s) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      tc::ldsm_x4(a[m], A + (16 * m + (lane & 15)) * lda + 16 * s + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint2 b = __ldg(wp + (size_t(s) * ntiles + j) * 32);
#pragma unroll
      for (int m = 0; m < MT; ++m) tc::mma_bf16(acc[m][j], a[m], b.x, b.y);
    }
  }
}

// The weight-gradient tile: acc (+)= A[rows, 0:16 MW]^T @ G[rows, this
// warp's 32 columns] over KR staged rows, A staged [KR][lda_a] and G
// [KR][lda_g] in shared memory; acc[m] covers the output rows 16 m .. 16 m +
// 15 of the block's MW m-tiles.  f32: both operands split in registers, one
// fresh accumulator per 16 rows.
template <int MW>
__device__ __forceinline__ void mma_atb(float (&acc)[MW][NJ][4], const float* A, int lda_a,
                                        const float* G, int lda_g, int KR) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int k16 = 0; k16 < KR; k16 += 16) {
    uint32_t bh[NJ][2][2], bl[NJ][2][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* b = G + (k16 + 8 * kk + t) * lda_g + 32 * warp + 8 * j + g;
        tf32::split(b[0], bh[j][kk][0], bl[j][kk][0]);
        tf32::split(b[4 * lda_g], bh[j][kk][1], bl[j][kk][1]);
      }
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // A^T element (i, k) is staged row k, column i
        const float* a = A + (k16 + 8 * kk + t) * lda_a + 16 * m + g;
        tf32::split(a[0], ah[kk][0], al[kk][0]);
        tf32::split(a[8], ah[kk][1], al[kk][1]);
        tf32::split(a[4 * lda_a], ah[kk][2], al[kk][2]);
        tf32::split(a[4 * lda_a + 8], ah[kk][3], al[kk][3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          tf32::mma_tf32(c, al[kk], bh[j][kk][0], bh[j][kk][1]);
          tf32::mma_tf32(c, ah[kk], bl[j][kk][0], bl[j][kk][1]);
          tf32::mma_tf32(c, ah[kk], bh[j][kk][0], bh[j][kk][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += c[e];
      }
    }
  }
}

// The same in bf16: the transposed A fragment and the B fragment through
// ldmatrix.trans from the row-major staged rows.
template <int MW>
__device__ __forceinline__ void mma_atb(float (&acc)[MW][NJ][4], const bf16* A, int lda_a,
                                        const bf16* G, int lda_g, int KR) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int k16 = 0; k16 < KR; k16 += 16) {
    uint32_t b[NJ / 2][4];
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p)
      tc::ldsm_x4_t(b[p], G + (k16 + (lane & 15)) * lda_g + 32 * warp + 16 * p +
                              (lane >> 4) * 8);
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      // matrices: (i 0-7, k 0-7), (i 8-15, k 0-7), (i 0-7, k 8-15), (i 8-15, k 8-15)
      uint32_t a[4];
      tc::ldsm_x4_t(a, A + (k16 + (lane & 7) + ((lane >> 4) << 3)) * lda_a + 16 * m +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p) {
        tc::mma_bf16(acc[m][2 * p], a, b[p][0], b[p][1]);
        tc::mma_bf16(acc[m][2 * p + 1], a, b[p][2], b[p][3]);
      }
    }
  }
}

}  // namespace wide
}  // namespace rounds
