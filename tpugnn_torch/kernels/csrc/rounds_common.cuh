// Device helpers shared by the fused-rounds kernels (fused_rounds.cu: K1 and
// K2a; fused_backward.cu: K2b).  One block of 256 threads works on one
// sample at a time; a warp owns 4 rows of a 32-row chunk and each lane 4 of
// the 128 columns, so a row reduction is one warp reduction.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace rounds {

constexpr int H = 128;          // node state width = message width
constexpr int HH = H * H;
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int CH = 32;          // rows per chunk: 8 warps x 4 rows
constexpr int KS = 16;          // weight rows staged per slab
constexpr int XLD = H + 4;      // padded row stride (floats) of chunk buffers
constexpr int NMAT = 5;         // matrices per direction in the weight pack
constexpr int NVEC = 7;         // vectors per direction in the vector pack
enum { M_WD = 0, M_UX = 1, M_WS = 2, M_WF = 3, M_W1 = 4 };
enum { V_B0 = 0, V_BOA = 1, V_UCS = 2, V_UB0 = 3, V_UB1 = 4, V_LNS = 5, V_LNB = 6 };

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 q = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&q.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&a);
  q.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}
// round an f32 value to the storage type and back
__device__ __forceinline__ float rnd(float x, float) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// acc[m][i][j] (+)= sum_k A[4*warp + i][k] * W_m[k][4*lane + j] for the NW
// consecutive [H][H] matrices starting at W.  A is a [CH][XLD] f32 chunk in
// shared memory; the weights pass through the shared slab wsl (KS rows of
// NW * H).  ACC adds to acc instead of overwriting it.  Every thread of the
// block calls this (it synchronises on entry, not on exit).
template <typename T, int NW, bool ACC = false>
__device__ __forceinline__ void gemm_chunk(const float* A, const T* __restrict__ W,
                                           T* wsl, float (&acc)[NW][4][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (!ACC) {
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;
  }

  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte copy
  constexpr int UNITS = KS * NW * H / VEC;
  for (int k0 = 0; k0 < H; k0 += KS) {
    __syncthreads();  // the previous slab's readers are done; A is written
    for (int u = tid; u < UNITS; u += THREADS) {
      const int e = u * VEC;
      const int kk = e / (NW * H);
      const int rem = e - kk * NW * H;
      const int m = rem / H;
      const int c = rem - m * H;
      *reinterpret_cast<uint4*>(wsl + kk * NW * H + m * H + c) =
          __ldg(reinterpret_cast<const uint4*>(W + size_t(m) * H * H + size_t(k0 + kk) * H + c));
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(warp * 4 + i) * XLD + k0 + kk];
#pragma unroll
      for (int m = 0; m < NW; ++m) {
        float w[4];
        load4(wsl + kk * NW * H + m * H + lane * 4, w);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][i][j] = fmaf(a[i], w[j], acc[m][i][j]);
      }
    }
  }
}

// Load rows [row0, row0 + CH) of a [rows][H] array into the f32 chunk buffer
// (zeros past the last row).  No __ldg: the source may be rewritten in the
// launch.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* x, int row0, int rows, float* xs) {
  for (int e = threadIdx.x * 4; e < CH * H; e += THREADS * 4) {
    const int r = e / H, c = e - r * H;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < rows) load4(x + size_t(row0 + r) * H + c, v);
    store4(xs + r * XLD + c, v);
  }
}

// panel[r] = rnd(x[r] @ W) for all rows (the source projection a gather
// reads), through the chunk buffer xs and the slab wsl.
template <typename T>
__device__ void project_rows(const T* x, int rows, const T* __restrict__ W, T* panel,
                             float* xs, T* wsl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row0 = 0; row0 < rows; row0 += CH) {
    __syncthreads();  // the previous chunk's readers of xs are done
    load_chunk(x, row0, rows, xs);
    float acc[1][4][4];
    gemm_chunk<T, 1>(xs, W, wsl, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + warp * 4 + i;
      if (r < rows) store4(panel + size_t(r) * H + lane * 4, acc[0][i]);
    }
  }
}

// Copy n 16-byte units from src to dst, the whole block.
__device__ __forceinline__ void block_copy16(void* dst, const void* src, size_t n) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (size_t u = threadIdx.x; u < n; u += THREADS) d[u] = s[u];
}

}  // namespace rounds
