// Device helpers shared by the rounds kernels (fused_rounds.cu: K1 and
// K2a; fused_backward.cu and fused_backward_tf32.cu: K2b; roll_gather.cu:
// K5): the layout constants of the packs, loads and stores of 4 columns,
// rounding to the state type and a block-wide copy.  The products are in rounds_mma.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace rounds {

constexpr int H = 128;          // node state width = message width
constexpr int HH = H * H;
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
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

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Copy n 16-byte units from src to dst, the whole block.
__device__ __forceinline__ void block_copy16(void* dst, const void* src, size_t n) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (size_t u = threadIdx.x; u < n; u += THREADS) d[u] = s[u];
}

}  // namespace rounds
