// What the two K2b kernels share (fused_backward.cu: bf16 states;
// fused_backward_tf32.cu: f32 states): the readers tables of the slot
// gathers, the column sums of an m16 x n128 accumulator into a warp's
// vector partial, the fixed-order sum of the blocks' partials and the
// launch.  Both kernels keep the mma fragment layout of rounds_mma.cuh
// (acc[j][2 h + c]: row g + 8 h, column 8 j + 2 t + c).
#pragma once

#include "rounds_common.cuh"

namespace rounds {
namespace bwd {

// The readers table of one direction: for each source row, the destination
// slots r * D + k that read it (with slots = false, the rows r), in (row,
// slot) order; off has src_rows + 1 entries.  idx is the slot table, in
// shared or global memory; off and lst are visible to the block on return.
__device__ inline void build_readers(const int* idx, int rows, int D, int src_rows, int* off,
                                     int* lst, bool slots = false) {
  const int n = rows * D;
  for (int sr = threadIdx.x; sr < src_rows; sr += THREADS) {
    int c = 0;
    for (int e = 0; e < n; ++e) c += idx[e] == sr;
    off[sr + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int sr = 0; sr < src_rows; ++sr) off[sr + 1] += off[sr];
  }
  __syncthreads();
  for (int sr = threadIdx.x; sr < src_rows; sr += THREADS) {
    int o = off[sr];
    for (int e = 0; e < n; ++e)
      if (idx[e] == sr) lst[o++] = slots ? e : e / D;
  }
  __syncthreads();
}

// p[0..1] += (a, b) for an f32 element pair that only this thread updates:
// a reduction without a return value, so the thread does not wait for the
// load, and in the thread's program order, so the sum is the same on every
// run.
__device__ __forceinline__ void red_add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// Sum v (v[2 j + c]: this thread's rows g and g + 8 already added, column
// 8 j + 2 t + c) over the 8 lanes that share t, by halving exchanges; each
// lane ends with the sums of columns 16 g + 2 t + {0, 1, 8, 9} and adds them
// to row p (f32, [H]) of its warp's partial.
template <int W>
__device__ __forceinline__ void colsum_halve(float (&v)[32], bool hi) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = hi ? v[i] : v[W + i];
    const float keep = hi ? v[W + i] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

static __device__ __noinline__ void colsum_add(float (&v)[32], float* p) {
  const int lane = threadIdx.x & 31;
  colsum_halve<16>(v, lane & 16);
  colsum_halve<8>(v, lane & 8);
  colsum_halve<4>(v, lane & 4);
  const int c = 16 * (lane >> 2) + 2 * (lane & 3);
  red_add2(p + c, v[0], v[1]);
  red_add2(p + c + 8, v[2], v[3]);
}

// dmats = sum over blocks of part_mats; dvecs = sum over blocks and warps of
// part_vecs; every element summed in the same order on every run.
static __global__ void reduce_partials(const float* __restrict__ part_mats,
                                       const float* __restrict__ part_vecs, float* dmats,
                                       float* dvecs, int G) {
  const int nm = 10 * HH, nv = 14 * H;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nm + nv;
       e += gridDim.x * blockDim.x) {
    float sum = 0.f;
    if (e < nm) {
      for (int g = 0; g < G; ++g) sum += part_mats[size_t(g) * nm + e];
      dmats[e] = sum;
    } else {
      const int v = e - nm;
      for (int g = 0; g < G * WARPS; ++g) sum += part_vecs[size_t(g) * nv + v];
      dvecs[v] = sum;
    }
  }
}

// The adjoint kernel on `grid` blocks of `smem` bytes, then the sum of the
// partials; the first launch error (0 on success).
template <typename K, typename... Args>
int launch_adjoint(K kernel, int grid, size_t smem, cudaStream_t stream, float* part_mats,
                   float* part_vecs, float* dmats, float* dvecs, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n = 10 * HH + 14 * H;
  reduce_partials<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      part_mats, part_vecs, dmats, dvecs, grid);
  return int(cudaGetLastError());
}

}  // namespace bwd
}  // namespace rounds
