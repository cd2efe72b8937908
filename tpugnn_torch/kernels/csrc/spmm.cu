// ELL slot-table aggregation of per-edge messages into rows (Hopper).
//
// K3a (sum; mean is the sum, scaled by the caller) replaces the TPU kernel
// tpugnn/kernels/spmm.py::_ell_aggregate_impl (pl.pallas_call at :79, body
// _spmm_kernel at :61); K3b (max) replaces _ell_max_impl (pl.pallas_call at
// :129, body _spmax_kernel at :102).  The function is the one
// tpugnn_torch/kernels/spmm.py::ell_aggregate_plain / ell_max_plain compute:
//
//   sum: out[b][r][f] = sum over slots k of row r with tbl[r][k] >= 0 of
//        msg[b][tbl[r][k]][f]
//   max: the same walk with a running max from -inf; a row with no valid
//        slot (still -inf) writes 0.  NaN propagates, as jnp.maximum does.
//
// msg [B][E][F] in f32 or bf16 (read as f32), out [B][rows][F] f32, tbl
// [rows][D] int32: the source edge of each slot, -1 for a masked slot (the
// wrapper builds it from slot_edge and slot_mask).  Indices must be < E, as
// the graph builder makes them.
//
// The TPU kernel runs the sum as an incidence GEMM S @ msg[b] and the max
// through a one-hot gather GEMM, because Mosaic has no dynamic gather.  Here
// each slot is a gather by index, in slot order.  Bound on an H100: bytes.
// The kernel reads every real edge's message once and writes every row once
// (at d=11, B=4096, F=128, f32: about 0.9 GB read and 0.25 GB written per
// direction, 0.35 ms at 3.35 TB/s); the adds are a few hundred MFLOP.
// Design: a block of 256 threads covers up to 32 rows of one sample; the
// block's slice of the slot table sits in shared memory; a row's lanes read
// its F columns in 16-byte (f32) or 8-byte (bf16) vectors, so one warp reads
// a whole 128-wide f32 row per slot, coalesced; sums accumulate in f32
// registers in slot order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 32;           // rows per block
constexpr int SMEM_INTS = 12288;       // 48 KB of slot table per block at most

template <int VEC>
__device__ __forceinline__ void loadv(const float* p, float v[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float v[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void storev(float* p, const float v[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// grid (B, ceil(rows / rows_per_block)); block (lanes, THREADS / lanes)
template <typename T, int VEC, bool MAX>
__global__ void __launch_bounds__(THREADS)
ell_reduce(const T* __restrict__ msg, const int* __restrict__ tbl,
           float* __restrict__ out, int E, int F, int rows, int D, int rows_per_block) {
  extern __shared__ int stbl[];
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = min(rows_per_block, rows - r0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < nr * D; i += blockDim.x * blockDim.y)
    stbl[i] = tbl[size_t(r0) * D + i];
  __syncthreads();

  const T* m = msg + size_t(b) * E * F;
  for (int lr = threadIdx.y; lr < nr; lr += blockDim.y) {
    const int* t = stbl + lr * D;
    float* o = out + (size_t(b) * rows + r0 + lr) * F;
    for (int f = threadIdx.x * VEC; f < F; f += blockDim.x * VEC) {
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = MAX ? -INFINITY : 0.f;
      for (int k = 0; k < D; ++k) {
        const int e = t[k];
        if (e < 0) continue;
        float v[VEC];
        loadv<VEC>(m + size_t(e) * F + f, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (MAX)
            acc[j] = (v[j] > acc[j] || v[j] != v[j]) ? v[j] : acc[j];
          else
            acc[j] += v[j];
        }
      }
      if (MAX) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (acc[j] == -INFINITY) acc[j] = 0.f;
      }
      storev<VEC>(o + f, acc);
    }
  }
}

template <typename T, int VEC>
int launch_typed(bool is_max, const void* msg, const int* tbl, float* out, int B, int E,
                 int F, int rows, int D, cudaStream_t stream) {
  int lanes = (F + VEC - 1) / VEC;
  lanes = ((lanes + 31) / 32) * 32;
  if (lanes > THREADS) lanes = THREADS;
  const dim3 block(lanes, THREADS / lanes);
  int rpb = SMEM_INTS / (D > 0 ? D : 1);
  if (rpb > MAX_ROWS) rpb = MAX_ROWS;
  if (rpb < 1) return int(cudaErrorInvalidValue);
  const dim3 grid(B, (rows + rpb - 1) / rpb);
  const size_t smem = size_t(rpb) * D * sizeof(int);
  const T* m = static_cast<const T*>(msg);
  if (is_max)
    ell_reduce<T, VEC, true><<<grid, block, smem, stream>>>(m, tbl, out, E, F, rows, D, rpb);
  else
    ell_reduce<T, VEC, false><<<grid, block, smem, stream>>>(m, tbl, out, E, F, rows, D, rpb);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dtype(bool is_max, const void* msg, const int* tbl, float* out, int B, int E,
                 int F, int rows, int D, cudaStream_t stream) {
  // 4-wide vectors need F % 4 == 0 and a base aligned to the vector
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(msg) % (4 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) return launch_typed<T, 4>(is_max, msg, tbl, out, B, E, F, rows, D, stream);
  return launch_typed<T, 1>(is_max, msg, tbl, out, B, E, F, rows, D, stream);
}

}  // namespace

extern "C" {

// dtype_code: 0 = f32 messages, 1 = bf16 messages.  Returns the CUDA error
// code of the launch (0 = launched).
int ell_aggregate_launch(int dtype_code, int is_max, const void* msg, const int* tbl,
                         float* out, int B, int E, int F, int rows, int D,
                         cudaStream_t stream) {
  if (B <= 0 || E <= 0 || F <= 0 || rows <= 0 || D <= 0)
    return int(cudaErrorInvalidValue);
  if (dtype_code == 0)
    return launch_dtype<float>(is_max != 0, msg, tbl, out, B, E, F, rows, D, stream);
  if (dtype_code == 1)
    return launch_dtype<__nv_bfloat16>(is_max != 0, msg, tbl, out, B, E, F, rows, D, stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
