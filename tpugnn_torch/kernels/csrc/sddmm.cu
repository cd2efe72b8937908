// Per-slot edge hidden states in ELL slot order: the SDDMM kernel K4 (Hopper).
//
// K4 replaces the TPU kernel tpugnn/kernels/sddmm.py::sddmm_edge_hidden
// (pl.pallas_call at :100, body _make_kernel at :35).  The function is the
// one tpugnn_torch/kernels/sddmm.py::sddmm_edge_hidden_plain computes:
//
//   ys = rnd(x_src[b] @ rnd(ws))                  [rows_src][MH]
//   yd = rnd(x_dst[b] @ rnd(wd))                  [rows_dst][MH]
//   out[b][r*D + k][j] = tbl[r][k] < 0 ? 0
//       : relu(rnd(rnd(ys[tbl[r][k]][j] + yd[r][j]) + rnd(bias[j])))
//
// with rnd the identity in f32 and a round to bf16 in bf16, products
// accumulated in f32 (the JAX kernel's rounding order, sddmm.py:40-55).  x
// arrives in the compute type, weights and bias in f32; out is f32.  tbl
// [rows_dst][D] holds each slot's source row, -1 for a masked slot (the
// wrapper builds it); indices must be < rows_src.
//
// The TPU kernel gathers ys through a one-hot GEMM (Mosaic has no dynamic
// gather) in a [rows, TB, F] layout.  Here a block owns one sample: it
// projects all source rows into a shared f32 panel, then projects the
// destination rows tile by tile and, in the GEMM's epilogue, reads each
// slot's source row from the panel by index and writes the D slot rows.
// Bound on an H100 at d=11, B=4096, H=MH=128: 34 GFLOP of projections (0.51
// ms at the f32 CUDA-core peak, 0.035 ms at the bf16 tensor-core peak) and
// 1.07 GB of f32 output (0.32 ms at 3.35 TB/s).  The projections are FMA
// loops over 64x64 output tiles (4x4 per thread) staged through 16-deep
// shared slabs: a simple kernel that is right, not yet a fast one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int TILE = 64;       // output tile: TILE rows x TILE columns
constexpr int KS = 16;         // depth of a staged slab

__device__ __forceinline__ float rnd(float x, float) { return x; }
__device__ __forceinline__ float rnd(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline size_t smem_bytes(int rows_dst, int rows_src, int D, int MH) {
  return align16(size_t(rows_src) * MH * sizeof(float))        // ys panel
         + 2 * align16(size_t(KS) * TILE * sizeof(float))       // A and W slabs
         + align16(size_t(rows_dst) * D * sizeof(int));         // slot table
}

// acc[i][j] = sum_h A[row0 + 4 ty + i][h] * rnd(W[h][col0 + 4 tx + j]) over a
// TILE x TILE tile, A [rows][H] in the compute type C, W [H][MH] f32.
template <typename C>
__device__ __forceinline__ void gemm_tile(const C* __restrict__ A, int rows, int row0,
                                          const float* __restrict__ W, int H, int MH,
                                          int col0, float* as, float* ws,
                                          float (&acc)[4][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += KS) {
    __syncthreads();  // the previous slab's readers are done
    for (int u = tid; u < KS * TILE; u += THREADS) {
      // A slab, transposed: as[kk][rr] = A[row0 + rr][k0 + kk]
      const int rr = u / KS, kk = u - rr * KS;
      const int r = row0 + rr, h = k0 + kk;
      as[kk * TILE + rr] = (r < rows && h < H) ? to_f32(A[size_t(r) * H + h]) : 0.f;
      // W slab: ws[kk][cc] = rnd(W[k0 + kk][col0 + cc])
      const int kw = u / TILE, cc = u - kw * TILE;
      const int hw = k0 + kw, c = col0 + cc;
      ws[kw * TILE + cc] = (hw < H && c < MH) ? rnd(__ldg(W + size_t(hw) * MH + c), C{}) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(as + kk * TILE + 4 * ty);
      const float4 w = *reinterpret_cast<const float4*>(ws + kk * TILE + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
}

template <typename C>
__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const C* __restrict__ xd, const C* __restrict__ xs, const int* __restrict__ tbl,
             const float* __restrict__ wd, const float* __restrict__ ws,
             const float* __restrict__ bias, float* __restrict__ out,
             int rows_dst, int rows_src, int D, int H, int MH) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* panel = reinterpret_cast<float*>(smem);
  size_t o = align16(size_t(rows_src) * MH * sizeof(float));
  float* as = reinterpret_cast<float*>(smem + o);
  o += align16(size_t(KS) * TILE * sizeof(float));
  float* wsl = reinterpret_cast<float*>(smem + o);
  o += align16(size_t(KS) * TILE * sizeof(float));
  int* stbl = reinterpret_cast<int*>(smem + o);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int i = tid; i < rows_dst * D; i += THREADS) stbl[i] = tbl[i];
  const C* xsb = xs + size_t(b) * rows_src * H;
  const C* xdb = xd + size_t(b) * rows_dst * H;
  const C tag{};

  // the source projections, all rows, into the panel
  for (int row0 = 0; row0 < rows_src; row0 += TILE)
    for (int col0 = 0; col0 < MH; col0 += TILE) {
      float acc[4][4];
      gemm_tile(xsb, rows_src, row0, ws, H, MH, col0, as, wsl, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = row0 + 4 * ty + i, c = col0 + 4 * tx + j;
          if (r < rows_src && c < MH) panel[size_t(r) * MH + c] = rnd(acc[i][j], tag);
        }
    }

  // the destination projections, each output element writing its D slots
  float* ob = out + size_t(b) * rows_dst * D * MH;
  for (int row0 = 0; row0 < rows_dst; row0 += TILE)
    for (int col0 = 0; col0 < MH; col0 += TILE) {
      float acc[4][4];
      gemm_tile(xdb, rows_dst, row0, wd, H, MH, col0, as, wsl, acc);
      // gemm_tile's slab barriers also ordered the panel's writes before
      // these reads (its first __syncthreads follows them)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + 4 * ty + i;
        if (r >= rows_dst) continue;
        for (int k = 0; k < D; ++k) {
          const int s = stbl[r * D + k];
          float* orow = ob + (size_t(r) * D + k) * MH;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = col0 + 4 * tx + j;
            if (c >= MH) continue;
            float v = 0.f;
            if (s >= 0) {
              const float yd = rnd(acc[i][j], tag);
              const float z = rnd(rnd(panel[size_t(s) * MH + c] + yd, tag) +
                                  rnd(__ldg(bias + c), tag), tag);
              v = z < 0.f ? 0.f : z;   // relu that keeps NaN, as jnp.maximum does
            }
            orow[c] = v;
          }
        }
      }
    }
}

template <typename C>
int launch_typed(const void* xd, const void* xs, const int* tbl, const float* wd,
                 const float* ws, const float* bias, float* out, int B, int rows_dst,
                 int rows_src, int D, int H, int MH, cudaStream_t stream) {
  const size_t smem = smem_bytes(rows_dst, rows_src, D, MH);
  cudaError_t err = cudaFuncSetAttribute(sddmm_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  sddmm_kernel<C><<<B, THREADS, smem, stream>>>(
      static_cast<const C*>(xd), static_cast<const C*>(xs), tbl, wd, ws, bias, out,
      rows_dst, rows_src, D, H, MH);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

long long sddmm_smem_bytes(int rows_dst, int rows_src, int D, int MH) {
  return static_cast<long long>(smem_bytes(rows_dst, rows_src, D, MH));
}

// compute_code: 0 = f32, 1 = bf16 (x in that type).  Returns the CUDA error
// code of the launch (0 = launched).
int sddmm_edge_hidden_launch(int compute_code, const void* xd, const void* xs,
                             const int* tbl, const float* wd, const float* ws,
                             const float* bias, float* out, int B, int rows_dst,
                             int rows_src, int D, int H, int MH, cudaStream_t stream) {
  if (B <= 0 || rows_dst <= 0 || rows_src <= 0 || D <= 0 || H <= 0 || MH <= 0)
    return int(cudaErrorInvalidValue);
  if (compute_code == 0)
    return launch_typed<float>(xd, xs, tbl, wd, ws, bias, out, B, rows_dst, rows_src, D,
                               H, MH, stream);
  if (compute_code == 1)
    return launch_typed<__nv_bfloat16>(xd, xs, tbl, wd, ws, bias, out, B, rows_dst,
                                       rows_src, D, H, MH, stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
