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
// arrives in the compute type, the weights in f32 (FMA kernel) or bf16
// (tensor-core kernel), bias in f32; out is f32.  tbl [rows_dst][D]
// holds each slot's source row, -1 for a masked slot (the wrapper builds
// it); indices must be < rows_src.  The TPU kernel gathers ys through a
// one-hot GEMM (Mosaic has no dynamic gather) in a [rows, TB, F] layout;
// here a block projects all source rows of a sample into a shared panel and
// reads each slot's source row from it by index.
//
// Bound on an H100 (chip_smoke.py phase 8: d=11, B=4096, H=MH=128, bf16, to
// checks): 0.351 ms from bytes, the 241 real rows read once in bf16 and the
// 440 real slots' f32 rows written once (1.18 GB at 3.35 TB/s); the
// projections, 33 GFLOP, take 0.033 ms at the bf16 tensor-core peak.  The
// kernel writes every padded slot row (128 rows x 4 slots x 512 B a sample,
// 1.07 GB) and reads the padded rows (0.27 GB): about 0.40 ms at 3.35 TB/s.
// So its job is to stream its f32 output at the memory rate.
//
// Two kernels; the wrapper picks one by shape:
//   bf16 at H = MH = 128 (tck:: below, the bench width): one block of 16
//     warps per sample, in three phases behind block barriers.  (1) The
//     sample's source and destination rows and both weight matrices arrive
//     in shared memory through cp.async (the wrapper rounds ws and wd to
//     bf16 once), every row padded to LDB so that ldmatrix reads them
//     without bank conflicts.  (2) Each warp projects a 16-row group in
//     place on mma.sync bf16 tensor cores with K1's operand layout and
//     primitives (rounds_mma.cuh): ys = rnd(x_src @ ws), yd = rnd(x_dst @
//     wd).  Every product reads bf16 values, so only the f32 summation
//     order differs from the plain version.  (3) Lane l forms columns
//     4 l .. 4 l + 3 of a slot row, so each warp store is a whole 512-byte
//     row, 16 bytes a lane, marked streaming (st.global.cs); the loop has no
//     branch (a masked slot reads row 0 and writes zeros) and its adds are
//     bf16x2.  A block's last stores drain while the next block on the SM
//     loads.  Shared memory 141,312 B at d=11 (one block an SM).
//     Measured on an H100 80GB HBM3 at 700 W: 0.52 ms a call over
//     back-to-back calls on bf16 states, 2.6 TB/s of the kernel's own
//     traffic, against 2.52 ms for the FMA kernel on the same inputs; one
//     call on f32 states, the wrapper's casts to bf16 inside (chip_smoke.py
//     phase 8's time), 0.79 ms against the FMA kernel's 2.87 ms.
//     scripts/k4_probe.py times the choices: a persistent
//     block that walks over samples with producer and consumer warps and
//     two panel buffers, TMA bulk copies for the rows, 8 warps, or plain
//     stores each measured within 1% of this simpler design (PERF.md
//     section 6).
//   f32, and bf16 at other widths (fmak:: below): exact f32 products on CUDA
//     cores, FMA loops over 64x64 output tiles (4x4 per thread) staged
//     through 16-deep shared slabs, over an f32 panel.

#include "rounds_mma.cuh"

namespace {

namespace fmak {

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

}  // namespace fmak

// ---------------------------------------------------------------------------
// bf16 at H = MH = 128 on tensor cores.

namespace tck {

using namespace rounds;
using namespace rounds::tc;

constexpr int NWARP = 16;              // warps of a block
constexpr int NTH = 32 * NWARP;

__host__ __device__ inline int rows16(int rows) { return (rows + 15) & ~15; }

constexpr size_t WEIGHT_BYTES = 2 * size_t(H) * LDB * sizeof(bf16);

// Both weight matrices, the panels (the source rows, then the destination
// rows, rounded up to 16 rows, each row padded to LDB), the slot table.
__host__ __device__ inline size_t smem_bytes(int rows_dst, int rows_src, int D) {
  return WEIGHT_BYTES + size_t(rows16(rows_src) + rows16(rows_dst)) * LDB * sizeof(bf16)
         + align16(size_t(rows_dst) * D * sizeof(int));
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
// relu(rnd(rnd(y + d) + b)) on a pair of bf16 values.  A bf16 add rounds
// the exact sum once, which for bf16 operands is rnd of their f32 sum (24 >=
// 2 * 8 + 2 bits); relu keeps NaN, as jnp.maximum does.
__device__ __forceinline__ float2 slot_pair(uint32_t y, uint32_t d, __nv_bfloat162 b) {
  const __nv_bfloat162 z = __hadd2(__hadd2(as_bf2(y), as_bf2(d)), b);
  return __bfloat1622float2(__hmax2_nan(z, __float2bfloat162_rn(0.f)));
}

// 16 panel rows (row stride LDB), which hold x on entry, become rnd(x @ W)
// in place.  Only this warp reads or writes them, so a __syncwarp orders
// the reads before the writes.
__device__ __forceinline__ void project_in_place(bf16* rows, const bf16* W) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[NT][4];
  zero_acc(acc);
  const bf16* a_row = rows + (lane & 15) * LDB + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < H; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_row + kk);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      ldsm_x4_t(b, W + (kk + (lane & 15)) * LDB + p * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      st_bf2(rows + (g + 8 * h) * LDB + 8 * j + 2 * t, acc[j][2 * h], acc[j][2 * h + 1]);
}

// One block per sample, in three phases behind block barriers: the
// sample's rows and the weights arrive through cp.async; the warps project
// the 16-row groups in place; the warps stream the output.  A block's last
// stores drain while the next block on the SM loads.
__global__ void __launch_bounds__(NTH, 1)
sddmm_tc_kernel(const bf16* __restrict__ xd, const bf16* __restrict__ xs,
                const int* __restrict__ tbl, const bf16* __restrict__ wd,
                const bf16* __restrict__ ws, const float* __restrict__ bias,
                float* __restrict__ out, int rows_dst, int rows_src, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* w_d = w_s + H * LDB;
  bf16* ys = w_d + H * LDB;
  const int ns16 = rows16(rows_src), nd16 = rows16(rows_dst);
  bf16* yd = ys + size_t(ns16) * LDB;
  int* stbl = reinterpret_cast<int*>(yd + size_t(nd16) * LDB);
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // panel row r: source row r, then destination row r - ns16; zeros past
  // the real rows (a copy of 0 source bytes)
  for (int u = threadIdx.x; u < (ns16 + nd16) * (H / 8); u += NTH) {
    const int r = u / (H / 8), c = (u % (H / 8)) * 8;
    const bool src = r < ns16;
    const int rr = src ? r : r - ns16;
    const bool real = rr < (src ? rows_src : rows_dst);
    const bf16* x = src ? xs + (size_t(b) * rows_src + rr) * H
                        : xd + (size_t(b) * rows_dst + rr) * H;
    cp_async16(ys + r * LDB + c, real ? x + c : xs, real ? 16 : 0);
  }
  for (int u = threadIdx.x; u < H * H / 8; u += NTH) {
    const int r = u / (H / 8), c = (u % (H / 8)) * 8;
    cp_async16(w_s + r * LDB + c, ws + size_t(r) * H + c);
    cp_async16(w_d + r * LDB + c, wd + size_t(r) * H + c);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < rows_dst * D; i += NTH) stbl[i] = tbl[i];
  cp_async_wait_all();
  __syncthreads();

  for (int q = warp; q < (ns16 + nd16) / 16; q += NWARP)
    project_in_place(ys + q * 16 * LDB, q * 16 < ns16 ? w_s : w_d);
  __syncthreads();

  // lane l forms columns 4 l .. 4 l + 3 of a slot row, so a warp's store is
  // one whole 512-byte row; streaming, nothing reads it back
  const int c0 = 4 * lane;
  const __nv_bfloat162 b01 = __floats2bfloat162_rn(__ldg(bias + c0), __ldg(bias + c0 + 1));
  const __nv_bfloat162 b23 = __floats2bfloat162_rn(__ldg(bias + c0 + 2), __ldg(bias + c0 + 3));
  float* ob = out + size_t(b) * rows_dst * D * H + c0;
  for (int r = warp; r < rows_dst; r += NWARP) {
    const uint2 d = *reinterpret_cast<const uint2*>(yd + r * LDB + c0);
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      // a masked slot reads row 0 and writes zeros: no branch, so the
      // unrolled slots' loads and adds overlap
      const int s = stbl[r * D + k];
      const uint2 y = *reinterpret_cast<const uint2*>(ys + max(s, 0) * LDB + c0);
      const float2 lo = slot_pair(y.x, d.x, b01), hi = slot_pair(y.y, d.y, b23);
      const float4 v = s < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                             : make_float4(lo.x, lo.y, hi.x, hi.y);
      __stcs(reinterpret_cast<float4*>(ob + (size_t(r) * D + k) * H), v);
    }
  }
}

int launch(const void* xd, const void* xs, const int* tbl, const void* wd, const void* ws,
           const float* bias, float* out, int B, int rows_dst, int rows_src, int D,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(rows_dst, rows_src, D);
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sddmm_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  sddmm_tc_kernel<<<B, NTH, smem, stream>>>(
      static_cast<const bf16*>(xd), static_cast<const bf16*>(xs), tbl,
      static_cast<const bf16*>(wd), static_cast<const bf16*>(ws), bias, out, rows_dst,
      rows_src, D);
  return int(cudaGetLastError());
}

}  // namespace tck

}  // namespace

extern "C" {

long long sddmm_smem_bytes(int rows_dst, int rows_src, int D, int MH) {
  return static_cast<long long>(fmak::smem_bytes(rows_dst, rows_src, D, MH));
}

long long sddmm_tc_smem_bytes(int rows_dst, int rows_src, int D) {
  return static_cast<long long>(tck::smem_bytes(rows_dst, rows_src, D));
}

// The FMA kernel.  compute_code: 0 = f32, 1 = bf16 (x in that type);
// weights f32.  Returns the CUDA error code of the launch (0 = launched).
int sddmm_edge_hidden_launch(int compute_code, const void* xd, const void* xs,
                             const int* tbl, const float* wd, const float* ws,
                             const float* bias, float* out, int B, int rows_dst,
                             int rows_src, int D, int H, int MH, cudaStream_t stream) {
  if (B <= 0 || rows_dst <= 0 || rows_src <= 0 || D <= 0 || H <= 0 || MH <= 0)
    return int(cudaErrorInvalidValue);
  if (compute_code == 0)
    return fmak::launch_typed<float>(xd, xs, tbl, wd, ws, bias, out, B, rows_dst, rows_src,
                                    D, H, MH, stream);
  if (compute_code == 1)
    return fmak::launch_typed<__nv_bfloat16>(xd, xs, tbl, wd, ws, bias, out, B, rows_dst,
                                            rows_src, D, H, MH, stream);
  return int(cudaErrorInvalidValue);
}

// The tensor-core kernel: x, wd and ws bf16, bias f32, H = MH = 128 (other
// widths are refused).  Returns the CUDA error code of the launch.
int sddmm_edge_hidden_tc_launch(const void* xd, const void* xs, const int* tbl,
                                const void* wd, const void* ws, const float* bias,
                                float* out, int B, int rows_dst, int rows_src, int D, int H,
                                int MH, cudaStream_t stream) {
  if (B <= 0 || rows_dst <= 0 || rows_src <= 0 || D <= 0 || H != rounds::H ||
      MH != rounds::H)
    return int(cudaErrorInvalidValue);
  return tck::launch(xd, xs, tbl, wd, ws, bias, out, B, rows_dst, rows_src, D, stream);
}

}  // extern "C"
