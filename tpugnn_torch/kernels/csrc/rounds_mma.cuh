// Tensor-core chunk GEMMs of the bf16 rounds kernels (fused_rounds.cu: K1
// and K2a; fused_backward.cu: K2b; roll_gather.cu: K5).  The f32
// instantiations keep the FMA loops of rounds_common.cuh.
//
// A chunk is a whole side of up to CR = 128 rows: each of the 8 warps owns
// 16 rows and all 128 columns of a product, as one m16 x n128 f32
// accumulator (16 n-tiles of mma.sync.m16n8k16, 64 registers a thread).  A
// warp reads only its own 16 rows of the A-operand buffers (xs, hs), so
// writing them needs a __syncwarp, not a block barrier.  Each product is one
// [128][128] weight matrix; it streams through a double buffer of SR-row
// slabs in shared memory (SR = 64, or 32 where shared memory is short),
// copied with cp.async: the next slab (or the next product's first) loads
// while the tensor cores work on the current one, behind one block barrier
// per slab.
// Chunk buffers and slabs have a padded row stride (LDB = 136 bf16, 272 B),
// so the 8 row addresses of an ldmatrix fall on distinct banks; the gather
// panels [rows][128] are XOR-swizzled in 16-byte units instead (no padding).
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4 g + t; a thread holds
// rows g and g + 8 of its warp's 16, columns 8 j + 2 t and 8 j + 2 t + 1 of
// each n-tile j: acc[j][2 h + c] is row g + 8 h, column 8 j + 2 t + c.  A
// row's 128 columns sit in one quad of lanes, so a row reduction is two
// shuffles.  The block-wide routines take the block's thread count NTH
// (THREADS by default); K5 runs 9 warps, so its chunks are 144 rows.
#pragma once

#include "rounds_common.cuh"

namespace rounds {
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int CR = WARPS * 16;  // rows per chunk
constexpr int LDB = H + 8;      // bf16 row stride of chunk buffers and slabs
constexpr int NT = H / 8;       // n-tiles of a 128-column product
constexpr size_t CHUNK_BYTES = size_t(CR) * LDB * sizeof(bf16);
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may use

__host__ __device__ inline size_t slab_bytes(int sr) {
  return size_t(2) * sr * LDB * sizeof(bf16);   // 2 buffers of sr weight rows
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Zero the columns from `width` on of row half h of an m16 x n128
// accumulator (a narrower model's padded columns, before its LayerNorm's
// variance).
__device__ __forceinline__ void mask_columns(float (&acc)[NT][4], int h, int t, int width) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= width) acc[j][2 * h] = 0.f;
    if (c + 1 >= width) acc[j][2 * h + 1] = 0.f;
  }
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most N of this thread's newest cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// element (r, c) of a swizzled [rows][128] bf16 panel
__device__ __forceinline__ int swz(int r, int c) {
  return r * H + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// Two f32 vector entries, read where they are used: a volatile load is not
// merged with another or hoisted, so a vector's 32 values per thread are not
// held in registers across an epilogue.
__device__ __forceinline__ float2 ld_vec2(const float* v, int row, int col) {
  float2 r;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(r.x), "=f"(r.y) : "l"(v + row * H + col));
  return r;
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// The weight stream: two slab buffers of SR rows of one [H][H] matrix; buf
// is the one the in-flight slab goes to.
template <int SR>
struct Slabs {
  bf16* base;
  int buf;
  __device__ bf16* buffer(int b) const { return base + size_t(b) * SR * LDB; }
};

// Copy rows [k0, k0 + SR) of the matrix W into slab buffer dst, the whole
// block, as one cp.async group.
template <int SR, int NTH = THREADS>
__device__ __forceinline__ void issue_slab(bf16* dst, const bf16* W, int k0) {
  constexpr int UPR = H / 8;      // 16-byte units per row
  for (int u = threadIdx.x; u < SR * UPR; u += NTH) {
    const int kk = u / UPR, c = (u - kk * UPR) * 8;
    cp_async16(dst + kk * LDB + c, W + size_t(k0 + kk) * H + c);
  }
  cp_async_commit();
}

// Start the stream with the first product's first slab.
template <int SR, int NTH = THREADS>
__device__ __forceinline__ void prime(Slabs<SR>& sl, const bf16* W) {
  issue_slab<SR, NTH>(sl.buffer(sl.buf), W, 0);
}

// acc (+)= A @ W for the [H][H] matrix W.  A is this warp's 16 rows of a
// chunk buffer (stride LDB).  On entry the first slab of W is in flight in
// sl.buf; on exit the first slab of `next` is (if not null).  Every thread
// of the block calls this; warps with no rows in the chunk pass active =
// false and only take part in the copies and barriers.
template <int SR, bool ACC = false, int NTH = THREADS>
__device__ __forceinline__ void mma_pass(const bf16* A, const bf16* __restrict__ W,
                                         Slabs<SR>& sl, const bf16* next,
                                         float (&acc)[NT][4], bool active) {
  const int lane = threadIdx.x & 31;
  if (!ACC) zero_acc(acc);
#pragma unroll 1
  for (int k0 = 0; k0 < H; k0 += SR) {
    cp_async_wait_all();
    __syncthreads();    // this slab landed for all; every warp is done with the last
    const bf16* cur = sl.buffer(sl.buf);
    sl.buf ^= 1;
    if (k0 + SR < H) issue_slab<SR, NTH>(sl.buffer(sl.buf), W, k0 + SR);
    else if (next != nullptr) issue_slab<SR, NTH>(sl.buffer(sl.buf), next, 0);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < SR; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, A + (lane & 15) * LDB + k0 + kk + (lane >> 4) * 8);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t b[4];
          ldsm_x4_t(b, cur + (kk + (lane & 15)) * LDB + p * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * p], a, b[0], b[1]);
          mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
  }
  __syncwarp();   // the warp's A rows may be rewritten after this
}

// Rows [r0, r0 + n) of a [*][H] bf16 array into this warp's 16 rows of a
// chunk buffer (zeros past n), then __syncwarp.
__device__ __forceinline__ void load_rows_warp(bf16* dst, const bf16* src, int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = lane; u < 16 * 16; u += 32) {
    const int r = u >> 4, c = (u & 15) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) v = *reinterpret_cast<const uint4*>(src + size_t(r) * H + c);
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = v;
  }
  __syncwarp();
}

// This warp's first n rows of a chunk buffer out to a [*][H] bf16 array.
__device__ __forceinline__ void store_rows_warp(bf16* dst, const bf16* src, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int u = lane; u < 16 * 16; u += 32) {
    const int r = u >> 4, c = (u & 15) * 8;
    if (r < n)
      *reinterpret_cast<uint4*>(dst + size_t(r) * H + c) =
          *reinterpret_cast<const uint4*>(src + r * LDB + c);
  }
}

// panel[r] = rnd(x[r] @ W) for rows [0, rows), through the chunk buffer xs
// (NTH / 2 rows), into a swizzled panel; then the first slab of `after` is
// in flight.
template <int SR, int NTH = THREADS>
__device__ __noinline__ void project_rows_tc(const bf16* x, int rows, const bf16* __restrict__ W,
                                             bf16* panel, bf16* xs, Slabs<SR>& slref,
                                             const bf16* after) {
  Slabs<SR> sl = slref;   // in registers: the asm's memory clobbers would reload it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int CRN = NTH / 32 * 16;
  for (int row0 = 0; row0 < rows; row0 += CRN) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, rows - r0));
    bf16* xa = xs + 16 * warp * LDB;
    load_rows_warp(xa, x + size_t(r0) * H, n);
    float acc[NT][4];
    mma_pass<SR, false, NTH>(xa, W, sl, row0 + CRN < rows ? W : after, acc, n > 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          st_bf2(panel + swz(r, 8 * j + 2 * t), acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
  slref = sl;
}

}  // namespace tc
}  // namespace rounds
