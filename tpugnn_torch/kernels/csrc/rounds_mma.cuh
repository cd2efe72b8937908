// Tensor-core chunk GEMMs of the rounds kernels: bf16 (namespace tc;
// fused_rounds.cu: K1 and K2a; fused_backward.cu: K2b; roll_gather.cu: K5)
// and f32 as three TF32 products (namespace tf32, below; K1, K2a, K5 and,
// in fused_backward_tf32.cu, K2b).
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

// ---------------------------------------------------------------------------
// f32 products on the TF32 tensor cores, near f32 accuracy ("3xTF32", the
// scheme of CUTLASS's OpMultiplyAddFastF32).  Each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: 10 mantissa bits, ties away
// from zero), and per m16 x n8 x k8 tile
//   c = a_lo w_hi;  c += a_hi w_lo;  c += a_hi w_hi;  acc += c
// on mma.sync.m16n8k8 .tf32; lo lo (2^-22 relative) is left out.  A slab's
// products (its SR / 8 = 2 k-steps, three each) go to a fresh accumulator
// c, added to the running sum acc on the CUDA cores (rounded to nearest):
// the tensor cores' f32 accumulation truncates, and 48 accumulations into
// acc put K1 1.1e-2 from the plain version on the circuit d=5 graph (3e-4
// with c), past the 1e-3 tolerance; four k-steps a sum put K1 4 times
// plain's distance from the rounds in f64 there, past the smoke's 3
// (scripts/k1_f32_probe.py).  The accumulator layout is the bf16 one
// (acc[j][2 h + c]: row g + 8 h, column 8 j + 2 t + c), so the epilogues
// are the same.
//
// A is an f32 chunk buffer (row stride LDX = 132 floats: the 8 rows of a
// fragment fall on distinct banks), split at fragment load (4 values a
// k-step, used for 16 n-tiles).  W arrives split: the wrapper packs each
// [128][128] matrix as hi/lo TF32 values in fragment order
// (fused_decoder.py::tf32_split_pack): for k-step s, n-tile j and lane
// 4 g + t one float4 {hi W[8s+t][8j+g], hi W[8s+t+4][8j+g], lo ..., lo ...},
// so a lane reads its B fragments of both halves with one 16-byte load and
// converts nothing.  Split in registers instead, every warp splits every
// weight again: 90 ms against 62 for the 4096-shot, 14-round d=11 decode
// (scripts/k1_f32_probe.py, wsplit_regs), though it halves the bytes.  A
// split matrix takes 128 KB; the weights stream through a ring of NS slabs
// of SR rows (k) in shared memory, copied with cp.async NS - 1 slabs ahead,
// behind one block barrier per slab.  The block-wide routines take the
// block's thread count NTH (THREADS by default; K5's f32 kernel runs 9
// warps, so its chunks are 144 rows).
namespace tf32 {

using tc::CR;
using tc::NT;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_group;
constexpr int LDX = H + 4;                 // f32 row stride of the chunk buffer
constexpr size_t CHUNK_BYTES = size_t(CR) * LDX * sizeof(float);
constexpr int KSTEP = NT * 32 * 4;         // floats of one k-step of a split matrix
constexpr size_t MAT = size_t(H / 8) * KSTEP;   // floats of one split matrix (2 H H)

__host__ __device__ inline size_t ring_bytes(int sr, int ns) {
  return size_t(ns) * (sr / 8) * KSTEP * sizeof(float);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The weight stream: NS slab buffers of SR rows of one split matrix; head is
// the buffer the next slab is read from.
template <int SR, int NS>
struct Ring {
  float* base;
  int head;
  __device__ float* buffer(int b) const { return base + size_t(b) * (SR / 8) * KSTEP; }
};

// Copy slab s (rows [s SR, (s + 1) SR)) of the split matrix W into dst, the
// whole block, as one cp.async group (a slab is contiguous in the pack).
template <int SR, int NTH = THREADS>
__device__ __forceinline__ void issue_slab(float* dst, const float* W, int s) {
  constexpr int UNITS = SR / 8 * KSTEP / 4;   // 16-byte units
  const float* src = W + size_t(s) * (SR / 8) * KSTEP;
  for (int u = threadIdx.x; u < UNITS; u += NTH) cp_async16(dst + 4 * u, src + 4 * u);
  cp_async_commit();
}

// Start the stream with the first NS - 1 slabs of W.
template <int SR, int NS, int NTH = THREADS>
__device__ __forceinline__ void prime(Ring<SR, NS>& rg, const float* W) {
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue_slab<SR, NTH>(rg.buffer(s), W, s);
  rg.head = 0;
}

// acc (+)= A @ W for the split matrix W.  A is this warp's 16 rows of an f32
// chunk buffer (stride LDX).  On entry the first NS - 1 slabs of W are in
// flight; on exit those of `next` are (if not null).  Each slab commits one
// cp.async group (an empty one past the stream's end), so the wait below
// leaves exactly the NS - 2 newest pending.  Every thread of the block calls
// this; warps with no rows in the chunk pass active = false and only take
// part in the copies and barriers.
template <int SR, int NS, bool ACC = false, int NTH = THREADS>
__device__ __forceinline__ void mma_pass(const float* A, const float* __restrict__ W,
                                         Ring<SR, NS>& rg, const float* next,
                                         float (&acc)[NT][4], bool active) {
  constexpr int NSL = H / SR;
  static_assert(NS >= 2 && NS - 1 <= NSL && SR % 8 == 0, "ring shape");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (!ACC) tc::zero_acc(acc);
#pragma unroll 1
  for (int s = 0; s < NSL; ++s) {
    cp_async_wait_group<NS - 2>();
    __syncthreads();    // slab s landed for all; every warp is done with slab s - 1
    const float* cur = rg.buffer(rg.head);
    const int fill = rg.head == 0 ? NS - 1 : rg.head - 1;   // slab s - 1's buffer
    rg.head = rg.head + 1 == NS ? 0 : rg.head + 1;
    const int ahead = s + NS - 1;
    if (ahead < NSL) issue_slab<SR, NTH>(rg.buffer(fill), W, ahead);
    else if (next != nullptr) issue_slab<SR, NTH>(rg.buffer(fill), next, ahead - NSL);
    else cp_async_commit();
    if (active) {
      constexpr int KK = SR / 8;   // k-steps of the slab, summed in one c
      uint32_t ah[KK][4], al[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const float* a = A + s * SR + kk * 8 + t;
        split(a[g * LDX], ah[kk][0], al[kk][0]);
        split(a[(g + 8) * LDX], ah[kk][1], al[kk][1]);
        split(a[g * LDX + 4], ah[kk][2], al[kk][2]);
        split(a[(g + 8) * LDX + 4], ah[kk][3], al[kk][3]);
      }
      const float4* b = reinterpret_cast<const float4*>(cur) + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const float4 w = b[kk * NT * 32 + 32 * j];
          const uint32_t wh[2] = {__float_as_uint(w.x), __float_as_uint(w.y)};
          const uint32_t wl[2] = {__float_as_uint(w.z), __float_as_uint(w.w)};
          mma_tf32(c, al[kk], wh[0], wh[1]);
          mma_tf32(c, ah[kk], wl[0], wl[1]);
          mma_tf32(c, ah[kk], wh[0], wh[1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += c[e];
      }
    }
  }
  __syncwarp();   // the warp's A rows may be rewritten after this
}

// element (r, c) of a swizzled [rows][128] f32 panel: 32-byte units XORed
// with the row's low bits, so a gather's rows spread over the banks
__device__ __forceinline__ int swz(int r, int c) {
  return r * H + ((((c >> 3) ^ (r & 3)) << 3) | (c & 7));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows [r0, r0 + n) of a [*][H] f32 array into this warp's 16 rows of a
// chunk buffer (zeros past n), then __syncwarp.  Plain loads: the source
// may be rewritten in the launch.
__device__ __forceinline__ void load_rows_warp(float* dst, const float* src, int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = lane; u < 16 * 32; u += 32) {
    const int r = u >> 5, c = (u & 31) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) v = *reinterpret_cast<const float4*>(src + size_t(r) * H + c);
    *reinterpret_cast<float4*>(dst + r * LDX + c) = v;
  }
  __syncwarp();
}

// panel[r] = x[r] @ W for rows [0, rows), through the chunk buffer xs (NTH
// / 2 rows), into a swizzled panel; then the first slabs of `after` are in
// flight.
template <int SR, int NS, int NTH = THREADS>
__device__ __noinline__ void project_rows(const float* x, int rows, const float* __restrict__ W,
                                          float* panel, float* xs, Ring<SR, NS>& rgref,
                                          const float* after) {
  Ring<SR, NS> rg = rgref;   // in registers: the asm's memory clobbers would reload it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int CRN = NTH / 32 * 16;
  float* xa = xs + 16 * warp * LDX;
  for (int row0 = 0; row0 < rows; row0 += CRN) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, rows - r0));
    load_rows_warp(xa, x + size_t(r0) * H, n);
    float acc[NT][4];
    mma_pass<SR, NS, false, NTH>(xa, W, rg, row0 + CRN < rows ? W : after, acc, n > 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          st2(panel + swz(r, 8 * j + 2 * t), acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
  rgref = rg;
}

}  // namespace tf32
}  // namespace rounds
