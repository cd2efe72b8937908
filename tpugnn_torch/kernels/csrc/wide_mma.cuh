// The tile engine of the rounds kernels (wide_rounds.cuh: K1, K2a and K2b
// at W = 128 to 512 columns, K5 at 256 to 512) on Hopper's warpgroup MMA
// (wgmma).
//
// A block is two consumer warpgroups and one producer warpgroup (384
// threads; setmaxnreg moves the producer's registers to the consumers, 240
// a consumer thread), persistent (one a SM) over tiles of rows.  A
// warpgroup owns 64 rows and NC columns of every product; the block's two
// warpgroups split either rows (a tile of 128 rows, each warpgroup all W
// columns of its 64: bf16 at W <= 256, f32 at 128) or columns (a tile of
// 64 rows, each warpgroup W / 2 columns), so that a warpgroup's
// accumulators hold whole 64-column blocks of its rows (NC / 2 floats a
// thread; f32 3xTF32 also a fresh sum of 32 a block in flight, which at
// 256 columns a warpgroup overflowed the registers into local memory).
// "Row group": the warpgroups that share a tile's 64 rows (one, or both
// where they split columns); they synchronise through a named barrier of
// their own, and a row's LayerNorm statistics (sum, sum of squared
// deviations, and K2b's adjoint sums) cross between them through 2 floats
// a row and statistic in shared memory (Geo::RED, 8 RT floats).
//
// The weights (B operand) stream as k-slabs of KS rows of one [W][W] matrix
// through a ring of NS slots in shared memory, filled by one thread of the
// producer warpgroup with one bulk copy (TMA, cp.async.bulk) a slab,
// completion on the slot's full mbarrier; every consumer thread arrives on
// the slot's empty mbarrier when its warpgroup's products on it are done.
// The wrapper packs each matrix once a call in the slab order the ring and
// wgmma read (the "no swizzle" K-major layout of 8 x 16-byte core
// matrices): slab s holds k in [s KS, s KS + KS), element (k, n) at
//   ((n / 8) (KS / T) + (k % KS) / T) 8 T + (n % 8) T + k % T,
// T = 8 bf16 or 4 f32 to a 16-byte row; f32 slabs hold the TF32 halves hi
// then lo (fused_decoder.py::wgmma_pack).  Every slab that reaches shared
// memory serves the whole tile, so a row reads 5 W^2 item / RT weight
// bytes from L2 a forward round: at W = 256 5 KB in bf16 (RT 128) and 40 KB
// in f32 (RT 64), against 20 KB and 80 KB from tiles of 32 rows; at W = 128
// 1.25 KB in bf16 and 5 KB in f32 (both RT 128).
//
// bf16: A from shared memory too (the tile's states, or hs/hc, in the same
// core-matrix layout, K = W: coff), wgmma.m64n64k16 with f32 accumulation,
// two slabs in flight.  f32: 3xTF32 (each operand split into TF32 hi + lo,
// the products lo.hi + hi.lo + hi.hi) on wgmma.m64n64k8 with A from
// registers (split as it is loaded, from shared or global memory); each
// k-slab's three products go to a fresh accumulator of 64 columns that is
// added to the running sum on the CUDA cores, because the tensor cores' f32
// accumulation truncates (PERF.md §6); with two column blocks both fresh
// sums are in flight, the first added under the second.
//
// Shared memory a block (Geo::SMEM, bytes): ring, X (the states' tile), H
// (hs, hc, rnd(dpre), rnd(dt)), the statistics, tie flags, a tied row's hs,
// K2b's live-slot counts (4 bits an entry):
//   bf16 W=128: 32,768 + 32,768 + 32,768 + 4,096 + ... +  8,192 = 112,192
//        W=256: 65,536 + 65,536 + 65,536 + 4,096 + ... + 16,384 = 219,712
//        W=384: 98,304 + 49,152 + 49,152 + 2,048 + ... + 12,288 = 212,800
//        W=512: 65,536 + 65,536 + 65,536 + 2,048 + ... + 16,384 = 217,376
//   f32  W=128: 65,536 + 67,584 + 67,584 + 4,096 + ... +  8,192 = 214,592
//        W=256: 65,536 + 66,560 + 66,560 + 2,048 + ... +  8,192 = 210,208
//        W=384: 98,304 +      0 + 99,328 + 2,048 + ... + 12,288 = 213,792
//        W=512: 65,536 +      0 + 132,096 + 2,048 + ... + 16,384 = 218,400
// (f32 past 256 reads its states from L2: their tile does not fit.)
//
// Accumulators: acc[j][e], j the warpgroup's 64-column block, is row 16 wr +
// g + 8 ((e >> 1) & 1) of the warpgroup's 64 (wr its warp, lane = 4 g + t),
// column 64 j + 8 (e >> 2) + 2 t + (e & 1) of its NC.
#pragma once

#include "rounds_mma.cuh"

namespace rounds {
namespace wide {

typedef __nv_bfloat16 bf16;
constexpr int WMAX = 512;       // the widest pack the kernels take
constexpr int CONSUMERS = 256;  // two warpgroups
constexpr int BLOCK = CONSUMERS + 128;   // + the producer warpgroup
constexpr int CONSUMER_REGS = 240;   // 256 x 240 + 128 x 24 = 64,512 of the SM's 65,536
constexpr int PRODUCER_REGS = 24;
constexpr int WGR = 64;         // rows of a warpgroup

// The geometry of state type T at width W (128, 256, 384 or 512); SPLIT:
// the warpgroups split every row's columns (K2b's replay, whose epilogues
// hold more than a row group's accumulators can spare).
template <typename T, int W, bool SPLIT = false>
struct Geo {
  typedef T State;
  static constexpr int Width = W;
  static constexpr bool F32 = sizeof(T) == 4;
  // warpgroups of a row group: f32 splits columns from 256 on (a thread's
  // 3xTF32 accumulators for 256 columns and their fresh sums overflow 240
  // registers)
  static constexpr int CG = SPLIT || W > (F32 ? 128 : 256) ? 2 : 1;
  static constexpr int RG = 2 / CG;             // row groups of a block
  static constexpr int RT = WGR * RG;           // rows of a tile
  static constexpr int NC = W / CG;             // columns of a warpgroup
  static constexpr int NJ = NC / 64;            // its 64-column blocks
  static constexpr int TE = F32 ? 4 : 8;        // elements of a 16-byte core row
  static constexpr int KS = F32 ? (W <= 384 ? 16 : 8) : 32;   // k rows of a slab
  static constexpr int PK = F32 ? 8 : 2;        // pack bytes of an element (f32: hi, lo)
  static constexpr int SLAB = KS * W * PK;      // bytes of a slab
  static constexpr int NSLAB = W / KS;          // slabs of a matrix
  static constexpr int NS = F32 ? (W <= 128 ? 4 : 2) : (W <= 384 ? 4 : 2);   // ring slots
  static constexpr int LDF = W + 4;             // row stride of an f32 A tile
  static constexpr bool XS = !F32 || W <= 256;  // the states' tile in shared memory (f32 wider: read from L2)
  // shared memory: ring, X (the states), H (hs / hc / dpre / dt), per-row
  // partials [8][RT], tie flags [RT], a row's hs [RG][W], live-slot counts
  // [RT][W / 2], barriers [2][NS]
  static constexpr int RING = NS * SLAB;
  static constexpr int XT = !XS ? 0 : F32 ? RT * LDF * 4 : RT * W * 2;
  static constexpr int HT = F32 ? RT * LDF * 4 : RT * W * 2;
  static constexpr int RED = 8 * RT * 4;
  static constexpr int CNT = RT * W / 2;        // K2b's live-slot counts, 4 bits an entry
  static constexpr int SMEM = RING + XT + HT + RED + RT * 4 + RG * W * 4 + CNT + 2 * NS * 8;
  static_assert(SMEM <= 232448, "over the block's shared memory");
  static_assert(W % KS == 0 && NC % 64 == 0, "geometry");
};

// bf16 A-tile layout: element (r, k) of a [64][W] row-group tile, K-major
// core matrices (the same layout as a weight slab with K = W).
template <int W>
__device__ __forceinline__ int coff(int r, int k) {
  return ((r >> 3) * (W / 8) + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
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

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers, bulk copies, named barriers, fences

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// bytes [p, p + n) into L2 ahead of their reads (16-byte multiples, in
// pieces of 16 KB)
__device__ __forceinline__ void prefetch_l2(const void* p, size_t n) {
  const char* c = static_cast<const char*>(p);
  for (size_t o = 0; o < n; o += 16384) {
    const uint32_t m = uint32_t(n - o < 16384 ? n - o : 16384);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(c + o), "r"(m) : "memory");
  }
}
// the threads of a row group (id 1 + its index, 128 CG threads)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ bool bar_or(int id, int count, bool p) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.or.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(uint32_t(p)), "r"(id), "r"(count)
      : "memory");
  return r != 0;
}
// the warpgroup's register budget (all its threads; the paths after it
// never rejoin)
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a shared-memory matrix descriptor, no swizzle: lbo the byte stride of core
// matrices along K, sbo along M or N
__device__ __forceinline__ uint64_t mdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

#define WIDE_D32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WIDE_D32_OUT(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define WIDE_D32_W(d)                                                                        \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),       \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),             \
      "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),          \
      "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),          \
      "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])

// d (64 x 64) += A (64 x 16, shared) B (16 x 64, shared), bf16 in, f32 out
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WIDE_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WIDE_D32_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}

// the same with A in registers (the m16n8k16 fragment of each warp's 16 rows)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WIDE_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WIDE_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) (+)= A (64 x 8, registers, TF32) B (8 x 64, shared, TF32);
// ADD 0 writes d without reading it (the first product of a fresh sum)
template <int ADD>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (ADD)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WIDE_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WIDE_D32_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WIDE_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WIDE_D32_W(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][32]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
}

// ---------------------------------------------------------------------------
// The weight ring.  Each side tracks its slot and the parity of its pass.

struct Ring {
  uint32_t base;    // shared address of slot 0
  uint32_t full;    // of full barrier 0 (8 bytes each)
  uint32_t empty;   // of empty barrier 0
  int slot, phase;
};

// The producer: the NSLAB slabs of one packed matrix into the ring.
template <int SLAB, int NSLAB, int NS>
__device__ __forceinline__ void feed(Ring& r, const unsigned char* mat) {
  for (int s = 0; s < NSLAB; ++s) {
    mbar_wait(r.empty + 8 * r.slot, r.phase ^ 1);
    mbar_expect(r.full + 8 * r.slot, SLAB);
    bulk_load(r.base + r.slot * SLAB, mat + size_t(s) * SLAB, SLAB, r.full + 8 * r.slot);
    if (++r.slot == NS) {
      r.slot = 0;
      r.phase ^= 1;
    }
  }
}

__device__ __forceinline__ int wg_warp() { return (threadIdx.x >> 5) & 3; }

// acc (+)= A[64][W] @ M[W][n0 : n0 + 64 NJ] over the ring's next NSLAB slabs,
// bf16.  a: the shared address of the row group's A tile (coff layout).
template <typename G>
__device__ __forceinline__ void gemm(float (&acc)[G::NJ][32], uint32_t a, int n0, Ring& r) {
  constexpr int W = G::NC * G::CG, KS = G::KS;
  constexpr uint32_t SBO_A = (W / 8) * 128, SBO_B = (KS / 8) * 128;
  int prev = -1;
#pragma unroll 1
  for (int s = 0; s < G::NSLAB; ++s) {
    mbar_wait(r.full + 8 * r.slot, r.phase);
    // one descriptor a slab and operand; the rest by adding 16-byte units
    // to its address field (addresses stay below 256 KB: no carry)
    const uint64_t da = mdesc(a + ((s * KS) >> 3) * 128, 128, SBO_A);
    const uint64_t db = mdesc(r.base + r.slot * G::SLAB + ((n0 >> 3) * (KS / 8)) * 128, 128, SBO_B);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
      for (int j = 0; j < G::NJ; ++j)
        wgmma_bf16(acc[j], da + 2 * kk * 8, db + (8 * j * (KS / 8) + 2 * kk) * 8);
    wg_commit();
    wg_wait<1>();   // the slab before is done: release it
    if (prev >= 0) mbar_arrive(r.empty + 8 * prev);
    prev = r.slot;
    if (++r.slot == G::NS) {
      r.slot = 0;
      r.phase ^= 1;
    }
  }
  wg_wait<0>();
  mbar_arrive(r.empty + 8 * prev);
}

// The same in f32 (3xTF32): A f32 at a (generic: shared or global), row
// stride lda, this warpgroup's 64 rows from row r0; a row past rmax reads
// row rmax (its results are never stored).
template <typename G>
__device__ __forceinline__ void gemm(float (&acc)[G::NJ][32], const float* a, int lda, int r0,
                                     int rmax, int n0, Ring& r) {
  constexpr int KS = G::KS, K8 = KS / 8;
  constexpr uint32_t SBO_B = (KS / 4) * 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = min(r0 + 16 * wg_warp() + g, rmax), rb = min(r0 + 16 * wg_warp() + g + 8, rmax);
  const float* p0 = a + size_t(ra) * lda + t;
  const float* p1 = a + size_t(rb) * lda + t;
  float nx[K8][4];
#pragma unroll
  for (int kk = 0; kk < K8; ++kk) {
    nx[kk][0] = p0[8 * kk];
    nx[kk][1] = p1[8 * kk];
    nx[kk][2] = p0[8 * kk + 4];
    nx[kk][3] = p1[8 * kk + 4];
  }
#pragma unroll 1
  for (int s = 0; s < G::NSLAB; ++s) {
    uint32_t ah[K8][4], al[K8][4];
#pragma unroll
    for (int kk = 0; kk < K8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32::split(nx[kk][i], ah[kk][i], al[kk][i]);
    if (s + 1 < G::NSLAB) {   // the next slab's A while this one's products run
      const int k = (s + 1) * KS;
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) {
        nx[kk][0] = p0[k + 8 * kk];
        nx[kk][1] = p1[k + 8 * kk];
        nx[kk][2] = p0[k + 8 * kk + 4];
        nx[kk][3] = p1[k + 8 * kk + 4];
      }
    }
    mbar_wait(r.full + 8 * r.slot, r.phase);
    // one descriptor a slab (the hi half; lo and the column blocks by adding
    // 16-byte units to its address field)
    const uint64_t dh = mdesc(r.base + r.slot * G::SLAB + ((n0 >> 3) * (KS / 4)) * 128, 128, SBO_B);
    constexpr uint32_t LO = KS * G::NC * G::CG * 4 / 16;
    auto fresh = [&](float (&c)[32], int j) {   // this slab's 3xTF32 sum of block j
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) {
        const uint64_t bh = dh + (8 * j * (KS / 4) + 2 * kk) * 8;
        if (kk == 0) wgmma_tf32<0>(c, al[kk], bh);
        else wgmma_tf32<1>(c, al[kk], bh);
        wgmma_tf32<1>(c, ah[kk], bh + LO);
        wgmma_tf32<1>(c, ah[kk], bh);
      }
      wg_commit();
    };
    if constexpr (G::NJ == 2) {   // both blocks in flight, the first added under the second
      float c0[32], c1[32];
      wg_fence();
      fresh(c0, 0);
      fresh(c1, 1);
      wg_wait<1>();
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[0][e] += c0[e];
      wg_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[1][e] += c1[e];
    } else {
#pragma unroll
      for (int j = 0; j < G::NJ; ++j) {
        float c[32];
        wg_fence();
        fresh(c, j);
        wg_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[j][e] += c[e];
      }
    }
    mbar_arrive(r.empty + 8 * r.slot);
    if (++r.slot == G::NS) {
      r.slot = 0;
      r.phase ^= 1;
    }
  }
}

}  // namespace wide
}  // namespace rounds
