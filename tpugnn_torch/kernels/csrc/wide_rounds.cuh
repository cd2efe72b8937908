// The rounds kernels at widths above 128 (Hopper): K1, K2a, K2b and K5 on
// packs of W = 256, 384 or 512 columns (and 128 in a build with WIDE_W128,
// scripts/a10_probe.py's), for the state type WIDE_STATE (code WIDE_CODE)
// of the including source, its forward (WIDE_FORWARD: K1, K2a, K5) or
// backward (WIDE_BACKWARD: K2b) entry points: wide_rounds.cu (bf16) and
// wide_rounds_tf32.cu (f32) the forward, wide_backward.cu and
// wide_backward_tf32.cu the backward, four libraries built in parallel.
//
// They replace, at those widths, the same TPU kernels as the 128-column
// family: tpugnn/kernels/fused_decoder.py::decoder_rounds_tiled
// (pl.pallas_call at :637; K1), fused_backward.py::make_kernel_vjp_rounds
// _fwd and _bwd (:575, :624; K2a, K2b) and roll_gather.py::decoder_rounds_roll
// (:364; K5).  The reference pads a message width up to a multiple of 128
// (fused_decoder.py:610-613) and takes any hidden width; the wrappers here
// pad both to W = 128 ceil(max(hidden, msg_hidden) / 128) and send W >= 256
// to this family (fused_decoder.py::kernel_width).  The functions are the
// plain versions': rounds_packed (K1, K2a: its stash), rounds_vjp_plain
// (K2b) and roll_rounds_plain (K5); read those docstrings for the math and
// the rounding points.  The LayerNorm runs over the model's `width` columns,
// the padded columns are 0 in every operand and stay 0.
//
// Design (wide_mma.cuh: the tile engine, its geometry and shared memory).
// Persistent blocks of two consumer warpgroups and a producer warpgroup walk
// tiles of rows (128 or 64, Geo) of both directions in one launch; the
// producer streams each product's weights through the shared-memory ring by
// TMA, so every weight that reaches shared memory serves the whole tile,
// and asks L2 for the next tile's state rows (cp.async.bulk.prefetch) while
// this one runs.  Outputs are staged in the tile they were read from and
// stored as whole 32-byte sectors (store_tile).  One round:
//   project  ys = rnd(x_src @ ws) for both directions (one launch, the
//            forward kernel's projection mode);
//   update   per tile: ydb = x @ wd + b0 on the tensor cores; in the
//            epilogue, from the accumulators, the slot gather-sum hs from ys
//            by slot table (K1, K2a) or by raster offset and mask bits (K5,
//            in its slot type) into the A tile H; t = hs @ wf + x @ ux + the
//            degree, syndrome and bias terms; hc = rnd(relu(t)) into H; v =
//            x + hc @ w1 + ub1 and the LayerNorm from the accumulators (each
//            row's sum and sum of squared deviations reduced over the quad,
//            and where two warpgroups split the row's columns, through
//            shared memory between them: two floats a row and statistic),
//            rounded into the new states.
// K1 updates its states in place after round 0 (a tile reads only its own
// rows of x; the gathers read ys); K2a reads round r's states from the stash
// entry r and writes round r + 1's into entry r + 1, so its outputs are K1's
// bit for bit.
//
// K2b walks the rounds in reverse from K2a's stash.  Per round:
//   project  ys as above;
//   replay   per tile (the same kernel shape): the forward of the tile (as
//            update) and the adjoint down to the gather: the LayerNorm
//            backward (dpre), dt = (rnd(dpre) @ w1^T) * (t > 0), dhs =
//            rnd(dt) @ wf^T, dydb = dhs times the row's live slots of the
//            column (counted by the gather into 4 bits an entry of shared
//            memory; past 15 slots the masks are read again), dsyn, and the
//            bias gradients' column sums over the tile's rows, reduced over
//            each warp's 16 rows by a transposing butterfly and added by
//            the one lane that owns the column to its warp's partial (no
//            other launch reads a residual to sum it, and each partial word
//            has one writer, so its adds land in program order); it writes
//            the residuals the later launches read (hs, hc, rnd(dpre),
//            rnd(dt), dpre, dhs, rnd(dydb), the slot masks as bits);
//   dys      the gather's adjoint onto its source rows, over the transposed
//            slot lists (the readers of each source row, in (row, slot)
//            order): a fixed order, no atomics, a reader's loads for every
//            column in flight together;
//   cotan    g = dpre + rnd(dydb) @ wd^T + rnd(dys) @ ws^T + rnd(dt) @ ux^T
//            on the tile engine;
//   wgrad    the ten weight gradients A^T G on wgmma over tiles of 128 x 128
//            outputs and row chunks (the A chunk in registers through
//            ldmatrix.trans, the G chunk transposed into shared memory, the
//            next chunk's loads in flight under the products), each
//            partial added to its chunk's;
// and two last launches sum the partials in a fixed order.  So two calls on
// the same inputs give the same bits.
//
// f32 states: every product is 3xTF32.  The adjoint's relu masks (z > 0 for
// each slot, t > 0) are discontinuities: a decision the tensor cores' sums
// take otherwise than the plain version's f32 products (on the card
// cuBLAS's, one FMA per k ascending) moves a whole cotangent entry
// (scripts/k2b_ties.py: 5.5e-4 against the 1e-4 gate at 128 columns).  So,
// as the 128-column f32 K2b does, a decision within TAU of the bound |x|
// |w_c| on its product's terms is taken again in the plain version's order:
// z from two sequential dot products, t from hs of the row summed as the
// plain version sums it (the row group computes that row together, a
// thread a column; over the slots in the order of torch's CUDA reduction,
// four interleaved partials, which past four slots is not the sequential
// sum: the circuit graphs' 10 to 14) and two more.  The bands are wider than the 128-column
// kernel's (2^-18 against 2^-20): the rounding of a sum grows with its
// length.  Only the masks change; the values stay the tensor cores'.  At
// K = 384 cuBLAS does not sum its f32 products one FMA per k (nor in equal
// slices of k), so z's re-decisions miss the plain version's masks on some
// seeds, with the re-decision or without it (scripts/k2b_wide_ties.py): the
// wrapper refuses f32 states at 384 columns (fused_backward.F32_BWD_REFUSED).
//
// Bounds and traffic on an H100 (d=11, W=256, per sample and round): the
// forward's five [241, 256] x [256, 256] products per direction, 158 MFLOP;
// the backward three times that.  Per row and round (W = 256;
// chip_smoke.wide_design_bytes): the forward reads 5 KB of weights from L2
// in bf16 (tiles of 128 rows) and 40 KB in f32 (64 rows), and moves 2.5 KB
// (bf16) or 5 KB (f32) of states through HBM; the backward reads 16 KB (bf16:
// the projection and cotangent products on 128-row tiles, the replay's six
// on 64-row ones, its warpgroups splitting the columns) or 80 KB (f32) of
// weights from L2 and moves 22.5 KB or 39 KB through HBM, most of it the
// weight gradients' operands (each read W / 128 times).
#pragma once

#include "wide_mma.cuh"

namespace {

using namespace rounds;
using namespace rounds::wide;

constexpr int ROLL_SLOTS = 4;
constexpr float TAU_Z = 1.f / 262144;   // 2^-18, the tie bands
constexpr float TAU_T = 1.f / 262144;
constexpr int WG_IB = 128;              // output rows (i) of a weight-gradient block
constexpr int WG_CB = 128;              // its output columns

struct Offsets {
  int o[ROLL_SLOTS];
};

// source cell of slot offset o from cell r, on a raster of L cells
__device__ __forceinline__ int wrap(int r, int o, int L) {
  const int src = r + o;
  return src < 0 ? src + L : (src >= L ? src - L : src);
}

// bytes of one matrix's pack (f32: TF32 hi and lo)
template <typename T>
__host__ __device__ inline size_t mat_bytes(int W) {
  return size_t(W) * W * (sizeof(T) == 4 ? 8 : 2);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// the same through the read-only path, for what the kernel never writes (so
// the compiler may move the load above its stores)
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the slot stage's rounding: bf16 after every op with SLOT16 (K5's bf16
// slot type), none otherwise
template <bool SLOT16>
__device__ __forceinline__ float srnd(float x) {
  if constexpr (SLOT16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// a.k. b with one FMA per k, k ascending, from 0: the plain version's f32
// product on the card (b contiguous)
__device__ __noinline__ float seq_dot(const float* a, const float* __restrict__ b, int K) {
  float s = 0.f;
  for (int k = 0; k < K; k += 4) {
    const float4 p = *reinterpret_cast<const float4*>(a + k);
    const float4 q = __ldg(reinterpret_cast<const float4*>(b + k));
    s = fmaf(p.w, q.w, fmaf(p.z, q.z, fmaf(p.y, q.y, fmaf(p.x, q.x, s))));
  }
  return s;
}

// the same down column c of a row-major [K][W] matrix (the row group
// together: neighbouring threads read neighbouring columns)
__device__ __forceinline__ float seq_dot_col(const float* a, const float* __restrict__ w,
                                             int c, int K, int W) {
  float s = 0.f;
  for (int k = 0; k < K; ++k) s = fmaf(a[k], __ldg(w + size_t(k) * W + c), s);
  return s;
}

// ---------------------------------------------------------------------------
// A block's shared memory and its roles

template <typename G>
struct Smem {
  typedef typename G::State T;
  static constexpr int W = G::Width;
  unsigned char* ring;
  T* X;          // [RG] tiles of the states: bf16 [64 W] (coff), f32 [64][W + 4]
  T* H;          // [RG][64 W] bf16 (coff) or [RT][LDF] f32
  float* red;    // [8][RT] per-row partials of the warpgroups
  int* flag;     // [RT] rows with a tie of t
  float* hsx;    // [RG][W] a row's hs as the plain version sums it
  unsigned char* cnt;   // [RT][W / 2] live slots of (row, column), 4 bits each
  uint64_t* bar; // full [NS], empty [NS]
  __device__ explicit Smem(unsigned char* s) {
    ring = s;
    X = reinterpret_cast<T*>(s + G::RING);
    H = reinterpret_cast<T*>(s + G::RING + G::XT);
    red = reinterpret_cast<float*>(s + G::RING + G::XT + G::HT);
    flag = reinterpret_cast<int*>(red + 8 * G::RT);
    hsx = reinterpret_cast<float*>(flag + G::RT);
    cnt = reinterpret_cast<unsigned char*>(hsx + G::RG * W);
    bar = reinterpret_cast<uint64_t*>(cnt + G::CNT);
  }
  __device__ Ring ring_view() const {
    return Ring{saddr(ring), saddr(bar), saddr(bar + G::NS), 0, 0};
  }
  // thread 0: the barriers; then every thread of the block
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < G::NS; ++i) {
        mbar_init(saddr(bar + i), 1);
        mbar_init(saddr(bar + G::NS + i), CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// A consumer thread's place: its warpgroup, row group (64 rows of the tile,
// `lrow` local rows), column group (columns n0 .. n0 + NC), warp and lane;
// each derived from threadIdx when asked, so that none holds a register
// across the products.
template <typename G>
struct Who {
  __device__ int wg() const { return threadIdx.x >> 7; }
  __device__ int rg() const { return wg() / G::CG; }
  __device__ int cg() const { return wg() % G::CG; }
  __device__ int wr() const { return (threadIdx.x >> 5) & 3; }
  __device__ int g() const { return (threadIdx.x & 31) >> 2; }
  __device__ int t() const { return threadIdx.x & 3; }
  static constexpr int nthr = 128 * G::CG;
  __device__ int ti() const { return threadIdx.x - rg() * nthr; }
  __device__ int n0() const { return cg() * G::NC; }
  __device__ int bar() const { return 1 + rg(); }
  __device__ int lrow(int h) const { return 16 * wr() + g() + 8 * h; }   // of the 64
  __device__ int col(int j, int q) const { return n0() + 64 * j + 8 * q + 2 * t(); }
  __device__ void sync() const { bar_sync(bar(), nthr); }
};

// rows [row0, row0 + 64) of x into the row group's bf16 tile (zeros past
// total), 16 bytes a thread, 8 rows of a core matrix to 8 neighbouring
// threads
template <int W, int NTHR, typename Wh>
__device__ __forceinline__ void load_tile(bf16* X, const bf16* x, int row0, int total,
                                          const Wh& w) {
  constexpr int N = WGR * W / 8 / NTHR;   // 16-byte units a thread, all loads in flight
  uint4 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int u = w.ti() + i * NTHR, rl = u & 7, kc = (u >> 3) % (W / 8), r = 8 * ((u >> 3) / (W / 8)) + rl;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total) v[i] = *reinterpret_cast<const uint4*>(x + size_t(row0 + r) * W + 8 * kc);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int u = w.ti() + i * NTHR, rl = u & 7, kc = (u >> 3) % (W / 8), r8 = (u >> 3) / (W / 8);
    *reinterpret_cast<uint4*>(X + (r8 * (W / 8) + kc) * 64 + 8 * rl) = v[i];
  }
}

// the same into the row group's f32 tile [64][W + 4]: a warp a row
template <int W, int NTHR, typename Wh>
__device__ __forceinline__ void load_tile(float* X, const float* x, int row0, int total,
                                          const Wh& w) {
  constexpr int N = WGR * W / 4 / NTHR, B = 8;   // in batches of 8 loads in flight
#pragma unroll 1
  for (int i0 = 0; i0 < N; i0 += B) {
    float4 v[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int u = w.ti() + (i0 + i) * NTHR, r = u / (W / 4), c = 4 * (u % (W / 4));
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < total) v[i] = *reinterpret_cast<const float4*>(x + size_t(row0 + r) * W + c);
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int u = w.ti() + (i0 + i) * NTHR, r = u / (W / 4), c = 4 * (u % (W / 4));
      *reinterpret_cast<float4*>(X + r * (W + 4) + c) = v[i];
    }
  }
}

// rows [row0, row0 + 64) of x from the row group's bf16 tile (rows past
// total not stored), the mirror of load_tile: whole 32-byte sectors
template <int W, int NTHR, typename Wh>
__device__ __forceinline__ void store_tile(bf16* x, const bf16* X, int row0, int total,
                                           const Wh& w) {
  constexpr int N = WGR * W / 8 / NTHR;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int u = w.ti() + i * NTHR, rl = u & 7, kc = (u >> 3) % (W / 8), r8 = (u >> 3) / (W / 8);
    if (row0 + 8 * r8 + rl < total)
      *reinterpret_cast<uint4*>(x + size_t(row0 + 8 * r8 + rl) * W + 8 * kc) =
          *reinterpret_cast<const uint4*>(X + (r8 * (W / 8) + kc) * 64 + 8 * rl);
  }
}
// the same from the row group's f32 tile [64][W + 4]: a warp a row
template <int W, int NTHR, typename Wh>
__device__ __forceinline__ void store_tile(float* x, const float* X, int row0, int total,
                                           const Wh& w) {
  constexpr int N = WGR * W / 4 / NTHR;
#pragma unroll 8
  for (int i = 0; i < N; ++i) {
    const int u = w.ti() + i * NTHR, r = u / (W / 4), c = 4 * (u % (W / 4));
    if (row0 + r < total)
      *reinterpret_cast<float4*>(x + size_t(row0 + r) * W + c) =
          *reinterpret_cast<const float4*>(X + r * (W + 4) + c);
  }
}

// pair (row lr, columns c, c + 1) of the row group's A tile
template <int W>
__device__ __forceinline__ bf16* at(bf16* H, int lr, int c) { return H + coff<W>(lr, c); }
template <int W>
__device__ __forceinline__ float* at(float* H, int lr, int c) { return H + lr * (W + 4) + c; }

// The row group's tile of a [RG] array of tiles (X, H)
template <typename G, typename T>
__device__ __forceinline__ T* rg_tile(T* base, int rg) {
  return base + rg * WGR * (G::F32 ? G::NC * G::CG + 4 : G::NC * G::CG);
}

// A product of the row group: acc (+)= A @ the ring's next matrix, A the f32
// rows r0 .. r0 + 63 (clamped to rmax) of `a` with row stride lda (states
// read from L2, where their tile does not fit)
template <typename G, typename Wh>
__device__ __forceinline__ void product(float (&acc)[G::NJ][32], const float* a, int lda, int r0,
                                        int rmax, Ring& r, const Wh& w) {
  gemm<G>(acc, a, lda, r0, rmax, w.n0(), r);
}
// the same with A the row group's tile in shared memory, either state type
template <typename G, typename Wh>
__device__ __forceinline__ void tile_product(float (&acc)[G::NJ][32], const bf16* A, Ring& r,
                                             const Wh& w) {
  gemm<G>(acc, saddr(A), w.n0(), r);
}
template <typename G, typename Wh>
__device__ __forceinline__ void tile_product(float (&acc)[G::NJ][32], const float* A, Ring& r,
                                             const Wh& w) {
  gemm<G>(acc, A, G::NC * G::CG + 4, 0, WGR - 1, w.n0(), r);
}

// Row sums of N statistics of both of this thread's rows: v[i][h], this
// thread's part of statistic i on row h, becomes its sum over the row, over
// the quad and, where two warpgroups split the row, through red (slots
// slot0 .. slot0 + N - 1), one barrier for all; every thread of the row
// group calls it at once.
template <typename G, int N, typename Wh>
__device__ __forceinline__ void row_sums(float (&v)[N][2], int slot0, float* red, const Wh& w) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) v[i][h] = quad_sum(v[i][h]);
  if constexpr (G::CG == 1) return;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (w.t() == 0) red[(2 * (slot0 + i) + w.cg()) * G::RT + w.rg() * WGR + w.lrow(h)] = v[i][h];
  w.sync();
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = red + (2 * (slot0 + i)) * G::RT + w.rg() * WGR + w.lrow(h);
      v[i][h] = p[0] + p[G::RT];
    }
}

// ---------------------------------------------------------------------------
// The forward: projection (ys) and update tiles of both directions.

template <typename T>
struct FSide {
  const T* x;          // [total][W] round-input states (projection: the source rows)
  T* out;              // [total][W] new states (may be x), or ys
  const T* ys;         // [B src_rows][W] the gather's source projection
  const float* syn;    // [B rows] the syndrome feature (checks), or null
  const int* idx;      // [rows][D] slot table, -1 masked (table); [rows] mask bits (roll)
  const float* degbo;  // [rows][W] (deg bo) @ ua (roll)
  const unsigned char* mats[4];   // packs, in product order
  const float* vec;    // [7][W]
  Offsets offs;        // slot offsets (roll)
  int rows, src_rows, D, total;
};

template <typename T>
struct FJob {
  FSide<T> s[2];
  int tiles0, tiles, project, width;
};

// PROJECT: the projection alone (K2b's library), no update compiled
template <typename T, int W, bool ROLL, bool SLOT16, bool PROJECT = false>
__global__ void __launch_bounds__(BLOCK, 1) wide_fwd_kernel(const __grid_constant__ FJob<T> job) {
  using G = Geo<T, W>;
  constexpr bool F32 = G::F32;
  constexpr int NJ = G::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<G> sm(smem);
  sm.init();
  Ring ring = sm.ring_view();
  const bool project = PROJECT || job.project;
  const int np = project ? 1 : 4;
  if (threadIdx.x >= CONSUMERS) {
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      for (int tile = blockIdx.x; tile < job.tiles; tile += gridDim.x) {
        const FSide<T>& d = tile < job.tiles0 ? job.s[0] : job.s[1];
        const int next = tile + gridDim.x;   // its states into L2 while this one runs
        if (next < job.tiles) {
          const FSide<T>& e = next < job.tiles0 ? job.s[0] : job.s[1];
          const int r0 = (next - (next < job.tiles0 ? 0 : job.tiles0)) * G::RT;
          prefetch_l2(e.x + size_t(r0) * W, size_t(min(G::RT, e.total - r0)) * W * sizeof(T));
        }
        for (int p = 0; p < np; ++p) feed<G::SLAB, G::NSLAB, G::NS>(ring, d.mats[p]);
      }
  } else {
    regs_up<CONSUMER_REGS>();
    const Who<G> w;
    T* X = rg_tile<G>(sm.X, w.rg());
    T* H = rg_tile<G>(sm.H, w.rg());
    // where outputs are staged before their coalesced stores: X, or H where
    // the f32 states are read from L2
    T* S;
    if constexpr (G::XS) S = X;
    else S = H;
    const float inv_w = 1.f / job.width;
    for (int tile = blockIdx.x; tile < job.tiles; tile += gridDim.x) {
      const bool q = tile >= job.tiles0;
      const FSide<T>& d = q ? job.s[1] : job.s[0];
      const int row0 = (tile - (q ? job.tiles0 : 0)) * G::RT + w.rg() * WGR;
      const float* vec = d.vec;
      float acc[NJ][32];
      w.sync();   // the row group is done with its last tile
      if constexpr (G::XS) {
        load_tile<W, Who<G>::nthr>(X, d.x, row0, d.total, w);
        if constexpr (!F32) fence_async();
        w.sync();
      }
      auto x_product = [&](float (&a)[NJ][32]) {
        if constexpr (G::XS) tile_product<G>(a, X, ring, w);
        else product<G>(a, reinterpret_cast<const float*>(d.x), W, row0, d.total - 1, ring, w);
      };
      auto h_product = [&](float (&a)[NJ][32]) { tile_product<G>(a, H, ring, w); };
      zero(acc);
      x_product(acc);
      if (project) {   // ys = rnd(x_src @ ws), staged in the tile it was read from
        if constexpr (G::XS) w.sync();   // every warpgroup of the row group is done reading X
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq)
              st2(at<W>(S, w.lrow(h), w.col(j, qq)), acc[j][4 * qq + 2 * h],
                  acc[j][4 * qq + 2 * h + 1]);
        w.sync();
        store_tile<W, Who<G>::nthr>(d.out, S, row0, d.total, w);
        continue;
      }
      if constexpr (!PROJECT) {
        // ydb = x @ wd + b0 in acc; the slot gather-sum of each row into H
        float deg[2];
        int bb[2], rr[2];
        unsigned mb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int fr = row0 + w.lrow(h);
          const bool live = fr < d.total;
          bb[h] = live ? fr / d.rows : 0;
          rr[h] = live ? fr - bb[h] * d.rows : 0;
          mb[h] = ROLL && live ? unsigned(d.idx[rr[h]]) : 0u;
          float n = 0.f;
          if (live)
            for (int k = 0; k < d.D; ++k) {
              const int src = ROLL ? ((mb[h] >> k) & 1u ? 0 : -1) : __ldg(d.idx + rr[h] * d.D + k);
              n += src >= 0 ? 1.f : 0.f;
            }
          deg[h] = n;
          if (!live) rr[h] = -1;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float hv[2][8][2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq) {
              const int c = w.col(j, qq);
              hv[h][qq][0] = hv[h][qq][1] = 0.f;
              acc[j][4 * qq + 2 * h] = srnd<ROLL && SLOT16>(acc[j][4 * qq + 2 * h] + __ldg(vec + V_B0 * W + c));
              acc[j][4 * qq + 2 * h + 1] =
                  srnd<ROLL && SLOT16>(acc[j][4 * qq + 2 * h + 1] + __ldg(vec + V_B0 * W + c + 1));
            }
          for (int k = 0; k < d.D; ++k) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (rr[h] < 0) continue;
              const int src = ROLL ? ((mb[h] >> k) & 1u ? wrap(rr[h], d.offs.o[k], d.rows) : -1)
                                   : __ldg(d.idx + rr[h] * d.D + k);
              if (src < 0) continue;   // a masked slot adds exactly 0
              const T* y = d.ys + (size_t(bb[h]) * d.src_rows + src) * W;
              float2 yv[8];
#pragma unroll
              for (int qq = 0; qq < 8; ++qq) yv[qq] = ldg2(y + w.col(j, qq));
#pragma unroll
              for (int qq = 0; qq < 8; ++qq) {
                const float y0 = yv[qq].x, y1 = yv[qq].y;
                const float z0 = acc[j][4 * qq + 2 * h], z1 = acc[j][4 * qq + 2 * h + 1];
                if (ROLL) {
                  hv[h][qq][0] = srnd<SLOT16>(hv[h][qq][0] + fmaxf(srnd<SLOT16>(y0 + z0), 0.f));
                  hv[h][qq][1] = srnd<SLOT16>(hv[h][qq][1] + fmaxf(srnd<SLOT16>(y1 + z1), 0.f));
                } else {
                  hv[h][qq][0] += fmaxf(y0 + z0, 0.f);
                  hv[h][qq][1] += fmaxf(y1 + z1, 0.f);
                }
              }
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq)
              st2(at<W>(H, w.lrow(h), w.col(j, qq)), hv[h][qq][0], hv[h][qq][1]);
        }
        if constexpr (!F32) fence_async();
        w.sync();
        // t = hs @ wf + x @ ux + the degree, syndrome and bias terms
        zero(acc);
        h_product(acc);
        x_product(acc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int fr = min(row0 + w.lrow(h), d.total - 1);   // rows past the end are never stored
          const float sv = d.syn != nullptr ? __ldg(d.syn + fr) : 0.f;
          const int cell = fr % d.rows;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = w.col(j, qq) + e;
                float v = acc[j][4 * qq + 2 * h + e];
                if (ROLL) {
                  v += __ldg(d.degbo + size_t(cell) * W + c);
                  if (d.syn != nullptr) v += rnd_t<T>(__fmul_rn(sv, __ldg(vec + V_UCS * W + c)));
                  v += __ldg(vec + V_UB0 * W + c);
                } else {
                  v += deg[h] * __ldg(vec + V_BOA * W + c) + __ldg(vec + V_UB0 * W + c);
                  if (d.syn != nullptr) v += sv * __ldg(vec + V_UCS * W + c);
                }
                acc[j][4 * qq + 2 * h + e] = v;
              }
        }
        w.sync();   // every warpgroup of the row group is done reading hs
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq)
              st2(at<W>(H, w.lrow(h), w.col(j, qq)), fmaxf(acc[j][4 * qq + 2 * h], 0.f),
                  fmaxf(acc[j][4 * qq + 2 * h + 1], 0.f));
        if constexpr (!F32) fence_async();
        w.sync();
        // v = x + hc @ w1 + ub1, and the LayerNorm of each row
        zero(acc);
        h_product(acc);
        // the mean, then the variance, of both rows in one barrier each
        float mu[1][2] = {{0.f, 0.f}}, rs[1][2] = {{0.f, 0.f}};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = w.lrow(h), fr = min(row0 + lr, d.total - 1);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq) {
              const int c = w.col(j, qq);
              float2 xv;
              if constexpr (G::XS) xv = ld2(at<W>(X, lr, c));
              else xv = ldg2(reinterpret_cast<const float*>(d.x) + size_t(fr) * W + c);
              acc[j][4 * qq + 2 * h] += xv.x + __ldg(vec + V_UB1 * W + c);
              acc[j][4 * qq + 2 * h + 1] += xv.y + __ldg(vec + V_UB1 * W + c + 1);
              if (c < job.width) mu[0][h] += acc[j][4 * qq + 2 * h];
              if (c + 1 < job.width) mu[0][h] += acc[j][4 * qq + 2 * h + 1];
            }
        }
        row_sums<G>(mu, 0, sm.red, w);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mu[0][h] *= inv_w;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (w.col(j, qq) + e < job.width) {
                  const float u = acc[j][4 * qq + 2 * h + e] - mu[0][h];
                  rs[0][h] += u * u;
                }
        }
        row_sums<G>(rs, 1, sm.red, w);
        // the new states staged where this thread read x, or hc where x is
        // read from L2: every warpgroup of the row group is past its reads
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float r = rsqrtf(rs[0][h] * inv_w + 1e-6f);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq) {
              const int c = w.col(j, qq);
              float o[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float nh = c + e < job.width ? (acc[j][4 * qq + 2 * h + e] - mu[0][h]) * r
                                                   : 0.f;
                o[e] = nh * __ldg(vec + V_LNS * W + c + e) + __ldg(vec + V_LNB * W + c + e);
              }
              st2(at<W>(S, w.lrow(h), c), o[0], o[1]);
            }
        }
        w.sync();
        store_tile<W, Who<G>::nthr>(d.out, S, row0, d.total, w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: the replay and the adjoint down to the gather.

template <typename T>
struct BSide {
  const T* x;             // [total][W] the stash's round-r states of this direction
  const T* xsrc;          // [B src_rows][W] those of the other direction
  const T* ys;            // [B src_rows][W] the replayed gather source
  const float* g;         // [total][W] the cotangent of the round's new states
  const float* syn;       // [total] (checks) or null
  float* dsyn;            // [total] (checks) or null
  const float* ucs32;     // [W] uc_s unrounded (checks) or null
  const int* idx;         // [rows][D] slot table
  const float* degt;      // [rows] real slots a row
  const unsigned char* mats[6];   // packs in product order: wd, wf, ux, w1, w1^T, wf^T
  const float* vec;       // [7][W]
  // residuals, [total][W] (live: [total][D][W / 32] bits)
  T *hs, *hc, *dpre_r, *dtr, *dydb_r;
  T* dhs;                 // rounded: the gather adjoint reads only rnd(dhs)
  float* dpre;
  uint32_t* live;
  float* part;            // [segments][7][W] the bias gradients' partials
  // ties (f32 states only)
  const float* w32;       // the direction's 5 f32 matrices [5][W][W]
  const float* w32t;      //   their transposes
  const float* wsrc32;    // the f32 matrix projecting xsrc into ys
  const float* wsrc32t;   //   its transpose
  const float* xn;        // [total] |x| of this round's rows
  const float* xn_src;    // [B src_rows]
  float wn_wd, wn_ux, wn_wf, wn_src;   // largest column norms
  int rows, src_rows, D, total;
};

template <typename T>
struct BJob {
  BSide<T> s[2];
  int tiles0, tiles, width, msg_width;
};

// Adds quantity v's column sums over this warp's 16 rows to its partial:
// x[2 qq + e] holds this thread's value (rows h = 0, 1 summed) of column c0
// + 8 qq + 2 t + e.  A transposing butterfly over g (14 shuffles for 16
// values) leaves lane (g, t) the sums of columns c0 + 8 g + 2 t + {0, 1},
// which it adds (red.add: only that lane ever adds to those words, so its
// adds land in program order, the same bits every call).
template <typename Wh>
__device__ __forceinline__ void colsum(float* part, int v, int c0, const float (&x)[16],
                                       const Wh& w, int W) {
  const bool u4 = w.g() & 4, u2 = w.g() & 2, u1 = w.g() & 1;
  float y[8], z[4], r[2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    y[i] = (u4 ? x[i + 8] : x[i]) + __shfl_xor_sync(0xffffffffu, u4 ? x[i] : x[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    z[i] = (u2 ? y[i + 4] : y[i]) + __shfl_xor_sync(0xffffffffu, u2 ? y[i] : y[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    r[i] = (u1 ? z[i + 2] : z[i]) + __shfl_xor_sync(0xffffffffu, u1 ? z[i] : z[i + 2], 4);
  float* p = part + size_t(v) * W + c0 + 8 * w.g() + 2 * w.t();
  atomicAdd(p, r[0]);
  atomicAdd(p + 1, r[1]);
}

template <typename T, int W>
__global__ void __launch_bounds__(BLOCK, 1) wide_replay_kernel(const __grid_constant__ BJob<T> job) {
  using G = Geo<T, W, true>;
  constexpr bool F32 = G::F32, TIES = F32;
  constexpr int NJ = G::NJ, WORDS = W / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<G> sm(smem);
  sm.init();
  Ring ring = sm.ring_view();
  if (threadIdx.x >= CONSUMERS) {
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      for (int tile = blockIdx.x; tile < job.tiles; tile += gridDim.x) {
        const BSide<T>& d = tile < job.tiles0 ? job.s[0] : job.s[1];
        const int next = tile + gridDim.x;   // its states and cotangent into L2
        if (next < job.tiles) {
          const BSide<T>& e = next < job.tiles0 ? job.s[0] : job.s[1];
          const int r0 = (next - (next < job.tiles0 ? 0 : job.tiles0)) * G::RT;
          const size_t n = size_t(min(G::RT, e.total - r0)) * W;
          prefetch_l2(e.x + size_t(r0) * W, n * sizeof(T));
          prefetch_l2(e.g + size_t(r0) * W, n * 4);
        }
        for (int p = 0; p < 6; ++p) feed<G::SLAB, G::NSLAB, G::NS>(ring, d.mats[p]);
      }
    return;
  }
  regs_up<CONSUMER_REGS>();
  const Who<G> w;
  T* X = rg_tile<G>(sm.X, w.rg());
  T* H = rg_tile<G>(sm.H, w.rg());
  T* S;   // the A tile of dt, then dydb's staging: X, or H where x is read from L2
  if constexpr (G::XS) S = X;
  else S = H;
  const float inv_w = 1.f / job.width;
  const int pslot = blockIdx.x * 8 + (threadIdx.x >> 5);
  for (int tile = blockIdx.x; tile < job.tiles; tile += gridDim.x) {
    const bool side = tile >= job.tiles0;
    const BSide<T>& d = side ? job.s[1] : job.s[0];
    const int row0 = (tile - (side ? job.tiles0 : 0)) * G::RT + w.rg() * WGR;
    const float* vec = d.vec;
    float* part = d.part + size_t(pslot) * 7 * W;
    float acc[NJ][32];
    w.sync();
    if constexpr (G::XS) {
      load_tile<W, Who<G>::nthr>(X, d.x, row0, d.total, w);
      if constexpr (!F32) fence_async();
      w.sync();
    }
    auto x_product = [&](float (&a)[NJ][32]) {
      if constexpr (G::XS) tile_product<G>(a, X, ring, w);
      else product<G>(a, reinterpret_cast<const float*>(d.x), W, row0, d.total - 1, ring, w);
    };
    auto h_product = [&](float (&a)[NJ][32]) { tile_product<G>(a, H, ring, w); };
    // a row's index, whether it is real, its slot count and |x|: derived
    // where used, so that none holds a register across the products
    auto fr = [&](int h) { return row0 + w.lrow(h); };
    auto live_row = [&](int h) { return row0 + w.lrow(h) < d.total; };
    auto deg = [&](int h) { return live_row(h) ? __ldg(d.degt + fr(h) % d.rows) : 0.f; };
    auto xn = [&](int h) { return TIES && live_row(h) ? __ldg(d.xn + fr(h)) : 0.f; };
    // ydb = x @ wd + b0; the replayed gather-sum into H and hs, the slot
    // masks as bits (f32: a mask whose |z| falls in the band taken again as
    // the plain version computes z); |hs| of each row
    zero(acc);
    x_product(acc);
    float hsq[2] = {0.f, 0.f};
    unsigned char* cnt = sm.cnt + size_t(w.rg()) * WGR * (W / 2);
    int bb[2], rr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bb[h] = live_row(h) ? fr(h) / d.rows : 0;
      rr[h] = live_row(h) ? fr(h) - bb[h] * d.rows : 0;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float hv[2][8][2];
      uint32_t nl[2][2] = {{0u, 0u}, {0u, 0u}};   // live slots, 4 bits an entry
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
          const int c = w.col(j, qq);
          hv[h][qq][0] = hv[h][qq][1] = 0.f;
          acc[j][4 * qq + 2 * h] += __ldg(vec + V_B0 * W + c);
          acc[j][4 * qq + 2 * h + 1] += __ldg(vec + V_B0 * W + c + 1);
        }
      for (int k = 0; k < d.D; ++k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bits[2] = {0u, 0u};
          const int src = live_row(h) ? __ldg(d.idx + rr[h] * d.D + k) : -1;
          if (src >= 0) {
            const size_t fs = size_t(bb[h]) * d.src_rows + src;
            const T* y = d.ys + fs * W;
            float2 yv[8];
#pragma unroll
            for (int qq = 0; qq < 8; ++qq) yv[qq] = ldg2(y + w.col(j, qq));
            const float band = TIES ? TAU_Z * (d.xn_src[fs] * d.wn_src + xn(h) * d.wn_wd) : 0.f;
            uint32_t tie = 0u;   // entries 2 qq + e whose |z| falls in the band (f32)
#pragma unroll
            for (int qq = 0; qq < 8; ++qq)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float z = (e ? yv[qq].y : yv[qq].x) + acc[j][4 * qq + 2 * h + e];
                hv[h][qq][e] += fmaxf(z, 0.f);
                const bool lv = z > 0.f;
                if (TIES && w.col(j, qq) + e < job.msg_width && fabsf(z) < band)
                  tie |= 1u << (2 * qq + e);
                bits[qq >> 2] |= (lv ? 1u : 0u) << ((8 * qq + 2 * w.t() + e) & 31);
                nl[h][qq >> 2] += (lv ? 1u : 0u) << (4 * (2 * (qq & 3) + e));
              }
            // the tied masks taken again as the plain version computes z, one
            // entry at a time (rare: not unrolled)
            for (; TIES && tie != 0u; tie &= tie - 1u) {
              const int i = __ffs(tie) - 1, qq = i >> 1, e = i & 1;
              const int c = w.col(j, qq) + e;
              const float* xs = reinterpret_cast<const float*>(d.xsrc) + fs * W;
              const float* xr = reinterpret_cast<const float*>(d.x) + size_t(fr(h)) * W;
              const float ex = __fadd_rn(
                  seq_dot(xs, d.wsrc32t + size_t(c) * W, W),
                  __fadd_rn(seq_dot(xr, d.w32t + size_t(M_WD) * W * W + size_t(c) * W, W),
                            __ldg(vec + V_B0 * W + c)));
              const uint32_t bit = 1u << ((8 * qq + 2 * w.t() + e) & 31);
              const uint32_t one = 1u << (4 * (2 * (qq & 3) + e));
              const int word = qq >> 2;
              const bool was = ((word ? bits[1] : bits[0]) & bit) != 0u;
              if ((ex > 0.f) != was) {   // flip the mask and the count
                if (word) {
                  bits[1] ^= bit;
                  nl[h][1] = was ? nl[h][1] - one : nl[h][1] + one;
                } else {
                  bits[0] ^= bit;
                  nl[h][0] = was ? nl[h][0] - one : nl[h][0] + one;
                }
              }
            }
          }
          // the quad's bits make the row's words for columns 64 j .. 64 j + 63
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            bits[i] |= __shfl_xor_sync(0xffffffffu, bits[i], 1);
            bits[i] |= __shfl_xor_sync(0xffffffffu, bits[i], 2);
          }
          if (live_row(h) && w.t() == 0)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              d.live[(size_t(fr(h)) * d.D + k) * WORDS + (w.n0() + 64 * j) / 32 + i] = bits[i];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
          const float h0 = rnd_t<T>(hv[h][qq][0]), h1 = rnd_t<T>(hv[h][qq][1]);
          const int c = w.col(j, qq);
          st2(at<W>(H, w.lrow(h), c), h0, h1);
          hsq[h] += h0 * h0 + h1 * h1;
          cnt[w.lrow(h) * (W / 2) + c / 2] = (nl[h][qq >> 2] >> (8 * (qq & 3))) & 0xffu;
        }
    }
    float hsn[1][2] = {{hsq[0], hsq[1]}};
    row_sums<G>(hsn, 0, sm.red, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) hsn[0][h] = sqrtf(hsn[0][h]);
    if constexpr (!F32) fence_async();
    w.sync();
    store_tile<W, Who<G>::nthr>(d.hs, H, row0, d.total, w);

    // t, its relu mask (tp) and, in f32, the entries in the tie band (tu)
    zero(acc);
    h_product(acc);
    x_product(acc);
    uint32_t tp[NJ], tu[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) tp[j] = tu[j] = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = min(fr(h), d.total - 1);
      const float sv = d.syn != nullptr ? __ldg(d.syn + f) : 0.f;
      const float band = TIES && live_row(h) ? TAU_T * (xn(h) * d.wn_ux + hsn[0][h] * d.wn_wf) : -1.f;
      const float dg = deg(h);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int qq = 0; qq < 8; ++qq)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = w.col(j, qq) + e, i = 4 * qq + 2 * h + e;
            float v = acc[j][i];
            v += dg * __ldg(vec + V_BOA * W + c) + __ldg(vec + V_UB0 * W + c);
            if (d.syn != nullptr) v += sv * __ldg(vec + V_UCS * W + c);
            acc[j][i] = v;
            tp[j] |= (v > 0.f ? 1u : 0u) << i;
            tu[j] |= (c < job.width && fabsf(v) < band ? 1u : 0u) << i;
          }
    }
    if constexpr (TIES) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < NJ; ++j) any |= tu[j] != 0u;
      if (bar_or(w.bar(), w.nthr, any)) {
        // each tied row's hs as the plain version sums it (a thread a
        // column), then the threads holding a tied entry take its mask again
        // from t as the plain version forms it
        int* flag = sm.flag + w.rg() * WGR;
        float* hsx = sm.hsx + w.rg() * W;
        if (w.ti() < WGR) flag[w.ti()] = 0;
        w.sync();
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if ((tu[j] >> i) & 1u) flag[w.lrow((i >> 1) & 1)] = 1;
        w.sync();
        for (int lr = 0; lr < WGR; ++lr) {
          if (!flag[lr]) continue;   // the same for every thread of the row group
          const int f = row0 + lr, b = f / d.rows, r = f - b * d.rows;
          const float* xr = reinterpret_cast<const float*>(d.x) + size_t(f) * W;
          for (int c = w.ti(); c < W; c += w.nthr) {
            const float ydb = __fadd_rn(seq_dot_col(xr, d.w32 + size_t(M_WD) * W * W, c, W, W),
                                        __ldg(vec + V_B0 * W + c));
            // the slots summed as torch's CUDA reduction forms the plain
            // version's z.sum(2): four partials, slot k into partial k % 4,
            // added in order (past four slots not the sequential sum)
            float hx[4] = {0.f, 0.f, 0.f, 0.f};
            for (int k = 0; k < d.D; ++k) {
              const int src = __ldg(d.idx + r * d.D + k);
              if (src < 0) continue;   // a masked slot adds exactly 0
              const float* xs = reinterpret_cast<const float*>(d.xsrc) +
                                (size_t(b) * d.src_rows + src) * W;
              const float z = fmaxf(__fadd_rn(seq_dot_col(xs, d.wsrc32, c, W, W), ydb), 0.f);
              switch (k & 3) {
                case 0: hx[0] = __fadd_rn(hx[0], z); break;
                case 1: hx[1] = __fadd_rn(hx[1], z); break;
                case 2: hx[2] = __fadd_rn(hx[2], z); break;
                default: hx[3] = __fadd_rn(hx[3], z);
              }
            }
            hsx[c] = __fadd_rn(__fadd_rn(__fadd_rn(hx[0], hx[1]), hx[2]), hx[3]);
          }
          w.sync();
          const float sv = d.syn != nullptr ? __ldg(d.syn + f) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (w.lrow(h) != lr) continue;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              // row h's tied entries of block j (bits 4 qq + 2 h + e), one at a time
              for (uint32_t m = tu[j] & (h ? 0xccccccccu : 0x33333333u); m != 0u; m &= m - 1u) {
                const int i = __ffs(m) - 1, qq = i >> 2, e = i & 1;
                const int c = w.col(j, qq) + e;
                float v = __fadd_rn(
                    seq_dot(xr, d.w32t + size_t(M_UX) * W * W + size_t(c) * W, W),
                    seq_dot(hsx, d.w32t + size_t(M_WF) * W * W + size_t(c) * W, W));
                v = __fadd_rn(v, __fmul_rn(deg(h), __ldg(vec + V_BOA * W + c)));
                v = __fadd_rn(v, __fmul_rn(sv, __ldg(vec + V_UCS * W + c)));
                v = __fadd_rn(v, __ldg(vec + V_UB0 * W + c));
                tp[j] = v > 0.f ? tp[j] | (1u << i) : tp[j] & ~(1u << i);
              }
          }
          w.sync();   // every thread is done with hsx
        }
      }
    }
    w.sync();   // every warpgroup of the row group is done reading hs
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
          const int c = w.col(j, qq);
          const float h0 = fmaxf(acc[j][4 * qq + 2 * h], 0.f);
          const float h1 = fmaxf(acc[j][4 * qq + 2 * h + 1], 0.f);
          st2(at<W>(H, w.lrow(h), c), h0, h1);
        }
    if constexpr (!F32) fence_async();
    w.sync();
    store_tile<W, Who<G>::nthr>(d.hc, H, row0, d.total, w);

    // v = x + hc @ w1 + ub1, the LayerNorm again and its adjoint: dpre; the
    // column sums of dpre, g nh and g
    zero(acc);
    h_product(acc);
    w.sync();   // every warpgroup of the row group is done reading hc
    {
      // each statistic of both rows in one barrier (row_sums): the mean, the
      // variance, then the adjoint's two sums
      float mu[1][2] = {{0.f, 0.f}}, rs[1][2] = {{0.f, 0.f}}, m12[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = w.lrow(h), f = min(fr(h), d.total - 1);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int qq = 0; qq < 8; ++qq) {
            const int c = w.col(j, qq);
            float2 xv;
            if constexpr (G::XS) xv = ld2(at<W>(X, lr, c));
            else xv = ldg2(reinterpret_cast<const float*>(d.x) + size_t(f) * W + c);
            acc[j][4 * qq + 2 * h] += xv.x + __ldg(vec + V_UB1 * W + c);
            acc[j][4 * qq + 2 * h + 1] += xv.y + __ldg(vec + V_UB1 * W + c + 1);
            if (c < job.width) mu[0][h] += acc[j][4 * qq + 2 * h];
            if (c + 1 < job.width) mu[0][h] += acc[j][4 * qq + 2 * h + 1];
          }
      }
      row_sums<G>(mu, 0, sm.red, w);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mu[0][h] *= inv_w;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int qq = 0; qq < 8; ++qq)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (w.col(j, qq) + e < job.width) {
                const float u = acc[j][4 * qq + 2 * h + e] - mu[0][h];
                rs[0][h] += u * u;
              }
      }
      row_sums<G>(rs, 1, sm.red, w);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[0][h] = rsqrtf(rs[0][h] * inv_w + 1e-6f);
        // acc becomes nh (0 past the LayerNorm's columns and on rows past the
        // end); s1, s2
        const int f = min(fr(h), d.total - 1);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int qq = 0; qq < 8; ++qq) {
            const int c = w.col(j, qq);
            const float2 gv = ldg2(d.g + size_t(f) * W + c);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * qq + 2 * h + e;
              const float nh = c + e < job.width ? (acc[j][i] - mu[0][h]) * rs[0][h] : 0.f;
              acc[j][i] = live_row(h) ? nh : 0.f;
              if (c + e < job.width) {
                const float dnh = (e ? gv.y : gv.x) * __ldg(vec + V_LNS * W + c + e);
                m12[0][h] += dnh;
                m12[1][h] += dnh * nh;
              }
            }
          }
      }
      row_sums<G>(m12, 2, sm.red, w);
      float rsv[2], m1[2], m2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rsv[h] = rs[0][h];
        m1[h] = m12[0][h] * inv_w;
        m2[h] = m12[1][h] * inv_w;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float cs[3][16];
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
          const int c = w.col(j, qq);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 gv =
                live_row(h) ? ldg2(d.g + size_t(fr(h)) * W + c) : make_float2(0.f, 0.f);
            float dp[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * qq + 2 * h + e;
              const float gg = e ? gv.y : gv.x;
              dp[e] = c + e < job.width && live_row(h)
                          ? rsv[h] * (gg * __ldg(vec + V_LNS * W + c + e) - m1[h] - acc[j][i] * m2[h])
                          : 0.f;
              cs[0][2 * qq + e] = (h ? cs[0][2 * qq + e] : 0.f) + dp[e];
              cs[1][2 * qq + e] = (h ? cs[1][2 * qq + e] : 0.f) + gg * acc[j][i];
              cs[2][2 * qq + e] = (h ? cs[2][2 * qq + e] : 0.f) + gg;
            }
            if (live_row(h)) st2(d.dpre + size_t(fr(h)) * W + c, dp[0], dp[1]);
            st2(at<W>(H, w.lrow(h), c), dp[0], dp[1]);
          }
        }
#pragma unroll
        for (int v = 0; v < 3; ++v) colsum(part, 4 + v, w.col(j, 0) - 2 * w.t(), cs[v], w, W);
      }
    }
    if constexpr (!F32) fence_async();
    w.sync();
    if constexpr (!F32) store_tile<W, Who<G>::nthr>(d.dpre_r, H, row0, d.total, w);

    // dt = (rnd(dpre) @ w1^T) * (t > 0); rnd(dt) into the next A tile; dsyn;
    // the column sums of deg dt, syn dt and dt
    zero(acc);
    h_product(acc);
    if constexpr (!G::XS) w.sync();   // dt goes into H, which the product read
    {
      float ds[2] = {0.f, 0.f}, sv[2], dg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sv[h] = d.syn != nullptr && live_row(h) ? __ldg(d.syn + fr(h)) : 0.f;
        dg[h] = deg(h);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float cs[3][16];
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
          const int c = w.col(j, qq);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * qq + 2 * h + e;
              o[e] = (tp[j] >> i) & 1u && live_row(h) ? acc[j][i] : 0.f;
              if (d.ucs32 != nullptr) ds[h] += o[e] * __ldg(d.ucs32 + c + e);
              cs[0][2 * qq + e] = (h ? cs[0][2 * qq + e] : 0.f) + dg[h] * o[e];
              cs[1][2 * qq + e] = (h ? cs[1][2 * qq + e] : 0.f) + sv[h] * o[e];
              cs[2][2 * qq + e] = (h ? cs[2][2 * qq + e] : 0.f) + o[e];
            }
            st2(at<W>(S, w.lrow(h), c), o[0], o[1]);
          }
        }
#pragma unroll
        for (int v = 0; v < 3; ++v) colsum(part, 1 + v, w.col(j, 0) - 2 * w.t(), cs[v], w, W);
      }
      float dsr[1][2] = {{ds[0], ds[1]}};
      row_sums<G>(dsr, 1, sm.red, w);
      // one thread owns the row's dsyn through every round: its adds land in order
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (d.dsyn != nullptr && live_row(h) && w.cg() == 0 && w.t() == 0)
          atomicAdd(d.dsyn + fr(h), dsr[0][h]);
    }
    if constexpr (!F32) fence_async();
    w.sync();
    store_tile<W, Who<G>::nthr>(d.dtr, S, row0, d.total, w);

    // dhs = rnd(dt) @ wf^T; dydb = dhs times the row's live slots of the
    // column (its sum over them, in one rounding), and its column sums
    zero(acc);
    tile_product<G>(acc, S, ring, w);
    w.sync();   // every warpgroup of the row group is done reading rnd(dt): dydb goes there
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float y[2][8][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) y[h][qq][0] = y[h][qq][1] = 0.f;
        if (!live_row(h)) continue;
        if (d.D <= 15) {   // the counts the gather left: dhs once a live slot
#pragma unroll
          for (int qq = 0; qq < 8; ++qq) {
            const unsigned n = cnt[w.lrow(h) * (W / 2) + w.col(j, qq) / 2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              y[h][qq][e] = acc[j][4 * qq + 2 * h + e] * float((n >> (4 * e)) & 15u);
          }
        } else {   // more slots than 4 bits count: the masks again, from L2
          for (int k = 0; k < d.D; ++k) {
            const uint32_t* lw = d.live + (size_t(fr(h)) * d.D + k) * WORDS + (w.n0() + 64 * j) / 32;
            const uint32_t l0 = lw[0], l1 = lw[1];
#pragma unroll
            for (int qq = 0; qq < 8; ++qq)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                y[h][qq][e] += float((((qq >> 2) ? l1 : l0) >> ((8 * qq + 2 * w.t() + e) & 31)) & 1u);
          }
#pragma unroll
          for (int qq = 0; qq < 8; ++qq)
#pragma unroll
            for (int e = 0; e < 2; ++e) y[h][qq][e] *= acc[j][4 * qq + 2 * h + e];
        }
      }
      float cs[16];
#pragma unroll
      for (int qq = 0; qq < 8; ++qq) {
        const int c = w.col(j, qq);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (live_row(h))
            st2(d.dhs + size_t(fr(h)) * W + c, acc[j][4 * qq + 2 * h], acc[j][4 * qq + 2 * h + 1]);
          st2(at<W>(S, w.lrow(h), c), y[h][qq][0], y[h][qq][1]);
        }
        cs[2 * qq] = y[0][qq][0] + y[1][qq][0];
        cs[2 * qq + 1] = y[0][qq][1] + y[1][qq][1];
      }
      colsum(part, 0, w.col(j, 0) - 2 * w.t(), cs, w, W);
    }
    w.sync();
    store_tile<W, Who<G>::nthr>(d.dydb_r, S, row0, d.total, w);
  }
}

// dys onto this direction's rows: the other direction's gather adjoint,
// each source row summing its readers (row, slot) in list order; a warp a
// row, a lane the columns c = lane + 32 i, every column's load of a reader
// in flight together.
template <typename T>
__global__ void __launch_bounds__(256) wide_dys_kernel(T* dys, int total, int rows,
                                                       const int* __restrict__ off,
                                                       const int* __restrict__ lst,
                                                       const T* dhs, const uint32_t* live,
                                                       int rd, int D, int W) {
  const int lane = threadIdx.x & 31;
  const int fs = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (fs >= total) return;
  const int b = fs / rows, s = fs - b * rows;
  const int e0 = __ldg(off + s), e1 = __ldg(off + s + 1);
  const int words = W / 32;
  float a[WMAX / 32];
#pragma unroll
  for (int i = 0; i < WMAX / 32; ++i) a[i] = 0.f;
  for (int e = e0; e < e1; ++e) {
    const int v = __ldg(lst + e), r = v / D, k = v - r * D;
    const size_t fr = size_t(b) * rd + r;
    const uint32_t* lw = live + (fr * D + k) * words;
    const T* dh = dhs + fr * W + lane;
#pragma unroll
    for (int i = 0; i < WMAX / 32; ++i)
      if (i < words && ((__ldg(lw + i) >> lane) & 1u)) a[i] += to_f<T>(__ldg(dh + 32 * i));
  }
#pragma unroll
  for (int i = 0; i < WMAX / 32; ++i)
    if (i < words) dys[size_t(fs) * W + lane + 32 * i] = from_f<T>(a[i]);
}

// g = dpre + rnd(dydb) @ wd^T + rnd(dys) @ ws^T + rnd(dt) @ ux^T, tiles of
// both directions (in place)
template <typename T>
struct CSide {
  float* g;
  const float* dpre;
  const T *dydb_r, *dys, *dtr;
  const unsigned char* mats[3];   // wd^T, ws^T, ux^T
  int total;
};

template <typename T>
struct CJob {
  CSide<T> s[2];
  int tiles0, tiles;
};

template <typename T, int W>
__global__ void __launch_bounds__(BLOCK, 1) wide_cotangent_kernel(const __grid_constant__ CJob<T> job) {
  using G = Geo<T, W>;
  constexpr bool F32 = G::F32;
  constexpr int NJ = G::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<G> sm(smem);
  sm.init();
  Ring ring = sm.ring_view();
  if (threadIdx.x >= CONSUMERS) {
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      for (int tile = blockIdx.x; tile < job.tiles; tile += gridDim.x) {
        const CSide<T>& d = tile < job.tiles0 ? job.s[0] : job.s[1];
        for (int p = 0; p < 3; ++p) feed<G::SLAB, G::NSLAB, G::NS>(ring, d.mats[p]);
      }
    return;
  }
  regs_up<CONSUMER_REGS>();
  const Who<G> w;
  T* X = rg_tile<G>(sm.X, w.rg());
  T* H = rg_tile<G>(sm.H, w.rg());
  for (int tile = blockIdx.x; tile < job.tiles; tile += gridDim.x) {
    const bool side = tile >= job.tiles0;
    const CSide<T>& d = side ? job.s[1] : job.s[0];
    const int row0 = (tile - (side ? job.tiles0 : 0)) * G::RT + w.rg() * WGR;
    float acc[NJ][32];
    zero(acc);
    w.sync();
    if constexpr (!G::XS) {
      product<G>(acc, reinterpret_cast<const float*>(d.dydb_r), W, row0, d.total - 1, ring, w);
      product<G>(acc, reinterpret_cast<const float*>(d.dys), W, row0, d.total - 1, ring, w);
      product<G>(acc, reinterpret_cast<const float*>(d.dtr), W, row0, d.total - 1, ring, w);
    } else {
      load_tile<W, Who<G>::nthr>(X, d.dydb_r, row0, d.total, w);
      load_tile<W, Who<G>::nthr>(H, d.dys, row0, d.total, w);
      if constexpr (!F32) fence_async();
      w.sync();
      tile_product<G>(acc, X, ring, w);
      tile_product<G>(acc, H, ring, w);
      w.sync();
      load_tile<W, Who<G>::nthr>(X, d.dtr, row0, d.total, w);
      if constexpr (!F32) fence_async();
      w.sync();
      tile_product<G>(acc, X, ring, w);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int fr = row0 + w.lrow(h);
      if (fr >= d.total) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
          const size_t e = size_t(fr) * W + w.col(j, qq);
          const float2 p = ldg2(d.dpre + e);
          st2(d.g + e, p.x + acc[j][4 * qq + 2 * h], p.y + acc[j][4 * qq + 2 * h + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// The ten weight gradients: block (mat, i-block, c-block, chunk) forms
// rows [128 ib, 128 ib + 128) and columns [128 cb, 128 cb + 128) of A^T G
// over the chunk's rows and adds them to the chunk's partial [10][W][W].  A
// warpgroup owns 64 output rows (i).  Per step of KR rows: A [KR][128] row
// major in shared memory, read into registers transposed (the wgmma A
// operand: ldmatrix.trans in bf16, split into TF32 halves in f32); G [KR][128]
// transposed into K-major core matrices (the B operand; the core matrices
// padded so that the transposing stores fall on distinct banks: lbo 144
// bytes, sbo = 64 mod 128); the next step's rows load into registers while
// this step's products run.  Each G operand is read W / 128 times, each A
// operand W / 128 times.

template <typename T>
struct WGrad {
  const T* a[10];
  const T* g[10];
  int total[10];
};

template <typename T>
struct WgGeo {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int KR = F32 ? 32 : 64;      // rows a step
  static constexpr int TE = F32 ? 4 : 8;
  static constexpr int LDA = WG_IB + (F32 ? 4 : 8);
  static constexpr int A_BYTES = KR * LDA * sizeof(T);
  static constexpr uint32_t LBO = 144;
  static constexpr uint32_t SBO = (KR / TE) * 144 + (64 - (KR / TE) * 144 % 128 + 128) % 128;
  static constexpr int B_HALF = (WG_CB / 8) * SBO;          // one TF32 half, or bf16
  static constexpr int B_BYTES = (F32 ? 2 : 1) * B_HALF;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = 2 * STAGE;
  static_assert(SBO % 128 == 64, "sbo");
};

template <typename T>
__global__ void __launch_bounds__(CONSUMERS, 1) wide_wgrad_kernel(const __grid_constant__ WGrad<T> p,
                                                                float* part, int nch, int W) {
  using Q = WgGeo<T>;
  constexpr bool F32 = Q::F32;
  constexpr int KR = Q::KR, NJ = WG_CB / 64;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nb = W / WG_IB;
  const int mat = blockIdx.x / (nb * nb), ib = blockIdx.x / nb % nb, cb = blockIdx.x % nb;
  const int ch = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg = threadIdx.x >> 7, wr = (threadIdx.x >> 5) & 3;
  const int total = p.total[mat];
  const int per = ((total + nch - 1) / nch + KR - 1) / KR * KR;
  const int r0 = ch * per, r1 = min(total, r0 + per);
  const T* A = p.a[mat] + WG_IB * ib;
  const T* Gm = p.g[mat] + WG_CB * cb;
  constexpr int V = 16 / sizeof(T);   // elements of a 16-byte load
  // a thread's share of a step: A rows (16-byte units), G 2-row x V-column units
  constexpr int AU = KR * WG_IB / V / CONSUMERS, GU = KR / 2 * WG_CB / V / CONSUMERS;
  uint4 an[AU], gn[GU][2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AU; ++i) {
      const int u = threadIdx.x + i * CONSUMERS, r = u / (WG_IB / V), c = (u % (WG_IB / V)) * V;
      an[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < r1) an[i] = *reinterpret_cast<const uint4*>(A + size_t(k0 + r) * W + c);
    }
#pragma unroll
    for (int i = 0; i < GU; ++i) {
      // lanes: (row pair, two neighbouring column units): full 32-byte sectors
      const int u = threadIdx.x + i * CONSUMERS;
      const int cl = u & 1, rp = (u >> 1) & 15, rest = u >> 5;
      const int cu = 2 * (rest % (WG_CB / V / 2)) + cl, rph = rest / (WG_CB / V / 2);
      const int r = 2 * (16 * rph + rp);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        gn[i][e] = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r + e < r1)
          gn[i][e] = *reinterpret_cast<const uint4*>(Gm + size_t(k0 + r + e) * W + cu * V);
      }
    }
  };
  auto store = [&](int buf) {
    unsigned char* st = smem + buf * Q::STAGE;
    T* As = reinterpret_cast<T*>(st);
#pragma unroll
    for (int i = 0; i < AU; ++i) {
      const int u = threadIdx.x + i * CONSUMERS, r = u / (WG_IB / V), c = (u % (WG_IB / V)) * V;
      *reinterpret_cast<uint4*>(As + r * Q::LDA + c) = an[i];
    }
    unsigned char* Bs = st + Q::A_BYTES;
#pragma unroll
    for (int i = 0; i < GU; ++i) {
      const int u = threadIdx.x + i * CONSUMERS;
      const int cl = u & 1, rp = (u >> 1) & 15, rest = u >> 5;
      const int cu = 2 * (rest % (WG_CB / V / 2)) + cl, rph = rest / (WG_CB / V / 2);
      const int k = 2 * (16 * rph + rp);
      const T* v0 = reinterpret_cast<const T*>(&gn[i][0]);
      const T* v1 = reinterpret_cast<const T*>(&gn[i][1]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int n = cu * V + e;
        const uint32_t o = (n >> 3) * Q::SBO + (k / Q::TE) * Q::LBO + (n & 7) * 16 +
                           (k % Q::TE) * sizeof(T);
        if constexpr (F32) {
          uint32_t h0, l0, h1, l1;
          tf32::split(v0[e], h0, l0);
          tf32::split(v1[e], h1, l1);
          *reinterpret_cast<uint2*>(Bs + o) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(Bs + Q::B_HALF + o) = make_uint2(l0, l1);
        } else {
          __nv_bfloat162 pr;
          pr.x = v0[e];
          pr.y = v1[e];
          *reinterpret_cast<__nv_bfloat162*>(Bs + o) = pr;
        }
      }
    }
  };
  float acc[NJ][32];
  zero(acc);
  const int steps = (r1 - r0 + KR - 1) / KR;
  if (steps > 0) {
    load(r0);
    store(0);
  }
  fence_async();
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load(r0 + (s + 1) * KR);
    const unsigned char* st = smem + buf * Q::STAGE;
    const T* As = reinterpret_cast<const T*>(st);
    const uint32_t bs = saddr(st + Q::A_BYTES);
    const int i0 = 64 * wg + 16 * wr;   // this warp's 16 output rows
    if constexpr (F32) {
#pragma unroll
      for (int k16 = 0; k16 < KR; k16 += 16) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // A^T element (i, k) is staged row k, column i
          const float* a = As + (k16 + 8 * kk + t) * Q::LDA + i0 + g;
          tf32::split(a[0], ah[kk][0], al[kk][0]);
          tf32::split(a[8], ah[kk][1], al[kk][1]);
          tf32::split(a[4 * Q::LDA], ah[kk][2], al[kk][2]);
          tf32::split(a[4 * Q::LDA + 8], ah[kk][3], al[kk][3]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float c[32];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint32_t o = (64 * j / 8) * Q::SBO + ((k16 + 8 * kk) / 4) * Q::LBO;
            const uint64_t bh = mdesc(bs + o, Q::LBO, Q::SBO);
            const uint64_t bl = mdesc(bs + Q::B_HALF + o, Q::LBO, Q::SBO);
            if (kk == 0) wgmma_tf32<0>(c, al[kk], bh);
            else wgmma_tf32<1>(c, al[kk], bh);
            wgmma_tf32<1>(c, ah[kk], bl);
            wgmma_tf32<1>(c, ah[kk], bh);
          }
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[j][e] += c[e];
        }
      }
      if (s + 1 < steps) store(buf ^ 1);
    } else {
      uint32_t a[KR / 16][4];
#pragma unroll
      for (int k16 = 0; k16 < KR / 16; ++k16)
        // matrices: (i 0-7, k 0-7), (i 8-15, k 0-7), (i 0-7, k 8-15), (i 8-15, k 8-15)
        tc::ldsm_x4_t(a[k16], As + (16 * k16 + (lane & 7) + ((lane >> 4) << 3)) * Q::LDA + i0 +
                                  ((lane >> 3) & 1) * 8);
      wg_fence();
#pragma unroll
      for (int k16 = 0; k16 < KR / 16; ++k16)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          wgmma_bf16_rs(acc[j], a[k16],
                        mdesc(bs + (64 * j / 8) * Q::SBO + (16 * k16 / 8) * Q::LBO, Q::LBO, Q::SBO));
      wg_commit();
      if (s + 1 < steps) store(buf ^ 1);   // under the products
      wg_wait<0>();
    }
    fence_async();
    __syncthreads();
  }
  float* out = part + (size_t(ch) * 10 + mat) * W * W;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = WG_IB * ib + 64 * wg + 16 * wr + g + 8 * ((e >> 1) & 1);
      const int c = WG_CB * cb + 64 * j + 8 * (e >> 2) + 2 * t;
      float2* q = reinterpret_cast<float2*>(out + size_t(i) * W + c);
      const float2 o = *q;
      *q = make_float2(o.x + acc[j][e], o.y + acc[j][e + 1]);
    }
}

// out[l] = sum over i < n of in[i len + l], i ascending
__global__ void sum_parts_kernel(const float* in, int n, size_t len, float* out) {
  for (size_t l = size_t(blockIdx.x) * blockDim.x + threadIdx.x; l < len;
       l += size_t(gridDim.x) * blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n; ++i) a += in[size_t(i) * len + l];
    out[l] = a;
  }
}

// ---------------------------------------------------------------------------
// Launches

template <typename K>
int prepare(K kernel, int smem) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// W = 128 only in a build with WIDE_W128 defined (scripts/a10_probe.py's
// copies): nothing routes 128 columns here, and each width is a set of
// instantiations the build compiles
bool bad_width(int W, int width) {
#ifdef WIDE_W128
  if (W == 128) return width <= 0 || width > W;
#endif
  return (W != 256 && W != 384 && W != 512) || width <= 0 || width > W;
}

template <typename G>
int tiles_of(int total) {
  return (total + G::RT - 1) / G::RT;
}

struct Fwd {
  const void *xc_in, *xq_in;
  const float* syn;
  const int *idx_c, *idx_q;    // table mode: slot tables; roll mode: mask bits [2][L]
  const float* degbo;          // roll mode: [2][L][W]
  const void* mats;            // [10] packs
  const float* vecs;           // [14][W]
  void *xc_out, *xq_out, *stash_c, *stash_q, *ys_c, *ys_q;
  Offsets offs_c, offs_q;
  int B, M, N, Dc, Dq, R, W, width;
  cudaStream_t stream;
};

template <typename T, int W, bool ROLL, bool SLOT16>
int run_forward_w(const Fwd& a) {
  using G = Geo<T, W>;
  const size_t mb = mat_bytes<T>(W);
  const unsigned char* mats = static_cast<const unsigned char*>(a.mats);
  auto kern = wide_fwd_kernel<T, W, ROLL, SLOT16>;
  if (int e = prepare(kern, G::SMEM)) return e;
  const size_t sc = size_t(a.B) * a.M * W, sq = size_t(a.B) * a.N * W;
  T* xc_out = static_cast<T*>(a.xc_out);
  T* xq_out = static_cast<T*>(a.xq_out);
  T* stc = static_cast<T*>(a.stash_c);
  T* stq = static_cast<T*>(a.stash_q);
  T* ysc = static_cast<T*>(a.ys_c);
  T* ysq = static_cast<T*>(a.ys_q);
  const bool stash = stc != nullptr;
  if (stash) {   // the stash's entry 0: the rounds' inputs
    cudaMemcpyAsync(stc, a.xc_in, sc * sizeof(T), cudaMemcpyDeviceToDevice, a.stream);
    cudaMemcpyAsync(stq, a.xq_in, sq * sizeof(T), cudaMemcpyDeviceToDevice, a.stream);
  }
  const int tc = tiles_of<G>(a.B * a.M), tq = tiles_of<G>(a.B * a.N);
  const int grid = min(sm_count(), tc + tq);
  for (int r = 0; r < a.R; ++r) {
    const T* xc = r == 0 ? static_cast<const T*>(a.xc_in) : (stash ? stc + r * sc : xc_out);
    const T* xq = r == 0 ? static_cast<const T*>(a.xq_in) : (stash ? stq + r * sq : xq_out);
    T* nc = stash && r + 1 < a.R ? stc + (r + 1) * sc : xc_out;
    T* nq = stash && r + 1 < a.R ? stq + (r + 1) * sq : xq_out;
    // the gathers' sources from the round's inputs: ys_c = rnd(x_q @ ws_c),
    // ys_q = rnd(x_c @ ws_q)
    FJob<T> p{};
    p.s[0] = FSide<T>{xq, ysc, nullptr, nullptr, nullptr, nullptr,
                      {mats + (NMAT + M_WS) * mb}, nullptr, {}, a.N, a.M, 1, a.B * a.N};
    p.s[1] = FSide<T>{xc, ysq, nullptr, nullptr, nullptr, nullptr, {mats + M_WS * mb},
                      nullptr, {}, a.M, a.N, 1, a.B * a.M};
    p.tiles0 = tq;
    p.tiles = tq + tc;
    p.project = 1;
    p.width = a.width;
    kern<<<grid, BLOCK, G::SMEM, a.stream>>>(p);
    FJob<T> u{};
    u.s[0] = FSide<T>{xc, nc, ysc, a.syn, a.idx_c, a.degbo,
                      {mats + M_WD * mb, mats + M_WF * mb, mats + M_UX * mb, mats + M_W1 * mb},
                      a.vecs, a.offs_c, a.M, a.N, a.Dc, a.B * a.M};
    const unsigned char* mq = mats + NMAT * mb;
    u.s[1] = FSide<T>{xq, nq, ysq, nullptr, a.idx_q,
                      a.degbo == nullptr ? nullptr : a.degbo + size_t(a.N) * W,
                      {mq + M_WD * mb, mq + M_WF * mb, mq + M_UX * mb, mq + M_W1 * mb},
                      a.vecs + NVEC * W, a.offs_q, a.N, a.M, a.Dq, a.B * a.N};
    u.tiles0 = tc;
    u.tiles = tc + tq;
    u.project = 0;
    u.width = a.width;
    kern<<<grid, BLOCK, G::SMEM, a.stream>>>(u);
    if (int e = int(cudaGetLastError())) return e;
  }
  return 0;
}

template <typename T, bool ROLL, bool SLOT16>
int run_forward(const Fwd& a) {
  switch (a.W) {
#ifdef WIDE_W128
    case 128: return run_forward_w<T, 128, ROLL, SLOT16>(a);
#endif
    case 256: return run_forward_w<T, 256, ROLL, SLOT16>(a);
    case 384: return run_forward_w<T, 384, ROLL, SLOT16>(a);
    case 512: return run_forward_w<T, 512, ROLL, SLOT16>(a);
  }
  return int(cudaErrorInvalidValue);
}

// The scratch of K2b, carved per direction.
template <typename T>
struct BScratch {
  T *ys, *hs, *hc, *dpre_r, *dtr, *dydb_r, *dys, *dhs;
  float* dpre;
  uint32_t* live;
};

// One direction's share: its residuals over its B rows rows, and ys, the
// gather source it reads, over the other direction's B src_rows rows.
template <typename T>
size_t bside_bytes(size_t rows, size_t src_rows, int D, int W) {
  constexpr bool F32 = sizeof(T) == 4;
  const size_t t = align16(rows * W * sizeof(T) + 255), f = align16(rows * W * 4 + 255);
  const size_t bits = align16(rows * D * (W / 32) * 4 + 255);
  return align16(src_rows * W * sizeof(T) + 255) + (F32 ? 6 : 7) * t + f + bits;
}

template <typename T>
BScratch<T> bside_carve(unsigned char*& p, size_t rows, size_t src_rows, int D, int W) {
  constexpr bool F32 = sizeof(T) == 4;
  auto take = [&](size_t bytes) {
    unsigned char* q = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 255) &
                                                        ~uintptr_t(255));
    p = q + bytes;
    return q;
  };
  BScratch<T> s;
  s.ys = reinterpret_cast<T*>(take(src_rows * W * sizeof(T)));
  s.hs = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
  s.hc = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
  s.dys = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
  s.dtr = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
  s.dydb_r = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
  s.dpre = reinterpret_cast<float*>(take(rows * W * 4));
  s.dhs = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
  // the rounded dpre is dpre itself in f32
  s.dpre_r = F32 ? reinterpret_cast<T*>(s.dpre) : reinterpret_cast<T*>(take(rows * W * sizeof(T)));
  s.live = reinterpret_cast<uint32_t*>(take(rows * D * (W / 32) * 4));
  return s;
}

template <typename T>
size_t bwd_scratch_bytes(int B, int M, int N, int Dc, int Dq, int W) {
  const size_t rc = size_t(B) * M, rq = size_t(B) * N;
  return bside_bytes<T>(rc, rq, Dc, W) + bside_bytes<T>(rq, rc, Dq, W) + 256;
}

struct Bwd {
  const void *stash_c, *stash_q;
  const float* syn;
  const int *idx_c, *idx_q, *off_c, *lst_c, *off_q, *lst_q;
  const float *deg_c, *deg_q;
  const void *mats, *mats_t;
  const float *mats32, *mats32_t, *xn_c, *xn_q;
  const float* wn;              // host array [10]
  const float *vecs, *ucs32;
  float *g_c, *g_q, *dsyn;
  void* scratch;
  float *part_mats, *part_vecs, *dmats, *dvecs;
  int B, M, N, Dc, Dq, R, W, width, msg_width, nch, segs;
  cudaStream_t stream;
};

template <typename T, int W>
int run_backward_w(const Bwd& a) {
  using G = Geo<T, W>;
  constexpr bool TIES = sizeof(T) == 4;
  const size_t mb = mat_bytes<T>(W), W2 = size_t(W) * W;
  const unsigned char* mats = static_cast<const unsigned char*>(a.mats);
  const unsigned char* mats_t = static_cast<const unsigned char*>(a.mats_t);
  auto fwd = wide_fwd_kernel<T, W, false, false, true>;
  auto rep = wide_replay_kernel<T, W>;
  auto cot = wide_cotangent_kernel<T, W>;
  auto wgr = wide_wgrad_kernel<T>;
  if (int e = prepare(fwd, G::SMEM)) return e;
  using GR = Geo<T, W, true>;   // the replay's tiles: 64 rows, the columns split
  if (int e = prepare(rep, GR::SMEM)) return e;
  if (int e = prepare(cot, G::SMEM)) return e;
  if (int e = prepare(wgr, WgGeo<T>::SMEM)) return e;
  unsigned char* p = static_cast<unsigned char*>(a.scratch);
  const size_t rc = size_t(a.B) * a.M, rq = size_t(a.B) * a.N;
  const BScratch<T> sc = bside_carve<T>(p, rc, rq, a.Dc, W);
  const BScratch<T> sq = bside_carve<T>(p, rq, rc, a.Dq, W);
  const int tc = tiles_of<G>(int(rc)), tq = tiles_of<G>(int(rq));
  const int grid = min(sm_count(), tc + tq);
  const int rtc = tiles_of<GR>(int(rc)), rtq = tiles_of<GR>(int(rq));
  const int rgrid = min(sm_count(), rtc + rtq);
  if (rgrid * 8 > a.segs) return int(cudaErrorInvalidValue);
  float* vpart_c = a.part_vecs;
  float* vpart_q = a.part_vecs + size_t(a.segs) * 7 * W;
  const unsigned char* mq = mats + NMAT * mb;
  const unsigned char* mqt = mats_t + NMAT * mb;
  for (int r = a.R - 1; r >= 0; --r) {
    const T* xc = static_cast<const T*>(a.stash_c) + r * rc * W;
    const T* xq = static_cast<const T*>(a.stash_q) + r * rq * W;
    FJob<T> pj{};
    pj.s[0] = FSide<T>{xq, sc.ys, nullptr, nullptr, nullptr, nullptr, {mq + M_WS * mb}, nullptr,
                       {}, a.N, a.M, 1, int(rq)};
    pj.s[1] = FSide<T>{xc, sq.ys, nullptr, nullptr, nullptr, nullptr, {mats + M_WS * mb},
                       nullptr, {}, a.M, a.N, 1, int(rc)};
    pj.tiles0 = tq;
    pj.tiles = tq + tc;
    pj.project = 1;
    pj.width = a.width;
    fwd<<<grid, BLOCK, G::SMEM, a.stream>>>(pj);
    BJob<T> bj{};
    bj.s[0] = BSide<T>{xc, xq, sc.ys, a.g_c, a.syn, a.dsyn, a.ucs32, a.idx_c, a.deg_c,
                       {mats + M_WD * mb, mats + M_WF * mb, mats + M_UX * mb, mats + M_W1 * mb,
                        mats_t + M_W1 * mb, mats_t + M_WF * mb},
                       a.vecs, sc.hs, sc.hc, sc.dpre_r, sc.dtr, sc.dydb_r, sc.dhs, sc.dpre,
                       sc.live, vpart_c,
                       TIES ? a.mats32 : nullptr, TIES ? a.mats32_t : nullptr,
                       TIES ? a.mats32 + (NMAT + M_WS) * W2 : nullptr,
                       TIES ? a.mats32_t + (NMAT + M_WS) * W2 : nullptr,
                       TIES ? a.xn_c + r * rc : nullptr, TIES ? a.xn_q + r * rq : nullptr,
                       TIES ? a.wn[M_WD] : 0.f, TIES ? a.wn[M_UX] : 0.f, TIES ? a.wn[M_WF] : 0.f,
                       TIES ? a.wn[NMAT + M_WS] : 0.f, a.M, a.N, a.Dc, int(rc)};
    bj.s[1] = BSide<T>{xq, xc, sq.ys, a.g_q, nullptr, nullptr, nullptr, a.idx_q, a.deg_q,
                       {mq + M_WD * mb, mq + M_WF * mb, mq + M_UX * mb, mq + M_W1 * mb,
                        mqt + M_W1 * mb, mqt + M_WF * mb},
                       a.vecs + NVEC * W, sq.hs, sq.hc, sq.dpre_r, sq.dtr, sq.dydb_r, sq.dhs,
                       sq.dpre, sq.live, vpart_q,
                       TIES ? a.mats32 + NMAT * W2 : nullptr,
                       TIES ? a.mats32_t + NMAT * W2 : nullptr,
                       TIES ? a.mats32 + M_WS * W2 : nullptr,
                       TIES ? a.mats32_t + M_WS * W2 : nullptr,
                       TIES ? a.xn_q + r * rq : nullptr, TIES ? a.xn_c + r * rc : nullptr,
                       TIES ? a.wn[NMAT + M_WD] : 0.f, TIES ? a.wn[NMAT + M_UX] : 0.f,
                       TIES ? a.wn[NMAT + M_WF] : 0.f, TIES ? a.wn[M_WS] : 0.f,
                       a.N, a.M, a.Dq, int(rq)};
    bj.tiles0 = rtc;
    bj.tiles = rtc + rtq;
    bj.width = a.width;
    bj.msg_width = a.msg_width;
    rep<<<rgrid, BLOCK, GR::SMEM, a.stream>>>(bj);
    // the gathers' adjoints: the qubit direction's onto the check rows, the
    // check direction's onto the qubit rows
    wide_dys_kernel<T><<<int((rc + 7) / 8), 256, 0, a.stream>>>(
        sc.dys, int(rc), a.M, a.off_q, a.lst_q, sq.dhs, sq.live, a.N, a.Dq, W);
    wide_dys_kernel<T><<<int((rq + 7) / 8), 256, 0, a.stream>>>(
        sq.dys, int(rq), a.N, a.off_c, a.lst_c, sc.dhs, sc.live, a.M, a.Dc, W);
    CJob<T> cj{};
    cj.s[0] = CSide<T>{a.g_c, sc.dpre, sc.dydb_r, sc.dys, sc.dtr,
                       {mats_t + M_WD * mb, mats_t + M_WS * mb, mats_t + M_UX * mb}, int(rc)};
    cj.s[1] = CSide<T>{a.g_q, sq.dpre, sq.dydb_r, sq.dys, sq.dtr,
                       {mqt + M_WD * mb, mqt + M_WS * mb, mqt + M_UX * mb}, int(rq)};
    cj.tiles0 = tc;
    cj.tiles = tc + tq;
    cot<<<grid, BLOCK, G::SMEM, a.stream>>>(cj);
    WGrad<T> wg{{xc, xc, xc, sc.hs, sc.hc, xq, xq, xq, sq.hs, sq.hc},
                {sc.dydb_r, sc.dtr, sc.dys, sc.dtr, sc.dpre_r, sq.dydb_r, sq.dtr, sq.dys, sq.dtr,
                 sq.dpre_r},
                {int(rc), int(rc), int(rc), int(rc), int(rc), int(rq), int(rq), int(rq), int(rq),
                 int(rq)}};
    const int nb = W / WG_IB;
    wgr<<<dim3(10 * nb * nb, a.nch), CONSUMERS, WgGeo<T>::SMEM, a.stream>>>(wg, a.part_mats,
                                                                          a.nch, W);
    if (int e = int(cudaGetLastError())) return e;
  }
  sum_parts_kernel<<<264, 256, 0, a.stream>>>(a.part_mats, a.nch, 10 * W2, a.dmats);
  sum_parts_kernel<<<8, 256, 0, a.stream>>>(vpart_c, a.segs, size_t(7) * W, a.dvecs);
  sum_parts_kernel<<<8, 256, 0, a.stream>>>(vpart_q, a.segs, size_t(7) * W,
                                            a.dvecs + size_t(NVEC) * W);
  return int(cudaGetLastError());
}

template <typename T>
int run_backward(const Bwd& a) {
  switch (a.W) {
#ifdef WIDE_W128
    case 128: return run_backward_w<T, 128>(a);
#endif
    case 256: return run_backward_w<T, 256>(a);
    case 384: return run_backward_w<T, 384>(a);
    case 512: return run_backward_w<T, 512>(a);
  }
  return int(cudaErrorInvalidValue);
}

// K5: bf16 slots only with bf16 states
template <typename T>
int run_roll(const Fwd& a, int slot16) {
  if constexpr (sizeof(T) == 2)
    if (slot16) return run_forward<T, true, true>(a);
  return run_forward<T, true, false>(a);
}

}  // namespace

extern "C" {

#ifdef WIDE_FORWARD
// K1 (stash null) and K2a: R rounds on states [B, M|N, W] in the state type
// (dtype 0 = float32, 1 = bfloat16: the library's own, else an error); syn
// [B, M] f32; idx_c [M, Dc], idx_q [N, Dq] int32 (-1 = masked); mats the
// [10] packs (fused_decoder.py::wgmma_pack) at width W; vecs [14, W] f32;
// ys_c [B, N, W], ys_q [B, M, W] scratch in the state type; stash_c [R, B,
// M, W] and stash_q [R, B, N, W] (K2a).  width: the LayerNorm's columns.
// Returns the first CUDA error (0 on success).
int wide_rounds_launch(int dtype, const void* xc_in, const void* xq_in, const void* syn,
                       const void* idx_c, const void* idx_q, const void* mats, const void* vecs,
                       void* xc_out, void* xq_out, void* stash_c, void* stash_q, void* ys_c,
                       void* ys_q, int B, int M, int N, int Dc, int Dq, int R, int W, int width,
                       void* stream) {
  if (dtype != WIDE_CODE || bad_width(W, width) || B <= 0 || M <= 0 || N <= 0 || Dc <= 0 ||
      Dq <= 0 || R <= 0 || (stash_c == nullptr) != (stash_q == nullptr))
    return int(cudaErrorInvalidValue);
  Fwd a{xc_in, xq_in, static_cast<const float*>(syn), static_cast<const int*>(idx_c),
        static_cast<const int*>(idx_q), nullptr, mats, static_cast<const float*>(vecs), xc_out,
        xq_out, stash_c, stash_q, ys_c, ys_q, {}, {}, B, M, N, Dc, Dq, R, W, width,
        static_cast<cudaStream_t>(stream)};
  return run_forward<WIDE_STATE, false, false>(a);
}

// K5: R rounds on raster states [B, L, W]; maskbits [2, L] int32 (bit k:
// slot k of the cell is real; checks, then qubits); degbo [2, L, W] f32;
// vecs row 2 the unrounded uc_s; offs a host array of 8 ints (the check
// side's four offsets, then the qubit side's); slot16 (bf16 only) rounds
// the slot stage to bf16; ys_c, ys_q [B, L, W] scratch.
int wide_roll_launch(int dtype, int slot16, const void* xc_in, const void* xq_in,
                     const void* syn, const void* maskbits, const void* degbo, const void* mats,
                     const void* vecs, void* xc_out, void* xq_out, void* ys_c, void* ys_q,
                     const void* offs, int B, int L, int R, int W, int width, void* stream) {
  if (dtype != WIDE_CODE || bad_width(W, width) || B <= 0 || L <= 0 || R <= 0 ||
      offs == nullptr)
    return int(cudaErrorInvalidValue);
  const int* bits = static_cast<const int*>(maskbits);
  Fwd a{xc_in, xq_in, static_cast<const float*>(syn), bits, bits + L,
        static_cast<const float*>(degbo), mats, static_cast<const float*>(vecs), xc_out,
        xq_out, nullptr, nullptr, ys_c, ys_q, {}, {}, B, L, L, ROLL_SLOTS, ROLL_SLOTS, R, W,
        width, static_cast<cudaStream_t>(stream)};
  const int* o = static_cast<const int*>(offs);
  for (int k = 0; k < ROLL_SLOTS; ++k) {
    a.offs_c.o[k] = o[k];
    a.offs_q.o[k] = o[ROLL_SLOTS + k];
    if (o[k] <= -L || o[k] >= L || o[ROLL_SLOTS + k] <= -L || o[ROLL_SLOTS + k] >= L)
      return int(cudaErrorInvalidValue);
  }
  return run_roll<WIDE_STATE>(a, slot16);
}
#endif  // WIDE_FORWARD

#ifdef WIDE_BACKWARD
// Bytes of K2b's scratch (the residuals of one round, both directions).
long long wide_rounds_bwd_scratch_bytes(int dtype, int B, int M, int N, int Dc, int Dq,
                                        int W) {
  if (dtype != WIDE_CODE) return -1;
  return (long long)bwd_scratch_bytes<WIDE_STATE>(B, M, N, Dc, Dq, W);
}

// Segments of K2b's bias-gradient partials (a warp of a persistent block
// each): part_vecs is [2][segments][7][W].
int wide_rounds_bwd_segments() { return 8 * sm_count(); }

// K2b: the adjoint of the R rounds from K2a's stash [R, B, M|N, W] in the
// state type.  g_c [B, M, W], g_q [B, N, W] f32: the cotangents of the
// outputs, rewritten in place into those of the inputs; dsyn [B, M] f32,
// zeroed by the caller.  off_c/lst_c: the readers of the qubit rows in the
// check direction's gather (lst entries r Dc + k of the check rows r),
// off_q/lst_q the same for the check rows; deg_c [M], deg_q [N] f32.  mats,
// mats_t: the packs (wgmma_pack) of the matrices and of their transposes;
// with f32 states also mats32, mats32_t [10, W, W] f32 unpacked, xn_c [R,
// B, M], xn_q [R, B, N] the stash rows' norms and wn a host array of the 10
// matrices' largest column norms (the ties; null in bf16).  ucs32 [W] uc_s
// unrounded.  part_mats [nch][10][W][W] and part_vecs [2][segments][7][W]
// f32, zeroed by the caller; dmats [10, W, W], dvecs [14, W] f32 the
// results.
int wide_rounds_bwd_launch(int dtype, const void* stash_c, const void* stash_q,
                           const void* syn, const void* idx_c, const void* idx_q,
                           const void* off_c, const void* lst_c, const void* off_q,
                           const void* lst_q, const void* deg_c, const void* deg_q,
                           const void* mats, const void* mats_t, const void* mats32,
                           const void* mats32_t, const void* xn_c, const void* xn_q,
                           const void* wn, const void* vecs, const void* ucs32, void* g_c,
                           void* g_q, void* dsyn, void* scratch, void* part_mats,
                           void* part_vecs, void* dmats, void* dvecs, int B, int M, int N,
                           int Dc, int Dq, int R, int W, int width, int msg_width, int nch,
                           void* stream) {
  if (dtype != WIDE_CODE || bad_width(W, width) || msg_width <= 0 || msg_width > W || B <= 0 ||
      M <= 0 || N <= 0 || Dc <= 0 || Dq <= 0 || R <= 0 || nch <= 0)
    return int(cudaErrorInvalidValue);
  if (sizeof(WIDE_STATE) == 4 && (mats32 == nullptr || mats32_t == nullptr ||
                                  xn_c == nullptr || xn_q == nullptr || wn == nullptr))
    return int(cudaErrorInvalidValue);
  Bwd a{stash_c, stash_q, static_cast<const float*>(syn), static_cast<const int*>(idx_c),
        static_cast<const int*>(idx_q), static_cast<const int*>(off_c),
        static_cast<const int*>(lst_c), static_cast<const int*>(off_q),
        static_cast<const int*>(lst_q), static_cast<const float*>(deg_c),
        static_cast<const float*>(deg_q), mats, mats_t, static_cast<const float*>(mats32),
        static_cast<const float*>(mats32_t), static_cast<const float*>(xn_c),
        static_cast<const float*>(xn_q), static_cast<const float*>(wn),
        static_cast<const float*>(vecs), static_cast<const float*>(ucs32),
        static_cast<float*>(g_c), static_cast<float*>(g_q), static_cast<float*>(dsyn), scratch,
        static_cast<float*>(part_mats), static_cast<float*>(part_vecs),
        static_cast<float*>(dmats), static_cast<float*>(dvecs), B, M, N, Dc, Dq, R, W, width,
        msg_width, nch, wide_rounds_bwd_segments(), static_cast<cudaStream_t>(stream)};
  return run_backward<WIDE_STATE>(a);
}
#endif  // WIDE_BACKWARD

}  // extern "C"
