// The rounds kernels at widths above 128 (Hopper): K1, K2a, K2b and K5 on
// packs of W = 256, 384 or 512 columns, in both state types.
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
// Design: one round and direction at a time, in launches over tiles of TR =
// 32 rows of the batch layout [B * rows, W], the states in global memory in
// the state type (wide_mma.cuh gives the products).  A block is W threads,
// warp w owning 32 columns of every product; each product reads its weight
// pack from L2 (the packs are 10 W^2 bf16, or 20 W^2 f32 split into TF32
// halves, at most 20 MB) and its A operand from shared memory.  Per round:
//   project  ys = rnd(x_src @ ws) for the rows each direction gathers from
//            (two launches, one a direction; K2b replays it the same way);
//   update   per tile of a direction's rows: ydb = x @ wd + b0; the slot
//            gather-sum hs from ys by slot table (K1, K2a) or by raster
//            offset and mask bits (K5, in its slot type); t = hs @ wf + x @
//            ux + the degree, syndrome and bias terms; hc = rnd(relu(t)); v =
//            x + hc @ w1 + ub1; the LayerNorm over the tile's whole rows (a
//            warp a row), rounded into the new states.
// K1 updates its states in place after round 0 (a tile reads only its own
// rows of x; the gathers read ys); K2a reads round r's states from the stash
// entry r and writes round r + 1's into entry r + 1, so its outputs are K1's
// bit for bit.  Shared memory a block: the tile x, the hs/hc buffer (A
// operands, in the state type), an f32 tile (ydb, then v) and a few per-row
// words: at W = 512 203,264 B in f32, 137,728 B in bf16.
//
// K2b walks the rounds in reverse from K2a's stash.  Per round, launches
// over tiles of each direction:
//   project  ys as above;
//   replay   the forward of the tile (as `update`) and the adjoint down to
//            the gather: the LayerNorm backward (dpre), dt = (rnd(dpre) @
//            w1^T) * (t > 0), dhs = rnd(dt) @ wf^T, dydb from dhs under the
//            slot masks, dsyn; it writes the residuals the later launches
//            read (hs, hc, dpre, dt, dhs, dydb, the LayerNorm's nh, the slot
//            masks as bits) to a scratch;
//   colsum   the bias gradients' column sums over row segments, added to
//            per-segment partials;
//   dys      the gather's adjoint onto its source rows, over the transposed
//            slot lists (the readers of each source row, in (row, slot)
//            order): a fixed order, no atomics;
//   cotan    g = dpre + dydb @ wd^T + dys @ ws^T + dt @ ux^T;
//   wgrad    the ten weight gradients x^T dy over row chunks, each block's
//            [64, W] tile added to its chunk's partial;
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
// plain version sums it (the block computes that row together, a thread a
// column) and two more.  The bands are wider than the 128-column kernel's
// (2^-18 against 2^-20): the rounding of a sum grows with its length.  Only
// the masks change; the values stay the tensor cores'.
//
// Bounds on an H100 (d=11, W=256, per sample and round): the forward's five
// [241, 256] x [256, 256] products per direction, 158 MFLOP; the backward
// three times that.  The design reads every weight from L2 once per tile of
// 32 rows (L2 traffic about 20 KB a row at W=256 in bf16, 80 KB in f32),
// and the states and residuals from HBM once per launch.

#include "wide_mma.cuh"

namespace {

using namespace rounds;
using namespace rounds::wide;

constexpr int ROLL_SLOTS = 4;
constexpr int NSEG = 256;          // row segments of the bias-gradient partials
constexpr int WG_ROWS = 64;        // output rows of a weight-gradient block
constexpr int WG_KR = 32;          // staged rows of a weight-gradient step
constexpr int WG_LDA = WG_ROWS + 8;
constexpr float TAU_Z = 1.f / 262144;   // 2^-18, the tie bands
constexpr float TAU_T = 1.f / 262144;

struct Offsets {
  int o[ROLL_SLOTS];
};

// source cell of slot offset o from cell r, on a raster of L cells
__device__ __forceinline__ int wrap(int r, int o, int L) {
  const int src = r + o;
  return src < 0 ? src + L : (src >= L ? src - L : src);
}

// elements of one matrix's pack: f32 split (hi, lo), bf16 plain
template <typename T>
__host__ __device__ inline size_t mat_elems(int W);
template <>
__host__ __device__ inline size_t mat_elems<float>(int W) { return size_t(2) * W * W; }
template <>
__host__ __device__ inline size_t mat_elems<bf16>(int W) { return size_t(W) * W; }

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// the same down column c of a row-major [K][W] matrix (the block together:
// neighbouring threads read neighbouring columns)
__device__ __forceinline__ float seq_dot_col(const float* a, const float* __restrict__ w,
                                             int c, int K, int W) {
  float s = 0.f;
  for (int k = 0; k < K; ++k) s = fmaf(a[k], __ldg(w + size_t(k) * W + c), s);
  return s;
}

// ---------------------------------------------------------------------------
// project: out = rnd(x @ w) for rows [0, n_rows) of x, a tile a block

template <typename T>
__global__ void __launch_bounds__(WMAX) wide_project_kernel(const T* x, T* out,
                                                            const T* __restrict__ w, int n_rows,
                                                            int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int ld = ld_of<T>(W);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * TR, n = min(TR, n_rows - row0);
  load_tile(xs, ld, x + size_t(row0) * W, n, W);
  __syncthreads();
  float acc[MT][NJ][4];
  zero_acc(acc);
  mma_rows(acc, xs, ld, w, W, W);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        st2(out + size_t(row0 + r) * W + 32 * warp + 8 * j + 2 * t, acc[m][j][2 * h],
            acc[m][j][2 * h + 1]);
    }
}

template <typename T>
size_t project_smem(int W) {
  return tile_bytes(ld_of<T>(W), sizeof(T));
}

// ---------------------------------------------------------------------------
// update: one direction's rounds update on a tile of its rows

template <typename T>
struct Side {
  const T* x;             // [B rows][W] round-input states
  T* out;                 // [B rows][W] new states (may be x)
  const T* ys;            // [B src_rows][W] the gather's source projection
  const float* syn;       // [B rows] the syndrome feature (checks), or null
  const int* idx;         // [rows][D] slot table, -1 masked (table mode)
  const int* bits;        // [rows] slot-mask bits (roll mode)
  const float* degbo;     // [rows][W] (deg bo) @ ua (roll mode)
  const T* w;             // the direction's 5 matrices, packed
  const float* vec;       // the direction's 7 vectors [7][W]
  Offsets offs;           // slot offsets (roll mode)
  int rows, src_rows, D, total;   // total = B rows
};

// Shared memory of update and replay: x tile, hs/hc tile, f32 tile, and a
// few per-row words.
template <typename T>
__host__ __device__ inline size_t update_smem(int W) {
  return 2 * tile_bytes(ld_of<T>(W), sizeof(T)) + tile_bytes(W + 4, sizeof(float)) +
         align16(size_t(8) * TR * sizeof(float)) + align16(size_t(W) * sizeof(float)) +
         align16(size_t(WMAX / 32) * TR * sizeof(float));
}

template <typename T>
struct Tiles {
  T* X;        // [TR][ld] the tile's states (A operand)
  T* H;        // [TR][ld] hs, then hc (A operands)
  float* V;    // [TR][W + 4] ydb, then v
  float* deg;  // [TR] real slots a row
  float* hsn;  // [TR] |hs| of a row (tie bands)
  int* flag;   // [TR] a row with a tie of t
  float* hsx;  // [W] a row's hs as the plain version sums it
  float* red;  // [W / 32][TR] per-warp row partials
};

template <typename T>
__device__ Tiles<T> carve(unsigned char* base, int W) {
  Tiles<T> s;
  const int ld = ld_of<T>(W);
  size_t o = 0;
  s.X = reinterpret_cast<T*>(base + o);       o += tile_bytes(ld, sizeof(T));
  s.H = reinterpret_cast<T*>(base + o);       o += tile_bytes(ld, sizeof(T));
  s.V = reinterpret_cast<float*>(base + o);   o += tile_bytes(W + 4, sizeof(float));
  s.deg = reinterpret_cast<float*>(base + o);
  s.hsn = s.deg + TR;
  s.flag = reinterpret_cast<int*>(s.hsn + TR);
  o += align16(size_t(8) * TR * sizeof(float));
  s.hsx = reinterpret_cast<float*>(base + o); o += align16(size_t(W) * sizeof(float));
  s.red = reinterpret_cast<float*>(base + o);
  return s;
}

// ydb = x @ wd + b0 into V (K5 with SLOT16: rounded to the slot type)
template <typename T, bool SLOT16>
__device__ __forceinline__ void stage_ydb(const Tiles<T>& s, const T* wd, const float* vec,
                                          int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NJ][4];
  zero_acc(acc);
  mma_rows(acc, s.X, ld_of<T>(W), wd, W, W);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 32 * warp + 8 * j + 2 * t;
      const float b0 = vec[V_B0 * W + c], b1 = vec[V_B0 * W + c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * m + g + 8 * h;
        s.V[r * (W + 4) + c] = srnd<SLOT16>(acc[m][j][2 * h] + b0);
        s.V[r * (W + 4) + c + 1] = srnd<SLOT16>(acc[m][j][2 * h + 1] + b1);
      }
    }
}

// The slot gather-sum of the tile's rows into H (rounded to the state type),
// a warp a row, a lane the columns c = lane + 32 i; deg of each row.
template <typename T, bool ROLL, bool SLOT16>
__device__ __forceinline__ void stage_gather(const Tiles<T>& s, const Side<T>& d, int row0,
                                             int n, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int ld = ld_of<T>(W);
  for (int rt = warp; rt < TR; rt += nw) {
    if (rt >= n) {
      for (int c = lane; c < W; c += 32) s.H[rt * ld + c] = from_f<T>(0.f);
      if (lane == 0) s.deg[rt] = 0.f;
      continue;
    }
    const int fr = row0 + rt, b = fr / d.rows, r = fr - b * d.rows;
    const T* ysb = d.ys + size_t(b) * d.src_rows * W;
    const unsigned mb = ROLL ? unsigned(d.bits[r]) : 0u;
    float deg = 0.f;
    for (int k = 0; k < d.D; ++k) {
      const int src = ROLL ? ((mb >> k) & 1u ? wrap(r, d.offs.o[k], d.rows) : -1)
                           : __ldg(d.idx + r * d.D + k);
      deg += src >= 0 ? 1.f : 0.f;
    }
    for (int c = lane; c < W; c += 32) {
      const float ydb = s.V[rt * (W + 4) + c];
      float h = 0.f;
      for (int k = 0; k < d.D; ++k) {
        const int src = ROLL ? ((mb >> k) & 1u ? wrap(r, d.offs.o[k], d.rows) : -1)
                             : __ldg(d.idx + r * d.D + k);
        if (src < 0) continue;   // a masked slot adds exactly 0
        const float y = to_f<T>(ysb[size_t(src) * W + c]);
        if (ROLL) h = srnd<SLOT16>(h + fmaxf(srnd<SLOT16>(y + ydb), 0.f));
        else h += fmaxf(y + ydb, 0.f);
      }
      s.H[rt * ld + c] = from_f<T>(h);
    }
    if (lane == 0) s.deg[rt] = deg;
  }
}

// t = hs @ wf + x @ ux + the degree, syndrome and bias terms, in acc
template <typename T, bool ROLL>
__device__ __forceinline__ void stage_t(float (&acc)[MT][NJ][4], const Tiles<T>& s,
                                        const Side<T>& d, int row0, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ld = ld_of<T>(W);
  const size_t me = mat_elems<T>(W);
  zero_acc(acc);
  mma_rows(acc, s.H, ld, d.w + M_WF * me, W, W);
  mma_rows(acc, s.X, ld, d.w + M_UX * me, W, W);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      const int fr = min(row0 + r, d.total - 1);   // rows past the end are never stored
      const float sv = d.syn != nullptr ? d.syn[fr] : 0.f;
      const int cell = fr % d.rows;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * warp + 8 * j + 2 * t + e;
          float v = acc[m][j][2 * h + e];
          if (ROLL) {
            v += d.degbo[size_t(cell) * W + c];
            if (d.syn != nullptr) v += rnd_t<T>(__fmul_rn(sv, d.vec[V_UCS * W + c]));
            v += d.vec[V_UB0 * W + c];
          } else {
            v += s.deg[r] * d.vec[V_BOA * W + c] + d.vec[V_UB0 * W + c];
            if (d.syn != nullptr) v += sv * d.vec[V_UCS * W + c];
          }
          acc[m][j][2 * h + e] = v;
        }
    }
}

// hc = rnd(relu(t)) into H; every warp must be done reading H first
template <typename T>
__device__ __forceinline__ void store_hc(const float (&acc)[MT][NJ][4], const Tiles<T>& s,
                                         int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ld = ld_of<T>(W);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        st2(s.H + (16 * m + g + 8 * h) * ld + 32 * warp + 8 * j + 2 * t,
            fmaxf(acc[m][j][2 * h], 0.f), fmaxf(acc[m][j][2 * h + 1], 0.f));
}

// v = x + hc @ w1 + ub1 into V
template <typename T>
__device__ __forceinline__ void stage_v(const Tiles<T>& s, const T* w1, const float* vec, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ld = ld_of<T>(W);
  float acc[MT][NJ][4];
  zero_acc(acc);
  mma_rows(acc, s.H, ld, w1, W, W);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * warp + 8 * j + 2 * t + e;
          s.V[r * (W + 4) + c] = acc[m][j][2 * h + e] + (to_f<T>(s.X[r * ld + c]) + vec[V_UB1 * W + c]);
        }
    }
}

// The LayerNorm statistics of tile row rt (a warp): the mean and 1/sigma over
// the first `width` columns.
__device__ __forceinline__ float2 ln_stats(const float* v, int width, int W) {
  const int lane = threadIdx.x & 31;
  const float inv_w = 1.f / width;
  float sum = 0.f;
  for (int c = lane; c < width; c += 32) sum += v[c];
  const float mu = warp_sum(sum) * inv_w;
  float sq = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float x = v[c] - mu;
    sq += x * x;
  }
  return make_float2(mu, rsqrtf(warp_sum(sq) * inv_w + 1e-6f));
}

// the LayerNorm of the tile's rows into out, rounded to the state type
template <typename T>
__device__ __forceinline__ void stage_ln(const Tiles<T>& s, T* out, const float* vec, int row0,
                                         int n, int width, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int rt = warp; rt < n; rt += nw) {
    const float* v = s.V + rt * (W + 4);
    const float2 st = ln_stats(v, width, W);
    for (int c = lane; c < W; c += 32) {
      const float nh = c < width ? (v[c] - st.x) * st.y : 0.f;
      out[size_t(row0 + rt) * W + c] = from_f<T>(nh * vec[V_LNS * W + c] + vec[V_LNB * W + c]);
    }
  }
}

template <typename T, bool ROLL, bool SLOT16>
__global__ void __launch_bounds__(WMAX) wide_update_kernel(Side<T> d, int W, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<T> s = carve<T>(smem, W);
  const size_t me = mat_elems<T>(W);
  const int row0 = blockIdx.x * TR, n = min(TR, d.total - row0);
  load_tile(s.X, ld_of<T>(W), d.x + size_t(row0) * W, n, W);
  __syncthreads();
  stage_ydb<T, ROLL && SLOT16>(s, d.w + M_WD * me, d.vec, W);
  __syncthreads();
  stage_gather<T, ROLL, SLOT16>(s, d, row0, n, W);
  __syncthreads();
  float acc[MT][NJ][4];
  stage_t<T, ROLL>(acc, s, d, row0, W);
  __syncthreads();   // every warp is done reading hs
  store_hc(acc, s, W);
  __syncthreads();
  stage_v(s, d.w + M_W1 * me, d.vec, W);
  __syncthreads();
  stage_ln(s, d.out, d.vec, row0, n, width, W);
}

// ---------------------------------------------------------------------------
// The launches of the forward (K1, K2a, K5).

template <typename K>
int prepare(K kernel, size_t smem) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem)));
}

bool bad_width(int W, int width) {
  return W < 128 || W > WMAX || W % 128 != 0 || width <= 0 || width > W;
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

template <typename T, bool ROLL, bool SLOT16>
int run_forward(const Fwd& a) {
  const int W = a.W;
  const size_t me = mat_elems<T>(W);
  const T* mats = static_cast<const T*>(a.mats);
  auto upd = wide_update_kernel<T, ROLL, SLOT16>;
  if (int e = prepare(wide_project_kernel<T>, project_smem<T>(W))) return e;
  if (int e = prepare(upd, update_smem<T>(W))) return e;
  const size_t sc = size_t(a.B) * a.M * W, sq = size_t(a.B) * a.N * W;
  T* xc_out = static_cast<T*>(a.xc_out);
  T* xq_out = static_cast<T*>(a.xq_out);
  T* stc = static_cast<T*>(a.stash_c);
  T* stq = static_cast<T*>(a.stash_q);
  const bool stash = stc != nullptr;
  if (stash) {   // the stash's entry 0: the rounds' inputs
    cudaMemcpyAsync(stc, a.xc_in, sc * sizeof(T), cudaMemcpyDeviceToDevice, a.stream);
    cudaMemcpyAsync(stq, a.xq_in, sq * sizeof(T), cudaMemcpyDeviceToDevice, a.stream);
  }
  const int tc = (a.B * a.M + TR - 1) / TR, tq = (a.B * a.N + TR - 1) / TR;
  for (int r = 0; r < a.R; ++r) {
    const T* xc = r == 0 ? static_cast<const T*>(a.xc_in) : (stash ? stc + r * sc : xc_out);
    const T* xq = r == 0 ? static_cast<const T*>(a.xq_in) : (stash ? stq + r * sq : xq_out);
    T* nc = stash && r + 1 < a.R ? stc + (r + 1) * sc : xc_out;
    T* nq = stash && r + 1 < a.R ? stq + (r + 1) * sq : xq_out;
    T* ysc = static_cast<T*>(a.ys_c);
    T* ysq = static_cast<T*>(a.ys_q);
    // the gathers' sources from the round's inputs: ys_c = rnd(x_q @ ws_c),
    // ys_q = rnd(x_c @ ws_q)
    wide_project_kernel<T><<<tq, W, project_smem<T>(W), a.stream>>>(
        xq, ysc, mats + (NMAT + M_WS) * me, a.B * a.N, W);
    wide_project_kernel<T><<<tc, W, project_smem<T>(W), a.stream>>>(
        xc, ysq, mats + M_WS * me, a.B * a.M, W);
    Side<T> c{xc, nc, ysc, a.syn, a.idx_c, a.idx_c, a.degbo, mats, a.vecs, a.offs_c,
              a.M, a.N, a.Dc, a.B * a.M};
    Side<T> q{xq, nq, ysq, nullptr, a.idx_q, a.idx_q,
              a.degbo == nullptr ? nullptr : a.degbo + size_t(a.N) * W, mats + NMAT * me,
              a.vecs + NVEC * W, a.offs_q, a.N, a.M, a.Dq, a.B * a.N};
    upd<<<tc, W, update_smem<T>(W), a.stream>>>(c, W, a.width);
    upd<<<tq, W, update_smem<T>(W), a.stream>>>(q, W, a.width);
    if (int e = int(cudaGetLastError())) return e;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K2b: the replay and the adjoint down to the gather, a tile of one
// direction's rows.

template <typename T>
struct BSide {
  const T* x;             // [B rows][W] the stash's round-r states of this direction
  const T* xsrc;          // [B src_rows][W] those of the other direction
  const T* ys;            // [B src_rows][W] the replayed gather source
  const float* g;         // [B rows][W] the cotangent of the round's new states
  const float* syn;       // [B rows] (checks) or null
  float* dsyn;            // [B rows] (checks) or null
  const float* ucs32;     // [W] uc_s unrounded (checks) or null
  const int* idx;         // [rows][D] slot table
  const float* degt;      // [rows] real slots a row
  const T* w;             // the direction's 5 packs
  const T* wt;            // the packs of their transposes
  const float* vec;       // [7][W]
  // residuals, [B rows][W] (live: [B rows][D][W / 32] bits)
  T *hs, *hc, *dpre_r, *dtr, *dydb_r;
  float *dpre, *dt, *dhs, *nh, *dydb;
  uint32_t* live;
  // ties (f32 states only)
  const float* w32;       // the direction's 5 f32 matrices [5][W][W]
  const float* w32t;      //   their transposes
  const float* wsrc32;    // the f32 matrix projecting xsrc into ys
  const float* wsrc32t;   //   its transpose
  const float* xn;        // [B rows] |x| of this round's rows
  const float* xn_src;    // [B src_rows]
  float wn_wd, wn_ux, wn_wf, wn_src;   // largest column norms
  int rows, src_rows, D, total;
};

// The slot gather-sum of the replay (as stage_gather, table mode), and the
// slot masks as bits of `live`; f32 with ties: a mask whose |z| falls in the
// band is taken again as the plain version computes z.
template <typename T>
__device__ __forceinline__ void replay_gather(const Tiles<T>& s, const BSide<T>& d, int row0,
                                              int n, int W, int msg_width) {
  constexpr bool TIES = sizeof(T) == 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int ld = ld_of<T>(W), words = W / 32;
  for (int rt = warp; rt < TR; rt += nw) {
    if (rt >= n) {
      for (int c = lane; c < W; c += 32) s.H[rt * ld + c] = from_f<T>(0.f);
      if (lane == 0) s.deg[rt] = s.hsn[rt] = 0.f;
      continue;
    }
    const int fr = row0 + rt, b = fr / d.rows, r = fr - b * d.rows;
    const T* ysb = d.ys + size_t(b) * d.src_rows * W;
    const float xn = TIES ? d.xn[fr] : 0.f;
    float sq = 0.f;
    for (int c = lane, i = 0; c < W; c += 32, ++i) {
      const float ydb = s.V[rt * (W + 4) + c];
      float h = 0.f;
      for (int k = 0; k < d.D; ++k) {
        const int src = __ldg(d.idx + r * d.D + k);
        bool live = false;
        if (src >= 0) {
          const float z = to_f<T>(ysb[size_t(src) * W + c]) + ydb;
          h += fmaxf(z, 0.f);
          live = z > 0.f;
          if (TIES && c < msg_width) {
            const size_t fs = size_t(b) * d.src_rows + src;
            const float band = TAU_Z * (d.xn_src[fs] * d.wn_src + xn * d.wn_wd);
            if (fabsf(z) < band) {
              const float* xs = reinterpret_cast<const float*>(d.xsrc) + fs * W;
              const float* xr = reinterpret_cast<const float*>(s.X) + rt * ld;
              const float ex = __fadd_rn(
                  seq_dot(xs, d.wsrc32t + size_t(c) * W, W),
                  __fadd_rn(seq_dot(xr, d.w32t + size_t(M_WD) * W * W + size_t(c) * W, W),
                            d.vec[V_B0 * W + c]));
              live = ex > 0.f;
            }
          }
        }
        const uint32_t word = __ballot_sync(0xffffffffu, live);
        if (lane == 0) d.live[(size_t(fr) * d.D + k) * words + i] = word;
      }
      const float hr = rnd_t<T>(h);
      s.H[rt * ld + c] = from_f<T>(hr);
      d.hs[size_t(fr) * W + c] = from_f<T>(hr);
      sq += hr * hr;
    }
    sq = warp_sum(sq);
    if (lane == 0) {
      s.deg[rt] = d.degt[r];
      s.hsn[rt] = sqrtf(sq);
    }
  }
}

// f32 ties of t: for each row of the tile with a tie, the block computes its
// hs as the plain version sums it (a thread a column) into s.hsx, and the
// threads holding a tied entry take its mask again from t as the plain
// version forms it.  tp: this thread's mask bits, tu: its ties.
template <typename T>
__device__ __forceinline__ void fix_t(const Tiles<T>& s, const BSide<T>& d, int row0, int W,
                                      uint32_t tu, uint32_t& tp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ld = ld_of<T>(W);
  if (threadIdx.x < TR) s.flag[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if ((tu >> ((m * NJ + j) * 4 + 2 * h + e)) & 1u) s.flag[16 * m + g + 8 * h] = 1;
  __syncthreads();
  for (int rt = 0; rt < TR; ++rt) {
    if (!s.flag[rt]) continue;   // the same for every thread
    const int fr = row0 + rt, b = fr / d.rows, r = fr - b * d.rows;
    const float* xr = reinterpret_cast<const float*>(s.X) + rt * ld;
    {
      const int c = threadIdx.x;   // blockDim.x == W
      const float ydb = __fadd_rn(seq_dot_col(xr, d.w32 + size_t(M_WD) * W * W, c, W, W),
                                  d.vec[V_B0 * W + c]);
      float hx = 0.f;
      for (int k = 0; k < d.D; ++k) {
        const int src = __ldg(d.idx + r * d.D + k);
        if (src < 0) continue;
        const float* xs = reinterpret_cast<const float*>(d.xsrc) +
                          (size_t(b) * d.src_rows + src) * W;
        hx = __fadd_rn(hx, fmaxf(__fadd_rn(seq_dot_col(xs, d.wsrc32, c, W, W), ydb), 0.f));
      }
      s.hsx[c] = hx;
    }
    __syncthreads();
    const float sv = d.syn != nullptr ? d.syn[fr] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (16 * m + g + 8 * h != rt) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int bit = (m * NJ + j) * 4 + 2 * h + e;
            if (!((tu >> bit) & 1u)) continue;
            const int c = 32 * warp + 8 * j + 2 * t + e;
            float v = __fadd_rn(seq_dot(xr, d.w32t + size_t(M_UX) * W * W + size_t(c) * W, W),
                                seq_dot(s.hsx, d.w32t + size_t(M_WF) * W * W + size_t(c) * W, W));
            v = __fadd_rn(v, __fmul_rn(s.deg[rt], d.vec[V_BOA * W + c]));
            v = __fadd_rn(v, __fmul_rn(sv, d.vec[V_UCS * W + c]));
            v = __fadd_rn(v, d.vec[V_UB0 * W + c]);
            tp = v > 0.f ? tp | (1u << bit) : tp & ~(1u << bit);
          }
      }
    __syncthreads();   // every thread is done with s.hsx
  }
}

template <typename T>
__global__ void __launch_bounds__(WMAX) wide_replay_kernel(BSide<T> d, int W, int width,
                                                           int msg_width) {
  constexpr bool TIES = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<T> s = carve<T>(smem, W);
  const size_t me = mat_elems<T>(W);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ld = ld_of<T>(W), words = W / 32;
  const int row0 = blockIdx.x * TR, n = min(TR, d.total - row0);
  load_tile(s.X, ld, d.x + size_t(row0) * W, n, W);
  __syncthreads();
  stage_ydb<T, false>(s, d.w + M_WD * me, d.vec, W);
  __syncthreads();
  replay_gather(s, d, row0, n, W, msg_width);
  __syncthreads();

  // t, its relu mask (tp) and, in f32, the entries in the tie band (tu)
  float acc[MT][NJ][4];
  Side<T> fwd{d.x, nullptr, d.ys, d.syn, d.idx, nullptr, nullptr, d.w, d.vec, {},
              d.rows, d.src_rows, d.D, d.total};
  stage_t<T, false>(acc, s, fwd, row0, W);
  uint32_t tp = 0u, tu = 0u;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      const float band = (TIES && r < n)
                             ? TAU_T * (d.xn[row0 + r] * d.wn_ux + s.hsn[r] * d.wn_wf)
                             : -1.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bit = (m * NJ + j) * 4 + 2 * h + e;
          const int c = 32 * warp + 8 * j + 2 * t + e;
          const float v = acc[m][j][2 * h + e];
          tp |= (v > 0.f ? 1u : 0u) << bit;
          tu |= (c < width && fabsf(v) < band ? 1u : 0u) << bit;
        }
    }
  if (TIES && __syncthreads_or(tu != 0u)) fix_t(s, d, row0, W, tu, tp);
  __syncthreads();   // every warp is done reading hs
  store_hc(acc, s, W);
  __syncthreads();
  for (int u = threadIdx.x; u < n * W; u += blockDim.x) {
    const int r = u / W, c = u - r * W;
    d.hc[size_t(row0 + r) * W + c] = s.H[r * ld + c];
  }
  stage_v(s, d.w + M_W1 * me, d.vec, W);
  __syncthreads();

  // the LayerNorm again, and its adjoint: dpre; rnd(dpre) into H
  for (int rt = warp; rt < TR; rt += nw) {
    if (rt >= n) {
      for (int c = lane; c < W; c += 32) s.H[rt * ld + c] = from_f<T>(0.f);
      continue;
    }
    const size_t fr = size_t(row0 + rt);
    const float* v = s.V + rt * (W + 4);
    const float2 st = ln_stats(v, width, W);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float nh = (v[c] - st.x) * st.y;
      const float dnh = d.g[fr * W + c] * d.vec[V_LNS * W + c];
      s1 += dnh;
      s2 += dnh * nh;
    }
    const float inv_w = 1.f / width;
    const float m1 = warp_sum(s1) * inv_w, m2 = warp_sum(s2) * inv_w;
    for (int c = lane; c < W; c += 32) {
      float nh = 0.f, dp = 0.f;
      if (c < width) {
        nh = (v[c] - st.x) * st.y;
        const float dnh = d.g[fr * W + c] * d.vec[V_LNS * W + c];
        dp = st.y * (dnh - m1 - nh * m2);
      }
      d.nh[fr * W + c] = nh;
      d.dpre[fr * W + c] = dp;
      const T dr = from_f<T>(dp);
      d.dpre_r[fr * W + c] = dr;
      s.H[rt * ld + c] = dr;
    }
  }
  __syncthreads();

  // dt = (rnd(dpre) @ w1^T) * (t > 0); rnd(dt) into X; dsyn
  zero_acc(acc);
  mma_rows(acc, s.H, ld, d.wt + M_W1 * me, W, W);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      float ds = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bit = (m * NJ + j) * 4 + 2 * h + e;
          const int c = 32 * warp + 8 * j + 2 * t + e;
          o[e] = (tp >> bit) & 1u ? acc[m][j][2 * h + e] : 0.f;
          if (d.ucs32 != nullptr) ds += o[e] * d.ucs32[c];
        }
        const int c = 32 * warp + 8 * j + 2 * t;
        st2(s.X + r * ld + c, o[0], o[1]);
        if (r < n) {
          const size_t fr = size_t(row0 + r);
          st2(d.dt + fr * W + c, o[0], o[1]);
          st2(d.dtr + fr * W + c, o[0], o[1]);
        }
      }
      ds += __shfl_xor_sync(0xffffffffu, ds, 1);
      ds += __shfl_xor_sync(0xffffffffu, ds, 2);
      if (t == 0) s.red[warp * TR + r] = ds;
    }
  __syncthreads();
  if (d.dsyn != nullptr && threadIdx.x < n) {
    float ds = 0.f;
    for (int w = 0; w < nw; ++w) ds += s.red[w * TR + threadIdx.x];
    d.dsyn[row0 + threadIdx.x] += ds;
  }

  // dhs = rnd(dt) @ wf^T; dydb = sum of dhs over the live slots
  zero_acc(acc);
  mma_rows(acc, s.X, ld, d.wt + M_WF * me, W, W);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      if (r >= n) continue;
      const size_t fr = size_t(row0 + r);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = 32 * warp + 8 * j + 2 * t;
        float y[2] = {0.f, 0.f};
        for (int k = 0; k < d.D; ++k) {
          const uint32_t lw = d.live[(fr * d.D + k) * words + c / 32];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if ((lw >> ((c + e) & 31)) & 1u) y[e] += acc[m][j][2 * h + e];
        }
        st2(d.dhs + fr * W + c, acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        st2(d.dydb + fr * W + c, y[0], y[1]);
        st2(d.dydb_r + fr * W + c, y[0], y[1]);
      }
    }
}

// The bias gradients' column sums over segment blockIdx.x of the rows, added
// to its partial [7][W]: dydb, deg dt, syn dt, dt, dpre, g nh, g.
template <typename T>
__global__ void __launch_bounds__(WMAX) wide_colsum_kernel(BSide<T> d, float* part, int W) {
  const int c = threadIdx.x;
  const int per = (d.total + NSEG - 1) / NSEG;
  const int r0 = blockIdx.x * per, r1 = min(d.total, r0 + per);
  float a[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int fr = r0; fr < r1; ++fr) {
    const size_t e = size_t(fr) * W + c;
    const float dt = d.dt[e], g = d.g[e];
    a[0] += d.dydb[e];
    a[1] += d.degt[fr % d.rows] * dt;
    if (d.syn != nullptr) a[2] += d.syn[fr] * dt;
    a[3] += dt;
    a[4] += d.dpre[e];
    a[5] += g * d.nh[e];
    a[6] += g;
  }
  float* p = part + size_t(blockIdx.x) * 7 * W + c;
#pragma unroll
  for (int v = 0; v < 7; ++v) p[v * W] += a[v];
}

// dys onto this direction's rows: the other direction's gather adjoint,
// each source row summing its readers (row, slot) in list order; a warp a
// row, a lane the columns c = lane + 32 i.
template <typename T>
__global__ void __launch_bounds__(256) wide_dys_kernel(T* dys, int total, int rows,
                                                       const int* __restrict__ off,
                                                       const int* __restrict__ lst,
                                                       const float* dhs, const uint32_t* live,
                                                       int rd, int D, int W) {
  const int lane = threadIdx.x & 31;
  const int fs = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (fs >= total) return;
  const int b = fs / rows, s = fs - b * rows;
  const int e0 = __ldg(off + s), e1 = __ldg(off + s + 1);
  const int words = W / 32;
  for (int c = lane, i = 0; c < W; c += 32, ++i) {
    float a = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int v = __ldg(lst + e), r = v / D, k = v - r * D;
      const size_t fr = size_t(b) * rd + r;
      if ((live[(fr * D + k) * words + i] >> lane) & 1u) a += rnd_t<T>(dhs[fr * W + c]);
    }
    dys[size_t(fs) * W + c] = from_f<T>(a);
  }
}

// g = dpre + rnd(dydb) @ wd^T + rnd(dys) @ ws^T + rnd(dt) @ ux^T, a tile of
// one direction's rows (in place)
template <typename T>
__global__ void __launch_bounds__(WMAX) wide_cotangent_kernel(
    float* g, const float* dpre, const T* dydb_r, const T* dys_r, const T* dtr,
    const T* __restrict__ wd_t, const T* __restrict__ ws_t, const T* __restrict__ ux_t,
    int total, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = ld_of<T>(W);
  T* A = reinterpret_cast<T*>(smem);
  T* B2 = reinterpret_cast<T*>(smem + tile_bytes(ld, sizeof(T)));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * TR, n = min(TR, total - row0);
  load_tile(A, ld, dydb_r + size_t(row0) * W, n, W);
  load_tile(B2, ld, dys_r + size_t(row0) * W, n, W);
  __syncthreads();
  float acc[MT][NJ][4];
  zero_acc(acc);
  mma_rows(acc, A, ld, wd_t, W, W);
  mma_rows(acc, B2, ld, ws_t, W, W);
  __syncthreads();
  load_tile(A, ld, dtr + size_t(row0) * W, n, W);
  __syncthreads();
  mma_rows(acc, A, ld, ux_t, W, W);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + gq + 8 * h;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const size_t e = size_t(row0 + r) * W + 32 * warp + 8 * j + 2 * t;
        const float2 p = *reinterpret_cast<const float2*>(dpre + e);
        *reinterpret_cast<float2*>(g + e) =
            make_float2(p.x + acc[m][j][2 * h], p.y + acc[m][j][2 * h + 1]);
      }
    }
}

// The ten weight gradients: block (mat, i-block, chunk) forms rows [64 ib,
// 64 ib + 64) of A^T G over the chunk's rows and adds them to the chunk's
// partial [10][W][W].
template <typename T>
struct WGrad {
  const T* a[10];
  const T* g[10];
  int total[10];
};

template <typename T>
__global__ void __launch_bounds__(WMAX) wide_wgrad_kernel(WGrad<T> p, float* part, int nch,
                                                          int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MW = WG_ROWS / 16;
  const int mat = blockIdx.x, ib = blockIdx.y, ch = blockIdx.z;
  const int lda_g = W + 8;
  T* As = reinterpret_cast<T*>(smem);
  T* Gs = reinterpret_cast<T*>(smem + align16(size_t(WG_KR) * WG_LDA * sizeof(T)));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int total = p.total[mat];
  const int per = ((total + nch - 1) / nch + WG_KR - 1) / WG_KR * WG_KR;
  const int r0 = ch * per, r1 = min(total, r0 + per);
  const T* A = p.a[mat];
  const T* G = p.g[mat];
  float acc[MW][NJ][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  constexpr int V = 16 / sizeof(T);
  for (int k0 = r0; k0 < r1; k0 += WG_KR) {
    const int n = min(WG_KR, r1 - k0);
    for (int u = threadIdx.x; u < WG_KR * (WG_ROWS / V); u += blockDim.x) {
      const int r = u / (WG_ROWS / V), c = (u - r * (WG_ROWS / V)) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) v = *reinterpret_cast<const uint4*>(A + size_t(k0 + r) * W + WG_ROWS * ib + c);
      *reinterpret_cast<uint4*>(As + r * WG_LDA + c) = v;
    }
    load_tile(Gs, lda_g, G + size_t(k0) * W, n, W);
    __syncthreads();
    mma_atb<MW>(acc, As, WG_LDA, Gs, lda_g, WG_KR);
    __syncthreads();
  }
  float* out = part + (size_t(ch) * 10 + mat) * W * W;
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = WG_ROWS * ib + 16 * m + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float2* q = reinterpret_cast<float2*>(out + size_t(i) * W + 32 * warp + 8 * j + 2 * t);
        const float2 o = *q;
        *q = make_float2(o.x + acc[m][j][2 * h], o.y + acc[m][j][2 * h + 1]);
      }
    }
}

template <typename T>
size_t wgrad_smem(int W) {
  return align16(size_t(WG_KR) * WG_LDA * sizeof(T)) + tile_bytes(W + 8, sizeof(T));
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

// The scratch of K2b, carved per direction.
template <typename T>
struct BScratch {
  T *ys, *hs, *hc, *dpre_r, *dtr, *dydb_r, *dys;
  float *dpre, *dt, *dhs, *nh, *dydb;
  uint32_t* live;
};

// One direction's share: its residuals over its B rows rows, and ys, the
// gather source it reads, over the other direction's B src_rows rows.
template <typename T>
size_t bside_bytes(size_t rows, size_t src_rows, int D, int W) {
  constexpr bool F32 = sizeof(T) == 4;
  const size_t t = align16(rows * W * sizeof(T) + 255), f = align16(rows * W * 4 + 255);
  const size_t bits = align16(rows * D * (W / 32) * 4 + 255);
  return align16(src_rows * W * sizeof(T) + 255) + (F32 ? 3 : 6) * t + 5 * f + bits;
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
  s.dpre = reinterpret_cast<float*>(take(rows * W * 4));
  s.dt = reinterpret_cast<float*>(take(rows * W * 4));
  s.dhs = reinterpret_cast<float*>(take(rows * W * 4));
  s.nh = reinterpret_cast<float*>(take(rows * W * 4));
  s.dydb = reinterpret_cast<float*>(take(rows * W * 4));
  if (F32) {   // the rounded copies are the values themselves
    s.dpre_r = reinterpret_cast<T*>(s.dpre);
    s.dtr = reinterpret_cast<T*>(s.dt);
    s.dydb_r = reinterpret_cast<T*>(s.dydb);
  } else {
    s.dpre_r = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
    s.dtr = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
    s.dydb_r = reinterpret_cast<T*>(take(rows * W * sizeof(T)));
  }
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
  int B, M, N, Dc, Dq, R, W, width, msg_width, nch;
  cudaStream_t stream;
};

template <typename T>
int run_backward(const Bwd& a) {
  const int W = a.W;
  const size_t me = mat_elems<T>(W), W2 = size_t(W) * W;
  const T* mats = static_cast<const T*>(a.mats);
  const T* mats_t = static_cast<const T*>(a.mats_t);
  if (int e = prepare(wide_project_kernel<T>, project_smem<T>(W))) return e;
  if (int e = prepare(wide_replay_kernel<T>, update_smem<T>(W))) return e;
  if (int e = prepare(wide_cotangent_kernel<T>, 2 * tile_bytes(ld_of<T>(W), sizeof(T)))) return e;
  if (int e = prepare(wide_wgrad_kernel<T>, wgrad_smem<T>(W))) return e;
  unsigned char* p = static_cast<unsigned char*>(a.scratch);
  const size_t rc = size_t(a.B) * a.M, rq = size_t(a.B) * a.N;
  const BScratch<T> sc = bside_carve<T>(p, rc, rq, a.Dc, W);
  const BScratch<T> sq = bside_carve<T>(p, rq, rc, a.Dq, W);
  const int tc = int((rc + TR - 1) / TR), tq = int((rq + TR - 1) / TR);
  const bool ties = sizeof(T) == 4;
  float* vpart_c = a.part_vecs;
  float* vpart_q = a.part_vecs + size_t(NSEG) * 7 * W;
  for (int r = a.R - 1; r >= 0; --r) {
    const T* xc = static_cast<const T*>(a.stash_c) + r * rc * W;
    const T* xq = static_cast<const T*>(a.stash_q) + r * rq * W;
    wide_project_kernel<T><<<tq, W, project_smem<T>(W), a.stream>>>(
        xq, sc.ys, mats + (NMAT + M_WS) * me, int(rq), W);
    wide_project_kernel<T><<<tc, W, project_smem<T>(W), a.stream>>>(
        xc, sq.ys, mats + M_WS * me, int(rc), W);
    const float* w32c = ties ? a.mats32 : nullptr;
    const float* w32tc = ties ? a.mats32_t : nullptr;
    BSide<T> c{xc, xq, sc.ys, a.g_c, a.syn, a.dsyn, a.ucs32, a.idx_c, a.deg_c, mats, mats_t,
               a.vecs, sc.hs, sc.hc, sc.dpre_r, sc.dtr, sc.dydb_r, sc.dpre, sc.dt, sc.dhs,
               sc.nh, sc.dydb, sc.live,
               w32c, w32tc, ties ? a.mats32 + (NMAT + M_WS) * W2 : nullptr,
               ties ? a.mats32_t + (NMAT + M_WS) * W2 : nullptr,
               ties ? a.xn_c + r * rc : nullptr, ties ? a.xn_q + r * rq : nullptr,
               ties ? a.wn[M_WD] : 0.f, ties ? a.wn[M_UX] : 0.f, ties ? a.wn[M_WF] : 0.f,
               ties ? a.wn[NMAT + M_WS] : 0.f, a.M, a.N, a.Dc, int(rc)};
    BSide<T> q{xq, xc, sq.ys, a.g_q, nullptr, nullptr, nullptr, a.idx_q, a.deg_q,
               mats + NMAT * me, mats_t + NMAT * me, a.vecs + NVEC * W, sq.hs, sq.hc,
               sq.dpre_r, sq.dtr, sq.dydb_r, sq.dpre, sq.dt, sq.dhs, sq.nh, sq.dydb, sq.live,
               ties ? a.mats32 + NMAT * W2 : nullptr, ties ? a.mats32_t + NMAT * W2 : nullptr,
               ties ? a.mats32 + M_WS * W2 : nullptr, ties ? a.mats32_t + M_WS * W2 : nullptr,
               ties ? a.xn_q + r * rq : nullptr, ties ? a.xn_c + r * rc : nullptr,
               ties ? a.wn[NMAT + M_WD] : 0.f, ties ? a.wn[NMAT + M_UX] : 0.f,
               ties ? a.wn[NMAT + M_WF] : 0.f, ties ? a.wn[M_WS] : 0.f,
               a.N, a.M, a.Dq, int(rq)};
    wide_replay_kernel<T><<<tc, W, update_smem<T>(W), a.stream>>>(c, W, a.width, a.msg_width);
    wide_replay_kernel<T><<<tq, W, update_smem<T>(W), a.stream>>>(q, W, a.width, a.msg_width);
    wide_colsum_kernel<T><<<NSEG, W, 0, a.stream>>>(c, vpart_c, W);
    wide_colsum_kernel<T><<<NSEG, W, 0, a.stream>>>(q, vpart_q, W);
    // the gathers' adjoints: the qubit direction's onto the check rows, the
    // check direction's onto the qubit rows
    wide_dys_kernel<T><<<int((rc + 7) / 8), 256, 0, a.stream>>>(
        sc.dys, int(rc), a.M, a.off_q, a.lst_q, sq.dhs, sq.live, a.N, a.Dq, W);
    wide_dys_kernel<T><<<int((rq + 7) / 8), 256, 0, a.stream>>>(
        sq.dys, int(rq), a.N, a.off_c, a.lst_c, sc.dhs, sc.live, a.M, a.Dc, W);
    const size_t cs = 2 * tile_bytes(ld_of<T>(W), sizeof(T));
    wide_cotangent_kernel<T><<<tc, W, cs, a.stream>>>(
        a.g_c, sc.dpre, sc.dydb_r, sc.dys, sc.dtr, mats_t + M_WD * me, mats_t + M_WS * me,
        mats_t + M_UX * me, int(rc), W);
    wide_cotangent_kernel<T><<<tq, W, cs, a.stream>>>(
        a.g_q, sq.dpre, sq.dydb_r, sq.dys, sq.dtr, mats_t + (NMAT + M_WD) * me,
        mats_t + (NMAT + M_WS) * me, mats_t + (NMAT + M_UX) * me, int(rq), W);
    WGrad<T> wg{{xc, xc, xc, sc.hs, sc.hc, xq, xq, xq, sq.hs, sq.hc},
                {sc.dydb_r, sc.dtr, sc.dys, sc.dtr, sc.dpre_r, sq.dydb_r, sq.dtr, sq.dys, sq.dtr,
                 sq.dpre_r},
                {int(rc), int(rc), int(rc), int(rc), int(rc), int(rq), int(rq), int(rq), int(rq),
                 int(rq)}};
    wide_wgrad_kernel<T><<<dim3(10, W / WG_ROWS, a.nch), W, wgrad_smem<T>(W), a.stream>>>(
        wg, a.part_mats, a.nch, W);
    if (int e = int(cudaGetLastError())) return e;
  }
  sum_parts_kernel<<<264, 256, 0, a.stream>>>(a.part_mats, a.nch, 10 * W2, a.dmats);
  sum_parts_kernel<<<8, 256, 0, a.stream>>>(vpart_c, NSEG, size_t(7) * W, a.dvecs);
  sum_parts_kernel<<<8, 256, 0, a.stream>>>(vpart_q, NSEG, size_t(7) * W,
                                            a.dvecs + size_t(NVEC) * W);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 (stash null) and K2a: R rounds on states [B, M|N, W] in the state type
// (dtype 0 = float32, 1 = bfloat16); syn [B, M] f32; idx_c [M, Dc], idx_q
// [N, Dq] int32 (-1 = masked); mats the [10] packs (f32: split,
// fused_decoder.py::tf32_split_pack; bf16: bf16_frag_pack) at width W;
// vecs [14, W] f32; ys_c [B, N, W], ys_q [B, M, W] scratch in the state
// type; stash_c [R, B, M, W] and stash_q [R, B, N, W] (K2a).  width: the
// LayerNorm's columns.  Returns the first CUDA error (0 on success).
int wide_rounds_launch(int dtype, const void* xc_in, const void* xq_in, const void* syn,
                       const void* idx_c, const void* idx_q, const void* mats, const void* vecs,
                       void* xc_out, void* xq_out, void* stash_c, void* stash_q, void* ys_c,
                       void* ys_q, int B, int M, int N, int Dc, int Dq, int R, int W, int width,
                       void* stream) {
  if (bad_width(W, width) || B <= 0 || M <= 0 || N <= 0 || Dc <= 0 || Dq <= 0 || R <= 0 ||
      (stash_c == nullptr) != (stash_q == nullptr))
    return int(cudaErrorInvalidValue);
  Fwd a{xc_in, xq_in, static_cast<const float*>(syn), static_cast<const int*>(idx_c),
        static_cast<const int*>(idx_q), nullptr, mats, static_cast<const float*>(vecs), xc_out,
        xq_out, stash_c, stash_q, ys_c, ys_q, {}, {}, B, M, N, Dc, Dq, R, W, width,
        static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return run_forward<float, false, false>(a);
  if (dtype == 1) return run_forward<bf16, false, false>(a);
  return int(cudaErrorInvalidValue);
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
  if (bad_width(W, width) || B <= 0 || L <= 0 || R <= 0 || offs == nullptr)
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
  if (dtype == 0) return run_forward<float, true, false>(a);
  if (dtype != 1) return int(cudaErrorInvalidValue);
  return slot16 ? run_forward<bf16, true, true>(a) : run_forward<bf16, true, false>(a);
}

// Bytes of K2b's scratch (the residuals of one round, both directions).
long long wide_rounds_bwd_scratch_bytes(int dtype, int B, int M, int N, int Dc, int Dq,
                                        int W) {
  return (long long)(dtype == 0 ? bwd_scratch_bytes<float>(B, M, N, Dc, Dq, W)
                                : bwd_scratch_bytes<bf16>(B, M, N, Dc, Dq, W));
}

// Row segments of K2b's bias-gradient partials: part_vecs is [2][segments][7][W].
int wide_rounds_bwd_segments() { return NSEG; }

// K2b: the adjoint of the R rounds from K2a's stash [R, B, M|N, W] in the
// state type.  g_c [B, M, W], g_q [B, N, W] f32: the cotangents of the
// outputs, rewritten in place into those of the inputs; dsyn [B, M] f32,
// zeroed by the caller.  off_c/lst_c: the readers of the qubit rows in the
// check direction's gather (lst entries r Dc + k of the check rows r),
// off_q/lst_q the same for the check rows; deg_c [M], deg_q [N] f32.  mats,
// mats_t: the packs of the matrices and of their transposes; with f32 states
// also mats32, mats32_t [10, W, W] f32 unpacked, xn_c [R, B, M], xn_q [R, B,
// N] the stash rows' norms and wn a host array of the 10 matrices' largest
// column norms (the ties; null in bf16).  ucs32 [W] uc_s unrounded.  part_mats [nch][10][W]
// [W] and part_vecs [2][segments][7][W] f32, zeroed by the caller; dmats [10,
// W, W], dvecs [14, W] f32 the results.
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
  if (bad_width(W, width) || msg_width <= 0 || msg_width > W || B <= 0 || M <= 0 || N <= 0 ||
      Dc <= 0 || Dq <= 0 || R <= 0 || nch <= 0)
    return int(cudaErrorInvalidValue);
  if (dtype == 0 && (mats32 == nullptr || mats32_t == nullptr || xn_c == nullptr ||
                     xn_q == nullptr || wn == nullptr))
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
        msg_width, nch, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return run_backward<float>(a);
  if (dtype == 1) return run_backward<bf16>(a);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
