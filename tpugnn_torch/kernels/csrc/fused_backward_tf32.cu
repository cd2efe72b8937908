// Backward of the R weight-tied rounds with f32 states (K2b, Hopper): every
// product as three TF32 products on the tensor cores.
//
// With fused_backward.cu (bf16 states) it replaces the TPU kernel
// tpugnn/kernels/fused_backward.py::make_kernel_vjp_rounds._bwd
// (pl.pallas_call at :624, body _make_bwd_kernel at :273).  The function is
// tpugnn_torch/kernels/fused_backward.py::rounds_vjp_plain's with f32
// states, where no cotangent is rounded: the rounds in reverse, each
// replayed from the stash K2a wrote (its input states), then its adjoint.
//
// Schedule: the bf16 kernel's (fused_backward.cu, tcb::; its comments give
// the stages).  A persistent grid of about one 256-thread block per SM; a
// block takes a tile of TILE samples and walks the rounds R-1 ... 0 over the
// tile.  Per round and sample, on whole-side chunks of 128 rows (8 warps x
// 16 rows, m16 x n128 each; a second, ragged chunk for a larger side):
//   S1  the two gather panels, ys_c = x_q @ ws_c and ys_q = x_c @ ws_q;
//   S2  per direction, the replay (x @ wd, the slot gather-sum and its relu
//       masks, hs @ wf + x @ ux, hc @ w1, the LayerNorm) and at once the
//       adjoint (the LayerNorm backward -> dpre, written to the state
//       cotangent; dpre @ w1^T, the relu mask of t, dt @ wf^T -> dhs; dydb,
//       the slot masks of the row applied to dhs in registers);
//   S3  per direction, dys of every source row: a gather of dhs under the
//       slot masks over the readers table, in (row, slot) order;
//   S4  per direction, g += dydb @ wd^T + dys @ ws^T + dt @ ux^T;
// and the residuals the weight gradients read (hs, hc, dpre, dt, dydb, dys)
// go to the tile's f32 scratch.  Then S5 forms the round's ten weight
// gradients x^T @ dy, each reduced over the tile's TILE x rows rows in one
// pass, into the block's f32 partial; a second launch sums the partials in a
// fixed order.  Bias gradients go to per-warp partials in program order
// (red_add2) and dsyn gets one add per row and round, so two calls on the
// same inputs give the same bits.
//
// Products (rounds_mma.cuh, namespace tf32): c = a_lo w_hi + a_hi w_lo +
// a_hi w_hi on mma.sync.m16n8k8 .tf32, a fresh c for each 16-row k-slab
// added to the running f32 sum on the CUDA cores (the tensor cores' f32
// accumulation truncates).  S1, S2 and S4 read their weights split once a
// call by the wrapper (fused_decoder.py::tf32_split_pack, the forward pack
// and the transposed one, in fragment order), through a ring of two 16-row
// slabs, and split the states and cotangents in registers at fragment load.
// In S5 both operands are activations: the tile's rows are staged through
// shared memory in 32-row chunks with a row stride of 136 floats, so that
// the transposed A fragment (A^T: element (m, k) is row k, column m of the
// staged rows) and the B fragment are each read by the 32 lanes from 32
// distinct banks, and both are split in registers.
//
// Ties.  The adjoint has discontinuities: the slot relu masks (z > 0, z =
// ys[src] + ydb) and the update's (t > 0).  A product formed otherwise than
// the plain version forms it (3xTF32 here; any other f32 summation order
// too) flips a few of them, and a flip moves a whole cotangent entry: at
// d=11, B=4096, R=14 that put the gradients 5e-4 from rounds_vjp_plain,
// and the plain version with its products split three ways as far.  On the
// card the plain version's f32 products are cuBLAS's, one FMA per k, k
// ascending (bit-equal to that loop at every shape the rounds use).  So a
// decision whose |z| or |t| falls within a band of the products' rounding
// (TAU times the bound |x| |w_c| on the sum of |x_k w_kc|, from the stash's
// row norms and the matrices' column norms) is taken again in that
// arithmetic: z from two such dot products (fix_slots), t from hs of the
// row summed as the plain version sums it (hs_exact_row, the warp
// together) and two more (fix_t).  Only the masks change; the values stay
// the tensor cores'.  A narrower model's padded columns, exactly 0 on both
// sides, hold no tie: t's past the model's width, the slot relus' past its
// message width (msg_width; a model with msg_hidden != hidden runs on packs
// padded to the larger, then to 128).  At d=11 on random weights about 1.5
// slot masks and 0.4 rows of t a sample and round fall in the band, 5% of
// the time (the rows of t nearly all of it); the gradients came out the same
// for z bands from 16 times wider to 4 times narrower and t bands up to 64
// times wider (scripts/k2b_probe.py counts the ties).
//
// Shared memory at d=11 (M = N = 128 padded rows): the f32 panels (131,072
// B), one f32 chunk buffer (128 x 132 floats, 67,584 B) and the two slabs
// (32,768 B) make 231,424 B of the 232,448 a block may use.  So, as in f32
// K1, the slot tables are read from global memory (L1), and the readers
// tables and slot masks live in the block's scratch; one chunk buffer holds
// each product's A operand in turn, x read again from the stash (L2) for
// x @ ux and the residual.  dhs goes to the panel its direction gathered
// from, once S2 has read it (else to the scratch).  S5's staging (three
// arrays x three 32-row chunks, 156,672 B) overlays the panels and the
// chunk buffer.
//
// Where the panels do not fit (d=13: 280,576 B; the circuit d=5 and d=7
// graphs), the GP layout keeps them at the head of the block's scratch
// slice ((M + N) x 512 B more of it), swizzled as in shared memory, and
// shared memory holds the chunk buffer under S5's staging and the ring:
// 189,440 B whatever the graph.  Only where the panels live changes, not
// an operation or its order, so the two layouts give the same bits where
// both fit.  Every graph that fits keeps its panels in shared memory:
// gathers from global memory cost the forward kernels 10-27% where both
// fit, though on an H100 at d=11 this layout measured no slower.
//
// The residual scratch: six f32 arrays a direction and sample of the tile,
// 6.3 MB a block at d=11 with a tile of 8, written in S2-S4 and read in S4
// and S5; a tile of 8 loads and stores each block's 640 KB partial once per
// 8 samples and round.
//
// Width: the LayerNorm and its adjoint run over the first `width` columns
// (a test at run time, as in f32 K1); the padded columns of the stash and
// the packs are zero, and no cotangent reaches one.  The message lanes are
// the first `msg_width` columns of the slot gathers.
//
// Bounds on an H100 at d=11, H=128, per sample and round: the replay's 10
// products, the adjoint's 10 and the 10 weight-gradient products, 30
// [rows, 128] x [128, 128] products on the 241 real rows, 119 MFLOP (6.8
// TFLOP at B=4096, R=14).  At the f32 CUDA-core peak (67 TFLOP/s) that is
// 102 ms, the floor of an FMA design; as 3xTF32 (three TF32 products an f32
// one at 495 TFLOP/s) 41.4 ms.  The bytes (the stash, 7.1 GB in f32) take
// 2.1 ms at 3.35 TB/s, the residual scratch's write and read about 25 ms
// more where they miss L2.  It measured 386 ms on an H100 (17.7 TFLOP/s;
// the FMA kernel it replaces 502-505 ms): S2 48% of a block's cycles, S5
// 24%, S4 18%, at 255 registers with spills.

#include "backward_common.cuh"
#include "rounds_mma.cuh"

namespace {

using namespace rounds;
using namespace rounds::bwd;
using namespace rounds::tf32;
using tc::ld_vec2;
using tc::mask_columns;
using tc::quad_sum;
using tc::cp_async_wait_all;

namespace t3b {

constexpr int SR = 16, NS = 2;   // the weight ring: two 16-row slabs of split weights
constexpr int TILE = 8;          // samples per tile
constexpr int RS = 32;           // rows per staged chunk of the weight-gradient products
constexpr int NSTAGE = 3;        // staged chunks in flight or in use: 2 loading ahead
constexpr int LDS = H + 8;       // f32 row stride of the staged rows
constexpr size_t STAGE_BYTES = size_t(NSTAGE) * 3 * RS * LDS * sizeof(float);
// The tie bands, in units of the bound |x| |w_c| on the sum of |x_k w_kc|
// that a product's rounding scales with: |z| below TAU_Z of it, |t| below
// TAU_T of it (which also covers hs's share of z's differences).  Both
// products' rounding is some 2^-24 of it.
constexpr float TAU_Z = 1.f / 1048576;   // 2^-20
constexpr float TAU_T = 1.f / 1048576;

__host__ __device__ inline size_t panel_bytes(int rows) {
  return align16(size_t(rows) * H * sizeof(float));
}

// The panels (but with GP, whose panels are in the scratch) and the chunk
// buffer, or S5's staging where that is more.
template <bool GP>
__host__ __device__ inline size_t work_bytes(int M, int N) {
  const size_t w = (GP ? 0 : panel_bytes(N) + panel_bytes(M)) + CHUNK_BYTES;
  return w > STAGE_BYTES ? w : STAGE_BYTES;
}

template <bool GP>
__host__ __device__ inline size_t smem_bytes(int M, int N) {
  return work_bytes<GP>(M, N) + ring_bytes(SR, NS);
}

struct Smem {
  float* ys_c;   // [N][H] swizzled, gathered by check rows
  float* ys_q;   // [M][H] swizzled, gathered by qubit rows
  float* xs;     // [CR][LDX] the chunk's A operand
  float* stage;  // S5's staging, from the start: over the panels (but with
                 //   GP) and the chunk buffer
  float* ring;   // [NS][SR / 8][KSTEP] weight slabs
};

// panels: with GP the block's panels [N + M][H] in its scratch slice
template <bool GP>
__device__ Smem carve(unsigned char* base, int M, int N, float* panels) {
  Smem s;
  size_t o = 0;
  if (GP) {
    s.ys_c = panels;
    s.ys_q = panels + size_t(N) * H;
  } else {
    s.ys_c = reinterpret_cast<float*>(base);
    s.ys_q = reinterpret_cast<float*>(base + panel_bytes(N));
    o = panel_bytes(N) + panel_bytes(M);
  }
  s.xs = reinterpret_cast<float*>(base + o);
  s.stage = reinterpret_cast<float*>(base);
  s.ring = reinterpret_cast<float*>(base + work_bytes<GP>(M, N));
  return s;
}

// Bytes of the two readers tables.
__host__ __device__ inline size_t table_bytes(int M, int N, int Dc, int Dq) {
  return align16(size_t(N + 1 + M * Dc) * sizeof(int)) +
         align16(size_t(M + 1 + N * Dq) * sizeof(int));
}

// Bytes of scratch one block needs: with GP the panels, then the readers
// tables, the slot masks, slot ties and dhs of one sample, a row of hs a
// warp, and the tile's six f32 residual arrays per direction.
__host__ __device__ inline size_t scratch_bytes(int M, int N, int Dc, int Dq, bool gp) {
  return (gp ? panel_bytes(N) + panel_bytes(M) : 0) + table_bytes(M, N, Dc, Dq) +
         2 * 16 * size_t(M * Dc + N * Dq) +
         size_t(M + N) * H * sizeof(float) + size_t(WARPS) * H * sizeof(float) +
         6 * size_t(TILE) * (M + N) * H * sizeof(float);
}

// One direction of a round over the tile.  Arrays marked [tile] hold the
// tile's samples one after another ([TILE * rows][H]); sample i starts at
// row i * rows.
struct Dir {
  const float* x;     // [tile] round-input states (the stash)
  float* g;           // [tile] state cotangent, rewritten in place
  int rows, D, src_rows;
  int width;          // the LayerNorm's columns
  int msg_width;      // the message lanes: the slot relus' columns
  const int* idx;     // [rows][D] slot table (global)
  const int* off;     // readers table of the gather (scratch): the slots
  const int* lst;     //   r * D + k that read source row s are lst[off[s] .. off[s+1])
  const float* ys;    // [src_rows][H] gathered panel (swizzled; with GP global)
  const float* W;     // the direction's 5 split matrices
  const float* WT;    // their transposes, split
  const float* vec;   // the direction's 7 vectors
  uint32_t* live;     // [rows][D][4] one sample's slot masks: bit 2 j + c of
                      //   word t is column 8 j + 2 t + c (relu(z) > 0)
  float* dhs_r;       // [rows][H] one sample's dhs, swizzled as a panel
  float *hs, *hc, *dpre, *dt, *dydb;   // [tile] residuals
  float* dys_src;     // [tile, src_rows]: this gather's adjoint onto its sources
  float* dys;         // [tile]: the other gather's adjoint onto these rows
  float* pmat;        // the block's partial of the direction's 5 matrices
  float* pvec;        // the block's per-warp vector partials, this direction
  // the ties (see the header): what the plain version's arithmetic reads
  const float* xsrc;    // [tile] the other direction's round-input states
  const float* W32;     // the direction's 5 matrices in f32, unsplit
  const float* W32T;    //   and their transposes
  const float* wsrc32;  // the f32 matrix that projects xsrc into ys
  const float* wsrc32T; //   and its transpose
  const float* xn;      // [tile] L2 norm of each row of x, this round
  const float* xn_src;  // [tile] of each row of xsrc
  float wn_wd, wn_ux, wn_wf, wn_src;   // the largest column norm of wd, ux, wf, wsrc32
  uint32_t* unc;      // [rows][D][4] one sample's slot ties, bits as live's
                      //   (0 but where fix_slots has a word to take)
  float* hsx;         // [WARPS][H] a row's hs as the plain version sums it
};

// Rows g and g + 8 of an m16 x n128 accumulator summed per column, into v
// for colsum_add.
__device__ __forceinline__ void rows_sum(const float (&a)[NT][4], float (&v)[32]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) v[2 * j + c] = a[j][c] + a[j][2 + c];
}

// (x1 . v1, x2 . v2) for rows v of the transposed matrices (columns of the
// matrices) as the plain version's f32 products form them on the card
// (cuBLAS: one FMA per k, k ascending, from 0), the two chains side by side.
__device__ __noinline__ float2 seq_dot2(const float* x1, const float* __restrict__ v1,
                                        const float* x2, const float* __restrict__ v2) {
  float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
  for (int k = 0; k < H; k += 4) {
    const float4 p1 = *reinterpret_cast<const float4*>(x1 + k);
    const float4 p2 = *reinterpret_cast<const float4*>(x2 + k);
    const float4 q1 = __ldg(reinterpret_cast<const float4*>(v1 + k));
    const float4 q2 = __ldg(reinterpret_cast<const float4*>(v2 + k));
    a1 = fmaf(p1.w, q1.w, fmaf(p1.z, q1.z, fmaf(p1.y, q1.y, fmaf(p1.x, q1.x, a1))));
    a2 = fmaf(p2.w, q2.w, fmaf(p2.z, q2.z, fmaf(p2.y, q2.y, fmaf(p2.x, q2.x, a2))));
  }
  return make_float2(a1, a2);
}

// The slot masks of row r (this lane's words) whose z fell within the tie
// band: taken again from z = ys[src][c] + ydb[r][c] of sample i as the
// plain version computes it.
__device__ __noinline__ void fix_slots(const Dir& d, int i, int r) {
  const int t = threadIdx.x & 3;
  const float* xr = d.x + (size_t(i) * d.rows + r) * H;
  for (int k = 0; k < d.D; ++k) {
    const size_t e = (size_t(r) * d.D + k) * 4 + t;
    uint32_t u = d.unc[e];
    if (u == 0u) continue;
    d.unc[e] = 0u;   // the words stay 0 but for this sample's ties
    uint32_t live = d.live[e];
    const float* xs = d.xsrc + (size_t(i) * d.src_rows + __ldg(d.idx + r * d.D + k)) * H;
    while (u != 0u) {
      const int b = __ffs(u) - 1;
      u &= u - 1;
      const int c = 8 * (b >> 1) + 2 * t + (b & 1);
      const float2 p = seq_dot2(xr, d.W32T + size_t(M_WD) * HH + c * H, xs, d.wsrc32T + c * H);
      const float z = __fadd_rn(p.y, __fadd_rn(p.x, __ldg(d.vec + V_B0 * H + c)));
      live = z > 0.f ? live | (1u << b) : live & ~(1u << b);
    }
    d.live[e] = live;
  }
}

// acc[q][e] = x_q . w[:, c0 + e] for 4 rows x_q and 4 columns, one FMA per
// k, k ascending (the plain version's order), k four at a time and four
// steps' loads issued together: the f32 matrices are rarely in L2 here, and
// the time goes in round trips to memory.
__device__ __forceinline__ void seq_dot_4x4(const float* const (&x)[4],
                                            const float* __restrict__ w, int c0,
                                            float (&acc)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < H; k += 4) {
    float4 wk[4], xq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wk[u] = __ldg(reinterpret_cast<const float4*>(w + (k + u) * H + c0));
#pragma unroll
    for (int q = 0; q < 4; ++q) xq[q] = *reinterpret_cast<const float4*>(x[q] + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float xv[4] = {xq[q].x, xq[q].y, xq[q].z, xq[q].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[q][0] = fmaf(xv[u], wk[u].x, acc[q][0]);
        acc[q][1] = fmaf(xv[u], wk[u].y, acc[q][1]);
        acc[q][2] = fmaf(xv[u], wk[u].z, acc[q][2]);
        acc[q][3] = fmaf(xv[u], wk[u].w, acc[q][3]);
      }
    }
  }
}

// hs of row r of sample i as the plain version sums it (each live slot's
// relu(z) in slot order, z as fix_slots takes it), into out[H]; the warp
// together, a lane 4 columns, 4 slots' ys at a time.
__device__ __noinline__ void hs_exact_row(const Dir& d, int i, int r, float* out) {
  const int c0 = 4 * (threadIdx.x & 31);
  const float* xr = d.x + (size_t(i) * d.rows + r) * H;
  float acc[4][4], ydb[4], h[4] = {0.f, 0.f, 0.f, 0.f};
  {
    const float* const xs[4] = {xr, xr, xr, xr};
    seq_dot_4x4(xs, d.W32 + size_t(M_WD) * HH, c0, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) ydb[e] = __fadd_rn(acc[0][e], __ldg(d.vec + V_B0 * H + c0 + e));
  }
  for (int s0 = 0; s0 < d.D; s0 += 4) {
    const float* xs[4];
    bool live[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // a masked slot reads row r and is left out
      const int src = s0 + q < d.D ? __ldg(d.idx + r * d.D + s0 + q) : -1;
      live[q] = src >= 0;
      xs[q] = live[q] ? d.xsrc + (size_t(i) * d.src_rows + src) * H : xr;
    }
    seq_dot_4x4(xs, d.wsrc32, c0, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!live[q]) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = __fadd_rn(h[e], fmaxf(__fadd_rn(acc[q][e], ydb[e]), 0.f));
    }
  }
  store4(out + c0, h);
}

// The t masks (tpos, a lane's rows g and g + 8) whose t fell within the
// tie band (tunc, bits as tpos'): taken again as the plain version computes
// t = x @ ux + hs @ wf + deg boa + syn ucs + ub0, hs of the row included.
// The whole warp calls this; it returns the new masks.
__device__ __noinline__ uint2 fix_t(const Dir& d, int i, int r0, uint32_t tu0, uint32_t tu1,
                                    uint32_t tp0, uint32_t tp1, float deg0, float deg1,
                                    float sv0, float sv1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* buf = d.hsx + (threadIdx.x >> 5) * H;
  for (int h = 0; h < 2; ++h) {
    const uint32_t tu = h ? tu1 : tu0;
    uint32_t rows = __ballot_sync(0xffffffffu, tu != 0u);   // lane 4 g + t: row g + 8 h
    while (rows != 0u) {
      const int gg = (__ffs(rows) - 1) >> 2;
      rows &= ~(0xfu << (4 * gg));
      const int r = r0 + gg + 8 * h;
      hs_exact_row(d, i, r, buf);
      __syncwarp();
      if (g == gg) {
        uint32_t u = tu, tp = h ? tp1 : tp0;
        const float deg = h ? deg1 : deg0, sv = h ? sv1 : sv0;
        const float* xr = d.x + (size_t(i) * d.rows + r) * H;
        while (u != 0u) {
          const int b = __ffs(u) - 1;
          u &= u - 1;
          const int c = 8 * (b >> 1) + 2 * t + (b & 1);
          const float2 p = seq_dot2(xr, d.W32T + size_t(M_UX) * HH + c * H, buf,
                                    d.W32T + size_t(M_WF) * HH + c * H);
          float v = __fadd_rn(p.x, p.y);
          v = __fadd_rn(v, __fmul_rn(deg, __ldg(d.vec + V_BOA * H + c)));
          v = __fadd_rn(v, __fmul_rn(sv, __ldg(d.vec + V_UCS * H + c)));
          v = __fadd_rn(v, __ldg(d.vec + V_UB0 * H + c));
          tp = v > 0.f ? tp | (1u << b) : tp & ~(1u << b);
        }
        if (h) tp1 = tp;
        else tp0 = tp;
      }
      __syncwarp();   // every lane is done with buf
    }
  }
  return make_uint2(tp0, tp1);
}

// S2: replay one direction's update for sample i and chain the adjoint down
// to dpre (written to the state cotangent), dhs and dydb.  The check
// direction passes its syndrome (syn, dsyn, ucs32), the qubit direction
// nullptr.  `after` is the product that follows.
__device__ __noinline__ void replay_adjoint(const Dir& dref, int i, const float* syn,
                                            float* dsyn, const float* ucs32, float* xs,
                                            Ring<SR, NS>& rgref, const float* after) {
  // local copies, held in registers: a store through a pointer cannot change them
  const Dir d = dref;
  Ring<SR, NS> rg = rgref;
  const bool with_syn = syn != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rows = d.rows;
  const size_t so = size_t(i) * rows * H;
  const float* x = d.x + so;
  float* gs = d.g + so;
  float* xa = xs + 16 * warp * LDX;
  float* pv = d.pvec + size_t(warp) * 14 * H;
  const float* wd = d.W + size_t(M_WD) * MAT;
  const float* ux = d.W + size_t(M_UX) * MAT;
  const float* wf = d.W + size_t(M_WF) * MAT;
  const float* w1 = d.W + size_t(M_W1) * MAT;
  const float* wft = d.WT + size_t(M_WF) * MAT;
  const float* w1t = d.WT + size_t(M_W1) * MAT;
  const float inv_w = 1.f / d.width;
  // this lane's columns within the model's width (t) and message width
  // (the slot relus), bits as live's: a narrower model's padded columns are
  // 0 here and in the plain version, so they hold no tie
  uint32_t cols = 0u, zcols = 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int c = 8 * (b >> 1) + 2 * t + (b & 1);
    cols |= (c < d.width ? 1u : 0u) << b;
    zcols |= (c < d.msg_width ? 1u : 0u) << b;
  }

  for (int row0 = 0; row0 < rows; row0 += CR) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, rows - r0));
    const bool active = n > 0;
    load_rows_warp(xa, x + size_t(r0) * H, n);
    float acc[NT][4];

    // ydb = x @ wd + b0; the slot gather-sum hs and the slots' relu masks;
    // hs replaces x in the chunk buffer
    mma_pass<SR, NS>(xa, wd, rg, wf, acc, active);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b0 = ld_vec2(d.vec, V_B0, 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[j][2 * h] += b0.x;
        acc[j][2 * h + 1] += b0.y;
      }
    }
    float deg[2], xn[2], hn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      float hsum[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) hsum[j][0] = hsum[j][1] = 0.f;
      deg[h] = 0.f;
      xn[h] = r < rows ? __ldg(d.xn + size_t(i) * rows + r) : 0.f;
      bool ties = false;
      if (r < rows) {
        for (int k = 0; k < d.D; ++k) {
          const int src = __ldg(d.idx + r * d.D + k);
          const size_t e = (size_t(r) * d.D + k) * 4 + t;
          uint32_t live = 0u;
          if (src >= 0) {
            deg[h] += 1.f;
            const float band = TAU_Z * (__ldg(d.xn_src + size_t(i) * d.src_rows + src) * d.wn_src +
                                        xn[h] * d.wn_wd);
            float near = band;   // the least |z|, or the band
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const float2 y = ld2(d.ys + swz(src, 8 * j + 2 * t));
              const float z0 = y.x + acc[j][2 * h], z1 = y.y + acc[j][2 * h + 1];
              hsum[j][0] += fmaxf(z0, 0.f);
              hsum[j][1] += fmaxf(z1, 0.f);
              live |= (z0 > 0.f ? 1u : 0u) << (2 * j);
              live |= (z1 > 0.f ? 1u : 0u) << (2 * j + 1);
              near = fminf(near, fminf(fabsf(z0), fabsf(z1)));
            }
            if (near < band) {   // a tie: which columns, from the same z
              uint32_t unc = 0u;
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                const float2 y = ld2(d.ys + swz(src, 8 * j + 2 * t));
                unc |= (fabsf(y.x + acc[j][2 * h]) < band ? 1u : 0u) << (2 * j);
                unc |= (fabsf(y.y + acc[j][2 * h + 1]) < band ? 1u : 0u) << (2 * j + 1);
              }
              unc &= zcols;
              if (unc != 0u) {
                d.unc[e] = unc;
                ties = true;
              }
            }
          }
          d.live[e] = live;
        }
      }
      if (ties) fix_slots(dref, i, r);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        sq += hsum[j][0] * hsum[j][0] + hsum[j][1] * hsum[j][1];
        st2(xa + (g + 8 * h) * LDX + c, hsum[j][0], hsum[j][1]);
        if (r < rows) st2(d.hs + so + size_t(r) * H + c, hsum[j][0], hsum[j][1]);
      }
      hn[h] = sqrtf(quad_sum(sq));
    }
    __syncwarp();

    // t = hs @ wf + x @ ux + deg boa + ub0 (+ syn ucs), its relu mask, hc;
    // x again from the stash for x @ ux, then hc replaces it
    mma_pass<SR, NS>(xa, wf, rg, ux, acc, active);
    load_rows_warp(xa, x + size_t(r0) * H, n);
    mma_pass<SR, NS, true>(xa, ux, rg, w1, acc, active);
    // (the qubit direction's syndrome row of the vector pack is zero)
    float sv[2], tband[2];
    uint32_t tpos[2] = {0u, 0u};     // bit 2 j + c of tpos[h]: t > 0
    uint32_t tunc[2] = {0u, 0u};     //   and of tunc[h]: t within the tie band
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      sv[h] = (with_syn && r < rows) ? syn[r] : 0.f;
      tband[h] = r < rows ? TAU_T * (xn[h] * d.wn_ux + hn[h] * d.wn_wf) : -1.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 boa = ld_vec2(d.vec, V_BOA, c), ub0 = ld_vec2(d.vec, V_UB0, c);
      const float2 ucs = ld_vec2(d.vec, V_UCS, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        float t0 = acc[j][2 * h] + deg[h] * boa.x + ub0.x;
        float t1 = acc[j][2 * h + 1] + deg[h] * boa.y + ub0.y;
        if (with_syn) {
          t0 += sv[h] * ucs.x;
          t1 += sv[h] * ucs.y;
        }
        tpos[h] |= (t0 > 0.f ? 1u : 0u) << (2 * j);
        tpos[h] |= (t1 > 0.f ? 1u : 0u) << (2 * j + 1);
        tunc[h] |= (fabsf(t0) < tband[h] ? 1u : 0u) << (2 * j);
        tunc[h] |= (fabsf(t1) < tband[h] ? 1u : 0u) << (2 * j + 1);
        st2(xa + (g + 8 * h) * LDX + c, fmaxf(t0, 0.f), fmaxf(t1, 0.f));
        if (r < rows) st2(d.hc + so + size_t(r) * H + c, fmaxf(t0, 0.f), fmaxf(t1, 0.f));
      }
    }
    tunc[0] &= cols;
    tunc[1] &= cols;
    if (__any_sync(0xffffffffu, (tunc[0] | tunc[1]) != 0u)) {
      const uint2 p = fix_t(dref, i, r0, tunc[0], tunc[1], tpos[0], tpos[1], deg[0], deg[1],
                            sv[0], sv[1]);
      tpos[0] = p.x;
      tpos[1] = p.y;
    }
    __syncwarp();

    // LayerNorm forward (the residual x from the stash) and backward -> dpre
    // (into g and the chunk buffer)
    mma_pass<SR, NS>(xa, w1, rg, w1t, acc, active);
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const float* xrow = x + size_t(r < rows ? r : 0) * H + 2 * t;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 ub1 = ld_vec2(d.vec, V_UB1, 8 * j + 2 * t);
        const float2 xv = r < rows ? ld2(xrow + 8 * j) : make_float2(0.f, 0.f);
        acc[j][2 * h] += xv.x + ub1.x;
        acc[j][2 * h + 1] += xv.y + ub1.y;
        sum += acc[j][2 * h] + acc[j][2 * h + 1];
      }
      const float mu = quad_sum(sum) * inv_w;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[j][2 * h + c] -= mu;
      if (d.width < H) mask_columns(acc, h, t, d.width);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) sq += acc[j][2 * h + c] * acc[j][2 * h + c];
      inv[h] = rsqrtf(quad_sum(sq) * inv_w + 1e-6f);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[j][2 * h + c] *= inv[h];   // nh
    }
    float gv[NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float2 gg = make_float2(0.f, 0.f);
        if (r < rows)
          gg = __ldcg(reinterpret_cast<const float2*>(gs + size_t(r) * H + 8 * j + 2 * t));
        gv[j][2 * h] = gg.x;
        gv[j][2 * h + 1] = gg.y;
      }
    }
    {
      float v[32];
      rows_sum(gv, v);
      colsum_add(v, pv + V_LNB * H);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          v[2 * j + c] = gv[j][c] * acc[j][c] + gv[j][2 + c] * acc[j][2 + c];
      colsum_add(v, pv + V_LNS * H);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {       // dnh = g * ln_scale
      const float2 lns = ld_vec2(d.vec, V_LNS, 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        gv[j][2 * h] *= lns.x;
        gv[j][2 * h + 1] *= lns.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s1 += gv[j][2 * h + c];
          s2 += gv[j][2 * h + c] * acc[j][2 * h + c];
        }
      const float m1 = quad_sum(s1) * inv_w;
      const float m2 = quad_sum(s2) * inv_w;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gv[j][2 * h + e] = inv[h] * (gv[j][2 * h + e] - m1 - acc[j][2 * h + e] * m2);
        if (c >= d.width) gv[j][2 * h] = 0.f;        // a narrower model's padded columns
        if (c + 1 >= d.width) gv[j][2 * h + 1] = 0.f;
        if (r < rows) {
          st2(gs + size_t(r) * H + c, gv[j][2 * h], gv[j][2 * h + 1]);
          st2(d.dpre + so + size_t(r) * H + c, gv[j][2 * h], gv[j][2 * h + 1]);
        }
        st2(xa + (g + 8 * h) * LDX + c, gv[j][2 * h], gv[j][2 * h + 1]);
      }
    }
    {
      float v[32];
      rows_sum(gv, v);
      colsum_add(v, pv + V_UB1 * H);
    }
    __syncwarp();

    // dhc = dpre @ w1^T; dt = dhc where t > 0
    mma_pass<SR, NS>(xa, w1t, rg, wft, acc, active);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (!((tpos[h] >> (2 * j + c)) & 1u)) acc[j][2 * h + c] = 0.f;
    {
      float v[32];
      rows_sum(acc, v);
      colsum_add(v, pv + V_UB0 * H);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) v[2 * j + c] = deg[0] * acc[j][c] + deg[1] * acc[j][2 + c];
      colsum_add(v, pv + V_BOA * H);
      if (with_syn) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) v[2 * j + c] = sv[0] * acc[j][c] + sv[1] * acc[j][2 + c];
        colsum_add(v, pv + V_UCS * H);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (with_syn) {
        float ds = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 u = ld_vec2(ucs32, 0, 8 * j + 2 * t);
          ds += acc[j][2 * h] * u.x + acc[j][2 * h + 1] * u.y;
        }
        ds = quad_sum(ds);
        if (t == 0 && r < rows) atomicAdd(dsyn + r, ds);   // this lane's element only
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        st2(xa + (g + 8 * h) * LDX + c, acc[j][2 * h], acc[j][2 * h + 1]);
        if (r < rows) st2(d.dt + so + size_t(r) * H + c, acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
    __syncwarp();

    // dhs = dt @ wf^T; dydb = the live slots' share of it, summed; dhs for S3
    mma_pass<SR, NS>(xa, wft, rg, row0 + CR < rows ? wd : after, acc, active);
    {
      float v[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) v[q] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r >= rows) continue;
        float dy[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) dy[j][0] = dy[j][1] = 0.f;
        for (int k = 0; k < d.D; ++k) {
          const uint32_t live = d.live[(size_t(r) * d.D + k) * 4 + t];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if ((live >> (2 * j + c)) & 1u) dy[j][c] += acc[j][2 * h + c];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = 8 * j + 2 * t;
          st2(d.dhs_r + swz(r, c), acc[j][2 * h], acc[j][2 * h + 1]);
          st2(d.dydb + so + size_t(r) * H + c, dy[j][0], dy[j][1]);
          v[2 * j] += dy[j][0];
          v[2 * j + 1] += dy[j][1];
        }
      }
      colsum_add(v, pv + V_B0 * H);
    }
  }
  rgref = rg;
}

// S3 for sample i: dys of every source row of the gather, in (row, slot)
// order over the readers table, each reader's share dhs where its slot was
// live.  A warp takes two source rows at a time, a lane 4 columns; the
// loads of up to 4 readers of each are in flight together.
__device__ __noinline__ void gather_adjoint(const Dir& dref, int i) {
  const Dir d = dref;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4;
  const int wlo = 2 * (lane & 1);     // the mask words of columns c0 .. c0 + 3
  const int bit = 2 * (lane >> 1);    //   and the bit of c0 in them
  float* dys = d.dys_src + size_t(i) * d.src_rows * H;
  for (int sr0 = warp; sr0 < d.src_rows; sr0 += 2 * WARPS) {
    float acc[2][4];
    int e[2], e1[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int sr = sr0 + v * WARPS;
      e[v] = sr < d.src_rows ? d.off[sr] : 0;
      e1[v] = sr < d.src_rows ? d.off[sr + 1] : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[v][q] = 0.f;
    }
    while (e[0] < e1[0] || e[1] < e1[1]) {
      float y[2][4][4];
      uint32_t lo[2][4], hi[2][4];
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          lo[v][u] = hi[v][u] = 0u;
          if (e[v] + u < e1[v]) {
            const int es = d.lst[e[v] + u];
            load4(d.dhs_r + swz(es / d.D, c0), y[v][u]);
            const uint2 w = *reinterpret_cast<const uint2*>(d.live + size_t(es) * 4 + wlo);
            lo[v][u] = w.x;
            hi[v][u] = w.y;
          }
        }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (e[v] + u < e1[v]) {
            acc[v][0] += ((lo[v][u] >> bit) & 1u) ? y[v][u][0] : 0.f;
            acc[v][1] += ((lo[v][u] >> (bit + 1)) & 1u) ? y[v][u][1] : 0.f;
            acc[v][2] += ((hi[v][u] >> bit) & 1u) ? y[v][u][2] : 0.f;
            acc[v][3] += ((hi[v][u] >> (bit + 1)) & 1u) ? y[v][u][3] : 0.f;
          }
        }
        e[v] += 4;
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int sr = sr0 + v * WARPS;
      if (sr < d.src_rows) store4(dys + size_t(sr) * H + c0, acc[v]);
    }
  }
}

// S4 for sample i: g = dpre + dydb @ wd^T + dys @ ws^T + dt @ ux^T, the
// three products into one accumulator and g read and written once.
__device__ __noinline__ void state_cotangent(const Dir& dref, int i, float* xs,
                                             Ring<SR, NS>& rgref, const float* after) {
  const Dir d = dref;
  Ring<SR, NS> rg = rgref;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t so = size_t(i) * d.rows * H;
  float* xa = xs + 16 * warp * LDX;
  float* gs = d.g + so;
  const float* wdt = d.WT + size_t(M_WD) * MAT;
  const float* wst = d.WT + size_t(M_WS) * MAT;
  const float* uxt = d.WT + size_t(M_UX) * MAT;
  for (int row0 = 0; row0 < d.rows; row0 += CR) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, d.rows - r0));
    const bool active = n > 0;
    float acc[NT][4];
    load_rows_warp(xa, d.dydb + so + size_t(r0) * H, n);
    mma_pass<SR, NS>(xa, wdt, rg, wst, acc, active);
    load_rows_warp(xa, d.dys + so + size_t(r0) * H, n);
    mma_pass<SR, NS, true>(xa, wst, rg, uxt, acc, active);
    load_rows_warp(xa, d.dt + so + size_t(r0) * H, n);
    mma_pass<SR, NS, true>(xa, uxt, rg, row0 + CR < d.rows ? wdt : after, acc, active);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= d.rows) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float2* p = reinterpret_cast<float2*>(gs + size_t(r) * H + 8 * j + 2 * t);
        const float2 v = __ldcg(p);
        *p = make_float2(v.x + acc[j][2 * h], v.y + acc[j][2 * h + 1]);
      }
    }
  }
  rgref = rg;
}

// S5: dW_p += A_p^T @ B_p over n rows, for NP products of the NA [n][H] f32
// arrays arr (A_p = arr[ia[p]], B_p = arr[ib[p]]), into the block's f32
// partials dW[p].  A warp owns rows 16 w .. 16 w + 15 of every dW_p.  The
// arrays pass through `stage` in RS-row chunks, NSTAGE - 1 of them loading
// ahead of the one the tensor cores work on; each 16-row slab of a chunk
// gets a fresh sum.
template <int NA, int NP>
__device__ __noinline__ void wgrad(const float* const (&arr)[NA], const int (&ia)[NP],
                                   const int (&ib)[NP], float* const (&dW)[NP], int n,
                                   float* stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[NP][NT][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = ld2(dW[p] + size_t(16 * warp + g + 8 * h) * H + 8 * j + 2 * t);
        acc[p][j][2 * h] = v.x;
        acc[p][j][2 * h + 1] = v.y;
      }
  const float* src[NA];    // register copies (the asm's memory clobbers would reload them)
  int pa[NP], pb[NP];
#pragma unroll
  for (int a = 0; a < NA; ++a) src[a] = arr[a];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    pa[p] = ia[p];
    pb[p] = ib[p];
  }
  auto buf = [&](int st, int a) { return stage + (size_t(st) * NA + a) * RS * LDS; };
  const int nch = (n + RS - 1) / RS;
  auto issue = [&](int ch) {     // one cp.async group per chunk, empty past the end
    constexpr int UPR = H / 4;   // 16-byte units per row
    if (ch < nch) {
      const int row0 = ch * RS, st = ch % NSTAGE;
#pragma unroll
      for (int a = 0; a < NA; ++a)
        for (int u = threadIdx.x; u < RS * UPR; u += THREADS) {
          const int r = u / UPR, c = (u - r * UPR) * 4;
          const bool ok = row0 + r < n;
          cp_async16(buf(st, a) + r * LDS + c, src[a] + size_t(ok ? row0 + r : 0) * H + c,
                     ok ? 16 : 0);
        }
    }
    cp_async_commit();
  };
  __syncthreads();    // the panels' and chunk buffer's last readers are done
#pragma unroll
  for (int ch = 0; ch < NSTAGE - 1; ++ch) issue(ch);
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait_group<NSTAGE - 2>();
    __syncthreads();  // chunk ch landed for all; every warp is done with ch - 1
    issue(ch + NSTAGE - 1);      // into ch - 1's stage
    const int st = ch % NSTAGE;
#pragma unroll
    for (int kk = 0; kk < RS; kk += 16) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        // A^T fragments of the slab's two k-steps: element (m, k) is staged
        // row kk + 8 s + k, column 16 warp + m
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float* a = buf(st, pa[p]) + (kk + 8 * s + t) * LDS + 16 * warp + g;
          split(a[0], ah[s][0], al[s][0]);
          split(a[8], ah[s][1], al[s][1]);
          split(a[4 * LDS], ah[s][2], al[s][2]);
          split(a[4 * LDS + 8], ah[s][3], al[s][3]);
        }
        const float* bm = buf(st, pb[p]) + (kk + t) * LDS + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float* b = bm + 8 * s * LDS + 8 * j;
            uint32_t bh[2], bl[2];
            split(b[0], bh[0], bl[0]);
            split(b[4 * LDS], bh[1], bl[1]);
            mma_tf32(c, al[s], bh[0], bh[1]);
            mma_tf32(c, ah[s], bl[0], bl[1]);
            mma_tf32(c, ah[s], bh[0], bh[1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][j][e] += c[e];
        }
      }
    }
  }
  __syncthreads();    // every warp is done with the staging buffers
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st2(dW[p] + size_t(16 * warp + g + 8 * h) * H + 8 * j + 2 * t, acc[p][j][2 * h],
            acc[p][j][2 * h + 1]);
}

// The direction's five weight gradients of one round over the tile's n rows.
__device__ void weight_grads(const Dir& d, int n, float* stage) {
  float* pm = d.pmat;
  {
    const float* const arr[3] = {d.x, d.dydb, d.dys};
    const int ia[2] = {0, 0}, ib[2] = {1, 2};
    float* const dw[2] = {pm + size_t(M_WD) * HH, pm + size_t(M_WS) * HH};
    wgrad<3, 2>(arr, ia, ib, dw, n, stage);
  }
  {
    const float* const arr[3] = {d.x, d.hs, d.dt};
    const int ia[2] = {0, 1}, ib[2] = {2, 2};
    float* const dw[2] = {pm + size_t(M_UX) * HH, pm + size_t(M_WF) * HH};
    wgrad<3, 2>(arr, ia, ib, dw, n, stage);
  }
  {
    const float* const arr[2] = {d.hc, d.dpre};
    const int ia[1] = {0}, ib[1] = {1};
    float* const dw[1] = {pm + size_t(M_W1) * HH};
    wgrad<2, 1>(arr, ia, ib, dw, n, stage);
  }
}

// mats and mats_t: the split packs (tf32_split_pack) of the matrices and of
// their transposes, 10 matrices of MAT floats each; for the ties mats32 and
// mats32_t the matrices and their transposes in f32, xn_c [R, B, M] and
// xn_q [R, B, N] the L2 norms of the stash's rows, wn [10] the largest
// column norm of each matrix.  GP: the panels in the scratch.
template <bool GP>
__global__ void __launch_bounds__(THREADS, 1)
fused_rounds_bwd_tf32x3_kernel(const float* __restrict__ stash_c,
                               const float* __restrict__ stash_q, const float* __restrict__ syn,
                               const int* __restrict__ idx_c, const int* __restrict__ idx_q,
                               const float* __restrict__ mats, const float* __restrict__ mats_t,
                               const float* __restrict__ mats32,
                               const float* __restrict__ mats32_t, const float* __restrict__ xn_c,
                               const float* __restrict__ xn_q, const float* __restrict__ wn,
                               const float* __restrict__ vecs, const float* __restrict__ ucs32,
                               float* dxc, float* dxq, float* dsyn, unsigned char* scratch,
                               float* part_mats, float* part_vecs, int B, int M, int N, int Dc,
                               int Dq, int R, int width, int msg_width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sc = scratch + size_t(blockIdx.x) * scratch_bytes(M, N, Dc, Dq, GP);
  auto take = [&](size_t bytes) { unsigned char* p = sc; sc += bytes; return p; };
  float* panels =
      GP ? reinterpret_cast<float*>(take(panel_bytes(N) + panel_bytes(M))) : nullptr;
  const Smem s = carve<GP>(smem_raw, M, N, panels);
  auto tile = [&](int rows) {
    return reinterpret_cast<float*>(take(size_t(TILE) * rows * H * sizeof(float)));
  };
  int* off_c = reinterpret_cast<int*>(take(align16(size_t(N + 1 + M * Dc) * sizeof(int))));
  int* off_q = reinterpret_cast<int*>(take(align16(size_t(M + 1 + N * Dq) * sizeof(int))));
  build_readers(idx_c, M, Dc, N, off_c, off_c + N + 1, true);
  build_readers(idx_q, N, Dq, M, off_q, off_q + M + 1, true);

  Dir c, q;
  c.width = q.width = width;
  c.msg_width = q.msg_width = msg_width;
  c.rows = M; c.D = Dc; c.src_rows = N;
  c.idx = idx_c; c.off = off_c; c.lst = off_c + N + 1; c.ys = s.ys_c;
  c.W = mats; c.WT = mats_t; c.vec = vecs;
  q.rows = N; q.D = Dq; q.src_rows = M;
  q.idx = idx_q; q.off = off_q; q.lst = off_q + M + 1; q.ys = s.ys_q;
  q.W = mats + size_t(NMAT) * MAT; q.WT = mats_t + size_t(NMAT) * MAT;
  q.vec = vecs + NVEC * H;
  c.live = reinterpret_cast<uint32_t*>(take(16 * size_t(M) * Dc));
  q.live = reinterpret_cast<uint32_t*>(take(16 * size_t(N) * Dq));
  c.unc = reinterpret_cast<uint32_t*>(take(16 * size_t(M) * Dc));
  q.unc = reinterpret_cast<uint32_t*>(take(16 * size_t(N) * Dq));
  for (int e = threadIdx.x; e < 4 * (M * Dc + N * Dq); e += THREADS) c.unc[e] = 0u;
  c.hsx = q.hsx = reinterpret_cast<float*>(take(size_t(WARPS) * H * sizeof(float)));
  c.W32 = mats32;
  q.W32 = mats32 + size_t(NMAT) * HH;
  c.W32T = mats32_t;
  q.W32T = mats32_t + size_t(NMAT) * HH;
  c.wsrc32 = q.W32 + size_t(M_WS) * HH;   // ys_c = x_q @ ws_c
  q.wsrc32 = c.W32 + size_t(M_WS) * HH;
  c.wsrc32T = q.W32T + size_t(M_WS) * HH;
  q.wsrc32T = c.W32T + size_t(M_WS) * HH;
  c.wn_wd = wn[M_WD]; c.wn_ux = wn[M_UX]; c.wn_wf = wn[M_WF]; c.wn_src = wn[NMAT + M_WS];
  q.wn_wd = wn[NMAT + M_WD]; q.wn_ux = wn[NMAT + M_UX]; q.wn_wf = wn[NMAT + M_WF];
  q.wn_src = wn[M_WS];
  c.dhs_r = reinterpret_cast<float*>(take(size_t(M) * H * sizeof(float)));
  q.dhs_r = reinterpret_cast<float*>(take(size_t(N) * H * sizeof(float)));
  // after S2 of one chunk of check rows has read ys_c for the last time
  if (M <= CR && M <= N) c.dhs_r = s.ys_c;
  if (N <= CR && N <= M) q.dhs_r = s.ys_q;
  c.hs = tile(M); c.hc = tile(M); c.dpre = tile(M); c.dt = tile(M); c.dydb = tile(M);
  c.dys_src = tile(N);
  q.hs = tile(N); q.hc = tile(N); q.dpre = tile(N); q.dt = tile(N); q.dydb = tile(N);
  q.dys_src = tile(M);
  c.dys = q.dys_src;        // the qubit gather's adjoint lands on check rows
  q.dys = c.dys_src;
  c.pmat = part_mats + size_t(blockIdx.x) * 10 * HH;
  q.pmat = c.pmat + size_t(NMAT) * HH;
  c.pvec = part_vecs + size_t(blockIdx.x) * WARPS * 14 * H;
  q.pvec = c.pvec + NVEC * H;

  const float* proj_q = q.W + size_t(M_WS) * MAT;   // ys_c = x_q @ ws_c
  const float* proj_c = c.W + size_t(M_WS) * MAT;   // ys_q = x_c @ ws_q
  Ring<SR, NS> rg{s.ring, 0};
  prime(rg, proj_q);
  const int ntiles = (B + TILE - 1) / TILE;
  for (int tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    const int b0 = tl * TILE;
    const int nt = min(TILE, B - b0);
    c.g = dxc + size_t(b0) * M * H;
    q.g = dxq + size_t(b0) * N * H;
    for (int r = R - 1; r >= 0; --r) {
      c.x = q.xsrc = stash_c + (size_t(r) * B + b0) * M * H;
      q.x = c.xsrc = stash_q + (size_t(r) * B + b0) * N * H;
      c.xn = q.xn_src = xn_c + (size_t(r) * B + b0) * M;
      q.xn = c.xn_src = xn_q + (size_t(r) * B + b0) * N;
      for (int i = 0; i < nt; ++i) {
        const int b = b0 + i;
        project_rows<SR, NS>(q.x + size_t(i) * N * H, N, proj_q, s.ys_c, s.xs, rg, proj_c);
        project_rows<SR, NS>(c.x + size_t(i) * M * H, M, proj_c, s.ys_q, s.xs, rg,
                             c.W + size_t(M_WD) * MAT);
        replay_adjoint(c, i, syn + size_t(b) * M, dsyn + size_t(b) * M, ucs32, s.xs, rg,
                       q.W + size_t(M_WD) * MAT);
        replay_adjoint(q, i, nullptr, nullptr, nullptr, s.xs, rg, c.WT + size_t(M_WD) * MAT);
        __syncthreads();   // every row's dhs and slot masks are written
        gather_adjoint(c, i);
        gather_adjoint(q, i);
        __syncthreads();   // every source row's dys is written
        state_cotangent(c, i, s.xs, rg, q.WT + size_t(M_WD) * MAT);
        state_cotangent(q, i, s.xs, rg, proj_q);
      }
      weight_grads(c, nt * M, s.stage);     // starts with a barrier
      weight_grads(q, nt * N, s.stage);
    }
  }
  cp_async_wait_all();
}

}  // namespace t3b

// The layout of a graph: the panels in the scratch (GP) only where they do
// not fit in shared memory.
bool gp_layout(int M, int N) { return t3b::smem_bytes<false>(M, N) > tc::SMEM_LIMIT; }

int launch(bool gp, const void* stash_c, const void* stash_q, const void* syn,
           const void* idx_c, const void* idx_q, const void* mats, const void* mats_t,
           const void* mats32, const void* mats32_t, const void* xn_c, const void* xn_q,
           const void* wn, const void* vecs, const void* ucs32, void* dxc, void* dxq,
           void* dsyn, void* scratch, void* part_mats, void* part_vecs, void* dmats,
           void* dvecs, int B, int M, int N, int Dc, int Dq, int R, int width, int msg_width,
           int grid, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || Dc <= 0 || Dq <= 0 || R <= 0 || grid <= 0 ||
      width <= 0 || width > H || msg_width <= 0 || msg_width > H)
    return int(cudaErrorInvalidValue);
  const size_t smem = gp ? t3b::smem_bytes<true>(M, N) : t3b::smem_bytes<false>(M, N);
  if (smem > tc::SMEM_LIMIT) return int(cudaErrorInvalidValue);
  float* pm = static_cast<float*>(part_mats);
  float* pv = static_cast<float*>(part_vecs);
  auto* kernel = gp ? &t3b::fused_rounds_bwd_tf32x3_kernel<true>
                    : &t3b::fused_rounds_bwd_tf32x3_kernel<false>;
  return launch_adjoint(
      kernel, grid, smem, static_cast<cudaStream_t>(stream), pm, pv, static_cast<float*>(dmats),
      static_cast<float*>(dvecs), static_cast<const float*>(stash_c),
      static_cast<const float*>(stash_q), static_cast<const float*>(syn),
      static_cast<const int*>(idx_c), static_cast<const int*>(idx_q),
      static_cast<const float*>(mats), static_cast<const float*>(mats_t),
      static_cast<const float*>(mats32), static_cast<const float*>(mats32_t),
      static_cast<const float*>(xn_c), static_cast<const float*>(xn_q),
      static_cast<const float*>(wn), static_cast<const float*>(vecs),
      static_cast<const float*>(ucs32), static_cast<float*>(dxc), static_cast<float*>(dxq),
      static_cast<float*>(dsyn), static_cast<unsigned char*>(scratch), pm, pv, B, M, N, Dc,
      Dq, R, width, msg_width);
}

}  // namespace

extern "C" {

// Shared memory one block of the layout the graph takes needs.
long long fused_rounds_bwd_smem_bytes(int M, int N, int Dc, int Dq) {
  return (long long)(gp_layout(M, N) ? t3b::smem_bytes<true>(M, N)
                                     : t3b::smem_bytes<false>(M, N));
}

// Samples a block takes at a time.
int fused_rounds_bwd_tile() { return t3b::TILE; }

// Bytes of scratch one block of the layout the graph takes needs.
long long fused_rounds_bwd_scratch_bytes(int M, int N, int Dc, int Dq) {
  return (long long)t3b::scratch_bytes(M, N, Dc, Dq, gp_layout(M, N));
}

// 1 where the graph takes the layout with the panels in the scratch.
int fused_rounds_bwd_gpanels(int M, int N, int Dc, int Dq) { return gp_layout(M, N) ? 1 : 0; }

// Bytes of scratch one block of that layout needs on any graph.
long long fused_rounds_bwd_gpanels_scratch_bytes(int M, int N, int Dc, int Dq) {
  return (long long)t3b::scratch_bytes(M, N, Dc, Dq, true);
}

// As fused_backward.cu's fused_rounds_bwd_launch, for f32 states: stash_c
// [R, B, M, 128] and stash_q [R, B, N, 128] f32; mats and mats_t the split
// packs (fused_decoder.py::tf32_split_pack) of the matrices and of their
// transposes; for the ties mats32 and mats32_t the matrices [10, 128, 128]
// and their transposes in f32, xn_c [R, B, M] and xn_q [R, B, N] the L2
// norms of the stash's rows and wn [10] the largest column norm of each
// matrix; scratch grid x fused_rounds_bwd_scratch_bytes; msg_width (<=
// 128) the model's message width, the slot gathers' columns past it zero.
// The layout is the graph's (fused_rounds_bwd_gpanels).  Returns the first
// launch error (0 on success).
int fused_rounds_bwd_launch(const void* stash_c, const void* stash_q, const void* syn,
                            const void* idx_c, const void* idx_q, const void* mats,
                            const void* mats_t, const void* mats32, const void* mats32_t,
                            const void* xn_c, const void* xn_q, const void* wn,
                            const void* vecs, const void* ucs32, void* dxc, void* dxq,
                            void* dsyn, void* scratch, void* part_mats, void* part_vecs,
                            void* dmats, void* dvecs, int B, int M, int N, int Dc, int Dq,
                            int R, int width, int msg_width, int grid, void* stream) {
  return launch(gp_layout(M, N), stash_c, stash_q, syn, idx_c, idx_q, mats, mats_t, mats32,
                mats32_t, xn_c, xn_q, wn, vecs, ucs32, dxc, dxq, dsyn, scratch, part_mats,
                part_vecs, dmats, dvecs, B, M, N, Dc, Dq, R, width, msg_width, grid, stream);
}

// fused_rounds_bwd_launch in the layout with the panels in the scratch on
// any graph (scratch: grid x fused_rounds_bwd_gpanels_scratch_bytes), to
// hold it to the shared-panel layout where both fit.
int fused_rounds_bwd_gpanels_launch(const void* stash_c, const void* stash_q, const void* syn,
                                    const void* idx_c, const void* idx_q, const void* mats,
                                    const void* mats_t, const void* mats32,
                                    const void* mats32_t, const void* xn_c, const void* xn_q,
                                    const void* wn, const void* vecs, const void* ucs32,
                                    void* dxc, void* dxq, void* dsyn, void* scratch,
                                    void* part_mats, void* part_vecs, void* dmats, void* dvecs,
                                    int B, int M, int N, int Dc, int Dq, int R, int width,
                                    int msg_width, int grid, void* stream) {
  return launch(true, stash_c, stash_q, syn, idx_c, idx_q, mats, mats_t, mats32, mats32_t,
                xn_c, xn_q, wn, vecs, ucs32, dxc, dxq, dsyn, scratch, part_mats, part_vecs,
                dmats, dvecs, B, M, N, Dc, Dq, R, width, msg_width, grid, stream);
}

}  // extern "C"
