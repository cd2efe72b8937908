// Backward of the R weight-tied rounds with bf16 states (K2b, Hopper).
//
// Replaces the TPU kernel
// tpugnn/kernels/fused_backward.py::make_kernel_vjp_rounds._bwd (pl.pallas_call
// at :624, body _make_bwd_kernel at :273); fused_backward_tf32.cu is its
// counterpart for f32 states, on this kernel's schedule.  The function is the
// one tpugnn_torch/kernels/fused_backward.py::rounds_vjp_plain computes: the
// rounds in reverse, each replayed from the stash that K2a wrote (its input
// states) and then the adjoint, with the cotangents dpre, dt, each slot's
// share of dz, dydb and dys rounded to the state type where the TPU kernel
// rounds them.
//
// Design.  A persistent grid of about one 256-thread block per SM, on the
// tensor cores (tcb:: below).  Every operand of every product is a bf16
// value (the stash, hs and hc, the packs, and dpre, dt, dydb and dys, which
// both versions round before their products), so mma.sync.m16n8k16 bf16
// with f32 accumulation forms the plain version's products; only the f32
// summation order differs.  A block takes a tile of 8 samples.  Per round
// and sample, on whole-side chunks of 128 rows (rounds_mma.cuh), each
// weight matrix staged once per side, sample and round:
//   S1  replay the gather panels ys_c = rnd(x_q @ ws_c), ys_q = rnd(x_c @ ws_q)
//       into shared memory (as K1);
//   S2  per direction: replay the update (the slot gather-sum, the folded
//       aggregation, the update MLP and the LayerNorm), then at once the
//       adjoint: LayerNorm backward, dpre_r @ W1^T, the relu mask of the
//       pre-activation, dt_r @ Wf^T -> dhs, and dydb from the slot masks S2
//       records and its dhs in registers;
//   S3  per direction, dys of every source row, a gather over the readers
//       table (for each source row, the slots that read it, in (row, slot)
//       order), so the scatter needs no atomics.  Each block builds the two
//       readers tables once, from the slot tables;
//   S4  per direction, the state cotangent
//       g = dpre + dydb_r @ wd^T + dys_r @ ws^T + dt_r @ ux^T;
// writing the six bf16-valued residuals (hs, hc, dpre_r, dt_r, dydb_r,
// dys_r) to the tile's bf16 scratch.  S5 then reduces the round's ten
// weight-gradient products x^T @ dy over the tile's 8 x rows rows in one
// pass each, ldmatrix.trans feeding A^T, into the block's own f32 partial in
// global memory: so a block's partial (640 KB) is loaded and stored once per
// tile and round, 9.4 GB at B=4096, R=14 against 75 GB once per sample.
// Bias gradients go to per-warp partials.  A second launch sums the blocks'
// partials in a fixed order, so a gradient is the same from run to run (no
// float atomics across threads).
//
// Where things live (d=11): the two gather panels, two [128][136] chunk
// buffers (S5 stages its rows over these four), a double-buffered weight
// slab, the slot and readers tables and the slot masks in shared memory
// (195,616 B); rnd(dhs) in the gathered panel once S2 no longer reads it;
// the running state cotangents in the dxc/dxq outputs; the tile's residuals
// in its bf16 scratch (3 MB a block).  Where no layout with the panels in
// shared memory fits (circuit d=7: 920 + 176 rows, 280,576 B of bf16 panels
// alone), the GP layouts keep the two swizzled panels at the head of the
// block's scratch instead, read and written through the same generic loads
// and stores; S5's staging (104,448 B) then overlays only the chunk buffers.
// There 64-row slabs come before the slot masks: at circuit d=7 64-row
// slabs with the masks in the scratch (178,112 B) took 391-393 ms against
// 437 for 32-row slabs with the masks in shared memory (229,568 B; B=4096,
// R=8, H100, scripts/k2b_gp_probe.py).  The panels (37 MB over 132 blocks) fit
// in the 50 MB L2 and the residuals streamed through the same scratch (13.8
// MB a block at circuit d=7) do not, yet storing those with evict-first
// hints bought nothing measurable: they do not push the panels out.
//
// Width: as the forward's (fused_rounds.cu).  The stash and the packs come
// zero-padded to 128 columns, and the LayerNorm runs over the model's first
// `width` columns; its backward is the derivative of that masked forward, so
// dpre is 0 on every padded column, and no cotangent reaches one.  The
// masking is compiled in only for width < 128 (MASK).
//
// Bounds on an H100 at d=11, H=128, per sample and round: the replay's 10
// products, the adjoint's 10 and the 10 weight-gradient products are 30
// [rows, 128] x [128, 128] products, about 3x K1's 39.7 MFLOP, plus the stash
// read (the bytes term, 3.76 GB at B=4096, R=14 in bf16, 1.1 ms).  So it is
// bound by operations: 6.8 TFLOP, 6.9 ms at the bf16 tensor-core peak.  It
// measured 139 ms on an H100 (49 TFLOP/s): its time is in the per-sample
// epilogues of S2-S4 and their memory traffic, not in the products.

#include "backward_common.cuh"
#include "rounds_mma.cuh"

namespace {

using namespace rounds;
using namespace rounds::bwd;

// ---------------------------------------------------------------------------
// The bf16 path on tensor cores (rounds_mma.cuh).  A block takes a tile of
// TILE samples and walks the rounds R-1 ... 0 over the whole tile.  In each
// round, per sample, on whole-side chunks of 128 rows (a second, ragged
// chunk for larger sides), one weight matrix per product:
//   S1  the two gather panels;
//   S2  per direction, the replay (x @ wd, the slot gather-sum and its relu
//       masks, hs @ wf + x @ ux, hc @ w1, the LayerNorm), then the adjoint
//       (the LayerNorm backward -> dpre, written to g; dpre_r @ w1^T, the
//       relu mask of t, dt_r @ wf^T -> dhs), then dydb (the slot masks of
//       the row applied to its dhs, in registers);
//   S3  per direction, dys of every source row: a gather over the readers
//       table of the rounded dhs rows under their slot masks (both in shared
//       memory where there is room);
//   S4  per direction, g += dydb_r @ wd^T + dys_r @ ws^T + dt_r @ ux^T, one
//       accumulator, g read and written once.
// The residuals the weight gradients read (hs, hc, dpre_r, dt_r, dydb_r,
// dys_r: all bf16 values) go to the tile's scratch in bf16.  Then S5 forms
// the ten weight gradients of the round as products that reduce over the
// tile's TILE * rows rows, A^T read with ldmatrix.trans, the rows staged
// through shared memory in 32-row chunks (cp.async, 3 loading ahead): each
// f32 partial of the block is loaded and stored once per tile and round, not
// once per sample and round.  Column sums (the bias gradients) leave the
// fragment layout by a shuffle reduce-scatter over the 8 lanes that share a
// column set.
namespace tcb {

using namespace rounds::tc;

constexpr int TILE = 8;     // samples per tile
constexpr int RS = 32;      // rows per staged chunk of the weight-gradient products
constexpr int NSTAGE = 4;   // staged chunks in flight or in use: 3 loading ahead
// S5 stages the rows of up to three arrays over the panels and chunk buffers
constexpr size_t STAGE_BYTES = size_t(NSTAGE) * 3 * RS * LDB * sizeof(bf16);

// The panels (not with gp: they are in the scratch) and the two chunk
// buffers, or S5's staging where that is more.
__host__ __device__ inline size_t work_bytes(int M, int N, bool gp) {
  size_t w = 2 * CHUNK_BYTES;
  if (!gp) w += align16(size_t(N) * H * sizeof(bf16)) + align16(size_t(M) * H * sizeof(bf16));
  return w > STAGE_BYTES ? w : STAGE_BYTES;
}

// live: the slot masks of both directions in shared memory (else in the
// scratch); gp: the gather panels in the scratch (else in shared memory)
template <int SR>
__host__ __device__ inline size_t smem_bytes(int M, int N, int Dc, int Dq, bool live,
                                             bool gp) {
  size_t s = work_bytes(M, N, gp);
  if (live) s += 16 * size_t(M * Dc + N * Dq);
  s += slab_bytes(SR);
  s += align16(size_t(M) * Dc * sizeof(int));
  s += align16(size_t(N) * Dq * sizeof(int));
  s += align16(size_t(N + 1 + M * Dc) * sizeof(int));
  s += align16(size_t(M + 1 + N * Dq) * sizeof(int));
  return s;
}

struct Smem {
  bf16* ys_c;   // [N][H] swizzled, gathered by check rows
  bf16* ys_q;   // [M][H] swizzled, gathered by qubit rows
  bf16* xs;     // [CR][LDB] chunk buffer (A operand)
  bf16* hs;     // [CR][LDB] chunk buffer
  bf16* stage;  // S5's staging: the start of the panels and chunk buffers
  bf16* slab;   // [2][SR][LDB] weight slabs
  int *idx_c, *idx_q, *off_c, *lst_c, *off_q, *lst_q;
  uint32_t* live;   // [M * Dc + N * Dq][4] slot masks, or nullptr
};

// With GP the panels are left to the caller (the block's scratch).
template <int SR, bool GP>
__device__ Smem carve(unsigned char* base, int M, int N, int Dc, int Dq, bool live) {
  Smem s;
  size_t o = 0;
  s.stage = reinterpret_cast<bf16*>(base);
  s.ys_c = s.ys_q = nullptr;
  if (!GP) {
    s.ys_c = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(N) * H * sizeof(bf16));
    s.ys_q = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(M) * H * sizeof(bf16));
  }
  s.xs = reinterpret_cast<bf16*>(base + o);    o += CHUNK_BYTES;
  s.hs = reinterpret_cast<bf16*>(base + o);
  o = work_bytes(M, N, GP);
  s.slab = reinterpret_cast<bf16*>(base + o);  o += slab_bytes(SR);
  s.idx_c = reinterpret_cast<int*>(base + o);  o += align16(size_t(M) * Dc * sizeof(int));
  s.idx_q = reinterpret_cast<int*>(base + o);  o += align16(size_t(N) * Dq * sizeof(int));
  s.off_c = reinterpret_cast<int*>(base + o);
  s.lst_c = s.off_c + N + 1;                   o += align16(size_t(N + 1 + M * Dc) * sizeof(int));
  s.off_q = reinterpret_cast<int*>(base + o);
  s.lst_q = s.off_q + M + 1;                   o += align16(size_t(M + 1 + N * Dq) * sizeof(int));
  s.live = live ? reinterpret_cast<uint32_t*>(base + o) : nullptr;
  return s;
}

// Bytes of scratch one block needs: with gp the two gather panels, then the
// slot masks and the rounded dhs of one sample, and the tile's six bf16
// residual arrays per direction.
__host__ __device__ inline size_t scratch_bytes(int M, int N, int Dc, int Dq, bool gp) {
  return (gp ? size_t(M + N) * H * sizeof(bf16) : 0) + 16 * size_t(M * Dc + N * Dq) +
         size_t(M + N) * H * sizeof(bf16) + 6 * size_t(TILE) * (M + N) * H * sizeof(bf16);
}

// One direction of a round over the tile.  Arrays marked [tile] hold the
// tile's samples one after another ([TILE * rows][H]); sample i starts at
// row i * rows.
struct Dir {
  const bf16* x;      // [tile] round-input states (the stash)
  float* g;           // [tile] state cotangent, rewritten in place
  int rows, D, src_rows;
  int width;          // the LayerNorm's columns
  const int* idx;     // [rows][D] (shared)
  const int* off;     // readers table of the gather (shared): the slots
  const int* lst;     //   r * D + k that read source row s are lst[off[s] .. off[s+1])
  const bf16* ys;     // [src_rows][H] gathered panel (swizzled; shared, or with GP
                      //   the block's scratch)
  const bf16* W;      // the direction's 5 matrices
  const bf16* WT;     // their transposes
  const float* vec;   // the direction's 7 vectors
  uint32_t* live;     // [rows][D][4] one sample's slot masks: bit 2 j + c of
                      //   word t is column 8 j + 2 t + c (relu(z) > 0)
  bf16* dhs_r;        // [rows][H] one sample's rnd(dhs), swizzled as a panel
  // (both in shared memory where there is room: dhs_r in the gathered panel,
  // which S2 no longer reads by the time it is written; else in the scratch)
  bf16 *hs, *hc, *dpre, *dt, *dydb;   // [tile] bf16 residuals
  bf16* dys_src;      // [tile, src_rows]: this gather's adjoint onto its sources
  bf16* dys;          // [tile]: the other gather's adjoint onto these rows
  float* pmat;        // the block's partial of the direction's 5 matrices
  float* pvec;        // the block's per-warp vector partials, this direction
};

// S2: replay one direction's update for sample i and chain the adjoint down
// to dpre (written to the state cotangent), dhs and dydb.
// The check direction passes its syndrome (syn, dsyn, ucs32), the qubit
// direction nullptr; one body serves both, to keep the code the block runs
// per sample small.  x_in_xs: the chunk buffer xs already holds the
// direction's states (S1 projected them last, in one chunk).  `after` is the
// product that follows.
template <int SR, bool MASK>
__device__ __noinline__ void replay_adjoint(const Dir& dref, int i, const float* syn,
                                            float* dsyn, const float* ucs32, const Smem& s,
                                            Slabs<SR>& slref, const bf16* after,
                                            bool x_in_xs) {
  // local copies, held in registers: a store through a pointer cannot change them
  const Dir d = dref;
  Slabs<SR> sl = slref;
  const bool with_syn = syn != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rows = d.rows;
  const size_t so = size_t(i) * rows * H;
  const bf16* x = d.x + so;
  float* gs = d.g + so;
  bf16* xa = s.xs + 16 * warp * LDB;
  bf16* ha = s.hs + 16 * warp * LDB;
  float* pv = d.pvec + size_t(warp) * 14 * H;
  const bf16* wd = d.W + size_t(M_WD) * HH;
  const bf16* ux = d.W + size_t(M_UX) * HH;
  const bf16* wf = d.W + size_t(M_WF) * HH;
  const bf16* w1 = d.W + size_t(M_W1) * HH;
  const bf16* wft = d.WT + size_t(M_WF) * HH;
  const bf16* w1t = d.WT + size_t(M_W1) * HH;

  for (int row0 = 0; row0 < rows; row0 += CR) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, rows - r0));
    const bool active = n > 0;
    if (!(x_in_xs && rows <= CR)) load_rows_warp(xa, x + size_t(r0) * H, n);
    float acc[NT][4];

    // ydb = x @ wd + b0; the slot gather-sum hs and the slots' relu masks
    mma_pass<SR>(xa, wd, sl, wf, acc, active);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b0 = ld_vec2(d.vec, V_B0, 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[j][2 * h] += b0.x;
        acc[j][2 * h + 1] += b0.y;
      }
    }
    float deg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      float hsum[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) hsum[j][0] = hsum[j][1] = 0.f;
      deg[h] = 0.f;
      if (r < rows) {
        for (int k = 0; k < d.D; ++k) {
          const int src = d.idx[r * d.D + k];
          uint32_t live = 0u;
          if (src >= 0) {
            deg[h] += 1.f;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const float2 y = ld_bf2(d.ys + swz(src, 8 * j + 2 * t));
              const float z0 = y.x + acc[j][2 * h], z1 = y.y + acc[j][2 * h + 1];
              hsum[j][0] += fmaxf(z0, 0.f);
              hsum[j][1] += fmaxf(z1, 0.f);
              live |= (z0 > 0.f ? 1u : 0u) << (2 * j);
              live |= (z1 > 0.f ? 1u : 0u) << (2 * j + 1);
            }
          }
          d.live[(size_t(r) * d.D + k) * 4 + t] = live;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        st_bf2(ha + (g + 8 * h) * LDB + 8 * j + 2 * t, hsum[j][0], hsum[j][1]);
    }
    store_rows_warp(d.hs + so + size_t(r0) * H, ha, n);

    // t = hs @ wf + x @ ux + deg boa + ub0 (+ syn ucs), its relu mask, hc
    mma_pass<SR>(ha, wf, sl, ux, acc, active);
    mma_pass<SR, true>(xa, ux, sl, w1, acc, active);
    // (the qubit direction's syndrome row of the vector pack is zero)
    float sv[2];
    uint32_t tpos[2] = {0u, 0u};     // bit 2 j + c of tpos[h]: t > 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      sv[h] = (with_syn && r < rows) ? syn[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 boa = ld_vec2(d.vec, V_BOA, c), ub0 = ld_vec2(d.vec, V_UB0, c);
      const float2 ucs = ld_vec2(d.vec, V_UCS, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t0 = acc[j][2 * h] + deg[h] * boa.x + ub0.x;
        float t1 = acc[j][2 * h + 1] + deg[h] * boa.y + ub0.y;
        if (with_syn) {
          t0 += sv[h] * ucs.x;
          t1 += sv[h] * ucs.y;
        }
        tpos[h] |= (t0 > 0.f ? 1u : 0u) << (2 * j);
        tpos[h] |= (t1 > 0.f ? 1u : 0u) << (2 * j + 1);
        st_bf2(ha + (g + 8 * h) * LDB + c, fmaxf(t0, 0.f), fmaxf(t1, 0.f));
      }
    }
    store_rows_warp(d.hc + so + size_t(r0) * H, ha, n);

    // LayerNorm forward and backward -> dpre (into g), dpre_r; the state
    // cotangent's loads are in flight during the product
    float gv[NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float2 gg = make_float2(0.f, 0.f);
        if (r < rows) gg = __ldcg(reinterpret_cast<const float2*>(gs + size_t(r) * H + 8 * j + 2 * t));
        gv[j][2 * h] = gg.x;
        gv[j][2 * h + 1] = gg.y;
      }
    }
    mma_pass<SR>(ha, w1, sl, w1t, acc, active);
    const float inv_w = MASK ? 1.f / d.width : 1.f / H;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 xv = ld_bf2(xa + (g + 8 * h) * LDB + c);
        const float2 ub1 = ld_vec2(d.vec, V_UB1, c);
        acc[j][2 * h] += xv.x + ub1.x;
        acc[j][2 * h + 1] += xv.y + ub1.y;
        sum += acc[j][2 * h] + acc[j][2 * h + 1];
      }
      const float mu = quad_sum(sum) * inv_w;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[j][2 * h + c] -= mu;
      if (MASK) mask_columns(acc, h, t, d.width);
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
    {
      float v[32];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) v[2 * j + c] = gv[j][c] + gv[j][2 + c];
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
        if (MASK) {   // a narrower model's padded columns
          if (c >= d.width) gv[j][2 * h] = 0.f;
          if (c + 1 >= d.width) gv[j][2 * h + 1] = 0.f;
        }
        if (r < rows)
          *reinterpret_cast<float2*>(gs + size_t(r) * H + c) =
              make_float2(gv[j][2 * h], gv[j][2 * h + 1]);
        st_bf2(xa + (g + 8 * h) * LDB + c, gv[j][2 * h], gv[j][2 * h + 1]);
      }
    }
    {
      float v[32];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) v[2 * j + c] = gv[j][c] + gv[j][2 + c];
      colsum_add(v, pv + V_UB1 * H);
    }
    store_rows_warp(d.dpre + so + size_t(r0) * H, xa, n);

    // dhc = dpre_r @ w1^T; dt = dhc where t > 0
    mma_pass<SR>(xa, w1t, sl, wft, acc, active);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (!((tpos[h] >> (2 * j + c)) & 1u)) acc[j][2 * h + c] = 0.f;
    {
      float v[32];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) v[2 * j + c] = acc[j][c] + acc[j][2 + c];
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
    if (with_syn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        float ds = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 u = ld_vec2(ucs32, 0, 8 * j + 2 * t);
          ds += acc[j][2 * h] * u.x + acc[j][2 * h + 1] * u.y;
        }
        ds = quad_sum(ds);
        if (t == 0 && r < rows) atomicAdd(dsyn + r, ds);   // this lane's element only
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        st_bf2(ha + (g + 8 * h) * LDB + 8 * j + 2 * t, acc[j][2 * h], acc[j][2 * h + 1]);
    store_rows_warp(d.dt + so + size_t(r0) * H, ha, n);

    // dhs = dt_r @ wf^T; dydb = the live slots' share of it, summed; rnd(dhs)
    // for S3
    mma_pass<SR>(ha, wft, sl, row0 + CR < rows ? wd : after, acc, active);
    {
      float v[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) v[q] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        float dy[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) dy[j][0] = dy[j][1] = 0.f;
        if (r < rows) {
          for (int k = 0; k < d.D; ++k) {
            const uint32_t live = d.live[(size_t(r) * d.D + k) * 4 + t];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                if ((live >> (2 * j + c)) & 1u) dy[j][c] += acc[j][2 * h + c];
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
            st_bf2(d.dhs_r + swz(r, 8 * j + 2 * t), acc[j][2 * h], acc[j][2 * h + 1]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          v[2 * j] += dy[j][0];
          v[2 * j + 1] += dy[j][1];
          st_bf2(xa + (g + 8 * h) * LDB + 8 * j + 2 * t, dy[j][0], dy[j][1]);
        }
      }
      colsum_add(v, pv + V_B0 * H);
    }
    store_rows_warp(d.dydb + so + size_t(r0) * H, xa, n);

  }
  slref = sl;
}

// S3 for sample i: dys of every source row of the gather, in (row, slot)
// order over the readers table, each reader's share rnd(dhs) where its slot
// was live.  A warp takes two source rows at a time, a lane 4 columns; the
// loads of up to 4 readers of each are in flight together.
__device__ __noinline__ void gather_adjoint(const Dir& dref, int i) {
  const Dir d = dref;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4;
  const int wlo = 2 * (lane & 1);     // the mask words of columns c0 .. c0 + 3
  const int bit = 2 * (lane >> 1);    //   and the bit of c0 in them
  bf16* dys = d.dys_src + size_t(i) * d.src_rows * H;
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

// S4 for sample i: g = dpre + dydb_r @ wd^T + dys_r @ ws^T + dt_r @ ux^T, the
// three products into one accumulator and g read and written once (its
// loads in flight during the products).
template <int SR>
__device__ __noinline__ void state_cotangent(const Dir& dref, int i, const Smem& s,
                                             Slabs<SR>& slref, const bf16* after) {
  const Dir d = dref;
  Slabs<SR> sl = slref;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t so = size_t(i) * d.rows * H;
  bf16* xa = s.xs + 16 * warp * LDB;
  bf16* ha = s.hs + 16 * warp * LDB;
  const bf16* wdt = d.WT + size_t(M_WD) * HH;
  const bf16* wst = d.WT + size_t(M_WS) * HH;
  const bf16* uxt = d.WT + size_t(M_UX) * HH;
  for (int row0 = 0; row0 < d.rows; row0 += CR) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, d.rows - r0));
    const bool active = n > 0;
    float* gs = d.g + so;
    float gv[NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float2 v = make_float2(0.f, 0.f);
        if (r < d.rows) v = __ldcg(reinterpret_cast<const float2*>(gs + size_t(r) * H + 8 * j + 2 * t));
        gv[j][2 * h] = v.x;
        gv[j][2 * h + 1] = v.y;
      }
    }
    load_rows_warp(xa, d.dydb + so + size_t(r0) * H, n);
    load_rows_warp(ha, d.dys + so + size_t(r0) * H, n);
    float acc[NT][4];
    mma_pass<SR>(xa, wdt, sl, wst, acc, active);
    mma_pass<SR, true>(ha, wst, sl, uxt, acc, active);
    load_rows_warp(xa, d.dt + so + size_t(r0) * H, n);
    mma_pass<SR, true>(xa, uxt, sl, row0 + CR < d.rows ? wdt : after, acc, active);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= d.rows) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(gs + size_t(r) * H + 8 * j + 2 * t) =
            make_float2(gv[j][2 * h] + acc[j][2 * h], gv[j][2 * h + 1] + acc[j][2 * h + 1]);
    }
  }
  slref = sl;
}

// S5: dW_p += A_p^T @ B_p over n rows, for NP products of the NA [n][H] bf16
// arrays arr (A_p = arr[ia[p]], B_p = arr[ib[p]]), into the block's f32
// partials dW[p].  A warp owns rows 16 w .. 16 w + 15 of every dW_p.  The
// arrays pass through `stage` in 32-row chunks, NSTAGE - 1 of them loading
// ahead of the one the tensor cores work on.
template <int NA, int NP>
__device__ __noinline__ void wgrad(const bf16* const (&arr)[NA], const int (&ia)[NP], const int (&ib)[NP],
                      float* const (&dW)[NP], int n, bf16* stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[NP][NT][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            dW[p] + size_t(16 * warp + g + 8 * h) * H + 8 * j + 2 * t);
        acc[p][j][2 * h] = v.x;
        acc[p][j][2 * h + 1] = v.y;
      }
  const bf16* src[NA];     // register copies (the asm's memory clobbers would reload them)
  int pa[NP], pb[NP];
#pragma unroll
  for (int a = 0; a < NA; ++a) src[a] = arr[a];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    pa[p] = ia[p];
    pb[p] = ib[p];
  }
  auto buf = [&](int st, int a) { return stage + (size_t(st) * NA + a) * RS * LDB; };
  const int nch = (n + RS - 1) / RS;
  auto issue = [&](int ch) {     // one cp.async group per chunk, empty past the end
    constexpr int UPR = H / 8;
    if (ch < nch) {
      const int row0 = ch * RS, st = ch % NSTAGE;
#pragma unroll
      for (int a = 0; a < NA; ++a)
        for (int u = threadIdx.x; u < RS * UPR; u += THREADS) {
          const int r = u / UPR, c = (u - r * UPR) * 8;
          const bool ok = row0 + r < n;
          cp_async16(buf(st, a) + r * LDB + c, src[a] + size_t(ok ? row0 + r : 0) * H + c,
                     ok ? 16 : 0);
        }
    }
    cp_async_commit();
  };
  __syncthreads();    // the panels' and chunk buffers' last readers are done
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
        uint32_t a[4];
        ldsm_x4_t(a, buf(st, pa[p]) + (kk + (lane & 7) + ((lane >> 4) << 3)) * LDB +
                         16 * warp + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int q = 0; q < NT / 2; ++q) {
          uint32_t b[4];
          ldsm_x4_t(b, buf(st, pb[p]) + (kk + (lane & 15)) * LDB + q * 16 + (lane >> 4) * 8);
          mma_bf16(acc[p][2 * q], a, b[0], b[1]);
          mma_bf16(acc[p][2 * q + 1], a, b[2], b[3]);
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
        *reinterpret_cast<float2*>(dW[p] + size_t(16 * warp + g + 8 * h) * H + 8 * j + 2 * t) =
            make_float2(acc[p][j][2 * h], acc[p][j][2 * h + 1]);
}

// The direction's five weight gradients of one round over the tile's n rows.
__device__ void weight_grads(const Dir& d, int n, const Smem& s) {
  float* pm = d.pmat;
  {
    const bf16* const arr[3] = {d.x, d.dydb, d.dys};
    const int ia[2] = {0, 0}, ib[2] = {1, 2};
    float* const dw[2] = {pm + size_t(M_WD) * HH, pm + size_t(M_WS) * HH};
    wgrad<3, 2>(arr, ia, ib, dw, n, s.stage);
  }
  {
    const bf16* const arr[3] = {d.x, d.hs, d.dt};
    const int ia[2] = {0, 1}, ib[2] = {2, 2};
    float* const dw[2] = {pm + size_t(M_UX) * HH, pm + size_t(M_WF) * HH};
    wgrad<3, 2>(arr, ia, ib, dw, n, s.stage);
  }
  {
    const bf16* const arr[2] = {d.hc, d.dpre};
    const int ia[1] = {0}, ib[1] = {1};
    float* const dw[1] = {pm + size_t(M_W1) * HH};
    wgrad<2, 1>(arr, ia, ib, dw, n, s.stage);
  }
}

template <int SR, bool MASK, bool GP>
__global__ void __launch_bounds__(THREADS, 1)
fused_rounds_bwd_tc_kernel(const bf16* __restrict__ stash_c, const bf16* __restrict__ stash_q,
                           const float* __restrict__ syn, const int* __restrict__ idx_c,
                           const int* __restrict__ idx_q, const bf16* __restrict__ mats,
                           const bf16* __restrict__ mats_t, const float* __restrict__ vecs,
                           const float* __restrict__ ucs32, float* dxc, float* dxq,
                           float* dsyn, unsigned char* scratch, float* part_mats,
                           float* part_vecs, int B, int M, int N, int Dc, int Dq, int R,
                           int live_smem, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve<SR, GP>(smem_raw, M, N, Dc, Dq, live_smem != 0);
  for (int e = threadIdx.x; e < M * Dc; e += THREADS) s.idx_c[e] = idx_c[e];
  for (int e = threadIdx.x; e < N * Dq; e += THREADS) s.idx_q[e] = idx_q[e];
  __syncthreads();
  build_readers(s.idx_c, M, Dc, N, s.off_c, s.lst_c, true);
  build_readers(s.idx_q, N, Dq, M, s.off_q, s.lst_q, true);

  unsigned char* sc = scratch + size_t(blockIdx.x) * scratch_bytes(M, N, Dc, Dq, GP);
  auto take = [&](size_t bytes) { unsigned char* p = sc; sc += bytes; return p; };
  if (GP) {
    s.ys_c = reinterpret_cast<bf16*>(take(size_t(N) * H * sizeof(bf16)));
    s.ys_q = reinterpret_cast<bf16*>(take(size_t(M) * H * sizeof(bf16)));
  }
  auto tile = [&](int rows) {
    return reinterpret_cast<bf16*>(take(size_t(TILE) * rows * H * sizeof(bf16)));
  };
  Dir c, q;
  c.width = q.width = width;
  c.rows = M; c.D = Dc; c.src_rows = N;
  c.idx = s.idx_c; c.off = s.off_c; c.lst = s.lst_c; c.ys = s.ys_c;
  c.W = mats; c.WT = mats_t; c.vec = vecs;
  q.rows = N; q.D = Dq; q.src_rows = M;
  q.idx = s.idx_q; q.off = s.off_q; q.lst = s.lst_q; q.ys = s.ys_q;
  q.W = mats + size_t(NMAT) * HH; q.WT = mats_t + size_t(NMAT) * HH;
  q.vec = vecs + NVEC * H;
  c.live = reinterpret_cast<uint32_t*>(take(16 * size_t(M) * Dc));
  q.live = reinterpret_cast<uint32_t*>(take(16 * size_t(N) * Dq));
  c.dhs_r = reinterpret_cast<bf16*>(take(size_t(M) * H * sizeof(bf16)));
  q.dhs_r = reinterpret_cast<bf16*>(take(size_t(N) * H * sizeof(bf16)));
  if (s.live != nullptr) {
    c.live = s.live;
    q.live = s.live + size_t(M) * Dc * 4;
  }
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

  const bf16* proj_q = q.W + size_t(M_WS) * HH;   // ys_c = rnd(x_q @ ws_c)
  const bf16* proj_c = c.W + size_t(M_WS) * HH;   // ys_q = rnd(x_c @ ws_q)
  Slabs<SR> sl{s.slab, 0};
  prime(sl, proj_q);
  const int ntiles = (B + TILE - 1) / TILE;
  for (int tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    const int b0 = tl * TILE;
    const int nt = min(TILE, B - b0);
    c.g = dxc + size_t(b0) * M * H;
    q.g = dxq + size_t(b0) * N * H;
    for (int r = R - 1; r >= 0; --r) {
      c.x = stash_c + (size_t(r) * B + b0) * M * H;
      q.x = stash_q + (size_t(r) * B + b0) * N * H;
      for (int i = 0; i < nt; ++i) {
        const int b = b0 + i;
        project_rows_tc<SR>(q.x + size_t(i) * N * H, N, proj_q, s.ys_c, s.xs, sl, proj_c);
        project_rows_tc<SR>(c.x + size_t(i) * M * H, M, proj_c, s.ys_q, s.xs, sl,
                            c.W + size_t(M_WD) * HH);
        replay_adjoint<SR, MASK>(c, i, syn + size_t(b) * M, dsyn + size_t(b) * M, ucs32, s, sl,
                           q.W + size_t(M_WD) * HH, true);
        replay_adjoint<SR, MASK>(q, i, nullptr, nullptr, nullptr, s, sl, c.WT + size_t(M_WD) * HH,
                           false);
        __syncthreads();   // every row's dhs and slot masks are written
        gather_adjoint(c, i);
        gather_adjoint(q, i);
        __syncthreads();   // every source row's dys is written
        state_cotangent<SR>(c, i, s, sl, q.WT + size_t(M_WD) * HH);
        state_cotangent<SR>(q, i, s, sl, proj_q);
      }
      weight_grads(c, nt * M, s);     // starts with a barrier
      weight_grads(q, nt * N, s);
    }
  }
  cp_async_wait_all();
}

}  // namespace tcb

// Where a block of the bf16 kernel keeps what: its slab rows (0 where no
// layout fits), the slot masks in shared memory (live) and the gather panels
// in the scratch (gp).
struct Layout {
  int sr;
  bool live, gp;
};

size_t layout_bytes(int M, int N, int Dc, int Dq, Layout l) {
  return l.sr == 64 ? tcb::smem_bytes<64>(M, N, Dc, Dq, l.live, l.gp)
                    : tcb::smem_bytes<32>(M, N, Dc, Dq, l.live, l.gp);
}

// The layouts in the order they are tried: the panels in shared memory with
// 64-row slabs and the slot masks in shared memory, 32-row slabs and the
// masks, 64-row slabs, 32-row slabs; then the panels in the scratch with
// 64-row slabs and the masks, 64-row slabs, 32-row slabs and the masks,
// 32-row slabs.
constexpr Layout LAYOUTS[] = {{64, true, false}, {32, true, false}, {64, false, false},
                              {32, false, false}, {64, true, true}, {64, false, true},
                              {32, true, true}, {32, false, true}};

// The first layout that fits in shared memory; sr = 0 and the last one where
// none does.
Layout tc_layout(int M, int N, int Dc, int Dq) {
  for (const Layout& l : LAYOUTS)
    if (layout_bytes(M, N, Dc, Dq, l) <= tc::SMEM_LIMIT) return l;
  Layout none = LAYOUTS[sizeof(LAYOUTS) / sizeof(LAYOUTS[0]) - 1];
  none.sr = 0;
  return none;
}

// Shared memory of the layout chosen, or of the last one tried where none fits.
size_t smem_for(int M, int N, int Dc, int Dq) {
  Layout l = tc_layout(M, N, Dc, Dq);
  if (l.sr == 0) l.sr = 32;
  return layout_bytes(M, N, Dc, Dq, l);
}

}  // namespace

extern "C" {

// Shared memory one block needs.
long long fused_rounds_bwd_smem_bytes(int M, int N, int Dc, int Dq) {
  return (long long)smem_for(M, N, Dc, Dq);
}

// Samples a block takes at a time.
int fused_rounds_bwd_tile() { return tcb::TILE; }

// Bytes of scratch one block needs.
long long fused_rounds_bwd_scratch_bytes(int M, int N, int Dc, int Dq) {
  return (long long)tcb::scratch_bytes(M, N, Dc, Dq, tc_layout(M, N, Dc, Dq).gp);
}

// 1 where the layout keeps the gather panels in the scratch (the GP kernel).
int fused_rounds_bwd_gpanels(int M, int N, int Dc, int Dq) {
  return tc_layout(M, N, Dc, Dq).gp ? 1 : 0;
}

// stash_c [R, B, M, 128], stash_q [R, B, N, 128] bf16 (K2a's); syn [B, M]
// f32; idx_c [M, Dc], idx_q [N, Dq] int32 (-1 = masked slot); mats and
// mats_t [10, 128, 128] bf16 (the packs and their transposes); vecs
// [14, 128] f32 as the forward read them; ucs32 [128] the f32 syndrome
// weights.  In/out: dxc [B, M, 128] and dxq [B, N, 128] f32 hold the
// outputs' cotangents and come back as the inputs'.  Out: dsyn [B, M] f32
// (zeroed by the caller), dmats [10, 128, 128] and dvecs [14, 128] f32.
// Scratch: scratch (grid x fused_rounds_bwd_scratch_bytes), part_mats
// [grid, 10, 128, 128] and part_vecs [grid, 8, 14, 128], both zeroed by the
// caller.  width (<= 128): the model's width, the columns past it zero in
// the stash and the packs.  Launches the adjoint on `grid` blocks, then the
// sum of the partials; returns the first launch error (0 on success).
int fused_rounds_bwd_launch(const void* stash_c, const void* stash_q, const void* syn,
                            const void* idx_c, const void* idx_q, const void* mats,
                            const void* mats_t, const void* vecs, const void* ucs32, void* dxc,
                            void* dxq, void* dsyn, void* scratch, void* part_mats,
                            void* part_vecs, void* dmats, void* dvecs, int B, int M, int N,
                            int Dc, int Dq, int R, int width, int grid, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || Dc <= 0 || Dq <= 0 || R <= 0 || grid <= 0 ||
      width <= 0 || width > H)
    return int(cudaErrorInvalidValue);
  typedef __nv_bfloat16 bf;
  const Layout lay = tc_layout(M, N, Dc, Dq);
  if (lay.sr == 0) return int(cudaErrorInvalidValue);
  const bool mask = width < H;
  decltype(&tcb::fused_rounds_bwd_tc_kernel<64, false, false>) kernel;
  if (lay.gp)
    kernel = lay.sr == 64 ? (mask ? tcb::fused_rounds_bwd_tc_kernel<64, true, true>
                                  : tcb::fused_rounds_bwd_tc_kernel<64, false, true>)
                          : (mask ? tcb::fused_rounds_bwd_tc_kernel<32, true, true>
                                  : tcb::fused_rounds_bwd_tc_kernel<32, false, true>);
  else
    kernel = lay.sr == 64 ? (mask ? tcb::fused_rounds_bwd_tc_kernel<64, true, false>
                                  : tcb::fused_rounds_bwd_tc_kernel<64, false, false>)
                          : (mask ? tcb::fused_rounds_bwd_tc_kernel<32, true, false>
                                  : tcb::fused_rounds_bwd_tc_kernel<32, false, false>);
  float* pm = static_cast<float*>(part_mats);
  float* pv = static_cast<float*>(part_vecs);
  return launch_adjoint(
      kernel, grid, layout_bytes(M, N, Dc, Dq, lay), static_cast<cudaStream_t>(stream), pm, pv,
      static_cast<float*>(dmats), static_cast<float*>(dvecs), static_cast<const bf*>(stash_c),
      static_cast<const bf*>(stash_q), static_cast<const float*>(syn),
      static_cast<const int*>(idx_c), static_cast<const int*>(idx_q),
      static_cast<const bf*>(mats), static_cast<const bf*>(mats_t),
      static_cast<const float*>(vecs), static_cast<const float*>(ucs32),
      static_cast<float*>(dxc), static_cast<float*>(dxq), static_cast<float*>(dsyn),
      static_cast<unsigned char*>(scratch), pm, pv, B, M, N, Dc, Dq, R, lay.live ? 1 : 0,
      width);
}

}  // extern "C"
