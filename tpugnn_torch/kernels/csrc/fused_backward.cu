// Backward of the R weight-tied rounds (K2b, Hopper).
//
// Replaces the TPU kernel
// tpugnn/kernels/fused_backward.py::make_kernel_vjp_rounds._bwd (pl.pallas_call
// at :624, body _make_bwd_kernel at :273).  The function is the one
// tpugnn_torch/kernels/fused_backward.py::rounds_vjp_plain computes: the
// rounds in reverse, each replayed from the stash that K2a wrote (its input
// states) and then the adjoint, with the cotangents dpre, dt, each slot's
// share of dz, dydb and dys rounded to the state type where the TPU kernel
// rounds them.
//
// Design.  A persistent grid of about one 256-thread block per SM.  Per
// round, per sample:
//   S1  replay the gather panels ys_c = rnd(x_q @ ws_c), ys_q = rnd(x_c @ ws_q)
//       into shared memory (as K1);
//   S2  per direction: replay the update (the slot gather-sum, the folded
//       aggregation, the update MLP and the LayerNorm), then at once the
//       adjoint: LayerNorm backward, dpre_r @ W1^T, the relu mask of the
//       pre-activation, dt_r @ Wf^T -> dhs;
//   S3  per direction, the slot-gather adjoint: dydb of every destination row
//       (over its slots), and dys of every source row, a gather over the
//       readers table (for each source row, the slots that read it, in (row,
//       slot) order), so the scatter needs no atomics.  Each block builds
//       the two readers tables once, from the slot tables;
//   S4  per direction, the state cotangent
//       g = dpre + dydb_r @ wd^T + dys_r @ ws^T + dt_r @ ux^T;
//   S5  per direction, the five weight gradients of the round, x^T @ dy,
//       added to the block's own f32 partial in global memory.
// Bias gradients go to per-warp partials.  A second launch sums the blocks'
// partials in a fixed order, so a gradient is the same from run to run (no
// float atomics across threads).
//
// Two instantiations:
//   bf16 states (training): the tensor-core path, tcb:: below.  Every
//     operand of every product is a bf16 value (the stash, hs and hc, the
//     packs, and dpre, dt, dydb and dys, which both versions round before
//     their products), so mma.sync.m16n8k16 bf16 with f32 accumulation forms
//     the plain version's products; only the f32 summation order differs.
//     S1, S2 and S4 run on whole-side chunks of 128 rows (rounds_mma.cuh),
//     each weight matrix staged once per side, sample and round; dydb comes
//     from the slot masks S2 records and its dhs in registers.  A block
//     takes a tile of 8 samples; S1-S4 run per sample, writing the six
//     bf16-valued residuals (hs, hc, dpre_r, dt_r, dydb_r, dys_r) to the
//     tile's bf16 scratch, and S5 then reduces the ten products over the
//     tile's 8 x rows rows in one pass each, ldmatrix.trans feeding A^T.  So
//     a block's f32 partial (640 KB) is loaded and stored once per tile and
//     round: 9.4 GB at B=4096, R=14 against 75 GB once per sample.
//   f32 states: one sample at a time, 32-row chunks, f32 FMA loops
//     (gemm_chunk), residuals in an f32 scratch, the partial read and
//     written once per sample and round; unchanged.
//
// Where things live (bf16, d=11): the two gather panels, two [128][136]
// chunk buffers (S5 stages its rows over these four), a double-buffered
// weight slab, the slot and readers tables and the slot masks in shared
// memory (195,616 B); rnd(dhs) in the gathered panel once S2 no longer reads
// it; the running state cotangents in the dxc/dxq outputs; the tile's
// residuals in its bf16 scratch (3 MB a block).
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
// bound by operations: 6.8 TFLOP, 6.9 ms at the bf16 tensor-core peak, 102 ms
// at the f32 CUDA-core peak (the floor of the f32 path and of any FMA
// design).  The bf16 path measured 139 ms on an H100 (49 TFLOP/s): its time
// is in the per-sample epilogues of S2-S4 and their memory traffic, not in
// the products.

#include "rounds_common.cuh"
#include "rounds_mma.cuh"

namespace {

using namespace rounds;

template <typename T>
struct Smem {
  T* ys_c;      // [N][H] qubit-row projections, gathered by check rows
  T* ys_q;      // [M][H] check-row projections, gathered by qubit rows
  float* xs;    // [CH][XLD] chunk buffer (GEMM A operand)
  float* hs;    // [CH][XLD] chunk buffer (GEMM A operand)
  T* wsl;       // [KS][2*H] staged weight slab
  int* idx_c;   // [M][Dc] source qubit per slot, -1 for a masked slot
  int* idx_q;   // [N][Dq]
  int* off_c;   // [N + 1] readers table of the check gather: the check rows
  int* lst_c;   // [M * Dc]  reading qubit row s are lst_c[off_c[s] .. off_c[s+1])
  int* off_q;   // [M + 1]
  int* lst_q;   // [N * Dq]
};

template <typename T>
__host__ __device__ inline size_t smem_bytes(int M, int N, int Dc, int Dq) {
  size_t s = 0;
  s += align16(size_t(N) * H * sizeof(T));
  s += align16(size_t(M) * H * sizeof(T));
  s += 2 * align16(size_t(CH) * XLD * sizeof(float));
  s += align16(size_t(KS) * 2 * H * sizeof(T));
  s += align16(size_t(M) * Dc * sizeof(int));
  s += align16(size_t(N) * Dq * sizeof(int));
  s += align16(size_t(N + 1 + M * Dc) * sizeof(int));
  s += align16(size_t(M + 1 + N * Dq) * sizeof(int));
  return s;
}

template <typename T>
__device__ Smem<T> carve(unsigned char* base, int M, int N, int Dc, int Dq) {
  Smem<T> s;
  size_t o = 0;
  s.ys_c = reinterpret_cast<T*>(base + o);      o += align16(size_t(N) * H * sizeof(T));
  s.ys_q = reinterpret_cast<T*>(base + o);      o += align16(size_t(M) * H * sizeof(T));
  s.xs = reinterpret_cast<float*>(base + o);    o += align16(size_t(CH) * XLD * sizeof(float));
  s.hs = reinterpret_cast<float*>(base + o);    o += align16(size_t(CH) * XLD * sizeof(float));
  s.wsl = reinterpret_cast<T*>(base + o);       o += align16(size_t(KS) * 2 * H * sizeof(T));
  s.idx_c = reinterpret_cast<int*>(base + o);   o += align16(size_t(M) * Dc * sizeof(int));
  s.idx_q = reinterpret_cast<int*>(base + o);   o += align16(size_t(N) * Dq * sizeof(int));
  s.off_c = reinterpret_cast<int*>(base + o);
  s.lst_c = s.off_c + N + 1;                    o += align16(size_t(N + 1 + M * Dc) * sizeof(int));
  s.off_q = reinterpret_cast<int*>(base + o);
  s.lst_q = s.off_q + M + 1;
  return s;
}

// Rows of the per-block scratch, in units of [H] f32 rows.
__host__ __device__ inline size_t scratch_rows(int M, int N) { return 8 * size_t(M + N); }

// One direction of a round: its destination rows, the source rows its gather
// reads, its weights and where its residuals go.
template <typename T>
struct Dir {
  const T* x;         // [rows][H] round-input states (stash)
  float* g;           // [rows][H] state cotangent, rewritten in place
  int rows, D, src_rows;
  int width;          // the LayerNorm's columns
  const int* idx;     // [rows][D] (shared)
  const int* off;     // readers table of the gather (shared)
  const int* lst;
  const T* ys;        // [src_rows][H] gathered panel (shared)
  const T* W;         // the direction's 5 matrices
  const T* WT;        // their transposes
  const float* vec;   // the direction's 7 vectors
  float *ydb, *hs, *hc, *dpre, *dt, *dhs, *dydb;   // [rows][H] scratch
  float* dys_src;     // [src_rows][H]: this gather's adjoint onto its sources
  const float* dys;   // [rows][H]: the other gather's adjoint onto these rows
  float* pmat;        // the block's partial of the direction's 5 matrices
  float* pvec;        // the block's per-warp vector partials, this direction
};

__device__ __forceinline__ void add_partial(float* p, const float v[4]) {
  float o[4];
  load4(p, o);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] += v[j];
  store4(p, o);
}

// S2: replay one direction's update and chain the adjoint down to dhs.
template <typename T, bool SYN, bool MASK>
__device__ void replay_adjoint(const Dir<T>& d, const float* syn, float* dsyn,
                               const float* ucs32, const Smem<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4;
  float b0[4], boa[4], ucs[4], ub0[4], ub1[4], lns[4], lnb[4], u32[4];
  load4(d.vec + V_B0 * H + c0, b0);
  load4(d.vec + V_BOA * H + c0, boa);
  load4(d.vec + V_UCS * H + c0, ucs);
  load4(d.vec + V_UB0 * H + c0, ub0);
  load4(d.vec + V_UB1 * H + c0, ub1);
  load4(d.vec + V_LNS * H + c0, lns);
  load4(d.vec + V_LNB * H + c0, lnb);
  if (SYN) load4(ucs32 + c0, u32);
  else u32[0] = u32[1] = u32[2] = u32[3] = 0.f;
  float p_lns[4] = {0.f, 0.f, 0.f, 0.f}, p_lnb[4] = {0.f, 0.f, 0.f, 0.f};
  float p_ub1[4] = {0.f, 0.f, 0.f, 0.f}, p_ub0[4] = {0.f, 0.f, 0.f, 0.f};
  float p_boa[4] = {0.f, 0.f, 0.f, 0.f}, p_ucs[4] = {0.f, 0.f, 0.f, 0.f};
  const T tag{};
  const int rows = d.rows;

  for (int row0 = 0; row0 < rows; row0 += CH) {
    __syncthreads();  // the previous chunk's readers of xs / hs are done
    load_chunk(d.x, row0, rows, s.xs);
    float acc[2][4][4];
    gemm_chunk<T, 2>(s.xs, d.W + size_t(M_WD) * HH, s.wsl, acc);   // [ydb | ux]

    float deg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      float h4[4] = {0.f, 0.f, 0.f, 0.f};
      deg[i] = 0.f;
      if (r < rows) {
        float ydb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) ydb[j] = acc[0][i][j] + b0[j];
        store4(d.ydb + size_t(r) * H + c0, ydb);
        for (int k = 0; k < d.D; ++k) {
          const int src = d.idx[r * d.D + k];
          if (src < 0) continue;
          deg[i] += 1.f;
          float y[4];
          load4(d.ys + size_t(src) * H + c0, y);
#pragma unroll
          for (int j = 0; j < 4; ++j) h4[j] += fmaxf(y[j] + ydb[j], 0.f);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) h4[j] = rnd(h4[j], tag);
      store4(s.hs + lr * XLD + c0, h4);
      if (r < rows) store4(d.hs + size_t(r) * H + c0, h4);
    }

    float agg[1][4][4];
    gemm_chunk<T, 1>(s.hs, d.W + size_t(M_WF) * HH, s.wsl, agg);
    __syncthreads();  // every warp has read hs before it is overwritten
    unsigned tpos = 0u;
    float sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      sv[i] = (SYN && r < rows) ? syn[r] : 0.f;
      float hc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[1][i][j] + agg[0][i][j] + deg[i] * boa[j] + ub0[j];
        if (SYN) t += sv[i] * ucs[j];
        if (t > 0.f) tpos |= 1u << (i * 4 + j);
        hc[j] = rnd(fmaxf(t, 0.f), tag);
      }
      store4(s.hs + lr * XLD + c0, hc);
      if (r < rows) store4(d.hc + size_t(r) * H + c0, hc);
    }

    gemm_chunk<T, 1>(s.hs, d.W + size_t(M_W1) * HH, s.wsl, agg);
    // LayerNorm forward and backward over the first d.width columns; a warp
    // reads and writes only its own rows of xs here
    const float inv_w = MASK ? 1.f / d.width : 1.f / H;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      float v[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = s.xs[lr * XLD + c0 + j] + agg[0][i][j] + ub1[j];
        sum += v[j];
      }
      const float mu = warp_sum(sum) * inv_w;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] -= mu;
        if (MASK && c0 + j >= d.width) v[j] = 0.f;
        sq += v[j] * v[j];
      }
      const float inv = rsqrtf(warp_sum(sq) * inv_w + 1e-6f);
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) load4(d.g + size_t(r) * H + c0, g);
      float nh[4], dnh[4], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nh[j] = v[j] * inv;
        p_lns[j] += g[j] * nh[j];
        p_lnb[j] += g[j];
        dnh[j] = g[j] * lns[j];
        s1 += dnh[j];
        s2 += dnh[j] * nh[j];
      }
      const float m1 = warp_sum(s1) * inv_w;
      const float m2 = warp_sum(s2) * inv_w;
      float dpre[4], dpr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dpre[j] = inv * (dnh[j] - m1 - nh[j] * m2);
        if (MASK && c0 + j >= d.width) dpre[j] = 0.f;
        p_ub1[j] += dpre[j];
        dpr[j] = rnd(dpre[j], tag);
      }
      if (r < rows) {
        store4(d.g + size_t(r) * H + c0, dpre);
        store4(d.dpre + size_t(r) * H + c0, dpr);
      }
      store4(s.xs + lr * XLD + c0, dpr);
    }

    gemm_chunk<T, 1>(s.xs, d.WT + size_t(M_W1) * HH, s.wsl, agg);   // dhc
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      float dtr[4], ds = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dt = ((tpos >> (i * 4 + j)) & 1u) ? agg[0][i][j] : 0.f;
        p_ub0[j] += dt;
        p_boa[j] += deg[i] * dt;
        if (SYN) {
          p_ucs[j] += sv[i] * dt;
          ds += dt * u32[j];
        }
        dtr[j] = rnd(dt, tag);
      }
      if (SYN) {
        ds = warp_sum(ds);
        if (lane == 0 && r < rows) dsyn[r] += ds;
      }
      if (r < rows) store4(d.dt + size_t(r) * H + c0, dtr);
      store4(s.hs + lr * XLD + c0, dtr);
    }

    gemm_chunk<T, 1>(s.hs, d.WT + size_t(M_WF) * HH, s.wsl, agg);   // dhs
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + warp * 4 + i;
      if (r < rows) store4(d.dhs + size_t(r) * H + c0, agg[0][i]);
    }
  }

  float* pv = d.pvec + size_t(warp) * 14 * H + c0;
  add_partial(pv + V_BOA * H, p_boa);
  if (SYN) add_partial(pv + V_UCS * H, p_ucs);
  add_partial(pv + V_UB0 * H, p_ub0);
  add_partial(pv + V_UB1 * H, p_ub1);
  add_partial(pv + V_LNS * H, p_lns);
  add_partial(pv + V_LNB * H, p_lnb);
}

// S3: the slot-gather adjoint of one direction.  A warp takes a row, a lane
// 4 columns.
template <typename T>
__device__ void gather_adjoint(const Dir<T>& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4;
  const T tag{};
  float p_b0[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = warp; r < d.rows; r += WARPS) {          // destination rows
    float ydb[4], dhs[4], dy[4] = {0.f, 0.f, 0.f, 0.f};
    load4(d.ydb + size_t(r) * H + c0, ydb);
    load4(d.dhs + size_t(r) * H + c0, dhs);
    for (int k = 0; k < d.D; ++k) {
      const int src = d.idx[r * d.D + k];
      if (src < 0) continue;
      float y[4];
      load4(d.ys + size_t(src) * H + c0, y);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (y[j] + ydb[j] > 0.f) dy[j] += dhs[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p_b0[j] += dy[j];
      dy[j] = rnd(dy[j], tag);
    }
    store4(d.dydb + size_t(r) * H + c0, dy);
  }
  for (int sr = warp; sr < d.src_rows; sr += WARPS) {   // source rows
    float y[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
    load4(d.ys + size_t(sr) * H + c0, y);
    for (int t = d.off[sr]; t < d.off[sr + 1]; ++t) {
      const int dst = d.lst[t];
      float ydb[4], dhs[4];
      load4(d.ydb + size_t(dst) * H + c0, ydb);
      load4(d.dhs + size_t(dst) * H + c0, dhs);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] += rnd(y[j] + ydb[j] > 0.f ? dhs[j] : 0.f, tag);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = rnd(acc[j], tag);
    store4(d.dys_src + size_t(sr) * H + c0, acc);
  }
  add_partial(d.pvec + size_t(warp) * 14 * H + V_B0 * H + c0, p_b0);
}

// S4: g = dpre + dydb_r @ wd^T + dys_r @ ws^T + dt_r @ ux^T.
template <typename T>
__device__ void state_cotangent(const Dir<T>& d, const Smem<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4;
  for (int row0 = 0; row0 < d.rows; row0 += CH) {
    float acc[1][4][4];
    __syncthreads();
    load_chunk(d.dydb, row0, d.rows, s.xs);
    gemm_chunk<T, 1>(s.xs, d.WT + size_t(M_WD) * HH, s.wsl, acc);
    __syncthreads();
    load_chunk(d.dys, row0, d.rows, s.xs);
    gemm_chunk<T, 1, true>(s.xs, d.WT + size_t(M_WS) * HH, s.wsl, acc);
    __syncthreads();
    load_chunk(d.dt, row0, d.rows, s.xs);
    gemm_chunk<T, 1, true>(s.xs, d.WT + size_t(M_UX) * HH, s.wsl, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + warp * 4 + i;
      if (r >= d.rows) continue;
      float gv[4];
      load4(d.g + size_t(r) * H + c0, gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] += acc[0][i][j];
      store4(d.g + size_t(r) * H + c0, gv);
    }
  }
}

// S5: dW[k][j] += sum_r A[r][k] B[r][j] over the sample's rows, into the
// block's partial.  A thread owns 16 rows k (warp * 16 + ii) and 4 columns j.
template <typename T, typename TA>
__device__ void wgrad(const TA* A, const float* Bm, int rows, float* dW,
                      const Smem<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4, k0 = warp * 16;
  float acc[16][4];
#pragma unroll
  for (int ii = 0; ii < 16; ++ii) load4(dW + size_t(k0 + ii) * H + c0, acc[ii]);
  for (int row0 = 0; row0 < rows; row0 += CH) {
    __syncthreads();
    load_chunk(A, row0, rows, s.xs);
    load_chunk(Bm, row0, rows, s.hs);
    __syncthreads();
#pragma unroll 2
    for (int rr = 0; rr < CH; ++rr) {
      float a[16], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) load4(s.xs + rr * XLD + k0 + 4 * q, a + 4 * q);
      load4(s.hs + rr * XLD + c0, b);
#pragma unroll
      for (int ii = 0; ii < 16; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ii][j] = fmaf(a[ii], b[j], acc[ii][j]);
    }
  }
#pragma unroll
  for (int ii = 0; ii < 16; ++ii) store4(dW + size_t(k0 + ii) * H + c0, acc[ii]);
}

template <typename T>
__device__ void weight_grads(const Dir<T>& d, const Smem<T>& s) {
  wgrad<T>(d.hc, d.dpre, d.rows, d.pmat + size_t(M_W1) * HH, s);
  wgrad<T>(d.hs, d.dt, d.rows, d.pmat + size_t(M_WF) * HH, s);
  wgrad<T>(d.x, d.dydb, d.rows, d.pmat + size_t(M_WD) * HH, s);
  wgrad<T>(d.x, d.dys, d.rows, d.pmat + size_t(M_WS) * HH, s);
  wgrad<T>(d.x, d.dt, d.rows, d.pmat + size_t(M_UX) * HH, s);
}

// The readers table of one direction: for each source row, the destination
// rows whose slots read it (with `slots`, the slots r * D + k), in (row,
// slot) order; off has src_rows + 1 entries.  idx is the slot table in
// shared memory.
__device__ void build_readers(const int* idx, int rows, int D, int src_rows, int* off,
                              int* lst, bool slots = false) {
  const int n = rows * D;
  for (int sr = threadIdx.x; sr < src_rows; sr += THREADS) {
    int c = 0;
    for (int e = 0; e < n; ++e) c += idx[e] == sr;
    off[sr + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int sr = 0; sr < src_rows; ++sr) off[sr + 1] += off[sr];
  }
  __syncthreads();
  for (int sr = threadIdx.x; sr < src_rows; sr += THREADS) {
    int o = off[sr];
    for (int e = 0; e < n; ++e)
      if (idx[e] == sr) lst[o++] = slots ? e : e / D;
  }
  __syncthreads();
}

template <typename T, bool MASK>
__global__ void __launch_bounds__(THREADS, 1)
fused_rounds_bwd_kernel(const T* __restrict__ stash_c, const T* __restrict__ stash_q,
                        const float* __restrict__ syn, const int* __restrict__ idx_c,
                        const int* __restrict__ idx_q, const T* __restrict__ mats,
                        const T* __restrict__ mats_t, const float* __restrict__ vecs,
                        const float* __restrict__ ucs32, float* dxc, float* dxq,
                        float* dsyn, float* scratch, float* part_mats,
                        float* part_vecs, int B, int M, int N, int Dc, int Dq, int R,
                        int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s = carve<T>(smem_raw, M, N, Dc, Dq);
  for (int e = threadIdx.x; e < M * Dc; e += THREADS) s.idx_c[e] = idx_c[e];
  for (int e = threadIdx.x; e < N * Dq; e += THREADS) s.idx_q[e] = idx_q[e];
  __syncthreads();
  build_readers(s.idx_c, M, Dc, N, s.off_c, s.lst_c);
  build_readers(s.idx_q, N, Dq, M, s.off_q, s.lst_q);

  float* sc = scratch + size_t(blockIdx.x) * scratch_rows(M, N) * H;
  auto take = [&](int rows) { float* p = sc; sc += size_t(rows) * H; return p; };
  Dir<T> c, q;
  c.width = q.width = width;
  c.rows = M; c.D = Dc; c.src_rows = N;
  c.idx = s.idx_c; c.off = s.off_c; c.lst = s.lst_c; c.ys = s.ys_c;
  c.W = mats; c.WT = mats_t; c.vec = vecs;
  q.rows = N; q.D = Dq; q.src_rows = M;
  q.idx = s.idx_q; q.off = s.off_q; q.lst = s.lst_q; q.ys = s.ys_q;
  q.W = mats + size_t(NMAT) * HH; q.WT = mats_t + size_t(NMAT) * HH;
  q.vec = vecs + NVEC * H;
  c.ydb = take(M); c.hs = take(M); c.hc = take(M); c.dpre = take(M);
  c.dt = take(M); c.dhs = take(M); c.dydb = take(M); c.dys_src = take(N);
  q.ydb = take(N); q.hs = take(N); q.hc = take(N); q.dpre = take(N);
  q.dt = take(N); q.dhs = take(N); q.dydb = take(N); q.dys_src = take(M);
  c.dys = q.dys_src;        // the qubit gather's adjoint lands on check rows
  q.dys = c.dys_src;
  c.pmat = part_mats + size_t(blockIdx.x) * 10 * HH;
  q.pmat = c.pmat + size_t(NMAT) * HH;
  c.pvec = part_vecs + size_t(blockIdx.x) * WARPS * 14 * H;
  q.pvec = c.pvec + NVEC * H;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    c.g = dxc + size_t(b) * M * H;
    q.g = dxq + size_t(b) * N * H;
    const float* syn_b = syn + size_t(b) * M;
    float* dsyn_b = dsyn + size_t(b) * M;
    for (int r = R - 1; r >= 0; --r) {
      c.x = stash_c + (size_t(r) * B + b) * M * H;
      q.x = stash_q + (size_t(r) * B + b) * N * H;
      project_rows<T>(q.x, N, q.W + size_t(M_WS) * HH, s.ys_c, s.xs, s.wsl);
      project_rows<T>(c.x, M, c.W + size_t(M_WS) * HH, s.ys_q, s.xs, s.wsl);
      replay_adjoint<T, true, MASK>(c, syn_b, dsyn_b, ucs32, s);
      replay_adjoint<T, false, MASK>(q, nullptr, nullptr, nullptr, s);
      __syncthreads();
      gather_adjoint<T>(c);
      gather_adjoint<T>(q);
      state_cotangent<T>(c, s);      // starts with a barrier
      state_cotangent<T>(q, s);
      weight_grads<T>(c, s);
      weight_grads<T>(q, s);
      __syncthreads();
    }
  }
}

// dmats = sum over blocks of part_mats; dvecs = sum over blocks and warps of
// part_vecs; every element summed in the same order on every run.
__global__ void reduce_partials(const float* __restrict__ part_mats,
                                const float* __restrict__ part_vecs, float* dmats,
                                float* dvecs, int G) {
  const int nm = 10 * HH, nv = 14 * H;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nm + nv;
       e += gridDim.x * blockDim.x) {
    float sum = 0.f;
    if (e < nm) {
      for (int g = 0; g < G; ++g) sum += part_mats[size_t(g) * nm + e];
      dmats[e] = sum;
    } else {
      const int v = e - nm;
      for (int g = 0; g < G * WARPS; ++g) sum += part_vecs[size_t(g) * nv + v];
      dvecs[v] = sum;
    }
  }
}

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

// The panels and the two chunk buffers, or S5's staging where that is more.
__host__ __device__ inline size_t work_bytes(int M, int N) {
  const size_t w = align16(size_t(N) * H * sizeof(bf16)) +
                   align16(size_t(M) * H * sizeof(bf16)) + 2 * CHUNK_BYTES;
  return w > STAGE_BYTES ? w : STAGE_BYTES;
}

// live: the slot masks of both directions in shared memory (else in the
// scratch)
template <int SR>
__host__ __device__ inline size_t smem_bytes(int M, int N, int Dc, int Dq, bool live) {
  size_t s = work_bytes(M, N);
  if (live) s += 16 * size_t(M * Dc + N * Dq);
  s += slab_bytes(SR);
  s += align16(size_t(M) * Dc * sizeof(int));
  s += align16(size_t(N) * Dq * sizeof(int));
  s += align16(size_t(N + 1 + M * Dc) * sizeof(int));
  s += align16(size_t(M + 1 + N * Dq) * sizeof(int));
  return s;
}

struct Smem {
  bf16* ys_c;   // [N][H] swizzled, gathered by check rows; S5's staging
  bf16* ys_q;   //   starts here and spans the panels and chunk buffers
  bf16* xs;     // [CR][LDB] chunk buffer (A operand)
  bf16* hs;     // [CR][LDB] chunk buffer
  bf16* slab;   // [2][SR][LDB] weight slabs
  int *idx_c, *idx_q, *off_c, *lst_c, *off_q, *lst_q;
  uint32_t* live;   // [M * Dc + N * Dq][4] slot masks, or nullptr
};

template <int SR>
__device__ Smem carve(unsigned char* base, int M, int N, int Dc, int Dq, bool live) {
  Smem s;
  size_t o = 0;
  s.ys_c = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(N) * H * sizeof(bf16));
  s.ys_q = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(M) * H * sizeof(bf16));
  s.xs = reinterpret_cast<bf16*>(base + o);    o += CHUNK_BYTES;
  s.hs = reinterpret_cast<bf16*>(base + o);
  o = work_bytes(M, N);
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

// Bytes of scratch one block needs: the slot masks and the rounded dhs of
// one sample, and the tile's six bf16 residual arrays per direction.
__host__ __device__ inline size_t scratch_bytes(int M, int N, int Dc, int Dq) {
  return 16 * size_t(M * Dc + N * Dq) + size_t(M + N) * H * sizeof(bf16) +
         6 * size_t(TILE) * (M + N) * H * sizeof(bf16);
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
  const bf16* ys;     // [src_rows][H] gathered panel (shared, swizzled)
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

// p[0..1] += (a, b) for an f32 element pair that only this thread updates:
// a reduction without a return value, so the thread does not wait for the
// load, and in the thread's program order, so the sum is the same on every
// run.
__device__ __forceinline__ void red_add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// Sum v (v[2 j + c]: this thread's rows g and g + 8 already added, column
// 8 j + 2 t + c) over the 8 lanes that share t, by halving exchanges; each
// lane ends with the sums of columns 16 g + 2 t + {0, 1, 8, 9} and adds them
// to row p (f32, [H]) of its warp's partial.
template <int W>
__device__ __forceinline__ void colsum_halve(float (&v)[32], bool hi) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = hi ? v[i] : v[W + i];
    const float keep = hi ? v[W + i] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

__device__ __noinline__ void colsum_add(float (&v)[32], float* p) {
  const int lane = threadIdx.x & 31;
  colsum_halve<16>(v, lane & 16);
  colsum_halve<8>(v, lane & 8);
  colsum_halve<4>(v, lane & 4);
  const int c = 16 * (lane >> 2) + 2 * (lane & 3);
  red_add2(p + c, v[0], v[1]);
  red_add2(p + c + 8, v[2], v[3]);
}

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
    wgrad<3, 2>(arr, ia, ib, dw, n, s.ys_c);
  }
  {
    const bf16* const arr[3] = {d.x, d.hs, d.dt};
    const int ia[2] = {0, 1}, ib[2] = {2, 2};
    float* const dw[2] = {pm + size_t(M_UX) * HH, pm + size_t(M_WF) * HH};
    wgrad<3, 2>(arr, ia, ib, dw, n, s.ys_c);
  }
  {
    const bf16* const arr[2] = {d.hc, d.dpre};
    const int ia[1] = {0}, ib[1] = {1};
    float* const dw[1] = {pm + size_t(M_W1) * HH};
    wgrad<2, 1>(arr, ia, ib, dw, n, s.ys_c);
  }
}

template <int SR, bool MASK>
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
  const Smem s = carve<SR>(smem_raw, M, N, Dc, Dq, live_smem != 0);
  for (int e = threadIdx.x; e < M * Dc; e += THREADS) s.idx_c[e] = idx_c[e];
  for (int e = threadIdx.x; e < N * Dq; e += THREADS) s.idx_q[e] = idx_q[e];
  __syncthreads();
  build_readers(s.idx_c, M, Dc, N, s.off_c, s.lst_c, true);
  build_readers(s.idx_q, N, Dq, M, s.off_q, s.lst_q, true);

  unsigned char* sc = scratch + size_t(blockIdx.x) * scratch_bytes(M, N, Dc, Dq);
  auto take = [&](size_t bytes) { unsigned char* p = sc; sc += bytes; return p; };
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

// The bf16 kernel's layout for a graph, the first that fits in shared
// memory of: 64-row slabs and the slot masks in shared memory, 32-row slabs
// and the masks, 64-row slabs, 32-row slabs.  Returns 2 * slab rows + masks,
// or 0 where none fits.
int tc_layout(int M, int N, int Dc, int Dq) {
  for (int live = 1; live >= 0; --live) {
    if (tcb::smem_bytes<64>(M, N, Dc, Dq, live) <= tc::SMEM_LIMIT) return 128 + live;
    if (tcb::smem_bytes<32>(M, N, Dc, Dq, live) <= tc::SMEM_LIMIT) return 64 + live;
  }
  return 0;
}

size_t smem_for(int dtype, int M, int N, int Dc, int Dq) {
  if (dtype == 0) return smem_bytes<float>(M, N, Dc, Dq);
  const int lay = tc_layout(M, N, Dc, Dq);
  return lay >= 128 ? tcb::smem_bytes<64>(M, N, Dc, Dq, lay & 1)
                    : tcb::smem_bytes<32>(M, N, Dc, Dq, lay & 1);
}

template <typename K, typename... Args>
int launch_kernel(K kernel, int grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = float32 states, 1 = bfloat16.
long long fused_rounds_bwd_smem_bytes(int dtype, int M, int N, int Dc, int Dq) {
  return (long long)smem_for(dtype, M, N, Dc, Dq);
}

// Samples a block takes at a time: 1 in f32, a tile of tcb::TILE in bf16.
int fused_rounds_bwd_tile(int dtype) { return dtype == 0 ? 1 : tcb::TILE; }

// Bytes of scratch one block needs.
long long fused_rounds_bwd_scratch_bytes(int dtype, int M, int N, int Dc, int Dq) {
  return dtype == 0 ? (long long)(scratch_rows(M, N) * H * sizeof(float))
                    : (long long)tcb::scratch_bytes(M, N, Dc, Dq);
}

// stash_c [R, B, M, 128], stash_q [R, B, N, 128] in the state type (K2a's);
// syn [B, M] f32; idx_c [M, Dc], idx_q [N, Dq] int32 (-1 = masked slot);
// mats and mats_t [10, 128, 128] in the state type (the packs and their
// transposes); vecs [14, 128] f32 as the forward read them; ucs32 [128] the
// f32 syndrome weights.  In/out: dxc [B, M, 128] and dxq [B, N, 128] f32
// hold the outputs' cotangents and come back as the inputs'.  Out: dsyn
// [B, M] f32 (zeroed by the caller), dmats [10, 128, 128] and dvecs
// [14, 128] f32.  Scratch: scratch (grid x fused_rounds_bwd_scratch_bytes),
// part_mats [grid, 10, 128, 128] and part_vecs [grid, 8, 14, 128], both
// zeroed by the caller.  width (<= 128): the model's width, the columns past
// it zero in the stash and the packs.  Launches the adjoint on `grid`
// blocks, then the sum of the partials; returns the first launch error (0 on
// success).
int fused_rounds_bwd_launch(int dtype, const void* stash_c, const void* stash_q,
                            const void* syn, const void* idx_c, const void* idx_q,
                            const void* mats, const void* mats_t, const void* vecs,
                            const void* ucs32, void* dxc, void* dxq, void* dsyn,
                            void* scratch, void* part_mats, void* part_vecs, void* dmats,
                            void* dvecs, int B, int M, int N, int Dc, int Dq, int R,
                            int width, int grid, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || Dc <= 0 || Dq <= 0 || R <= 0 || grid <= 0 ||
      width <= 0 || width > H)
    return int(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(syn);
  const int* ic = static_cast<const int*>(idx_c);
  const int* iq = static_cast<const int*>(idx_q);
  const float* v = static_cast<const float*>(vecs);
  const float* u = static_cast<const float*>(ucs32);
  float* gc = static_cast<float*>(dxc);
  float* gq = static_cast<float*>(dxq);
  float* ds = static_cast<float*>(dsyn);
  float* pm = static_cast<float*>(part_mats);
  float* pv = static_cast<float*>(part_vecs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_for(dtype, M, N, Dc, Dq);
  int err;
  if (dtype == 0) {
    err = launch_kernel(width < H ? fused_rounds_bwd_kernel<float, true>
                                  : fused_rounds_bwd_kernel<float, false>, grid, smem, st,
                        static_cast<const float*>(stash_c), static_cast<const float*>(stash_q),
                        s, ic, iq, static_cast<const float*>(mats),
                        static_cast<const float*>(mats_t), v, u, gc, gq, ds,
                        static_cast<float*>(scratch), pm, pv, B, M, N, Dc, Dq, R, width);
  } else if (dtype == 1) {
    typedef __nv_bfloat16 bf;
    const bf* sc = static_cast<const bf*>(stash_c);
    const bf* sq = static_cast<const bf*>(stash_q);
    const bf* mt = static_cast<const bf*>(mats);
    const bf* mtt = static_cast<const bf*>(mats_t);
    unsigned char* scr = static_cast<unsigned char*>(scratch);
    const int lay = tc_layout(M, N, Dc, Dq);
    if (lay == 0) return int(cudaErrorInvalidValue);
    const bool mask = width < H;
    auto kernel = lay >= 128 ? (mask ? tcb::fused_rounds_bwd_tc_kernel<64, true>
                                     : tcb::fused_rounds_bwd_tc_kernel<64, false>)
                             : (mask ? tcb::fused_rounds_bwd_tc_kernel<32, true>
                                     : tcb::fused_rounds_bwd_tc_kernel<32, false>);
    err = launch_kernel(kernel, grid, smem, st, sc, sq, s, ic, iq, mt, mtt, v, u, gc, gq, ds,
                        scr, pm, pv, B, M, N, Dc, Dq, R, lay & 1, width);
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int n = 10 * HH + 14 * H;
  reduce_partials<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      pm, pv, static_cast<float*>(dmats), static_cast<float*>(dvecs), grid);
  return int(cudaGetLastError());
}

}  // extern "C"
