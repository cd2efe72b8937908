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
// Design.  A persistent grid of about one 256-thread block per SM; each block
// walks a strided set of samples, and for each sample the rounds from R-1 down
// to 0.  Per round:
//   S1  replay the gather panels ys_c = rnd(x_q @ ws_c), ys_q = rnd(x_c @ ws_q)
//       into shared memory (as K1);
//   S2  per direction, rows in chunks of 32: replay x @ [wd|ux], the slot
//       gather-sum, the folded aggregation, the update MLP and the LayerNorm,
//       then at once the adjoint: LayerNorm backward, dpre_r @ W1^T, the relu
//       mask of the pre-activation, dt_r @ Wf^T -> dhs;
//   S3  per direction, the slot-gather adjoint: dydb of every destination row
//       (a gather over its slots), and dys of every source row, a gather over
//       the readers table (for each source row, the destination rows that
//       read it, in (row, slot) order), so the scatter needs no atomics.
//       Each block builds the two readers tables once, from the slot tables;
//   S4  per direction, the state cotangent
//       g = dpre + dydb_r @ wd^T + dys_r @ ws^T + dt_r @ ux^T;
//   S5  per direction, the five weight gradients of the round, x^T @ dy over
//       the sample's rows, added to the block's own partial in global memory.
// Bias gradients are kept per thread over a stage and added to a per-warp
// partial.  A second launch sums the blocks' partials in a fixed order, so a
// gradient is the same from run to run (no float atomics).
//
// Where things live: the two gather panels, two [32][132] f32 chunk buffers,
// a 16-deep weight slab and the slot and readers tables in shared memory
// (190.5 KB in f32, 116.8 KB in bf16 at d=11); the running state cotangents
// in the dxc/dxq outputs; each round's residuals (ydb, hs, hc, dhs) and
// rounded cotangents (dpre_r, dt_r, dydb_r, dys_r) in a per-block f32
// scratch of 8 (M + N) rows, 1 MB at d=11, partly held in L2.
//
// Bounds on an H100 at d=11, H=128, per sample and round: the replay's 10
// GEMM passes, the adjoint's 10 and the 10 weight-gradient products are
// 30 [rows, 128] x [128, 128] products, about 3x K1's 39.7 MFLOP, plus the
// stash read (the bytes term, 3.76 GB at B=4096, R=14 in bf16, 1.1 ms).  So it
// is bound by operations.  Like K1 it runs f32 FMA loops on CUDA cores, one
// block per SM: a first version that is right, not yet a fast one.

#include "rounds_common.cuh"

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
template <typename T, bool SYN>
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
    // LayerNorm forward and backward; a warp reads and writes only its own
    // rows of xs here
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      float v[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = s.xs[lr * XLD + c0 + j] + agg[0][i][j] + ub1[j];
        sum += v[j];
      }
      const float mu = warp_sum(sum) * (1.f / H);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] -= mu;
        sq += v[j] * v[j];
      }
      const float inv = rsqrtf(warp_sum(sq) * (1.f / H) + 1e-6f);
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
      const float m1 = warp_sum(s1) * (1.f / H);
      const float m2 = warp_sum(s2) * (1.f / H);
      float dpre[4], dpr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dpre[j] = inv * (dnh[j] - m1 - nh[j] * m2);
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
// rows whose slots read it, in (row, slot) order; off has src_rows + 1
// entries.  idx is the slot table in shared memory.
__device__ void build_readers(const int* idx, int rows, int D, int src_rows, int* off,
                              int* lst) {
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
      if (idx[e] == sr) lst[o++] = e / D;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_rounds_bwd_kernel(const T* __restrict__ stash_c, const T* __restrict__ stash_q,
                        const float* __restrict__ syn, const int* __restrict__ idx_c,
                        const int* __restrict__ idx_q, const T* __restrict__ mats,
                        const T* __restrict__ mats_t, const float* __restrict__ vecs,
                        const float* __restrict__ ucs32, float* dxc, float* dxq,
                        float* dsyn, float* scratch, float* part_mats,
                        float* part_vecs, int B, int M, int N, int Dc, int Dq, int R) {
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
      replay_adjoint<T, true>(c, syn_b, dsyn_b, ucs32, s);
      replay_adjoint<T, false>(q, nullptr, nullptr, nullptr, s);
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

template <typename T>
int launch(const void* stash_c, const void* stash_q, const float* syn, const int* idx_c,
           const int* idx_q, const void* mats, const void* mats_t, const float* vecs,
           const float* ucs32, float* dxc, float* dxq, float* dsyn, float* scratch,
           float* part_mats, float* part_vecs, float* dmats, float* dvecs, int B, int M,
           int N, int Dc, int Dq, int R, int grid, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(M, N, Dc, Dq);
  cudaError_t err = cudaFuncSetAttribute(fused_rounds_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  fused_rounds_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(stash_c), static_cast<const T*>(stash_q), syn, idx_c, idx_q,
      static_cast<const T*>(mats), static_cast<const T*>(mats_t), vecs, ucs32, dxc, dxq,
      dsyn, scratch, part_mats, part_vecs, B, M, N, Dc, Dq, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n = 10 * HH + 14 * H;
  reduce_partials<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      part_mats, part_vecs, dmats, dvecs, grid);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = float32 states, 1 = bfloat16.
long long fused_rounds_bwd_smem_bytes(int dtype, int M, int N, int Dc, int Dq) {
  return dtype == 0 ? (long long)smem_bytes<float>(M, N, Dc, Dq)
                    : (long long)smem_bytes<__nv_bfloat16>(M, N, Dc, Dq);
}

// f32 elements of scratch one block needs.
long long fused_rounds_bwd_scratch_floats(int M, int N) {
  return (long long)(scratch_rows(M, N) * H);
}

// stash_c [R, B, M, 128], stash_q [R, B, N, 128] in the state type (K2a's);
// syn [B, M] f32; idx_c [M, Dc], idx_q [N, Dq] int32 (-1 = masked slot); mats and mats_t [10, 128, 128] in the state type (the
// packs and their transposes); vecs [14, 128] f32 as the forward read them;
// ucs32 [128] the f32 syndrome weights.  In/out: dxc [B, M, 128] and dxq
// [B, N, 128] f32 hold the outputs' cotangents and come back as the inputs'.
// Out: dsyn [B, M] f32 (zeroed by the caller), dmats [10, 128, 128] and dvecs
// [14, 128] f32.  Scratch: scratch (grid x fused_rounds_bwd_scratch_floats),
// part_mats [grid, 10, 128, 128] and part_vecs [grid, 8, 14, 128], both
// zeroed by the caller.  Launches the adjoint on `grid` blocks, then the sum
// of the partials; returns the first launch error (0 on success).
int fused_rounds_bwd_launch(int dtype, const void* stash_c, const void* stash_q,
                            const void* syn, const void* idx_c, const void* idx_q,
                            const void* mats, const void* mats_t, const void* vecs,
                            const void* ucs32, void* dxc, void* dxq, void* dsyn,
                            void* scratch, void* part_mats, void* part_vecs, void* dmats,
                            void* dvecs, int B, int M, int N, int Dc, int Dq, int R,
                            int grid, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || Dc <= 0 || Dq <= 0 || R <= 0 || grid <= 0)
    return int(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(syn);
  const int* ic = static_cast<const int*>(idx_c);
  const int* iq = static_cast<const int*>(idx_q);
  const float* v = static_cast<const float*>(vecs);
  const float* u = static_cast<const float*>(ucs32);
  float* gc = static_cast<float*>(dxc);
  float* gq = static_cast<float*>(dxq);
  float* ds = static_cast<float*>(dsyn);
  float* sc = static_cast<float*>(scratch);
  float* pm = static_cast<float*>(part_mats);
  float* pv = static_cast<float*>(part_vecs);
  float* dm = static_cast<float*>(dmats);
  float* dv = static_cast<float*>(dvecs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(stash_c, stash_q, s, ic, iq, mats, mats_t, v, u, gc, gq, ds, sc,
                         pm, pv, dm, dv, B, M, N, Dc, Dq, R, grid, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(stash_c, stash_q, s, ic, iq, mats, mats_t, v, u, gc,
                                 gq, ds, sc, pm, pv, dm, dv, B, M, N, Dc, Dq, R, grid,
                                 st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
