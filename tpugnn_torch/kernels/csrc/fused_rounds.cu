// R weight-tied message rounds of the GNN decoder in one launch (Hopper).
//
// K1 replaces the TPU kernel tpugnn/kernels/fused_decoder.py::decoder_rounds_tiled
// (pl.pallas_call at :637, body _make_kernel at :187).  K2a, the same kernel
// with its STASH flag, replaces the forward-with-stash kernel of training,
// tpugnn/kernels/fused_backward.py::make_kernel_vjp_rounds._fwd (pl.pallas_call
// at :575, body _make_fwd_kernel at :233): at the start of every round it
// also copies the round's input states to the stash [R, B, rows, H], the
// only residuals the backward (fused_backward.cu) reads.  The function is the
// one tpugnn_torch/kernels/fused_decoder.py::rounds_plain computes; read that
// docstring for the math.  The TPU schedule is not copied: the slot gather
// reads source rows by index from shared memory instead of the one-hot
// incidence GEMM, and the layout is the batch layout [B, rows, H].
//
// Design: one block of 256 threads per sample; all R rounds loop inside the
// block.  Per round:
//   A  ys_c = rnd(x_q @ ws_c) for all qubit rows      -> shared panel [N, H]
//   B  check rows: x @ [wd_c|uc_x|ws_q] (ws_q part -> shared panel ys_q
//      [M, H]), slot gather-sum over ys_c, folded aggregation GEMM, update
//      MLP, residual, LayerNorm; the new rows overwrite the state
//   C  qubit rows, the same against ys_q
// The states live in the output tensors (global memory; a block's 2 x 128 x
// 128 panel pair stays in L2) and are rewritten in place chunk by chunk; the
// two gather panels and the chunk buffers are in shared memory.
//
// Two instantiations:
//   bf16 states (the bench config, training): the tensor-core path, tcp::
//     below.  Every operand of every product is a bf16 value (states, hs and
//     hc are rounded, the packed matrices stored in bf16), so
//     mma.sync.m16n8k16 bf16 with f32 accumulation forms the same products
//     as the plain version; only the f32 summation order differs.  Chunks
//     are a whole side of 128 rows (8 warps x 16 rows), so each weight
//     matrix is staged once per side and round (320 KB a sample-round at
//     d=11 instead of 1.31 MB through 32-row chunks), double-buffered with
//     cp.async behind 4 barriers per product (rounds_mma.cuh).  A side of
//     more rows (d=13: 176) runs a second, ragged chunk.
//   f32 states (the trained decode, serve, LER): 32-row chunks, each warp 4
//     rows and each lane 4 columns, f32 FMA loops over a 16-deep slab
//     (gemm_chunk, rounds_common.cuh), unchanged.
//
// Bounds on an H100 at d=11, H=128: 39.7 MFLOP per sample and round on the
// 241 real rows with the folded weights; HBM traffic is only the states in
// and out.  So the work is bound by operations: at B=4096, R=8 1.30 TFLOP,
// 1.32 ms at the bf16 tensor-core peak (989 TFLOP/s) and 19.4 ms at the f32
// CUDA-core peak (67 TFLOP/s), the floor of the f32 path and of any FMA
// design.  One block per SM by shared memory.

#include "rounds_common.cuh"
#include "rounds_mma.cuh"

namespace {

using namespace rounds;

template <typename T>
struct Smem {
  T* ys_c;      // [N][H] qubit-row projections, gathered by check rows
  T* ys_q;      // [M][H] check-row projections, gathered by qubit rows
  float* xs;    // [CH][XLD] state chunk (GEMM A operand, residual)
  float* hs;    // [CH][XLD] slot sum, then update hidden (GEMM A operand)
  T* wsl;       // [KS][3*H] staged weight slab
  int* idx_c;   // [M][Dc] source qubit per slot, -1 for a masked slot
  int* idx_q;   // [N][Dq]
};

template <typename T>
__host__ __device__ inline size_t smem_bytes(int M, int N, int Dc, int Dq) {
  size_t s = 0;
  s += align16(size_t(N) * H * sizeof(T));
  s += align16(size_t(M) * H * sizeof(T));
  s += 2 * align16(size_t(CH) * XLD * sizeof(float));
  s += align16(size_t(KS) * 3 * H * sizeof(T));
  s += align16(size_t(M) * Dc * sizeof(int));
  s += align16(size_t(N) * Dq * sizeof(int));
  return s;
}

template <typename T>
__device__ Smem<T> carve(unsigned char* base, int M, int N, int Dc, int Dq) {
  Smem<T> s;
  size_t o = 0;
  s.ys_c = reinterpret_cast<T*>(base + o);     o += align16(size_t(N) * H * sizeof(T));
  s.ys_q = reinterpret_cast<T*>(base + o);     o += align16(size_t(M) * H * sizeof(T));
  s.xs = reinterpret_cast<float*>(base + o);   o += align16(size_t(CH) * XLD * sizeof(float));
  s.hs = reinterpret_cast<float*>(base + o);   o += align16(size_t(CH) * XLD * sizeof(float));
  s.wsl = reinterpret_cast<T*>(base + o);      o += align16(size_t(KS) * 3 * H * sizeof(T));
  s.idx_c = reinterpret_cast<int*>(base + o);  o += align16(size_t(M) * Dc * sizeof(int));
  s.idx_q = reinterpret_cast<int*>(base + o);
  return s;
}

// Phases B and C: update rows [0, rows) of state x in place (reading the
// state from x_src, writing it to x_dst, which may alias).  NW = 3 also
// writes the projection x @ W[M_WS] into ys_out (the other direction's
// gather source); SYN adds the syndrome term.
template <typename T, int NW, bool SYN>
__device__ void update_rows(const T* x_src, T* x_dst, int rows,
                            const T* ys_src, T* ys_out, const int* idx, int D,
                            const float* syn, const T* __restrict__ W,
                            const float* __restrict__ vec, const Smem<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4;
  float b0[4], boa[4], ucs[4], ub0[4], ub1[4], lns[4], lnb[4];
  load4(vec + V_B0 * H + c0, b0);
  load4(vec + V_BOA * H + c0, boa);
  load4(vec + V_UCS * H + c0, ucs);
  load4(vec + V_UB0 * H + c0, ub0);
  load4(vec + V_UB1 * H + c0, ub1);
  load4(vec + V_LNS * H + c0, lns);
  load4(vec + V_LNB * H + c0, lnb);
  const T tag{};

  for (int row0 = 0; row0 < rows; row0 += CH) {
    __syncthreads();  // the previous chunk's readers of xs / hs are done
    load_chunk(x_src, row0, rows, s.xs);

    // [x @ wd | x @ ux | x @ ws]
    float acc[NW][4][4];
    gemm_chunk<T, NW>(s.xs, W, s.wsl, acc);

    // slot gather-sum over the source panel
    float deg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      float h4[4] = {0.f, 0.f, 0.f, 0.f};
      deg[i] = 0.f;
      if (r < rows) {
        if (NW == 3) {
          float p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) p[j] = acc[NW - 1][i][j];
          store4(ys_out + size_t(r) * H + c0, p);
        }
        float ydb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) ydb[j] = acc[M_WD][i][j] + b0[j];
        for (int k = 0; k < D; ++k) {
          const int src = idx[r * D + k];
          if (src < 0) continue;
          deg[i] += 1.f;
          float y[4];
          load4(ys_src + size_t(src) * H + c0, y);
#pragma unroll
          for (int j = 0; j < 4; ++j) h4[j] += fmaxf(y[j] + ydb[j], 0.f);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) h4[j] = rnd(h4[j], tag);
      store4(s.hs + lr * XLD + c0, h4);
    }

    // folded aggregation GEMM, update-MLP pre-activation
    float agg[1][4][4];
    gemm_chunk<T, 1>(s.hs, W + size_t(M_WF) * H * H, s.wsl, agg);
    __syncthreads();  // every warp has read hs before it is overwritten
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      const float sv = (SYN && r < rows) ? syn[r] : 0.f;
      float hc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pre = acc[M_UX][i][j] + agg[0][i][j] + deg[i] * boa[j] + ub0[j];
        if (SYN) pre += sv * ucs[j];
        hc[j] = rnd(fmaxf(pre, 0.f), tag);
      }
      store4(s.hs + lr * XLD + c0, hc);
    }

    // update output GEMM, residual, LayerNorm (two-pass, eps 1e-6)
    gemm_chunk<T, 1>(s.hs, W + size_t(M_W1) * H * H, s.wsl, agg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      float v[4];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = s.xs[lr * XLD + c0 + j] + agg[0][i][j] + ub1[j];
        sum += v[j];
      }
      const float mu = warp_sum(sum) * (1.f / H);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sq += (v[j] - mu) * (v[j] - mu);
      const float rs = rsqrtf(warp_sum(sq) * (1.f / H) + 1e-6f);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = (v[j] - mu) * rs * lns[j] + lnb[j];
      if (r < rows) store4(x_dst + size_t(r) * H + c0, o);
    }
  }
}

template <typename T, bool STASH>
__global__ void __launch_bounds__(THREADS, 1)
fused_rounds_kernel(const T* xc_in, const T* xq_in, const float* __restrict__ syn,
                    const int* __restrict__ idx_c, const int* __restrict__ idx_q,
                    const T* __restrict__ mats, const float* __restrict__ vecs,
                    T* xc_out, T* xq_out, T* stash_c, T* stash_q,
                    int M, int N, int Dc, int Dq, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s = carve<T>(smem_raw, M, N, Dc, Dq);
  const size_t b = blockIdx.x;
  for (int e = threadIdx.x; e < M * Dc; e += THREADS) s.idx_c[e] = idx_c[e];
  for (int e = threadIdx.x; e < N * Dq; e += THREADS) s.idx_q[e] = idx_q[e];
  const float* syn_b = syn + b * M;
  T* xc = xc_out + b * size_t(M) * H;
  T* xq = xq_out + b * size_t(N) * H;
  const T* wc = mats;                       // check direction's 5 matrices
  const T* wq = mats + size_t(NMAT) * H * H;  // qubit direction's 5 matrices

  for (int round = 0; round < R; ++round) {
    // round 0 reads the inputs; later rounds the states rewritten in place
    const T* xc_src = round == 0 ? xc_in + b * size_t(M) * H : xc;
    const T* xq_src = round == 0 ? xq_in + b * size_t(N) * H : xq;
    if (STASH) {  // read before project_rows' first barrier, rewritten after it
      const size_t sb = size_t(round) * gridDim.x + b;
      block_copy16(stash_c + sb * M * H, xc_src, size_t(M) * H * sizeof(T) / 16);
      block_copy16(stash_q + sb * N * H, xq_src, size_t(N) * H * sizeof(T) / 16);
    }
    project_rows<T>(xq_src, N, wq + size_t(M_WS) * H * H, s.ys_c, s.xs, s.wsl);
    __syncthreads();
    update_rows<T, 3, true>(xc_src, xc, M, s.ys_c, s.ys_q, s.idx_c, Dc, syn_b,
                            wc, vecs, s);
    __syncthreads();
    update_rows<T, 2, false>(xq_src, xq, N, s.ys_q, nullptr, s.idx_q, Dq, nullptr,
                             wq, vecs + NVEC * H, s);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The bf16 path on tensor cores (rounds_mma.cuh).  Per round, with whole-side
// chunks of 128 rows (a second, ragged chunk for larger sides), one product
// (one weight matrix) at a time, each accumulator m16 x n128 per warp:
//   A  ys_c = rnd(x_q @ ws_c)
//   B  check chunk: ys_q = rnd(x @ ws_q); ydb = x @ wd + b0 and the slot
//      gather-sum; pre = hs @ wf + x @ ux (the second product accumulates
//      into the first's registers, so no two accumulators are ever live);
//      hc @ w1, the residual and LayerNorm (a row is one quad: two shuffles)
//   C  qubit chunk: the same without ys_q and the syndrome term
// Each product streams its weights once per chunk: 10 matrices, 320 KB of
// bf16 per sample-round at d=11, two 64-row slabs each.
namespace tcp {

using namespace rounds::tc;

template <int SR>
__host__ __device__ inline size_t smem_bytes(int M, int N, int Dc, int Dq) {
  size_t s = 0;
  s += align16(size_t(N) * H * sizeof(bf16));
  s += align16(size_t(M) * H * sizeof(bf16));
  s += 2 * CHUNK_BYTES;
  s += slab_bytes(SR);
  s += align16(size_t(M) * Dc * sizeof(int));
  s += align16(size_t(N) * Dq * sizeof(int));
  return s;
}

struct Smem {
  bf16* ys_c;   // [N][H] swizzled, gathered by check rows
  bf16* ys_q;   // [M][H] swizzled, gathered by qubit rows
  bf16* xs;     // [CR][LDB] state chunk (A operand, residual, output staging)
  bf16* hs;     // [CR][LDB] slot sum, then update hidden (A operand)
  bf16* slab;   // [2][SR][LDB] weight slabs
  int* idx_c;
  int* idx_q;
};

template <int SR>
__device__ Smem carve(unsigned char* base, int M, int N, int Dc) {
  Smem s;
  size_t o = 0;
  s.ys_c = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(N) * H * sizeof(bf16));
  s.ys_q = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(M) * H * sizeof(bf16));
  s.xs = reinterpret_cast<bf16*>(base + o);    o += CHUNK_BYTES;
  s.hs = reinterpret_cast<bf16*>(base + o);    o += CHUNK_BYTES;
  s.slab = reinterpret_cast<bf16*>(base + o);  o += slab_bytes(SR);
  s.idx_c = reinterpret_cast<int*>(base + o);  o += align16(size_t(M) * Dc * sizeof(int));
  s.idx_q = reinterpret_cast<int*>(base + o);
  return s;
}

// Phases B (CHECK) and C: rows [0, rows) of state x_src updated into x_dst
// (which may alias it); CHECK also writes ys_out = rnd(x @ ws) and adds the
// syndrome term.  `after` is the product that follows the last chunk.
template <int SR, bool CHECK>
__device__ void update_rows_tc(const bf16* x_src, bf16* x_dst, int rows, const bf16* ys_src,
                               bf16* ys_out, const int* idx, int D, const float* syn,
                               const bf16* __restrict__ W, const float* __restrict__ vec,
                               const Smem& s, Slabs<SR>& sl, const bf16* after) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* xa = s.xs + 16 * warp * LDB;
  bf16* ha = s.hs + 16 * warp * LDB;
  const bf16* wd = W + size_t(M_WD) * HH;
  const bf16* ux = W + size_t(M_UX) * HH;
  const bf16* ws = W + size_t(M_WS) * HH;
  const bf16* wf = W + size_t(M_WF) * HH;
  const bf16* w1 = W + size_t(M_W1) * HH;
  const bf16* first = CHECK ? ws : wd;

  for (int row0 = 0; row0 < rows; row0 += CR) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, rows - r0));
    const bool active = n > 0;
    load_rows_warp(xa, x_src + size_t(r0) * H, n);
    float acc[NT][4];

    if (CHECK) {   // the other direction's gather source
      mma_pass<SR>(xa, ws, sl, wd, acc, active);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            st_bf2(ys_out + swz(r, 8 * j + 2 * t), acc[j][2 * h], acc[j][2 * h + 1]);
        }
      }
    }

    // ydb = x @ wd + b0, then the slot gather-sum over the source panel
    mma_pass<SR>(xa, wd, sl, wf, acc, active);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b0 = ld_vec2(vec, V_B0, 8 * j + 2 * t);
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
        for (int k = 0; k < D; ++k) {
          const int src = idx[r * D + k];
          if (src < 0) continue;
          deg[h] += 1.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 y = ld_bf2(ys_src + swz(src, 8 * j + 2 * t));
            hsum[j][0] += fmaxf(y.x + acc[j][2 * h], 0.f);
            hsum[j][1] += fmaxf(y.y + acc[j][2 * h + 1], 0.f);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        st_bf2(ha + (g + 8 * h) * LDB + 8 * j + 2 * t, hsum[j][0], hsum[j][1]);
    }
    __syncwarp();

    // update-MLP pre-activation: hs @ (wo @ ua) + x @ ux + ...
    mma_pass<SR>(ha, wf, sl, ux, acc, active);
    mma_pass<SR, true>(xa, ux, sl, w1, acc, active);
    float sv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      sv[h] = (CHECK && r < rows) ? syn[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 boa = ld_vec2(vec, V_BOA, c), ub0 = ld_vec2(vec, V_UB0, c);
      float2 ucs = make_float2(0.f, 0.f);
      if (CHECK) ucs = ld_vec2(vec, V_UCS, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0 = acc[j][2 * h] + deg[h] * boa.x + ub0.x;
        float p1 = acc[j][2 * h + 1] + deg[h] * boa.y + ub0.y;
        if (CHECK) {
          p0 += sv[h] * ucs.x;
          p1 += sv[h] * ucs.y;
        }
        st_bf2(ha + (g + 8 * h) * LDB + c, fmaxf(p0, 0.f), fmaxf(p1, 0.f));
      }
    }
    __syncwarp();

    // update output, residual, LayerNorm (two-pass, eps 1e-6)
    mma_pass<SR>(ha, w1, sl, row0 + CR < rows ? first : after, acc, active);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 x = ld_bf2(xa + (g + 8 * h) * LDB + c);
        const float2 ub1 = ld_vec2(vec, V_UB1, c);
        acc[j][2 * h] += x.x + ub1.x;
        acc[j][2 * h + 1] += x.y + ub1.y;
        sum += acc[j][2 * h] + acc[j][2 * h + 1];
      }
      const float mu = quad_sum(sum) * (1.f / H);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * h] -= mu;
        acc[j][2 * h + 1] -= mu;
        sq += acc[j][2 * h] * acc[j][2 * h] + acc[j][2 * h + 1] * acc[j][2 * h + 1];
      }
      const float rs = rsqrtf(quad_sum(sq) * (1.f / H) + 1e-6f);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 lns = ld_vec2(vec, V_LNS, c), lnb = ld_vec2(vec, V_LNB, c);
        st_bf2(xa + (g + 8 * h) * LDB + c, acc[j][2 * h] * rs * lns.x + lnb.x,
               acc[j][2 * h + 1] * rs * lns.y + lnb.y);
      }
    }
    store_rows_warp(x_dst + size_t(r0) * H, xa, n);
  }
}

template <bool STASH, int SR>
__global__ void __launch_bounds__(THREADS, 1)
fused_rounds_tc_kernel(const bf16* xc_in, const bf16* xq_in, const float* __restrict__ syn,
                       const int* __restrict__ idx_c, const int* __restrict__ idx_q,
                       const bf16* __restrict__ mats, const float* __restrict__ vecs,
                       bf16* xc_out, bf16* xq_out, bf16* stash_c, bf16* stash_q,
                       int M, int N, int Dc, int Dq, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve<SR>(smem_raw, M, N, Dc);
  const size_t b = blockIdx.x;
  for (int e = threadIdx.x; e < M * Dc; e += THREADS) s.idx_c[e] = idx_c[e];
  for (int e = threadIdx.x; e < N * Dq; e += THREADS) s.idx_q[e] = idx_q[e];
  const float* syn_b = syn + b * M;
  bf16* xc = xc_out + b * size_t(M) * H;
  bf16* xq = xq_out + b * size_t(N) * H;
  const bf16* wc = mats;
  const bf16* wq = mats + size_t(NMAT) * HH;
  const bf16* proj = wq + size_t(M_WS) * HH;   // ys_c = rnd(x_q @ ws_c)
  Slabs<SR> sl{s.slab, 0};
  prime(sl, proj);

  for (int round = 0; round < R; ++round) {
    const bf16* xc_src = round == 0 ? xc_in + b * size_t(M) * H : xc;
    const bf16* xq_src = round == 0 ? xq_in + b * size_t(N) * H : xq;
    if (STASH) {  // read before the first barrier of the round, rewritten after it
      const size_t sb = size_t(round) * gridDim.x + b;
      block_copy16(stash_c + sb * M * H, xc_src, size_t(M) * H * sizeof(bf16) / 16);
      block_copy16(stash_q + sb * N * H, xq_src, size_t(N) * H * sizeof(bf16) / 16);
    }
    project_rows_tc<SR>(xq_src, N, proj, s.ys_c, s.xs, sl, wc + size_t(M_WS) * HH);
    update_rows_tc<SR, true>(xc_src, xc, M, s.ys_c, s.ys_q, s.idx_c, Dc, syn_b, wc, vecs,
                             s, sl, wq + size_t(M_WD) * HH);
    update_rows_tc<SR, false>(xq_src, xq, N, s.ys_q, nullptr, s.idx_q, Dq, nullptr, wq,
                              vecs + NVEC * H, s, sl, round + 1 < R ? proj : nullptr);
    __syncthreads();   // the round's state writes are visible to the next round
  }
}

}  // namespace tcp

// The slab rows of the bf16 kernel for a graph: 64 where that fits in shared
// memory, else 32; 0 where neither does.
int tc_slab_rows(int M, int N, int Dc, int Dq) {
  if (tcp::smem_bytes<64>(M, N, Dc, Dq) <= tc::SMEM_LIMIT) return 64;
  if (tcp::smem_bytes<32>(M, N, Dc, Dq) <= tc::SMEM_LIMIT) return 32;
  return 0;
}

size_t smem_for(int dtype, int M, int N, int Dc, int Dq) {
  if (dtype == 0) return smem_bytes<float>(M, N, Dc, Dq);
  return tc_slab_rows(M, N, Dc, Dq) == 32 ? tcp::smem_bytes<32>(M, N, Dc, Dq)
                                          : tcp::smem_bytes<64>(M, N, Dc, Dq);
}

template <typename K, typename... Args>
int launch_kernel(K kernel, int grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

template <bool STASH>
int launch_dtype(int dtype, const void* xc_in, const void* xq_in, const void* syn,
                 const void* idx_c, const void* idx_q, const void* mats,
                 const void* vecs, void* xc_out, void* xq_out, void* stash_c,
                 void* stash_q, int B, int M, int N, int Dc, int Dq, int R,
                 void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || Dc <= 0 || Dq <= 0 || R <= 0)
    return int(cudaErrorInvalidValue);
  if (STASH && (stash_c == nullptr || stash_q == nullptr))
    return int(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(syn);
  const int* ic = static_cast<const int*>(idx_c);
  const int* iq = static_cast<const int*>(idx_q);
  const float* v = static_cast<const float*>(vecs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_for(dtype, M, N, Dc, Dq);
  if (dtype == 0)
    return launch_kernel(fused_rounds_kernel<float, STASH>, B, smem, st,
                         static_cast<const float*>(xc_in), static_cast<const float*>(xq_in),
                         s, ic, iq, static_cast<const float*>(mats), v,
                         static_cast<float*>(xc_out), static_cast<float*>(xq_out),
                         static_cast<float*>(stash_c), static_cast<float*>(stash_q),
                         M, N, Dc, Dq, R);
  if (dtype != 1) return int(cudaErrorInvalidValue);
  typedef __nv_bfloat16 bf;
  const bf* xci = static_cast<const bf*>(xc_in);
  const bf* xqi = static_cast<const bf*>(xq_in);
  const bf* mt = static_cast<const bf*>(mats);
  bf* xco = static_cast<bf*>(xc_out);
  bf* xqo = static_cast<bf*>(xq_out);
  bf* sc = static_cast<bf*>(stash_c);
  bf* sq = static_cast<bf*>(stash_q);
  switch (tc_slab_rows(M, N, Dc, Dq)) {
    case 64:
      return launch_kernel(tcp::fused_rounds_tc_kernel<STASH, 64>, B, smem, st, xci, xqi, s,
                           ic, iq, mt, v, xco, xqo, sc, sq, M, N, Dc, Dq, R);
    case 32:
      return launch_kernel(tcp::fused_rounds_tc_kernel<STASH, 32>, B, smem, st, xci, xqi, s,
                           ic, iq, mt, v, xco, xqo, sc, sq, M, N, Dc, Dq, R);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = float32 states, 1 = bfloat16.
long long fused_rounds_smem_bytes(int dtype, int M, int N, int Dc, int Dq) {
  return (long long)smem_for(dtype, M, N, Dc, Dq);
}

// xc_in/xq_in/xc_out/xq_out: [B, M|N, 128] in the state type; syn [B, M] f32;
// idx_c [M, Dc], idx_q [N, Dq] int32 (-1 = masked slot); mats [10, 128, 128]
// in the state type; vecs [14, 128] f32.  Returns cudaGetLastError() after the
// launch (0 on success).
int fused_rounds_launch(int dtype, const void* xc_in, const void* xq_in,
                        const void* syn, const void* idx_c, const void* idx_q,
                        const void* mats, const void* vecs, void* xc_out,
                        void* xq_out, int B, int M, int N, int Dc, int Dq, int R,
                        void* stream) {
  return launch_dtype<false>(dtype, xc_in, xq_in, syn, idx_c, idx_q, mats, vecs,
                             xc_out, xq_out, nullptr, nullptr, B, M, N, Dc, Dq, R,
                             stream);
}

// K2a: as fused_rounds_launch, and every round's input states go to
// stash_c [R, B, M, 128] and stash_q [R, B, N, 128] in the state type.
int fused_rounds_stash_launch(int dtype, const void* xc_in, const void* xq_in,
                              const void* syn, const void* idx_c, const void* idx_q,
                              const void* mats, const void* vecs, void* xc_out,
                              void* xq_out, void* stash_c, void* stash_q, int B,
                              int M, int N, int Dc, int Dq, int R, void* stream) {
  return launch_dtype<true>(dtype, xc_in, xq_in, syn, idx_c, idx_q, mats, vecs,
                            xc_out, xq_out, stash_c, stash_q, B, M, N, Dc, Dq, R,
                            stream);
}

}  // extern "C"
