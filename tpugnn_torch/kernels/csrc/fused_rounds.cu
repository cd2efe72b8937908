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
//   B  check rows in chunks of 32: x @ [wd_c|uc_x|ws_q] (ws_q part -> shared
//      panel ys_q [M, H]), slot gather-sum over ys_c, folded aggregation GEMM,
//      update MLP, residual, LayerNorm; the new rows overwrite the state
//   C  qubit rows in chunks of 32, the same against ys_q
// The states live in the output tensors (global memory; a block's 2 x 128 x
// 128 panel pair stays in L2) and are rewritten in place chunk by chunk; the
// two gather panels and the chunk buffers are in shared memory.  Each warp
// owns 4 rows of a chunk and each lane 4 columns, so a LayerNorm row is one
// warp reduction.  GEMMs are FMA loops over a 16-deep slab of the weights
// staged in shared memory (weights stay L2-resident across blocks).
//
// Bounds on an H100 at d=11, H=128: 42 MFLOP per sample and round with the
// folded weights; HBM traffic is only the states in and out.  So the work is
// bound by operations: at B=4096, R=8 about 1.4 TFLOP, 1.4 ms at the bf16
// tensor-core peak and 21 ms at the f32 CUDA-core peak this kernel's FMA
// loops can reach.  It runs on CUDA cores (no mma/wgmma), one block per SM by
// shared memory: a first version that is right, not yet a fast one.

#include "rounds_common.cuh"

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

template <typename T, bool STASH>
int launch(const void* xc_in, const void* xq_in, const float* syn, const int* idx_c,
           const int* idx_q, const void* mats, const float* vecs, void* xc_out,
           void* xq_out, void* stash_c, void* stash_q, int B, int M, int N, int Dc,
           int Dq, int R, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(M, N, Dc, Dq);
  cudaError_t err = cudaFuncSetAttribute(fused_rounds_kernel<T, STASH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  fused_rounds_kernel<T, STASH><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(xc_in), static_cast<const T*>(xq_in), syn, idx_c, idx_q,
      static_cast<const T*>(mats), vecs, static_cast<T*>(xc_out),
      static_cast<T*>(xq_out), static_cast<T*>(stash_c), static_cast<T*>(stash_q),
      M, N, Dc, Dq, R);
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
  if (dtype == 0)
    return launch<float, STASH>(xc_in, xq_in, s, ic, iq, mats, v, xc_out, xq_out,
                                stash_c, stash_q, B, M, N, Dc, Dq, R, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, STASH>(xc_in, xq_in, s, ic, iq, mats, v, xc_out,
                                        xq_out, stash_c, stash_q, B, M, N, Dc, Dq, R,
                                        st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = float32 states, 1 = bfloat16.
long long fused_rounds_smem_bytes(int dtype, int M, int N, int Dc, int Dq) {
  return dtype == 0 ? (long long)smem_bytes<float>(M, N, Dc, Dq)
                    : (long long)smem_bytes<__nv_bfloat16>(M, N, Dc, Dq);
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
