// R weight-tied message rounds of the GNN decoder on the raster of a rotated
// surface code, in one launch (Hopper): K5.
//
// K5 replaces the TPU kernel tpugnn/kernels/roll_gather.py::decoder_rounds_roll
// (pl.pallas_call at :364, body _make_roll_kernel at :188).  The function is
// the one tpugnn_torch/kernels/roll_gather.py::roll_rounds_plain computes;
// read that module's docstring for the math and the term order.  The node
// rows sit on a (d+1)-pitch raster of L cells (checks and qubits each on
// their own raster), so slot k of cell r reads its source at cell
// (r + offs[k]) mod L and is real where bit k of the cell's mask entry is
// set.  The TPU kernel rotates whole panels with two static slices because
// Mosaic has no dynamic gather; here a thread reads the source row directly
// by its index, with no index table.  The batch layout is [B, L, H].
//
// Design: K1's (fused_rounds.cu), on L raster rows per side instead of the
// graph's padded rows.  One block of 256 threads per sample; all R rounds
// loop inside the block.  Per round:
//   A  ys_c = rnd(x_q @ ws_c) for every qubit cell        -> shared panel [L, H]
//   B  check cells in chunks of 32: x @ [wd_c|uc_x|ws_q] (ws_q part -> shared
//      panel ys_q [L, H]), the four-slot rotation sum over ys_c, the folded
//      aggregation GEMM plus (deg * bo) @ ua, update MLP, residual, LayerNorm;
//      the new rows overwrite the state in place
//   C  qubit cells in chunks of 32, the same against ys_q
// Empty cells are computed like the others (their states move by relu(ub0)),
// as in the JAX kernel.  With SLOT16 the slot stage rounds to bf16 after
// every add, as the JAX kernel's bf16 slot type does (an f32 add then one
// rounding to bf16 is the bf16 add: 24 >= 2 * 8 + 2 bits).
//
// Bounds on an H100 at d=11, H=128: the work is K1's (the raster's 288 rows
// against the graph's 241 real ones are this design's overhead), 42 MFLOP per
// sample and round; bound by operations: at B=4096, R=8 about 1.3 ms at the
// bf16 tensor-core peak and 21 ms at the f32 CUDA-core peak this kernel's FMA
// loops can reach.  It runs on CUDA cores, one block per SM by shared memory
// (about 206 KB at f32): a first version that is right, not yet a fast one.

#include "rounds_common.cuh"

namespace {

using namespace rounds;

constexpr int SLOTS = 4;

struct Offsets {
  int o[SLOTS];
};

template <typename T>
struct Smem {
  T* ys_c;               // [L][H] qubit-cell projections, read by check cells
  T* ys_q;               // [L][H] check-cell projections, read by qubit cells
  float* xs;             // [CH][XLD] state chunk (GEMM A operand, residual)
  float* hs;             // [CH][XLD] slot sum, then update hidden (GEMM A operand)
  T* wsl;                // [KS][3*H] staged weight slab
  unsigned char* bits;   // [2][L] slot-mask bits: check cells, then qubit cells
};

template <typename T>
__host__ __device__ inline size_t smem_bytes(int L) {
  return 2 * align16(size_t(L) * H * sizeof(T)) +
         2 * align16(size_t(CH) * XLD * sizeof(float)) +
         align16(size_t(KS) * 3 * H * sizeof(T)) + align16(size_t(2) * L);
}

template <typename T>
__device__ Smem<T> carve(unsigned char* base, int L) {
  Smem<T> s;
  size_t o = 0;
  s.ys_c = reinterpret_cast<T*>(base + o);     o += align16(size_t(L) * H * sizeof(T));
  s.ys_q = reinterpret_cast<T*>(base + o);     o += align16(size_t(L) * H * sizeof(T));
  s.xs = reinterpret_cast<float*>(base + o);   o += align16(size_t(CH) * XLD * sizeof(float));
  s.hs = reinterpret_cast<float*>(base + o);   o += align16(size_t(CH) * XLD * sizeof(float));
  s.wsl = reinterpret_cast<T*>(base + o);      o += align16(size_t(KS) * 3 * H * sizeof(T));
  s.bits = base + o;
  return s;
}

// the slot stage's rounding: to bf16 after every op with SLOT16, none in f32
template <bool SLOT16>
__device__ __forceinline__ float srnd(float x) {
  if constexpr (SLOT16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Phases B and C: update cells [0, L) of state x in place (reading the state
// from x_src, writing it to x_dst, which may alias).  NW = 3 also writes the
// projection x @ W[M_WS] into ys_out (the other side's gather source); SYN
// adds the syndrome term rnd(syn * uc_s).
template <typename T, int NW, bool SYN, bool SLOT16>
__device__ void update_cells(const T* x_src, T* x_dst, int L, const T* ys_src, T* ys_out,
                             const unsigned char* bits, Offsets offs, const float* syn,
                             const float* __restrict__ degbo, const T* __restrict__ W,
                             const float* __restrict__ vec, const Smem<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4;
  float b0[4], ucs[4], ub0[4], ub1[4], lns[4], lnb[4];
  load4(vec + V_B0 * H + c0, b0);
  load4(vec + V_UCS * H + c0, ucs);
  load4(vec + V_UB0 * H + c0, ub0);
  load4(vec + V_UB1 * H + c0, ub1);
  load4(vec + V_LNS * H + c0, lns);
  load4(vec + V_LNB * H + c0, lnb);
  const T tag{};

  for (int row0 = 0; row0 < L; row0 += CH) {
    __syncthreads();  // the previous chunk's readers of xs / hs are done
    load_chunk(x_src, row0, L, s.xs);

    // [x @ wd | x @ ux | x @ ws]
    float acc[NW][4][4];
    gemm_chunk<T, NW>(s.xs, W, s.wsl, acc);

    // four-slot rotation sum over the source panel, in offs order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = warp * 4 + i, r = row0 + lr;
      float h4[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < L) {
        if (NW == 3) {
          float p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) p[j] = acc[NW - 1][i][j];
          store4(ys_out + size_t(r) * H + c0, p);
        }
        float ydb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) ydb[j] = srnd<SLOT16>(acc[M_WD][i][j] + b0[j]);
        const unsigned m = bits[r];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          if (!((m >> k) & 1u)) continue;   // a masked slot adds exactly 0
          int src = r + offs.o[k];
          src = src < 0 ? src + L : (src >= L ? src - L : src);
          float y[4];
          load4(ys_src + size_t(src) * H + c0, y);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            h4[j] = srnd<SLOT16>(h4[j] + fmaxf(srnd<SLOT16>(y[j] + ydb[j]), 0.f));
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
      float db[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < L) load4(degbo + size_t(r) * H + c0, db);
      const float sv = (SYN && r < L) ? syn[r] : 0.f;
      float hc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pre = acc[M_UX][i][j] + (agg[0][i][j] + db[j]);
        if (SYN) pre += rnd(__fmul_rn(sv, ucs[j]), tag);
        pre += ub0[j];
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
      if (r < L) store4(x_dst + size_t(r) * H + c0, o);
    }
  }
}

template <typename T, bool SLOT16>
__global__ void __launch_bounds__(THREADS, 1)
roll_rounds_kernel(const T* xc_in, const T* xq_in, const float* __restrict__ syn,
                   const int* __restrict__ maskbits, const float* __restrict__ degbo,
                   const T* __restrict__ mats, const float* __restrict__ vecs,
                   T* xc_out, T* xq_out, Offsets offs_c, Offsets offs_q, int L, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s = carve<T>(smem_raw, L);
  const size_t b = blockIdx.x;
  for (int e = threadIdx.x; e < 2 * L; e += THREADS)
    s.bits[e] = static_cast<unsigned char>(maskbits[e]);
  const float* syn_b = syn + b * L;
  T* xc = xc_out + b * size_t(L) * H;
  T* xq = xq_out + b * size_t(L) * H;
  const T* wc = mats;                         // check side's 5 matrices
  const T* wq = mats + size_t(NMAT) * H * H;  // qubit side's 5 matrices

  for (int round = 0; round < R; ++round) {
    // round 0 reads the inputs; later rounds the states rewritten in place
    const T* xc_src = round == 0 ? xc_in + b * size_t(L) * H : xc;
    const T* xq_src = round == 0 ? xq_in + b * size_t(L) * H : xq;
    project_rows<T>(xq_src, L, wq + size_t(M_WS) * H * H, s.ys_c, s.xs, s.wsl);
    __syncthreads();
    update_cells<T, 3, true, SLOT16>(xc_src, xc, L, s.ys_c, s.ys_q, s.bits, offs_c,
                                     syn_b, degbo, wc, vecs, s);
    __syncthreads();
    update_cells<T, 2, false, SLOT16>(xq_src, xq, L, s.ys_q, nullptr, s.bits + L, offs_q,
                                      nullptr, degbo + size_t(L) * H, wq, vecs + NVEC * H,
                                      s);
    __syncthreads();
  }
}

template <typename T, bool SLOT16>
int launch(const void* xc_in, const void* xq_in, const float* syn, const int* bits,
           const float* degbo, const void* mats, const float* vecs, void* xc_out,
           void* xq_out, Offsets offs_c, Offsets offs_q, int B, int L, int R,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(L);
  cudaError_t err = cudaFuncSetAttribute(roll_rounds_kernel<T, SLOT16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  roll_rounds_kernel<T, SLOT16><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(xc_in), static_cast<const T*>(xq_in), syn, bits, degbo,
      static_cast<const T*>(mats), vecs, static_cast<T*>(xc_out), static_cast<T*>(xq_out),
      offs_c, offs_q, L, R);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = float32 states, 1 = bfloat16.
long long roll_rounds_smem_bytes(int dtype, int L) {
  return dtype == 0 ? (long long)smem_bytes<float>(L)
                    : (long long)smem_bytes<__nv_bfloat16>(L);
}

// xc_in/xq_in/xc_out/xq_out: [B, L, 128] raster states in the state type;
// syn [B, L] f32; maskbits [2, L] int32 (bit k: slot k of the cell is real;
// check cells, then qubit cells); degbo [2, L, 128] f32; mats [10, 128, 128]
// in the state type; vecs [14, 128] f32 (row 2 the unrounded uc_s); offs, a
// host array of 8 ints: the four check-side offsets, then the four qubit-side
// ones.  slot16 (bf16 states only) rounds the slot stage to bf16.  Returns
// cudaGetLastError() after the launch (0 on success).
int roll_rounds_launch(int dtype, int slot16, const void* xc_in, const void* xq_in,
                       const void* syn, const void* maskbits, const void* degbo,
                       const void* mats, const void* vecs, void* xc_out, void* xq_out,
                       const void* offs, int B, int L, int R, void* stream) {
  if (B <= 0 || L <= 0 || R <= 0 || offs == nullptr) return int(cudaErrorInvalidValue);
  Offsets oc, oq;
  const int* o = static_cast<const int*>(offs);
  for (int k = 0; k < SLOTS; ++k) {
    oc.o[k] = o[k];
    oq.o[k] = o[SLOTS + k];
    if (oc.o[k] <= -L || oc.o[k] >= L || oq.o[k] <= -L || oq.o[k] >= L)
      return int(cudaErrorInvalidValue);
  }
  const float* s = static_cast<const float*>(syn);
  const int* mb = static_cast<const int*>(maskbits);
  const float* db = static_cast<const float*>(degbo);
  const float* v = static_cast<const float*>(vecs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(xc_in, xq_in, s, mb, db, mats, v, xc_out, xq_out, oc, oq,
                                B, L, R, st);
  if (dtype == 1 && slot16)
    return launch<__nv_bfloat16, true>(xc_in, xq_in, s, mb, db, mats, v, xc_out, xq_out,
                                       oc, oq, B, L, R, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(xc_in, xq_in, s, mb, db, mats, v, xc_out, xq_out,
                                        oc, oq, B, L, R, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
