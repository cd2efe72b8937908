// R weight-tied message rounds of the GNN decoder in one launch (Hopper).
//
// K1 replaces the TPU kernel tpugnn/kernels/fused_decoder.py::decoder_rounds_tiled
// (pl.pallas_call at :637, body _make_kernel at :187).  K2a replaces the
// forward-with-stash kernel of training,
// tpugnn/kernels/fused_backward.py::make_kernel_vjp_rounds._fwd (pl.pallas_call
// at :575, body _make_fwd_kernel at :233): the same rounds, and every round's
// input states in the stash [R, B, rows, H], the only residuals the backward
// (fused_backward.cu) reads.  K2a is K1's kernel with its STASH flag, in
// both state types, so its outputs equal K1's bit for bit.  The function is the
// one tpugnn_torch/kernels/fused_decoder.py::rounds_plain computes; read that
// docstring for the math.  The TPU schedule is not copied: the slot gather
// reads source rows by index from shared memory instead of the one-hot
// incidence GEMM, and the layout is the batch layout [B, rows, H].
//
// Design: one block of 256 threads per sample; all R rounds loop inside the
// block.  Per round, with whole-side chunks of 128 rows (8 warps x 16 rows;
// a side of more rows runs a second, ragged chunk), one product (one weight
// matrix) at a time, each accumulator m16 x n128 per warp:
//   A  ys_c = rnd(x_q @ ws_c)                         -> gather panel [N, H]
//   B  check chunk: ys_q = rnd(x @ ws_q) -> panel [M, H]; ydb = x @ wd + b0
//      and the slot gather-sum over ys_c; pre = hs @ wf + x @ ux (the second
//      product accumulates into the first's registers, so no two
//      accumulators are ever live); hc @ w1, the residual and LayerNorm (a
//      row is one quad of lanes: two shuffles); the new rows overwrite the
//      state
//   C  qubit chunk: the same against ys_q, without ys_q and the syndrome
//      term
// The states live in the output tensors (global memory; a block's panel
// pair stays in L2) and are rewritten in place chunk by chunk.  Each product
// streams its weights once per chunk, so each matrix is staged once a side
// and round.  The two state types build apart, one library each, so that
// their nvcc runs go in parallel:
// this source holds the bf16 one; fused_rounds_tf32.cu the f32 one
// (3xTF32, namespace t3p).
//   bf16 (the bench config, training): tcp:: below.  Every operand of every
//     product is a bf16 value (states, hs and hc are rounded, the packed
//     matrices stored in bf16), so mma.sync.m16n8k16 bf16 with f32
//     accumulation forms the same products as the plain version; only the
//     f32 summation order differs.  Swizzled bf16 panels and two bf16
//     chunk buffers in shared memory; 64-row weight slabs (32 where shared
//     memory is short), double-buffered with cp.async (rounds_mma.cuh, tc).
//   Global panels in bf16 (K1 and K2a).  Where the bf16 panels do not fit
//     (circuit d=7: 920 + 176 rows, 280,576 B of panels alone), the GP
//     variant of tcp:: keeps them swizzled in the same per-block global
//     scratch [grid][N + M][H] on a persistent grid of one block per SM
//     (132 blocks: 37 MB of panels, inside the 50 MB L2), read and written
//     through the same generic loads and stores; the chunk buffers, the
//     64-row slab ring and the slot tables stay in shared memory (121,664 B
//     at circuit d=7).  The arithmetic and its order are the shared-panel
//     kernel's, so the two agree bit for bit.
//
// Width.  The kernels are built for H = 128 columns; a model of width
// h < 128 runs on states and packs zero-padded to 128 (the wrapper pads).
// Every padded column stays exactly 0 through a round (zero weight rows and
// columns, zero biases, relu(0) = 0, LayerNorm scale and bias 0), so only
// the LayerNorm sees the width: its mean and variance are taken over the
// first `width` columns, and the centred value is 0 on the others.  The bf16
// kernels compile that masking in only for width < 128 (MASK): at 128 they
// run the unmasked LayerNorm.  The f32 kernels test the width at run time.
//
// Bounds on an H100 at d=11, H=128: 39.7 MFLOP per sample and round on the
// 241 real rows with the folded weights; HBM traffic is only the states in
// and out.  So the work is bound by operations: at B=4096, R=8 1.30 TFLOP,
// 1.32 ms at the bf16 tensor-core peak (989 TFLOP/s).  In f32 the floor of
// an FMA design is the f32 CUDA-core peak (67 TFLOP/s: 19.4 ms at R=8, 33.99
// at the trained R=14); the 3xTF32 design does three TF32 products for each
// f32 one at 495 TFLOP/s, a floor of 13.80 ms at R=14.  One block per SM by
// shared memory.

#include "rounds_common.cuh"
#include "rounds_mma.cuh"

namespace {
constexpr int kDtype = 1;   // the state type this library builds: bfloat16
}  // namespace

#include "fused_rounds_api.cuh"

namespace {

using namespace rounds;

// ---------------------------------------------------------------------------
// The bf16 path on tensor cores (rounds_mma.cuh, tc); the round as the
// header describes it.  Each product streams its weights once per chunk: 10
// matrices, 320 KB of bf16 per sample-round at d=11, two 64-row slabs each.
namespace tcp {

using namespace rounds::tc;

// GP: the gather panels in global memory (the block's slice of a scratch)
template <int SR, bool GP = false>
__host__ __device__ inline size_t smem_bytes(int M, int N, int Dc, int Dq) {
  size_t s = 0;
  if (!GP) {
    s += align16(size_t(N) * H * sizeof(bf16));
    s += align16(size_t(M) * H * sizeof(bf16));
  }
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

// panels: the block's global panels [N + M][H] (GP), or nullptr
template <int SR, bool GP>
__device__ Smem carve(unsigned char* base, int M, int N, int Dc, bf16* panels) {
  Smem s;
  size_t o = 0;
  if (GP) {
    s.ys_c = panels;
    s.ys_q = panels + size_t(N) * H;
  } else {
    s.ys_c = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(N) * H * sizeof(bf16));
    s.ys_q = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(M) * H * sizeof(bf16));
  }
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
template <int SR, bool CHECK, bool MASK>
__device__ void update_rows_tc(const bf16* x_src, bf16* x_dst, int rows, const bf16* ys_src,
                               bf16* ys_out, const int* idx, int D, const float* syn,
                               const bf16* __restrict__ W, const float* __restrict__ vec,
                               const Smem& s, Slabs<SR>& sl, const bf16* after, int width) {
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

    // update output, residual, LayerNorm (two-pass, eps 1e-6, over the
    // first `width` columns)
    mma_pass<SR>(ha, w1, sl, row0 + CR < rows ? first : after, acc, active);
    const float inv_w = MASK ? 1.f / width : 1.f / H;
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
      const float mu = quad_sum(sum) * inv_w;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * h] -= mu;
        acc[j][2 * h + 1] -= mu;
      }
      if (MASK) mask_columns(acc, h, t, width);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sq += acc[j][2 * h] * acc[j][2 * h] + acc[j][2 * h + 1] * acc[j][2 * h + 1];
      const float rs = rsqrtf(quad_sum(sq) * inv_w + 1e-6f);
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

// One block per sample (grid = B), or with GP a persistent grid whose
// blocks walk the samples, each with its own panels in `panels`.
template <bool STASH, int SR, bool MASK, bool GP>
__global__ void __launch_bounds__(THREADS, 1)
fused_rounds_tc_kernel(const bf16* xc_in, const bf16* xq_in, const float* __restrict__ syn,
                       const int* __restrict__ idx_c, const int* __restrict__ idx_q,
                       const bf16* __restrict__ mats, const float* __restrict__ vecs,
                       bf16* xc_out, bf16* xq_out, bf16* stash_c, bf16* stash_q,
                       bf16* panels, int B, int M, int N, int Dc, int Dq, int R, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve<SR, GP>(smem_raw, M, N, Dc,
                               GP ? panels + size_t(blockIdx.x) * (M + N) * H : nullptr);
  for (int e = threadIdx.x; e < M * Dc; e += THREADS) s.idx_c[e] = idx_c[e];
  for (int e = threadIdx.x; e < N * Dq; e += THREADS) s.idx_q[e] = idx_q[e];
  const bf16* wc = mats;
  const bf16* wq = mats + size_t(NMAT) * HH;
  const bf16* proj = wq + size_t(M_WS) * HH;   // ys_c = rnd(x_q @ ws_c)
  Slabs<SR> sl{s.slab, 0};
  prime(sl, proj);

  for (size_t b = blockIdx.x; b < size_t(B); b += gridDim.x) {
    const float* syn_b = syn + b * M;
    bf16* xc = xc_out + b * size_t(M) * H;
    bf16* xq = xq_out + b * size_t(N) * H;
    for (int round = 0; round < R; ++round) {
      const bf16* xc_src = round == 0 ? xc_in + b * size_t(M) * H : xc;
      const bf16* xq_src = round == 0 ? xq_in + b * size_t(N) * H : xq;
      if (STASH) {  // read before the first barrier of the round, rewritten after it
        const size_t sb = size_t(round) * B + b;
        block_copy16(stash_c + sb * M * H, xc_src, size_t(M) * H * sizeof(bf16) / 16);
        block_copy16(stash_q + sb * N * H, xq_src, size_t(N) * H * sizeof(bf16) / 16);
      }
      project_rows_tc<SR>(xq_src, N, proj, s.ys_c, s.xs, sl, wc + size_t(M_WS) * HH);
      update_rows_tc<SR, true, MASK>(xc_src, xc, M, s.ys_c, s.ys_q, s.idx_c, Dc, syn_b, wc,
                                     vecs, s, sl, wq + size_t(M_WD) * HH, width);
      const bool more = round + 1 < R || b + gridDim.x < size_t(B);
      update_rows_tc<SR, false, MASK>(xq_src, xq, N, s.ys_q, nullptr, s.idx_q, Dq, nullptr, wq,
                                      vecs + NVEC * H, s, sl, more ? proj : nullptr, width);
      __syncthreads();   // the round's state writes are visible to the next round
    }
  }
}

}  // namespace tcp

// The slab rows of the bf16 kernel for a graph: 64 where that fits in shared
// memory, else 32; 0 where neither does.  The global-panel variant (GP) is
// built with 64-row slabs only: 32 would only matter past 32,000 slots.
int tc_slab_rows(int M, int N, int Dc, int Dq, bool gp) {
  if (gp) return tcp::smem_bytes<64, true>(M, N, Dc, Dq) <= tc::SMEM_LIMIT ? 64 : 0;
  if (tcp::smem_bytes<64>(M, N, Dc, Dq) <= tc::SMEM_LIMIT) return 64;
  if (tcp::smem_bytes<32>(M, N, Dc, Dq) <= tc::SMEM_LIMIT) return 32;
  return 0;
}

// K1 and K2a (the same kernel, its stash flag aside), shared panels
size_t smem_for(int M, int N, int Dc, int Dq) {
  return tc_slab_rows(M, N, Dc, Dq, false) == 32 ? tcp::smem_bytes<32>(M, N, Dc, Dq)
                                                 : tcp::smem_bytes<64>(M, N, Dc, Dq);
}

// the same with the panels in global memory
size_t gp_smem_for(int M, int N, int Dc, int Dq) {
  return tcp::smem_bytes<64, true>(M, N, Dc, Dq);
}

template <bool STASH>
int launch_state(const void* xc_in, const void* xq_in, const float* s, const int* ic,
                 const int* iq, const void* mats, const float* v, void* xc_out,
                 void* xq_out, void* stash_c, void* stash_q, void* panels, int B, int M, int N,
                 int Dc, int Dq, int R, int width, int grid, size_t smem, cudaStream_t st) {
  typedef __nv_bfloat16 bf;
  const bool gp = panels != nullptr;
  const bool mask = width < H;   // the LayerNorm's masking, compiled in below 128
  const bf* xci = static_cast<const bf*>(xc_in);
  const bf* xqi = static_cast<const bf*>(xq_in);
  const bf* mt = static_cast<const bf*>(mats);
  bf* xco = static_cast<bf*>(xc_out);
  bf* xqo = static_cast<bf*>(xq_out);
  bf* sc = static_cast<bf*>(stash_c);
  bf* sq = static_cast<bf*>(stash_q);
  bf* pn = static_cast<bf*>(panels);
  decltype(&tcp::fused_rounds_tc_kernel<STASH, 64, false, false>) kernel;
  switch (tc_slab_rows(M, N, Dc, Dq, gp)) {
    case 64:
      kernel = gp ? (mask ? tcp::fused_rounds_tc_kernel<STASH, 64, true, true>
                          : tcp::fused_rounds_tc_kernel<STASH, 64, false, true>)
                  : (mask ? tcp::fused_rounds_tc_kernel<STASH, 64, true, false>
                          : tcp::fused_rounds_tc_kernel<STASH, 64, false, false>);
      break;
    case 32:
      kernel = mask ? tcp::fused_rounds_tc_kernel<STASH, 32, true, false>
                    : tcp::fused_rounds_tc_kernel<STASH, 32, false, false>;
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return launch_kernel(kernel, grid, smem, st, xci, xqi, s, ic, iq, mt, v, xco, xqo, sc, sq, pn,
                       B, M, N, Dc, Dq, R, width);
}

}  // namespace
