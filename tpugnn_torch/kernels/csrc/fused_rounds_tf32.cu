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
// this source holds the f32 one; fused_rounds.cu the bf16 one
// (namespace tcp).
//   f32 (the trained decode, serve, LER, the detector, stream and circuit
//     graphs): t3p:: below.  Every product runs as three TF32 products on
//     mma.sync.m16n8k8 (3xTF32, rounds_mma.cuh, tf32): both operands split
//     into hi and lo TF32 halves, a slab's products summed apart and added to
//     the f32 running sum.  That stays near f32 accuracy but not at it: the
//     tensor cores' f32 accumulation truncates, and on an H100 the kernel's
//     distance from the rounds in f64 is 1.1 times plain f32's at d=11 and up
//     to 2.2 times on circuit d=5 (chip_smoke.py gates it at 3); everything else
//     (gather-sum, relu, biases, degree and syndrome terms, residual,
//     LayerNorm) is f32 on the CUDA cores.  The wrapper splits the weights
//     once a call (tf32_split_pack: hi/lo pairs in fragment order, 128 KB a
//     matrix), because a split in registers would be repeated by every warp;
//     the states are split in registers.  Shared memory decides the rest.  The
//     f32 panels [N + M][128] take 131,072 B at d=11 (M = N = 128 padded
//     rows), so only ONE f32 chunk buffer fits beside them ([128][132],
//     67,584 B): it holds the A operand of each product in turn (x, then hs,
//     then x again, reloaded from the state, then hc), and the residual reads
//     x from the state too (L2), which leaves the registers to the products
//     (the kernel is latency-bound at 255 registers a thread).  The split
//     weights stream through two 16-row slabs (32 KB, one ahead, one barrier
//     and one sum a slab), and the slot tables are read from global memory
//     (L1): 231,424 B at d=11 of the 232,448 a block may use.  Where the
//     panels do not fit (d=13: 280,576 B, d=15, circuit d=5 and d=7), the GP
//     variant keeps them in a per-block global scratch [grid][N + M][H], read
//     through L1/L2 with plain loads (not ld.global.nc: every round rewrites
//     them), on a persistent grid of one block per SM, so the resident
//     blocks' panels (237 KB a block at d=15, 31 MB in all) stay in the 50 MB
//     L2; its weights stream through three 16-row slabs (48 KB, two ahead).
//     The arithmetic is the shared-panel kernel's, in the same order.  A
//     small graph's samples run several to a block (the wrapper stacks them
//     as one graph: samples_per_block).  scripts/k1_f32_probe.py times copies
//     of this kernel with parts cut out or changed.  K2a's instantiations
//     (both placements; with global panels one sample a block at a time, its
//     stash indexed by (round, sample) as the shared-panel kernel's) copy
//     round 0's inputs to the stash and store every later entry from the
//     LayerNorm epilogue of the round before, beside the state (streaming
//     stores, no reads); bf16 K2a copies each round's inputs at its start.
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
constexpr int kDtype = 0;   // the state type this library builds: float32
}  // namespace

#include "fused_rounds_api.cuh"

namespace {

using namespace rounds;

// ---------------------------------------------------------------------------
// The f32 path on tensor cores (3xTF32, rounds_mma.cuh).  The same round as
// tcp, with f32 panels and one f32 chunk buffer; see the header.
namespace t3p {

using namespace rounds::tf32;
using tc::ld_vec2;
using tc::mask_columns;
using tc::quad_sum;

// the weight ring: shared panels (SP) and global panels (GP)
constexpr int SP_SR = 16, SP_NS = 2;
constexpr int GP_SR = 16, GP_NS = 3;

template <bool GP>
__host__ __device__ inline size_t smem_bytes(int M, int N) {
  size_t s = 0;
  if (!GP) {
    s += align16(size_t(N) * H * sizeof(float));
    s += align16(size_t(M) * H * sizeof(float));
  }
  s += CHUNK_BYTES;
  s += GP ? ring_bytes(GP_SR, GP_NS) : ring_bytes(SP_SR, SP_NS);
  return s;
}

struct Smem {
  float* ys_c;   // [N][H] swizzled, gathered by check rows
  float* ys_q;   // [M][H] swizzled, gathered by qubit rows
  float* xs;     // [CR][LDX] the chunk's A operand
  float* ring;   // [NS][SR / 8][KSTEP] weight slabs
};

// panels: the block's global panels [N + M][H] (GP), or nullptr
template <bool GP>
__device__ Smem carve(unsigned char* base, int M, int N, float* panels) {
  Smem s;
  size_t o = 0;
  if (GP) {
    s.ys_c = panels;
    s.ys_q = panels + size_t(N) * H;
  } else {
    s.ys_c = reinterpret_cast<float*>(base + o);  o += align16(size_t(N) * H * sizeof(float));
    s.ys_q = reinterpret_cast<float*>(base + o);  o += align16(size_t(M) * H * sizeof(float));
  }
  s.xs = reinterpret_cast<float*>(base + o);      o += CHUNK_BYTES;
  s.ring = reinterpret_cast<float*>(base + o);
  return s;
}

// Phases B (CHECK) and C: rows [0, rows) of state x_src updated into x_dst
// (which may alias it); CHECK also writes ys_out = x @ ws and adds the
// syndrome term.  W is the direction's five split matrices; `after` is the
// product that follows the last chunk.  The LayerNorm runs over the first
// `width` columns (a test, not a template flag: it costs a compare a row,
// and two fewer instantiations build faster).  With STASH the new rows go
// to `stash` too (the next round's stash entry, or nullptr after the last
// round), with streaming stores.
template <int SR, int NS, bool CHECK, bool STASH = false>
__device__ void update_rows(const float* x_src, float* x_dst, int rows, const float* ys_src,
                            float* ys_out, const int* idx, int D, const float* syn,
                            const float* __restrict__ W, const float* __restrict__ vec,
                            float* xs, Ring<SR, NS>& rg, const float* after, int width,
                            float* stash = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* xa = xs + 16 * warp * LDX;
  const float* wd = W + M_WD * MAT;
  const float* ux = W + M_UX * MAT;
  const float* ws = W + M_WS * MAT;
  const float* wf = W + M_WF * MAT;
  const float* w1 = W + M_W1 * MAT;
  const float* first = CHECK ? ws : wd;

  for (int row0 = 0; row0 < rows; row0 += CR) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, rows - r0));
    const bool active = n > 0;
    load_rows_warp(xa, x_src + size_t(r0) * H, n);
    float acc[NT][4];

    if (CHECK) {   // the other direction's gather source
      mma_pass<SR, NS>(xa, ws, rg, wd, acc, active);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            st2(ys_out + swz(r, 8 * j + 2 * t), acc[j][2 * h], acc[j][2 * h + 1]);
        }
      }
    }

    // ydb = x @ wd + b0, then the slot gather-sum over the source panel;
    // hs replaces x in the chunk buffer
    mma_pass<SR, NS>(xa, wd, rg, wf, acc, active);
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
          const int src = __ldg(idx + r * D + k);
          if (src < 0) continue;
          deg[h] += 1.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 y = ld2(ys_src + swz(src, 8 * j + 2 * t));
            hsum[j][0] += fmaxf(y.x + acc[j][2 * h], 0.f);
            hsum[j][1] += fmaxf(y.y + acc[j][2 * h + 1], 0.f);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        st2(xa + (g + 8 * h) * LDX + 8 * j + 2 * t, hsum[j][0], hsum[j][1]);
    }
    __syncwarp();

    // update-MLP pre-activation: hs @ (wo @ ua), then x again from the
    // state (its rows are rewritten only below) and + x @ ux, + ...
    mma_pass<SR, NS>(xa, wf, rg, ux, acc, active);
    load_rows_warp(xa, x_src + size_t(r0) * H, n);
    mma_pass<SR, NS, true>(xa, ux, rg, w1, acc, active);
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
        st2(xa + (g + 8 * h) * LDX + c, fmaxf(p0, 0.f), fmaxf(p1, 0.f));
      }
    }
    __syncwarp();

    // update output, residual (x from the state: each thread reads the
    // entries it writes), LayerNorm (two-pass, eps 1e-6, over the first
    // `width` columns); the rows go straight to the state
    mma_pass<SR, NS>(xa, w1, rg, row0 + CR < rows ? first : after, acc, active);
    const float inv_w = 1.f / width;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const float* xrow = x_src + size_t(r < rows ? r : 0) * H + 2 * t;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 ub1 = ld_vec2(vec, V_UB1, 8 * j + 2 * t);
        const float2 x = r < rows ? ld2(xrow + 8 * j) : make_float2(0.f, 0.f);
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
      if (width < H) mask_columns(acc, h, t, width);
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sq += acc[j][2 * h] * acc[j][2 * h] + acc[j][2 * h + 1] * acc[j][2 * h + 1];
      const float rs = rsqrtf(quad_sum(sq) * inv_w + 1e-6f);
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 lns = ld_vec2(vec, V_LNS, c), lnb = ld_vec2(vec, V_LNB, c);
          const float2 o = make_float2(acc[j][2 * h] * rs * lns.x + lnb.x,
                                       acc[j][2 * h + 1] * rs * lns.y + lnb.y);
          st2(x_dst + size_t(r) * H + c, o.x, o.y);
          if (STASH && stash != nullptr)
            __stcs(reinterpret_cast<float2*>(stash + size_t(r) * H + c), o);
        }
      }
    }
  }
}

// One block per sample (grid = B), or with GP a persistent grid whose
// blocks walk the samples, each with its own panels in `panels`.  mats is
// the split pack (tf32_split_pack): 10 matrices of MAT floats.
template <bool GP, bool STASH>
__global__ void __launch_bounds__(THREADS, 1)
fused_rounds_tf32x3_kernel(const float* xc_in, const float* xq_in, const float* __restrict__ syn,
                           const int* __restrict__ idx_c, const int* __restrict__ idx_q,
                           const float* __restrict__ mats, const float* __restrict__ vecs,
                           float* xc_out, float* xq_out, float* stash_c, float* stash_q,
                           float* panels, int B, int M, int N, int Dc, int Dq, int R,
                           int width) {
  constexpr int SR = GP ? GP_SR : SP_SR, NS = GP ? GP_NS : SP_NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve<GP>(smem_raw, M, N,
                           GP ? panels + size_t(blockIdx.x) * (M + N) * H : nullptr);
  const float* wc = mats;                       // check direction's 5 matrices
  const float* wq = mats + size_t(NMAT) * MAT;  // qubit direction's 5 matrices
  const float* proj = wq + size_t(M_WS) * MAT;  // ys_c = x_q @ ws_c
  Ring<SR, NS> rg{s.ring, 0};
  prime(rg, proj);

  for (size_t b = blockIdx.x; b < size_t(B); b += gridDim.x) {
    const float* syn_b = syn + b * M;
    float* xc = xc_out + b * size_t(M) * H;
    float* xq = xq_out + b * size_t(N) * H;
    for (int round = 0; round < R; ++round) {
      // round 0 reads the inputs; later rounds the states rewritten in place
      const float* xc_src = round == 0 ? xc_in + b * size_t(M) * H : xc;
      const float* xq_src = round == 0 ? xq_in + b * size_t(N) * H : xq;
      // the stash: round 0's entry copied from the inputs, each later one
      // stored with the rows of the round before it
      float *next_c = nullptr, *next_q = nullptr;
      if (STASH) {
        if (round == 0) {
          block_copy16(stash_c + b * M * H, xc_src, size_t(M) * H * sizeof(float) / 16);
          block_copy16(stash_q + b * N * H, xq_src, size_t(N) * H * sizeof(float) / 16);
        }
        if (round + 1 < R) {
          const size_t sb = size_t(round + 1) * B + b;
          next_c = stash_c + sb * M * H;
          next_q = stash_q + sb * N * H;
        }
      }
      project_rows(xq_src, N, proj, s.ys_c, s.xs, rg, wc + size_t(M_WS) * MAT);
      update_rows<SR, NS, true, STASH>(xc_src, xc, M, s.ys_c, s.ys_q, idx_c, Dc, syn_b, wc,
                                       vecs, s.xs, rg, wq + size_t(M_WD) * MAT, width, next_c);
      const bool more = round + 1 < R || b + gridDim.x < size_t(B);
      update_rows<SR, NS, false, STASH>(xq_src, xq, N, s.ys_q, nullptr, idx_q, Dq, nullptr,
                                        wq, vecs + NVEC * H, s.xs, rg, more ? proj : nullptr,
                                        width, next_q);
      __syncthreads();   // the round's state writes are visible to the next round
    }
  }
}

}  // namespace t3p

// K1 and K2a (the same kernel, its stash flag aside), shared panels
size_t smem_for(int M, int N, int, int) { return t3p::smem_bytes<false>(M, N); }

// the same with the panels in global memory
size_t gp_smem_for(int M, int N, int, int) { return t3p::smem_bytes<true>(M, N); }

// mats: the split pack
template <bool STASH>
int launch_state(const void* xc_in, const void* xq_in, const float* s, const int* ic,
                 const int* iq, const void* mats, const float* v, void* xc_out,
                 void* xq_out, void* stash_c, void* stash_q, void* panels, int B, int M, int N,
                 int Dc, int Dq, int R, int width, int grid, size_t smem, cudaStream_t st) {
  const float* xci = static_cast<const float*>(xc_in);
  const float* xqi = static_cast<const float*>(xq_in);
  const float* mt = static_cast<const float*>(mats);
  float* xco = static_cast<float*>(xc_out);
  float* xqo = static_cast<float*>(xq_out);
  float* sc = static_cast<float*>(stash_c);
  float* sq = static_cast<float*>(stash_q);
  float* pn = static_cast<float*>(panels);
  return launch_kernel(panels != nullptr ? t3p::fused_rounds_tf32x3_kernel<true, STASH>
                                         : t3p::fused_rounds_tf32x3_kernel<false, STASH>,
                       grid, smem, st, xci, xqi, s, ic, iq, mt, v, xco, xqo, sc, sq, pn, B, M, N,
                       Dc, Dq, R, width);
}

}  // namespace
