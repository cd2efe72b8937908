// K5 with f32 states (Hopper): the f32 library of the raster rounds kernel.
//
// The kernel, its function and its design are described in roll_gather.cu's
// header (the f32 instantiation, t3r::); this source builds it apart from the
// bf16 one so that the two nvcc runs go in parallel, with the shared entry
// points of roll_gather_api.cuh (dtype 0 here) and the f32 global-panel
// variant's own (roll_rounds_gpanels_*).

#include "rounds_common.cuh"
#include "rounds_mma.cuh"

namespace {
constexpr int kDtype = 0;   // the state type this library builds: float32
}  // namespace

#include "roll_gather_api.cuh"

namespace {

// ---------------------------------------------------------------------------
// The f32 path on tensor cores (3xTF32, rounds_mma.cuh, tf32): K1's t3p::
// round on the raster, each product as three TF32 products of operands
// split into hi and lo halves, a slab's products summed apart and added to
// the f32 running sum; the slot sum, relu, biases, degree and syndrome
// terms, residual and LayerNorm in f32 on the CUDA cores.  9 warps, chunks
// of 144 rows (d=11's raster side in one), two 16-row slabs of split
// weights.  One f32 chunk buffer holds each product's A operand in turn (x,
// the slot sum hs, x again from the state, the update hidden hc); the
// residual reads x from the state.  ONE gather panel, the source of the
// side being updated:
//   A   P = x_q @ ws_c
//   B   check cells from x_c (cur) into the other state buffer (nxt), the
//       slot sum over P: the old x_c stays readable
//   A'  P = x_c (cur) @ ws_q
//   C   qubit cells in place, the slot sum over P
// x_c ping-pongs between the output and a per-block scratch, arranged so
// that the last round writes the output.  P lives in shared memory (SP) or,
// where it does not fit, in the per-block scratch too (GP); the arithmetic
// is the same.  A persistent grid of blocks walks the samples; with SP a
// small raster's samples run S to a block, as one raster of S L rows, each
// sample's slot sources wrapping within its own L cells.
namespace t3r {

using namespace rounds::tf32;
using tc::ld_vec2;
using tc::mask_columns;
using tc::quad_sum;

// warps, weight slab rows, ring depth
constexpr int NWARP = 9, SR = 16, NS = 2;
constexpr int NTH = 32 * NWARP, CRN = 16 * NWARP;   // 144-row chunks
constexpr size_t CHUNK = size_t(CRN) * LDX * sizeof(float);

// rows: the block's raster rows (S samples of L cells)
template <bool GP>
__host__ __device__ inline size_t smem_bytes(int rows, int L) {
  return (GP ? 0 : align16(size_t(rows) * H * sizeof(float))) + CHUNK + ring_bytes(SR, NS) +
         align16(size_t(2) * L);
}

struct Smem {
  float* panel;          // [rows][H] swizzled, the gather source
  float* xs;             // [CRN][LDX] the chunk's A operand
  float* ring;           // [NS][SR / 8][KSTEP] weight slabs
  unsigned char* bits;   // [2][L] slot-mask bits: check cells, then qubit cells
};

// gp_panel: the block's global panel [rows][H] (GP), or nullptr
template <bool GP>
__device__ Smem carve(unsigned char* base, int rows, float* gp_panel) {
  Smem s;
  size_t o = 0;
  if (GP) {
    s.panel = gp_panel;
  } else {
    s.panel = reinterpret_cast<float*>(base + o);  o += align16(size_t(rows) * H * sizeof(float));
  }
  s.xs = reinterpret_cast<float*>(base + o);       o += CHUNK;
  s.ring = reinterpret_cast<float*>(base + o);     o += ring_bytes(SR, NS);
  s.bits = base + o;
  return s;
}

template <bool ACC = false>
__device__ __forceinline__ void pass(const float* A, const float* __restrict__ W,
                                     Ring<SR, NS>& rg, const float* next, float (&acc)[NT][4],
                                     bool active) {
  mma_pass<SR, NS, ACC, NTH>(A, W, rg, next, acc, active);
}

// Phases B (CHECK) and C: rows [0, rows) (S samples of L cells) of state
// x_src updated into x_dst (which may alias it), the slot sum over the
// panel ys; CHECK adds the syndrome term.  W is the side's five split
// matrices (ws unused); `after` is the product that follows the last chunk.
template <bool CHECK>
__device__ void update_cells(const float* x_src, float* x_dst, int rows, int L, const float* ys,
                             const unsigned char* bits, Offsets offs, const float* syn,
                             const float* __restrict__ degbo, const float* __restrict__ W,
                             const float* __restrict__ vec, float* xs, Ring<SR, NS>& rg,
                             const float* after, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* xa = xs + 16 * warp * LDX;
  const float* wd = W + M_WD * MAT;
  const float* ux = W + M_UX * MAT;
  const float* wf = W + M_WF * MAT;
  const float* w1 = W + M_W1 * MAT;

  for (int row0 = 0; row0 < rows; row0 += CRN) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, rows - r0));
    const bool active = n > 0;
    load_rows_warp(xa, x_src + size_t(r0) * H, n);
    float acc[NT][4];

    // ydb = x @ wd + b0, then the four-slot sum over the panel in offs
    // order (a masked slot adds exactly 0); hs replaces x in the chunk buffer
    pass(xa, wd, rg, wf, acc, active);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b0 = ld_vec2(vec, V_B0, 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[j][2 * h] += b0.x;
        acc[j][2 * h + 1] += b0.y;
      }
    }
    int cell[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const int base = r < rows ? r / L * L : 0;   // the row's sample
      cell[h] = r < rows ? r - base : L - 1;       // a row past the last reads the last cell
      float hsum[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) hsum[j][0] = hsum[j][1] = 0.f;
      if (r < rows) {
        const unsigned m = bits[cell[h]];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          if (!((m >> k) & 1u)) continue;
          const int src = base + wrap(cell[h], offs.o[k], L);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 y = ld2(ys + swz(src, 8 * j + 2 * t));
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
    // state and + x @ ux, + (deg * bo) @ ua + syn * uc_s + ub0
    pass(xa, wf, rg, ux, acc, active);
    load_rows_warp(xa, x_src + size_t(r0) * H, n);
    pass<true>(xa, ux, rg, w1, acc, active);
    float sv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      sv[h] = (CHECK && r < rows) ? syn[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 ub0 = ld_vec2(vec, V_UB0, c);
      float2 ucs = make_float2(0.f, 0.f);
      if (CHECK) ucs = ld_vec2(vec, V_UCS, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 db = ld_vec2(degbo, cell[h], c);
        float p0 = acc[j][2 * h] + db.x;
        float p1 = acc[j][2 * h + 1] + db.y;
        if (CHECK) {
          p0 += __fmul_rn(sv[h], ucs.x);
          p1 += __fmul_rn(sv[h], ucs.y);
        }
        st2(xa + (g + 8 * h) * LDX + c, fmaxf(p0 + ub0.x, 0.f), fmaxf(p1 + ub0.y, 0.f));
      }
    }
    __syncwarp();

    // update output, residual (x from the state: each thread reads the
    // entries it writes), LayerNorm (two-pass, eps 1e-6, over the first
    // `width` columns); the rows go straight to the state
    pass(xa, w1, rg, row0 + CRN < rows ? wd : after, acc, active);
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
          st2(x_dst + size_t(r) * H + c, acc[j][2 * h] * rs * lns.x + lnb.x,
              acc[j][2 * h + 1] * rs * lns.y + lnb.y);
        }
      }
    }
  }
}

// B stacked samples of S L rows (the states [B][S L][H], syn [B][S L]) on a
// persistent grid; block i's scratch is scratch[i]: [rows][H] f32 for the
// check states' other buffer, and with GP the panel [rows][H] after it.
// mats is the split pack (fused_decoder.py::tf32_split_pack).
template <bool GP>
__global__ void __launch_bounds__(NTH, 1)
roll_rounds_tf32x3_kernel(const float* xc_in, const float* xq_in, const float* __restrict__ syn,
                          const int* __restrict__ maskbits, const float* __restrict__ degbo,
                          const float* __restrict__ mats, const float* __restrict__ vecs,
                          float* xc_out, float* xq_out, Offsets offs_c, Offsets offs_q, int L,
                          int R, int width, float* scratch, int B, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = S * L;
  float* other = scratch + size_t(blockIdx.x) * (GP ? 2 : 1) * rows * H;
  const Smem s = carve<GP>(smem_raw, rows, GP ? other + size_t(rows) * H : nullptr);
  for (int e = threadIdx.x; e < 2 * L; e += NTH)
    s.bits[e] = static_cast<unsigned char>(maskbits[e]);
  const float* wc = mats;                         // check side's 5 matrices
  const float* wq = mats + size_t(NMAT) * MAT;    // qubit side's 5 matrices
  const float* proj_c = wq + size_t(M_WS) * MAT;  // P = x_q @ ws_c
  const float* proj_q = wc + size_t(M_WS) * MAT;  // P = x_c @ ws_q
  Ring<SR, NS> rg{s.ring, 0};
  prime<SR, NS, NTH>(rg, proj_c);

  for (size_t b = blockIdx.x; b < size_t(B); b += gridDim.x) {
    const float* syn_b = syn + b * rows;
    float* xc = xc_out + b * size_t(rows) * H;
    float* xq = xq_out + b * size_t(rows) * H;
    const float* cur = xc_in + b * size_t(rows) * H;   // the round's check states
    for (int round = 0; round < R; ++round) {
      // round 0 reads the inputs; the qubit states are rewritten in place,
      // the check states into the other buffer, the output in the last round
      const float* xq_src = round == 0 ? xq_in + b * size_t(rows) * H : xq;
      float* nxt = (R - 1 - round) % 2 == 0 ? xc : other;
      project_rows<SR, NS, NTH>(xq_src, rows, proj_c, s.panel, s.xs, rg,
                                wc + size_t(M_WD) * MAT);
      update_cells<true>(cur, nxt, rows, L, s.panel, s.bits, offs_c, syn_b, degbo, wc, vecs,
                         s.xs, rg, proj_q, width);
      project_rows<SR, NS, NTH>(cur, rows, proj_q, s.panel, s.xs, rg, wq + size_t(M_WD) * MAT);
      const bool more = round + 1 < R || b + gridDim.x < size_t(B);
      update_cells<false>(xq_src, xq, rows, L, s.panel, s.bits + L, offs_q, nullptr,
                          degbo + size_t(L) * H, wq, vecs + NVEC * H, s.xs, rg,
                          more ? proj_c : nullptr, width);
      __syncthreads();   // the round's state writes are visible to the next round
      cur = nxt;
    }
  }
}

}  // namespace t3r

// S samples of L cells (S L rows) a block
size_t smem_for(int L, int S) { return t3r::smem_bytes<false>(S * L, L); }

// a persistent grid of `grid` blocks, `samples` samples a block, each block's
// scratch [samples L][128] f32 in `scratch`
int launch_state(Launch& a, int, int samples, int grid, void* scratch) {
  if (samples < 1 || a.B % samples != 0 || (samples > 1 && samples * a.L > t3r::CRN) ||
      grid <= 0 || scratch == nullptr)
    return int(cudaErrorInvalidValue);
  a.grid = grid;
  return launch_kernel<float>(t3r::roll_rounds_tf32x3_kernel<false>, t3r::NTH,
                              smem_for(a.L, samples), a, a.panels, a.B / samples, samples);
}

}  // namespace

extern "C" {

// Shared memory one block of the f32 global-panel variant needs.
long long roll_rounds_gpanels_smem_bytes(int L) {
  return (long long)t3r::smem_bytes<true>(L, L);
}

// The f32 global-panel variant of roll_rounds_launch: `grid` blocks walk the
// samples, block i with its scratch in panels[i] ([grid][2 L][128] f32: the
// check states' other buffer, then the gather panel); mats the split pack.
int roll_rounds_gpanels_launch(const void* xc_in, const void* xq_in, const void* syn,
                               const void* maskbits, const void* degbo, const void* mats,
                               const void* vecs, void* xc_out, void* xq_out, void* panels,
                               const void* offs, int B, int L, int R, int width, int grid,
                               void* stream) {
  Launch a{xc_in, xq_in, static_cast<const float*>(syn), static_cast<const int*>(maskbits),
           static_cast<const float*>(degbo), mats, static_cast<const float*>(vecs), xc_out,
           xq_out, {}, {}, B, L, R, width, grid, static_cast<float*>(panels),
           static_cast<cudaStream_t>(stream)};
  if (int err = prepare(a, offs)) return err;
  if (grid <= 0 || panels == nullptr) return int(cudaErrorInvalidValue);
  return launch_kernel<float>(t3r::roll_rounds_tf32x3_kernel<true>, t3r::NTH,
                              t3r::smem_bytes<true>(L, L), a, a.panels, a.B, 1);
}

}  // extern "C"
