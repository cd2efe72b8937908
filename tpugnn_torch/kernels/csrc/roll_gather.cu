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
// One block per sample; all R rounds loop inside the block.  Per round:
//   A  ys_c = rnd(x_q @ ws_c) for every qubit cell        -> shared panel [L, H]
//   B  check cells: ys_q = rnd(x @ ws_q) (-> shared panel [L, H]), ydb = x @
//      wd_c + b0, the four-slot rotation sum over ys_c in offs order, the
//      folded aggregation GEMM plus (deg * bo) @ ua, update MLP, residual,
//      LayerNorm; the new rows overwrite the state in place
//   C  qubit cells, the same against ys_q
// Empty cells are computed like the others (their states move by relu(ub0)),
// as in the JAX kernel.  With SLOT16 the slot stage rounds to bf16 after
// every add, as the JAX kernel's bf16 slot type does (an f32 add then one
// rounding to bf16 is the bf16 add: 24 >= 2 * 8 + 2 bits).
//
// Two instantiations, both on tensor cores, each a library of its own (this
// source bf16, roll_gather_tf32.cu f32; roll_gather_api.cuh their shared
// entry points), so that the two build in parallel:
//   bf16 states (the bench config's pallas_roll and pallas_roll16): tcr::
//     below, on K1's routine (rounds_mma.cuh, tc).  Every operand of every
//     product is a bf16 value (states, the slot sum and the update hidden
//     are rounded, the packed matrices stored in bf16), so mma.sync.m16n8k16
//     bf16 with f32 accumulation forms the products of the plain version;
//     only the f32 summation order differs.  A block has 9 warps, so a chunk
//     is 144 rows: d=11's whole raster side (a 128-row chunk of 8 warps
//     would leave a 16-row tail that one warp works through behind every
//     slab barrier); larger rasters run a second, ragged chunk (d=13: 144 +
//     56, d=15: 144 + 112, with 32-row weight slabs).
//   f32 states (the trained roll decode): t3r:: below, every product as
//     three TF32 products of operands split into TF32 halves (3xTF32,
//     rounds_mma.cuh, tf32: the wrapper splits the weights once a call,
//     fused_decoder.py::tf32_split_pack), a slab's products summed apart and
//     added to the f32 running sum; everything else f32 on the CUDA cores.
//     9 warps and 144-row chunks as in bf16, two 16-row slabs of split
//     weights (32 KB).  Both f32 panels [144][128] (147,456 B at d=11) and a
//     144-row f32 chunk buffer (76,032 B) leave no room for the slabs, so the
//     kernel keeps ONE gather panel: the check states ping-pong between the
//     output and a per-block global scratch, so that the old x_c is still
//     there to project ys_q after the check cells are updated.  SP keeps that
//     panel in shared memory, 182,816 B at d=11 and 211,600 at d=13 with the
//     slot bits; at d=15 (240,384 B) the GP variant keeps it in the scratch
//     too (109,312 B), read through L1/L2 with plain loads.  Both run on a
//     persistent grid of one block per SM; SP stacks a small raster's
//     samples in one block.  ptxas: 168 registers a thread (the cap of 9
//     warps: three on one SM sub-partition), 12 B spilled (SP) and 60 B
//     (GP).  Measured on an H100 at d=11, B=4096, R=14 on the trained
//     weights (chip_smoke.py phase 11): 78.5 ms; the kernel's real rows are
//     4.0e-4 from the rounds in f64, the plain f32 version's 4.2e-4.
//     scripts/k5_probe.py times copies with one thing changed: 8 warps
//     (a 16-row second chunk: 99 ms), three slabs (78), 32-row slabs with
//     one sum every four k-steps (76, less precise), the panel in global
//     memory (93), against 78-81 as built.
//
// Width: as K1's.  States and packs come zero-padded to 128 columns, and
// the LayerNorm runs over the model's first `width` columns (bf16: with
// MASK, compiled in only for width < 128; f32: a run-time test).
//
// Bounds on an H100 at d=11, H=128: the work is K1's (the raster's 288 rows
// against the graph's 241 real ones are this design's overhead), 39.7 MFLOP
// per sample and round on the real rows; HBM traffic is the states in and
// out, so it is bound by operations: at B=4096, R=8 1.32 ms at the bf16
// tensor-core peak; at the trained R=14 in f32 13.80 ms as 3xTF32 (three
// TF32 products an f32 one at 495 TFLOP/s) and 33.99 ms at the f32
// CUDA-core peak.  One block per SM by shared memory (bf16 at d=11 187,168
// B).


#include "rounds_common.cuh"
#include "rounds_mma.cuh"

namespace {
constexpr int kDtype = 1;   // the state type this library builds: bfloat16
}  // namespace

#include "roll_gather_api.cuh"

namespace {

// ---------------------------------------------------------------------------
// The bf16 path on tensor cores (rounds_mma.cuh), K1's tcp:: schedule on the
// raster.  NWARP warps, chunks of 16 * NWARP rows (the last one ragged), one product (one weight matrix) at a time, each
// accumulator m16 x n128 per warp:
//   A  ys_c = rnd(x_q @ ws_c)
//   B  check chunk: ys_q = rnd(x @ ws_q); ydb = x @ wd + b0 and the slot sum
//      in offs order under the mask bits; pre = hs @ wf + x @ ux (the second
//      product accumulates into the first's registers) + (deg * bo) @ ua +
//      rnd(syn * uc_s) + ub0; hc @ w1, the residual and LayerNorm
//   C  qubit chunk: the same without ys_q and the syndrome term
// A warp with no rows in a chunk (the ragged tail) only takes part in the
// weight copies and the barriers.  Phase B's last ys_q store and phase C's
// first gather are separated by the slab barriers of phase C's first
// products, as phase A's ys_c stores and phase B's gathers are.
namespace tcr {

using namespace rounds::tc;

template <int NWARP>
__host__ __device__ constexpr size_t chunk_bytes() {
  return size_t(16 * NWARP) * LDB * sizeof(bf16);
}

template <int SR, int NWARP>
__host__ __device__ inline size_t smem_bytes(int L) {
  return 2 * align16(size_t(L) * H * sizeof(bf16)) + 2 * chunk_bytes<NWARP>() +
         slab_bytes(SR) + align16(size_t(2) * L);
}

struct Smem {
  bf16* ys_c;            // [L][H] swizzled, gathered by check cells
  bf16* ys_q;            // [L][H] swizzled, gathered by qubit cells
  bf16* xs;              // [16 NWARP][LDB] state chunk (A operand, residual, output)
  bf16* hs;              // [16 NWARP][LDB] slot sum, then update hidden (A operand)
  bf16* slab;            // [2][SR][LDB] weight slabs
  unsigned char* bits;   // [2][L] slot-mask bits: check cells, then qubit cells
};

template <int SR, int NWARP>
__device__ Smem carve(unsigned char* base, int L) {
  Smem s;
  size_t o = 0;
  s.ys_c = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(L) * H * sizeof(bf16));
  s.ys_q = reinterpret_cast<bf16*>(base + o);  o += align16(size_t(L) * H * sizeof(bf16));
  s.xs = reinterpret_cast<bf16*>(base + o);    o += chunk_bytes<NWARP>();
  s.hs = reinterpret_cast<bf16*>(base + o);    o += chunk_bytes<NWARP>();
  s.slab = reinterpret_cast<bf16*>(base + o);  o += slab_bytes(SR);
  s.bits = base + o;
  return s;
}

// the slot stage's rounding: to bf16 after every op with SLOT16, none in f32
template <bool SLOT16>
__device__ __forceinline__ float srnd(float x) {
  if constexpr (SLOT16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Phases B (CHECK) and C: cells [0, L) of state x_src updated into x_dst
// (which may alias it); CHECK also writes ys_out = rnd(x @ ws) and adds the
// syndrome term.  `after` is the product that follows the last chunk.
template <int SR, int NWARP, bool CHECK, bool SLOT16, bool MASK>
__device__ void update_cells_tc(const bf16* x_src, bf16* x_dst, int L, const bf16* ys_src,
                                bf16* ys_out, const unsigned char* bits, Offsets offs,
                                const float* syn, const float* __restrict__ degbo,
                                const bf16* __restrict__ W, const float* __restrict__ vec,
                                const Smem& s, Slabs<SR>& sl, const bf16* after, int width) {
  constexpr int NTH = 32 * NWARP, CRN = 16 * NWARP;
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

  for (int row0 = 0; row0 < L; row0 += CRN) {
    const int r0 = row0 + 16 * warp;
    const int n = max(0, min(16, L - r0));
    const bool active = n > 0;
    load_rows_warp(xa, x_src + size_t(r0) * H, n);
    float acc[NT][4];

    if (CHECK) {   // the other side's gather source
      mma_pass<SR, false, NTH>(xa, ws, sl, wd, acc, active);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r < L) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            st_bf2(ys_out + swz(r, 8 * j + 2 * t), acc[j][2 * h], acc[j][2 * h + 1]);
        }
      }
    }

    // ydb = x @ wd + b0, then the four-slot sum over the source panel
    mma_pass<SR, false, NTH>(xa, wd, sl, wf, acc, active);
    if (active) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 b0 = ld_vec2(vec, V_B0, 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[j][2 * h] = srnd<SLOT16>(acc[j][2 * h] + b0.x);
          acc[j][2 * h + 1] = srnd<SLOT16>(acc[j][2 * h + 1] + b0.y);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        float hsum[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) hsum[j][0] = hsum[j][1] = 0.f;
        if (r < L) {
          const unsigned m = bits[r];
#pragma unroll
          for (int k = 0; k < SLOTS; ++k) {
            // a masked slot adds exactly 0: selected, not branched, so the
            // lanes of a quad group stay together
            const bool real = (m >> k) & 1u;
            const int src = wrap(r, offs.o[k], L);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const float2 y = ld_bf2(ys_src + swz(src, 8 * j + 2 * t));
              const float t0 = fmaxf(srnd<SLOT16>(y.x + acc[j][2 * h]), 0.f);
              const float t1 = fmaxf(srnd<SLOT16>(y.y + acc[j][2 * h + 1]), 0.f);
              hsum[j][0] = srnd<SLOT16>(hsum[j][0] + (real ? t0 : 0.f));
              hsum[j][1] = srnd<SLOT16>(hsum[j][1] + (real ? t1 : 0.f));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          st_bf2(ha + (g + 8 * h) * LDB + 8 * j + 2 * t, hsum[j][0], hsum[j][1]);
      }
      __syncwarp();
    }

    // update-MLP pre-activation: hs @ (wo @ ua) + x @ ux + (deg * bo) @ ua + ...
    mma_pass<SR, false, NTH>(ha, wf, sl, ux, acc, active);
    mma_pass<SR, true, NTH>(xa, ux, sl, w1, acc, active);
    if (active) {
      float sv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        sv[h] = (CHECK && r < L) ? syn[r] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 ub0 = ld_vec2(vec, V_UB0, c);
        float2 ucs = make_float2(0.f, 0.f);
        if (CHECK) ucs = ld_vec2(vec, V_UCS, c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // rows past L (a ragged warp) read the last cell's entries and
          // are never stored
          const float2 db = ld_vec2(degbo, min(r0 + g + 8 * h, L - 1), c);
          float p0 = acc[j][2 * h] + db.x;
          float p1 = acc[j][2 * h + 1] + db.y;
          if (CHECK) {
            p0 += rnd(__fmul_rn(sv[h], ucs.x), bf16{});
            p1 += rnd(__fmul_rn(sv[h], ucs.y), bf16{});
          }
          st_bf2(ha + (g + 8 * h) * LDB + c, fmaxf(p0 + ub0.x, 0.f), fmaxf(p1 + ub0.y, 0.f));
        }
      }
      __syncwarp();
    }

    // update output, residual, LayerNorm (two-pass, eps 1e-6, over the
    // first `width` columns)
    mma_pass<SR, false, NTH>(ha, w1, sl, row0 + CRN < L ? first : after, acc, active);
    if (active) {
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
}

template <int SR, int NWARP, bool SLOT16, bool MASK>
__global__ void __launch_bounds__(32 * NWARP, 1)
roll_rounds_tc_kernel(const bf16* xc_in, const bf16* xq_in, const float* __restrict__ syn,
                      const int* __restrict__ maskbits, const float* __restrict__ degbo,
                      const bf16* __restrict__ mats, const float* __restrict__ vecs,
                      bf16* xc_out, bf16* xq_out, Offsets offs_c, Offsets offs_q, int L,
                      int R, int width) {
  constexpr int NTH = 32 * NWARP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve<SR, NWARP>(smem_raw, L);
  const size_t b = blockIdx.x;
  for (int e = threadIdx.x; e < 2 * L; e += NTH)
    s.bits[e] = static_cast<unsigned char>(maskbits[e]);
  const float* syn_b = syn + b * L;
  bf16* xc = xc_out + b * size_t(L) * H;
  bf16* xq = xq_out + b * size_t(L) * H;
  const bf16* wc = mats;
  const bf16* wq = mats + size_t(NMAT) * HH;
  const bf16* proj = wq + size_t(M_WS) * HH;   // ys_c = rnd(x_q @ ws_c)
  Slabs<SR> sl{s.slab, 0};
  prime<SR, NTH>(sl, proj);

  for (int round = 0; round < R; ++round) {
    // round 0 reads the inputs; later rounds the states rewritten in place
    const bf16* xc_src = round == 0 ? xc_in + b * size_t(L) * H : xc;
    const bf16* xq_src = round == 0 ? xq_in + b * size_t(L) * H : xq;
    project_rows_tc<SR, NTH>(xq_src, L, proj, s.ys_c, s.xs, sl, wc + size_t(M_WS) * HH);
    update_cells_tc<SR, NWARP, true, SLOT16, MASK>(xc_src, xc, L, s.ys_c, s.ys_q, s.bits, offs_c,
                                             syn_b, degbo, wc, vecs, s, sl,
                                             wq + size_t(M_WD) * HH, width);
    update_cells_tc<SR, NWARP, false, SLOT16, MASK>(xq_src, xq, L, s.ys_q, nullptr, s.bits + L,
                                              offs_q, nullptr, degbo + size_t(L) * H, wq,
                                              vecs + NVEC * H, s, sl,
                                              round + 1 < R ? proj : nullptr, width);
    __syncthreads();   // the round's state writes are visible to the next round
  }
}


// The global-panel variant (bf16 rasters past d=15: at d=17, l_pad = 328,
// the shared layout needs 264,336 B even with 32-row slabs): both panels in
// the block's slice of a per-block scratch [grid][2 L][H], swizzled as in
// shared memory and read and written through the same generic loads and
// stores, on a persistent grid of `grid` blocks that walk the samples; the
// chunk buffers, the 64-row slab ring and the slot bits stay in shared
// memory (113,152 B and 2 L bytes of slot bits).  Only where the panels live
// changes, not an operation or its order, so where both layouts fit they
// give the same bits (as bf16 K1's do).
template <int SR, int NWARP>
__host__ __device__ inline size_t gp_smem_bytes(int L) {
  return 2 * chunk_bytes<NWARP>() + slab_bytes(SR) + align16(size_t(2) * L);
}

template <int SR, int NWARP>
__device__ Smem carve_gp(unsigned char* base, int L, bf16* panels) {
  Smem s;
  size_t o = 0;
  s.ys_c = panels;
  s.ys_q = panels + size_t(L) * H;
  s.xs = reinterpret_cast<bf16*>(base + o);    o += chunk_bytes<NWARP>();
  s.hs = reinterpret_cast<bf16*>(base + o);    o += chunk_bytes<NWARP>();
  s.slab = reinterpret_cast<bf16*>(base + o);  o += slab_bytes(SR);
  s.bits = base + o;
  return s;
}

template <int SR, int NWARP, bool SLOT16, bool MASK>
__global__ void __launch_bounds__(32 * NWARP, 1)
roll_rounds_tc_gpanels_kernel(const bf16* xc_in, const bf16* xq_in, const float* __restrict__ syn,
                              const int* __restrict__ maskbits, const float* __restrict__ degbo,
                              const bf16* __restrict__ mats, const float* __restrict__ vecs,
                              bf16* xc_out, bf16* xq_out, Offsets offs_c, Offsets offs_q, int L,
                              int R, int width, bf16* panels, int B) {
  constexpr int NTH = 32 * NWARP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve_gp<SR, NWARP>(smem_raw, L, panels + size_t(blockIdx.x) * 2 * L * H);
  for (int e = threadIdx.x; e < 2 * L; e += NTH)
    s.bits[e] = static_cast<unsigned char>(maskbits[e]);
  const bf16* wc = mats;
  const bf16* wq = mats + size_t(NMAT) * HH;
  const bf16* proj = wq + size_t(M_WS) * HH;   // ys_c = rnd(x_q @ ws_c)
  for (size_t b = blockIdx.x; b < size_t(B); b += gridDim.x) {
    const float* syn_b = syn + b * L;
    bf16* xc = xc_out + b * size_t(L) * H;
    bf16* xq = xq_out + b * size_t(L) * H;
    Slabs<SR> sl{s.slab, 0};
    prime<SR, NTH>(sl, proj);
    for (int round = 0; round < R; ++round) {
      const bf16* xc_src = round == 0 ? xc_in + b * size_t(L) * H : xc;
      const bf16* xq_src = round == 0 ? xq_in + b * size_t(L) * H : xq;
      project_rows_tc<SR, NTH>(xq_src, L, proj, s.ys_c, s.xs, sl, wc + size_t(M_WS) * HH);
      update_cells_tc<SR, NWARP, true, SLOT16, MASK>(xc_src, xc, L, s.ys_c, s.ys_q, s.bits,
                                                     offs_c, syn_b, degbo, wc, vecs, s, sl,
                                                     wq + size_t(M_WD) * HH, width);
      update_cells_tc<SR, NWARP, false, SLOT16, MASK>(xq_src, xq, L, s.ys_q, nullptr,
                                                      s.bits + L, offs_q, nullptr,
                                                      degbo + size_t(L) * H, wq,
                                                      vecs + NVEC * H, s, sl,
                                                      round + 1 < R ? proj : nullptr, width);
      __syncthreads();   // the round's state and panel writes are visible to the next
    }
  }
}

}  // namespace tcr

// Warps of the bf16 kernel: d=11's raster side (144 cells) is one chunk.
constexpr int TC_WARPS = 9;

// Slab rows of the bf16 kernel: 64 where that fits in shared memory, else 32
// (d=15).
int tc_slab_rows(int L) {
  return tcr::smem_bytes<64, TC_WARPS>(L) <= tc::SMEM_LIMIT ? 64 : 32;
}

size_t smem_for(int L, int) {
  return tc_slab_rows(L) == 64 ? tcr::smem_bytes<64, TC_WARPS>(L)
                               : tcr::smem_bytes<32, TC_WARPS>(L);
}

// The bf16 global-panel variant, built with the LayerNorm's column mask only:
// at width 128 it masks nothing and takes 1/width = 1/128, so its arithmetic
// is the unmasked kernel's (two instantiations fewer to build).
template <bool SLOT16>
int launch_tc_gp(const Launch& a) {
  typedef __nv_bfloat16 bf;
  return launch_kernel<bf>(tcr::roll_rounds_tc_gpanels_kernel<64, TC_WARPS, SLOT16, true>,
                           32 * TC_WARPS, tcr::gp_smem_bytes<64, TC_WARPS>(a.L), a,
                           reinterpret_cast<bf*>(a.panels), a.B);
}

template <bool SLOT16, bool MASK>
int launch_tc(size_t smem, const Launch& a) {
  typedef __nv_bfloat16 bf;
  if (tc_slab_rows(a.L) == 64)
    return launch_kernel<bf>(tcr::roll_rounds_tc_kernel<64, TC_WARPS, SLOT16, MASK>,
                             32 * TC_WARPS, smem, a);
  return launch_kernel<bf>(tcr::roll_rounds_tc_kernel<32, TC_WARPS, SLOT16, MASK>,
                           32 * TC_WARPS, smem, a);
}

// one block a sample: grid B, no scratch (samples, grid and scratch unused)
int launch_state(Launch& a, int slot16, int, int, void*) {
  const size_t smem = smem_for(a.L, 1);
  if (a.width < H)
    return slot16 ? launch_tc<true, true>(smem, a) : launch_tc<false, true>(smem, a);
  return slot16 ? launch_tc<true, false>(smem, a) : launch_tc<false, false>(smem, a);
}

}  // namespace

extern "C" {

// Shared memory one block of the bf16 global-panel variant needs.
long long roll_rounds_tc_gpanels_smem_bytes(int L) {
  return (long long)tcr::gp_smem_bytes<64, TC_WARPS>(L);
}

// The bf16 global-panel variant of roll_rounds_launch: `grid` blocks walk the
// samples, block i with its two panels in panels[i] ([grid][2 L][128] bf16:
// ys_c, then ys_q); slot16 as there.
int roll_rounds_tc_gpanels_launch(int slot16, const void* xc_in, const void* xq_in,
                                  const void* syn, const void* maskbits, const void* degbo,
                                  const void* mats, const void* vecs, void* xc_out,
                                  void* xq_out, void* panels, const void* offs, int B, int L,
                                  int R, int width, int grid, void* stream) {
  Launch a{xc_in, xq_in, static_cast<const float*>(syn), static_cast<const int*>(maskbits),
           static_cast<const float*>(degbo), mats, static_cast<const float*>(vecs), xc_out,
           xq_out, {}, {}, B, L, R, width, grid, static_cast<float*>(panels),
           static_cast<cudaStream_t>(stream)};
  if (int err = prepare(a, offs)) return err;
  if (grid <= 0 || panels == nullptr) return int(cudaErrorInvalidValue);
  return slot16 ? launch_tc_gp<true>(a) : launch_tc_gp<false>(a);
}

}  // extern "C"
