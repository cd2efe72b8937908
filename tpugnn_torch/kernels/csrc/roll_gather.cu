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
// Two instantiations:
//   bf16 states (the bench config's pallas_roll and pallas_roll16): the
//     tensor-core path, tcr:: below, on K1's routine (rounds_mma.cuh).  Every
//     operand of every product is a bf16 value (states, the slot sum and the
//     update hidden are rounded, the packed matrices stored in bf16), so
//     mma.sync.m16n8k16 bf16 with f32 accumulation forms the products of the
//     plain version; only the f32 summation order differs.  A block has 9
//     warps, so a chunk is 144 rows: d=11's whole raster side (a 128-row
//     chunk of 8 warps would leave a 16-row tail that one warp works through
//     behind every slab barrier); larger rasters run a second, ragged chunk
//     (d=13: 144 + 56, d=15: 144 + 112, with 32-row weight slabs).
//   f32 states (the trained roll decode): 32-row chunks of f32 FMA loops
//     (gemm_chunk, rounds_common.cuh).  From d=13 the two f32 panels do not
//     fit in shared memory (l_pad 200: 263,568 B); there its GP variant
//     keeps them in a per-block global scratch [grid][2 L][H] on a
//     persistent grid of one block per SM, as K1's (fused_rounds.cu).
//
// Width: as K1's.  States and packs come zero-padded to 128 columns, and
// with MASK (compiled in only for width < 128) the LayerNorm runs over the
// model's first `width` columns.
//
// Bounds on an H100 at d=11, H=128: the work is K1's (the raster's 288 rows
// against the graph's 241 real ones are this design's overhead), 39.7 MFLOP
// per sample and round on the real rows; HBM traffic is the states in and
// out, so it is bound by operations: at B=4096, R=8 1.32 ms at the bf16
// tensor-core peak and 19.4 ms at the f32 CUDA-core peak.  One block per SM
// by shared memory (bf16 at d=11 about 187 KB, f32 about 206 KB).

#include "rounds_common.cuh"
#include "rounds_mma.cuh"

namespace {

using namespace rounds;

constexpr int SLOTS = 4;

struct Offsets {
  int o[SLOTS];
};

// source cell of slot offset o from cell r, on a raster of L cells
__device__ __forceinline__ int wrap(int r, int o, int L) {
  const int src = r + o;
  return src < 0 ? src + L : (src >= L ? src - L : src);
}

// ---------------------------------------------------------------------------
// The f32 path: 32-row chunks, each warp 4 rows and each lane 4 columns, f32
// FMA loops over a 16-deep slab.

struct Smem {
  float* ys_c;           // [L][H] qubit-cell projections, read by check cells
  float* ys_q;           // [L][H] check-cell projections, read by qubit cells
  float* xs;             // [CH][XLD] state chunk (GEMM A operand, residual)
  float* hs;             // [CH][XLD] slot sum, then update hidden (GEMM A operand)
  float* wsl;            // [KS][3*H] staged weight slab
  unsigned char* bits;   // [2][L] slot-mask bits: check cells, then qubit cells
};

// GP: the gather panels are in global memory, not in the block's share
template <bool GP = false>
__host__ __device__ inline size_t smem_bytes(int L) {
  return (GP ? 0 : 2 * align16(size_t(L) * H * sizeof(float))) +
         2 * align16(size_t(CH) * XLD * sizeof(float)) +
         align16(size_t(KS) * 3 * H * sizeof(float)) + align16(size_t(2) * L);
}

// panels: the block's global panels [2 L][H] (GP), or nullptr
template <bool GP>
__device__ Smem carve(unsigned char* base, int L, float* panels) {
  Smem s;
  size_t o = 0;
  if (GP) {
    s.ys_c = panels;
    s.ys_q = panels + size_t(L) * H;
  } else {
    s.ys_c = reinterpret_cast<float*>(base + o); o += align16(size_t(L) * H * sizeof(float));
    s.ys_q = reinterpret_cast<float*>(base + o); o += align16(size_t(L) * H * sizeof(float));
  }
  s.xs = reinterpret_cast<float*>(base + o);   o += align16(size_t(CH) * XLD * sizeof(float));
  s.hs = reinterpret_cast<float*>(base + o);   o += align16(size_t(CH) * XLD * sizeof(float));
  s.wsl = reinterpret_cast<float*>(base + o);  o += align16(size_t(KS) * 3 * H * sizeof(float));
  s.bits = base + o;
  return s;
}

// Phases B and C: update cells [0, L) of state x in place (reading the state
// from x_src, writing it to x_dst, which may alias).  NW = 3 also writes the
// projection x @ W[M_WS] into ys_out (the other side's gather source); SYN
// adds the syndrome term syn * uc_s.
template <int NW, bool SYN, bool MASK>
__device__ void update_cells(const float* x_src, float* x_dst, int L, const float* ys_src,
                             float* ys_out, const unsigned char* bits, Offsets offs,
                             const float* syn, const float* __restrict__ degbo,
                             const float* __restrict__ W, const float* __restrict__ vec,
                             const Smem& s, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * 4;
  float b0[4], ucs[4], ub0[4], ub1[4], lns[4], lnb[4];
  load4(vec + V_B0 * H + c0, b0);
  load4(vec + V_UCS * H + c0, ucs);
  load4(vec + V_UB0 * H + c0, ub0);
  load4(vec + V_UB1 * H + c0, ub1);
  load4(vec + V_LNS * H + c0, lns);
  load4(vec + V_LNB * H + c0, lnb);

  for (int row0 = 0; row0 < L; row0 += CH) {
    __syncthreads();  // the previous chunk's readers of xs / hs are done
    load_chunk(x_src, row0, L, s.xs);

    // [x @ wd | x @ ux | x @ ws]
    float acc[NW][4][4];
    gemm_chunk<float, NW>(s.xs, W, s.wsl, acc);

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
        for (int j = 0; j < 4; ++j) ydb[j] = acc[M_WD][i][j] + b0[j];
        const unsigned m = bits[r];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          if (!((m >> k) & 1u)) continue;   // a masked slot adds exactly 0
          float y[4];
          load4(ys_src + size_t(wrap(r, offs.o[k], L)) * H + c0, y);
#pragma unroll
          for (int j = 0; j < 4; ++j) h4[j] += fmaxf(y[j] + ydb[j], 0.f);
        }
      }
      store4(s.hs + lr * XLD + c0, h4);
    }

    // folded aggregation GEMM, update-MLP pre-activation
    float agg[1][4][4];
    gemm_chunk<float, 1>(s.hs, W + size_t(M_WF) * H * H, s.wsl, agg);
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
        if (SYN) pre += __fmul_rn(sv, ucs[j]);
        pre += ub0[j];
        hc[j] = fmaxf(pre, 0.f);
      }
      store4(s.hs + lr * XLD + c0, hc);
    }

    // update output GEMM, residual, LayerNorm (two-pass, eps 1e-6, over
    // the first `width` columns; a padded column's v is 0)
    gemm_chunk<float, 1>(s.hs, W + size_t(M_W1) * H * H, s.wsl, agg);
    const float inv_w = MASK ? 1.f / width : 1.f / H;
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
      const float mu = warp_sum(sum) * inv_w;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] -= mu;
      if (MASK) {   // a narrower model's padded columns
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j >= width) v[j] = 0.f;
      }
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sq += v[j] * v[j];
      const float rs = rsqrtf(warp_sum(sq) * inv_w + 1e-6f);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = v[j] * rs * lns[j] + lnb[j];
      if (r < L) store4(x_dst + size_t(r) * H + c0, o);
    }
  }
}

// One block per sample (grid = B), or with GP a persistent grid whose
// blocks walk the samples, each with its own panels in `panels`.
template <bool GP, bool MASK>
__global__ void __launch_bounds__(THREADS, 1)
roll_rounds_kernel(const float* xc_in, const float* xq_in, const float* __restrict__ syn,
                   const int* __restrict__ maskbits, const float* __restrict__ degbo,
                   const float* __restrict__ mats, const float* __restrict__ vecs,
                   float* xc_out, float* xq_out, Offsets offs_c, Offsets offs_q, int L,
                   int R, int width, float* panels, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve<GP>(smem_raw, L,
                           GP ? panels + size_t(blockIdx.x) * 2 * L * H : nullptr);
  for (int e = threadIdx.x; e < 2 * L; e += THREADS)
    s.bits[e] = static_cast<unsigned char>(maskbits[e]);
  const float* wc = mats;                         // check side's 5 matrices
  const float* wq = mats + size_t(NMAT) * H * H;  // qubit side's 5 matrices

  for (size_t b = blockIdx.x; b < size_t(B); b += gridDim.x) {
    const float* syn_b = syn + b * L;
    float* xc = xc_out + b * size_t(L) * H;
    float* xq = xq_out + b * size_t(L) * H;
    for (int round = 0; round < R; ++round) {
      // round 0 reads the inputs; later rounds the states rewritten in place
      const float* xc_src = round == 0 ? xc_in + b * size_t(L) * H : xc;
      const float* xq_src = round == 0 ? xq_in + b * size_t(L) * H : xq;
      project_rows<float>(xq_src, L, wq + size_t(M_WS) * H * H, s.ys_c, s.xs, s.wsl);
      __syncthreads();
      update_cells<3, true, MASK>(xc_src, xc, L, s.ys_c, s.ys_q, s.bits, offs_c, syn_b, degbo, wc,
                            vecs, s, width);
      __syncthreads();
      update_cells<2, false, MASK>(xq_src, xq, L, s.ys_q, nullptr, s.bits + L, offs_q, nullptr,
                             degbo + size_t(L) * H, wq, vecs + NVEC * H, s, width);
      __syncthreads();
    }
  }
}

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

}  // namespace tcr

// Warps of the bf16 kernel: d=11's raster side (144 cells) is one chunk.
constexpr int TC_WARPS = 9;

// Slab rows of the bf16 kernel: 64 where that fits in shared memory, else 32
// (d=15).
int tc_slab_rows(int L) {
  return tcr::smem_bytes<64, TC_WARPS>(L) <= tc::SMEM_LIMIT ? 64 : 32;
}

size_t smem_for(int dtype, int L) {
  if (dtype == 0) return smem_bytes(L);
  return tc_slab_rows(L) == 64 ? tcr::smem_bytes<64, TC_WARPS>(L)
                               : tcr::smem_bytes<32, TC_WARPS>(L);
}

// The launch's arguments past the kernel's choice: one call of any of the
// kernels, with `grid` blocks (B, or the persistent grid of the GP variant).
struct Launch {
  const void *xc_in, *xq_in;
  const float* syn;
  const int* bits;
  const float* degbo;
  const void* mats;
  const float* vecs;
  void *xc_out, *xq_out;
  Offsets offs_c, offs_q;
  int B, L, R, width, grid;
  float* panels;
  cudaStream_t stream;
};

// `extra`: the arguments past `width` (the f32 kernel's panels and B).
template <typename T, typename K, typename... Extra>
int launch_kernel(K kernel, int threads, size_t smem, const Launch& a, Extra... extra) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<a.grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.xc_in), static_cast<const T*>(a.xq_in), a.syn, a.bits, a.degbo,
      static_cast<const T*>(a.mats), a.vecs, static_cast<T*>(a.xc_out),
      static_cast<T*>(a.xq_out), a.offs_c, a.offs_q, a.L, a.R, a.width, extra...);
  return int(cudaGetLastError());
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

// Checks the shapes and reads the offsets; returns 0 or an error.
int prepare(Launch& a, const void* offs) {
  if (a.B <= 0 || a.L <= 0 || a.R <= 0 || a.width <= 0 || a.width > H || offs == nullptr)
    return int(cudaErrorInvalidValue);
  const int* o = static_cast<const int*>(offs);
  for (int k = 0; k < SLOTS; ++k) {
    a.offs_c.o[k] = o[k];
    a.offs_q.o[k] = o[SLOTS + k];
    if (a.offs_c.o[k] <= -a.L || a.offs_c.o[k] >= a.L || a.offs_q.o[k] <= -a.L ||
        a.offs_q.o[k] >= a.L)
      return int(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = float32 states, 1 = bfloat16.
long long roll_rounds_smem_bytes(int dtype, int L) {
  return (long long)smem_for(dtype, L);
}

// Shared memory one block of the f32 global-panel variant needs.
long long roll_rounds_gpanels_smem_bytes(int L) {
  return (long long)smem_bytes<true>(L);
}

// xc_in/xq_in/xc_out/xq_out: [B, L, 128] raster states in the state type;
// syn [B, L] f32; maskbits [2, L] int32 (bit k: slot k of the cell is real;
// check cells, then qubit cells); degbo [2, L, 128] f32; mats [10, 128, 128]
// in the state type; vecs [14, 128] f32 (row 2 the unrounded uc_s); offs, a
// host array of 8 ints: the four check-side offsets, then the four qubit-side
// ones.  slot16 (bf16 states only) rounds the slot stage to bf16.  width
// (<= 128): the model's width, the columns past it zero in every operand.
// Returns cudaGetLastError() after the launch (0 on success).
int roll_rounds_launch(int dtype, int slot16, const void* xc_in, const void* xq_in,
                       const void* syn, const void* maskbits, const void* degbo,
                       const void* mats, const void* vecs, void* xc_out, void* xq_out,
                       const void* offs, int B, int L, int R, int width, void* stream) {
  Launch a{xc_in, xq_in, static_cast<const float*>(syn), static_cast<const int*>(maskbits),
           static_cast<const float*>(degbo), mats, static_cast<const float*>(vecs), xc_out,
           xq_out, {}, {}, B, L, R, width, B, nullptr, static_cast<cudaStream_t>(stream)};
  if (int err = prepare(a, offs)) return err;
  const size_t smem = smem_for(dtype, L);
  const bool mask = width < H;
  if (dtype == 0)
    return launch_kernel<float>(mask ? roll_rounds_kernel<false, true>
                                     : roll_rounds_kernel<false, false>, THREADS, smem, a,
                                a.panels, a.B);
  if (dtype != 1) return int(cudaErrorInvalidValue);
  if (mask) return slot16 ? launch_tc<true, true>(smem, a) : launch_tc<false, true>(smem, a);
  return slot16 ? launch_tc<true, false>(smem, a) : launch_tc<false, false>(smem, a);
}

// The f32 global-panel variant of roll_rounds_launch: `grid` blocks walk the
// samples, block i with its two panels in panels[i] ([grid][2 L][128] f32
// scratch).
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
  return launch_kernel<float>(width < H ? roll_rounds_kernel<true, true>
                                         : roll_rounds_kernel<true, false>, THREADS,
                              smem_bytes<true>(L), a, a.panels, a.B);
}

}  // extern "C"
