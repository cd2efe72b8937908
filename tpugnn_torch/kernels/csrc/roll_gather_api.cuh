// What K5's two libraries share, and their common C entry points:
// roll_gather.cu (bf16 states, namespace tcr) and roll_gather_tf32.cu (f32
// states, 3xTF32, namespace t3r).  The two state types build apart, one nvcc
// each, so that they build in parallel (the two together were the build's
// longest); roll_rounds_smem_bytes and roll_rounds_launch are the same in
// both, and each library takes only its own state type (dtype argument: 0 =
// float32, 1 = bfloat16; the other gives -1 bytes or cudaErrorInvalidValue).
// The global-panel variants' entry points are each library's own
// (roll_rounds_gpanels_* f32, roll_rounds_tc_gpanels_* bf16).  A source
// defines kDtype, includes this after rounds_common.cuh and defines, in its
// anonymous namespace:
//   smem_for       one block's shared memory for one sample of L cells;
//   launch_state   the launch of its kernel on checked arguments (slot16,
//                  and the f32 kernel's samples a block, grid and scratch).
#pragma once

#include "rounds_common.cuh"

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
  float* panels;        // the f32 or the bf16 variant's per-block scratch
  cudaStream_t stream;
};

// `extra`: the arguments past `width` (the f32 kernel's scratch, B and S).
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

size_t smem_for(int L, int S);
int launch_state(Launch& a, int slot16, int samples, int grid, void* scratch);

}  // namespace

extern "C" {

// Shared memory one block needs for one sample of L cells; dtype 0 =
// float32 states, 1 = bfloat16.  f32 samples stacked S to a block (S L <=
// 144) need no more than one sample of 144 cells, which fits.
long long roll_rounds_smem_bytes(int dtype, int L) {
  return dtype == kDtype ? (long long)smem_for(L, 1) : -1;
}

// xc_in/xq_in/xc_out/xq_out: [B, L, 128] raster states in the state type;
// syn [B, L] f32; maskbits [2, L] int32 (bit k: slot k of the cell is real;
// check cells, then qubit cells); degbo [2, L, 128] f32; mats [10, 128, 128]
// in bf16, or for f32 states the same matrices split into TF32 halves in
// fragment order (fused_decoder.py::tf32_split_pack); vecs [14, 128] f32
// (row 2 the unrounded uc_s); offs, a host array of 8 ints: the four
// check-side offsets, then the four qubit-side ones.  slot16 (bf16 states
// only) rounds the slot stage to bf16.  width (<= 128): the model's width,
// the columns past it zero in every operand.  f32 only: `samples` samples
// a block (dividing B, samples * L <= 144), a persistent grid of `grid`
// blocks and their scratch [grid][samples L][128] f32 (bf16: 1, 0, null).
// Returns cudaGetLastError() after the launch (0 on success).
int roll_rounds_launch(int dtype, int slot16, const void* xc_in, const void* xq_in,
                       const void* syn, const void* maskbits, const void* degbo,
                       const void* mats, const void* vecs, void* xc_out, void* xq_out,
                       const void* offs, int B, int L, int R, int width, int samples,
                       void* scratch, int grid, void* stream) {
  Launch a{xc_in, xq_in, static_cast<const float*>(syn), static_cast<const int*>(maskbits),
           static_cast<const float*>(degbo), mats, static_cast<const float*>(vecs), xc_out,
           xq_out, {}, {}, B, L, R, width, B, static_cast<float*>(scratch),
           static_cast<cudaStream_t>(stream)};
  if (int err = prepare(a, offs)) return err;
  if (dtype != kDtype) return int(cudaErrorInvalidValue);
  return launch_state(a, slot16, samples, grid, scratch);
}

}  // extern "C"
