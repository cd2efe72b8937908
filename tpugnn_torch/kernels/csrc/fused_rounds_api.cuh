// The C entry points of K1 and K2a, shared by the two libraries that build
// them: fused_rounds.cu (bf16 states, namespace tcp) and fused_rounds_tf32.cu
// (f32 states, 3xTF32, namespace t3p).  The two state types build apart, one
// nvcc each, so that they build in parallel; the entry points, their
// arguments and their checks are the same in both, and each library takes
// only its own state type (dtype argument: 0 = float32, 1 = bfloat16; the
// other gives -1 bytes or cudaErrorInvalidValue).  A source includes this
// after rounds_common.cuh and defines, in its anonymous namespace:
//   kDtype                        its state type;
//   smem_for, gp_smem_for         a block's shared memory, panels in shared
//                                 or in global memory;
//   launch_state<STASH>           the launch of its kernel on checked
//                                 arguments.
#pragma once

#include "rounds_common.cuh"

namespace {

using namespace rounds;

size_t smem_for(int M, int N, int Dc, int Dq);
size_t gp_smem_for(int M, int N, int Dc, int Dq);
template <bool STASH>
int launch_state(const void* xc_in, const void* xq_in, const float* syn, const int* idx_c,
                 const int* idx_q, const void* mats, const float* vecs, void* xc_out,
                 void* xq_out, void* stash_c, void* stash_q, void* panels, int B, int M, int N,
                 int Dc, int Dq, int R, int width, int grid, size_t smem, cudaStream_t stream);

template <typename K, typename... Args>
int launch_kernel(K kernel, int grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

bool bad_shape(int B, int M, int N, int Dc, int Dq, int R, int width) {
  return B <= 0 || M <= 0 || N <= 0 || Dc <= 0 || Dq <= 0 || R <= 0 || width <= 0 ||
         width > H;
}

// K1 (K2a with STASH) in the library's state type; panels (a [grid][N +
// M][128] scratch in the state type) selects the global-panel variant on
// `grid` blocks, else the grid is B.
template <bool STASH>
int launch_dtype(int dtype, const void* xc_in, const void* xq_in, const void* syn,
                 const void* idx_c, const void* idx_q, const void* mats,
                 const void* vecs, void* xc_out, void* xq_out, void* stash_c,
                 void* stash_q, void* panels, int B, int M, int N, int Dc, int Dq, int R,
                 int width, int grid, void* stream) {
  const bool gp = panels != nullptr;
  if (dtype != kDtype || bad_shape(B, M, N, Dc, Dq, R, width) || (gp && grid <= 0))
    return int(cudaErrorInvalidValue);
  if (STASH && (stash_c == nullptr || stash_q == nullptr))
    return int(cudaErrorInvalidValue);
  if (!gp) grid = B;
  const size_t smem = gp ? gp_smem_for(M, N, Dc, Dq) : smem_for(M, N, Dc, Dq);
  return launch_state<STASH>(xc_in, xq_in, static_cast<const float*>(syn),
                             static_cast<const int*>(idx_c), static_cast<const int*>(idx_q),
                             mats, static_cast<const float*>(vecs), xc_out, xq_out, stash_c,
                             stash_q, panels, B, M, N, Dc, Dq, R, width, grid, smem,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Shared memory one block of K1 needs.
long long fused_rounds_smem_bytes(int dtype, int M, int N, int Dc, int Dq) {
  return dtype == kDtype ? (long long)smem_for(M, N, Dc, Dq) : -1;
}

// Shared memory one block of K2a (fused_rounds_stash_launch) needs.
long long fused_rounds_stash_smem_bytes(int dtype, int M, int N, int Dc, int Dq) {
  return dtype == kDtype ? (long long)smem_for(M, N, Dc, Dq) : -1;
}

// Shared memory one block of the global-panel variant needs (K1 and K2a).
long long fused_rounds_gpanels_smem_bytes(int dtype, int M, int N, int Dc, int Dq) {
  return dtype == kDtype ? (long long)gp_smem_for(M, N, Dc, Dq) : -1;
}

// xc_in/xq_in/xc_out/xq_out: [B, M|N, 128] in the state type; syn [B, M] f32;
// idx_c [M, Dc], idx_q [N, Dq] int32 (-1 = masked slot); mats [10, 128, 128]
// in bf16, or for f32 states the same matrices split into TF32 halves in
// fragment order (fused_decoder.py::tf32_split_pack); vecs [14, 128] f32;
// width (<= 128): the model's width,
// the columns past it zero in every operand.  Returns cudaGetLastError()
// after the launch (0 on success).
int fused_rounds_launch(int dtype, const void* xc_in, const void* xq_in,
                        const void* syn, const void* idx_c, const void* idx_q,
                        const void* mats, const void* vecs, void* xc_out,
                        void* xq_out, int B, int M, int N, int Dc, int Dq, int R,
                        int width, void* stream) {
  return launch_dtype<false>(dtype, xc_in, xq_in, syn, idx_c, idx_q, mats, vecs,
                             xc_out, xq_out, nullptr, nullptr, nullptr, B, M, N, Dc, Dq, R,
                             width, 0, stream);
}

// The global-panel variant of fused_rounds_launch: `grid` blocks walk the
// samples, block i with its two panels in panels[i] ([grid][N + M][128]
// scratch in the state type).
int fused_rounds_gpanels_launch(int dtype, const void* xc_in, const void* xq_in,
                                const void* syn, const void* idx_c, const void* idx_q,
                                const void* mats, const void* vecs, void* xc_out, void* xq_out,
                                void* panels, int B, int M, int N, int Dc, int Dq, int R,
                                int width, int grid, void* stream) {
  if (panels == nullptr) return int(cudaErrorInvalidValue);
  return launch_dtype<false>(dtype, xc_in, xq_in, syn, idx_c, idx_q, mats, vecs,
                             xc_out, xq_out, nullptr, nullptr, panels, B, M, N, Dc, Dq, R,
                             width, grid, stream);
}

// K2a: as fused_rounds_launch, and every round's input states go to
// stash_c [R, B, M, 128] and stash_q [R, B, N, 128] in the state type; for
// f32 states mats the split pack.  B samples of M and N rows may be s
// samples stacked as one graph of s M and s N rows (B / s blocks): the stash
// [R, B / s, s M, 128] is the same memory as [R, B, M, 128].
int fused_rounds_stash_launch(int dtype, const void* xc_in, const void* xq_in,
                              const void* syn, const void* idx_c, const void* idx_q,
                              const void* mats, const void* vecs, void* xc_out,
                              void* xq_out, void* stash_c, void* stash_q, int B,
                              int M, int N, int Dc, int Dq, int R, int width,
                              void* stream) {
  return launch_dtype<true>(dtype, xc_in, xq_in, syn, idx_c, idx_q, mats, vecs,
                            xc_out, xq_out, stash_c, stash_q, nullptr, B, M, N, Dc, Dq, R,
                            width, 0, stream);
}

// K2a's global-panel variant: as fused_rounds_stash_launch on `grid` blocks
// with their panels in `panels`, as fused_rounds_gpanels_launch; its stash is
// laid out as the shared-panel kernel's, one sample a block at a time.
int fused_rounds_stash_gpanels_launch(int dtype, const void* xc_in, const void* xq_in,
                                      const void* syn, const void* idx_c, const void* idx_q,
                                      const void* mats, const void* vecs, void* xc_out,
                                      void* xq_out, void* stash_c, void* stash_q,
                                      void* panels, int B, int M, int N, int Dc, int Dq,
                                      int R, int width, int grid, void* stream) {
  if (panels == nullptr) return int(cudaErrorInvalidValue);
  return launch_dtype<true>(dtype, xc_in, xq_in, syn, idx_c, idx_q, mats, vecs,
                            xc_out, xq_out, stash_c, stash_q, panels, B, M, N, Dc, Dq, R,
                            width, grid, stream);
}

}  // extern "C"
