// K1, K2a and K5 above 128 columns with bf16 states: the forward entry
// points of the wide rounds kernels (wide_rounds.cuh: the design, the
// bounds; wide_mma.cuh: the tile engine on wgmma).  wide_rounds_tf32.cu
// builds them for f32 states, wide_backward.cu and wide_backward_tf32.cu
// K2b, each a library of its own so that the four nvcc runs go in parallel.
#include <cuda_bf16.h>

#define WIDE_STATE __nv_bfloat16
#define WIDE_CODE 1
#define WIDE_FORWARD
#include "wide_rounds.cuh"
