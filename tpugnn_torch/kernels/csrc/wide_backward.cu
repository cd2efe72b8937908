// K2b above 128 columns with bf16 states: the backward entry points of the
// wide rounds kernels (wide_rounds.cuh), a library of its own beside
// wide_rounds.cu's forward; wide_backward_tf32.cu builds them for f32.
#include <cuda_bf16.h>

#define WIDE_STATE __nv_bfloat16
#define WIDE_CODE 1
#define WIDE_BACKWARD
#include "wide_rounds.cuh"
