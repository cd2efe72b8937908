// K2b above 128 columns with f32 states: the backward entry points of the
// wide rounds kernels (wide_rounds.cuh), every product 3xTF32 on wgmma;
// wide_backward.cu builds them for bf16.
#define WIDE_STATE float
#define WIDE_CODE 0
#define WIDE_BACKWARD
#include "wide_rounds.cuh"
