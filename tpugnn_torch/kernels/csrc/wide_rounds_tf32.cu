// K1, K2a and K5 above 128 columns with f32 states: the forward entry
// points of the wide rounds kernels of wide_rounds.cuh, every product
// 3xTF32 on wgmma (wide_mma.cuh); wide_rounds.cu builds them for bf16.
#define WIDE_STATE float
#define WIDE_CODE 0
#define WIDE_FORWARD
#include "wide_rounds.cuh"
