// Single-rounding float arithmetic shared by the kernels.
//
// The kernels spell every product and sum with the _rn intrinsics, which
// nvcc never contracts into fused multiply-adds.  Each operation then rounds
// once, as PyTorch's elementwise operators and the JAX package do, so a
// kernel and its plain PyTorch version (the same formula, one tensor
// operation per step) give the same bits.
#pragma once

#include <cuda_runtime.h>

namespace nsp {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
// a / b; not named div, which <cstdlib> declares for integers.
__device__ __forceinline__ float ratio(float a, float b) { return __fdiv_rn(a, b); }

}  // namespace nsp
