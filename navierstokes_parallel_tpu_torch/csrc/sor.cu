// Red-black SOR sweeps on the correction equation A delta = rhs_neg.
//
// Replaces the Pallas TPU kernel navierstokes_parallel_tpu/ops/pallas/
// sor_kernel.py::_make_kernel (called through _sweeps_call / inner_sweeps):
// n red-black sweeps from delta = 0, the inner stage of the mixed-precision
// refinement solver (ops/sor.py), which owns the f64 master pressure and the
// convergence test.
//
// What bounds it on an H100: memory traffic and launches.  At the main
// path's 258 x 258 padded grid a half-sweep reads 8 B (delta and rhs) and
// writes 4 B per updated cell, about 0.4 MB in all, while delta + rhs
// (0.53 MB) exceed the 227 KB of shared memory one block may use, so the
// TPU kernel's whole-grid residency does not carry over.  This first design
// therefore keeps the data in device memory, where it stays resident in the
// 50 MB L2 cache across launches:
//   - one launch per half-sweep over a 2D grid of blocks, one thread per
//     cell (threads of the other colour and of the ghost ring return at
//     once); neighbours are read from global memory, i.e. from L2;
//   - the C entry point loops the 2 n launches itself on the caller's
//     stream, so Python pays one call per n sweeps, not one per launch;
//   - the update is in place and race-free: a red cell reads only black
//     neighbours and itself, and a black cell the reverse.
// The Neumann boundary is folded into a per-cell self coefficient as in the
// Pallas kernel: ghost cells are never written, stay 0 (the caller passes
// delta = 0), and self_coef * delta adds the mirrored neighbour.  Temporal
// blocking in shared memory (the 2K halo of sor_kernel.py:188-201) and TMA
// are later work.
//
// Arithmetic order and constants follow the Pallas kernel:
//   nb    = (d_W + d_E) * dx2_inv + (d_S + d_N) * dy2_inv + d * self_coef
//   d_new = (1 - omega) * d + coef * (nb - rhs)
// with every constant rounded to f32 once on the host.

#include <cuda_runtime.h>

#include "nsp_round.cuh"

namespace {

constexpr int kBlockJ = 32;  // threads along j, the contiguous axis
constexpr int kBlockI = 8;   // threads along i

__global__ void rb_half_sweep(float* d, const float* __restrict__ rhs, int ni,
                              int nj, int parity, float one_minus_omega,
                              float coef, float dx2_inv, float dy2_inv) {
  using namespace nsp;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  // Interior cells of this colour; parity is (i + j) & 1 on the padded
  // (= 1-based interior) indices, red = 0 first.
  if (i < 1 || i > ni - 2 || j < 1 || j > nj - 2 || ((i + j) & 1) != parity)
    return;
  const size_t c = static_cast<size_t>(i) * nj + j;
  const float self_coef =
      add(mul(static_cast<float>((i == 1) + (i == ni - 2)), dx2_inv),
          mul(static_cast<float>((j == 1) + (j == nj - 2)), dy2_inv));
  const float dc = d[c];
  const float nb = add(add(mul(add(d[c - nj], d[c + nj]), dx2_inv),
                           mul(add(d[c - 1], d[c + 1]), dy2_inv)),
                       mul(dc, self_coef));
  d[c] = add(mul(one_minus_omega, dc), mul(coef, sub(nb, rhs[c])));
}

}  // namespace

// n_sweeps red-black sweeps, in place on d (ni x nj, row-major f32; its
// ghost ring must be 0).  Returns cudaGetLastError() after the launches.
extern "C" int nsp_sor_sweeps(float* d, const float* rhs, int ni, int nj,
                              int n_sweeps, float one_minus_omega, float coef,
                              float dx2_inv, float dy2_inv, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockJ, kBlockI);
  const dim3 grid((nj + kBlockJ - 1) / kBlockJ, (ni + kBlockI - 1) / kBlockI);
  for (int k = 0; k < n_sweeps; ++k) {
    for (int parity = 0; parity < 2; ++parity) {
      rb_half_sweep<<<grid, block, 0, s>>>(d, rhs, ni, nj, parity,
                                           one_minus_omega, coef, dx2_inv,
                                           dy2_inv);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
