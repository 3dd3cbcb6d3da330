// Red-black SOR sweeps on colour-compacted arrays (B5).
//
// nsp_sor_compressed_sweeps replaces the Pallas TPU kernel navierstokes_
// parallel_tpu/ops/pallas/sor_kernel.py::_make_compressed_kernel (called
// through _compressed_sweeps_call / inner_sweeps_compressed): n red-black
// sweeps on A delta = rhs_neg from delta = 0, with the red and the black
// cells held in two (ni, nj / 2) arrays (nj, the padded width, even).  The
// wrapper compacts rhs and expands the result with PyTorch operations, as
// the JAX package does both in XLA outside its kernel.
//
// Index algebra (b = i & 1, the row parity):
//   red[i, k]   = d[i, 2k + b]       black[i, k] = d[i, 2k + 1 - b]
//   red W/E neighbours  = black[i -/+ 1, k]
//   red N = black[i, k + b],   red S = black[i, k + b - 1]
//   black N = red[i, k + 1 - b], black S = red[i, k - b]
// The update is nsp_sor.cuh's expression with the Pallas kernel's order of
// the y neighbours, (W + E) * dx2_inv + (N + S) * dy2_inv + d * self_coef;
// IEEE addition commutes, so it equals nsp_sor_sweeps_simple (sor.cu) bit
// for bit.
//
// What bounds it on an H100: as B1, memory traffic and the launch rate.  It
// makes one launch per half-sweep, looped in C, like B1, but every thread
// of a launch updates a cell of the launch's colour: there is no colour
// test and no idle half of the threads, and a half-sweep reads and writes
// contiguous half-width rows.  The TPU gained nothing from it (its vector
// registers are 128 lanes wide either way, sor_kernel.py:867-872).  Nor
// does the card: halving the threads per launch does not lift the launch
// rate, the bound at 258^2, and 64 sweeps there took 0.57 ms against B1's
// 0.41 ms on an H100 (700 W).  A compacted layout would pay inside a kernel
// that sweeps many times per launch, as the tiled one (sor_tiled.cu) does.

#include <cuda_runtime.h>

#include "nsp_round.cuh"

namespace {

constexpr int kBlockK = 32;  // threads along k, the contiguous axis
constexpr int kBlockI = 8;   // threads along i

// One half-sweep in place on tgt (the colour `is_red` says) from other,
// both ni x nj/2.
__global__ void compressed_half_sweep(float* __restrict__ tgt,
                                      const float* __restrict__ other,
                                      const float* __restrict__ rhs, int ni,
                                      int nj, int is_red,
                                      float one_minus_omega, float coef,
                                      float dx2_inv, float dy2_inv) {
  using namespace nsp;
  const int njc = nj / 2;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ni || k >= njc) return;
  const int b = i & 1;
  const int j = 2 * k + (is_red ? b : 1 - b);
  if (i < 1 || i > ni - 2 || j < 1 || j > nj - 2) return;
  const size_t row = static_cast<size_t>(i) * njc;
  const size_t c = row + k;
  const int kn = is_red ? k + b : k + 1 - b;  // N; S is kn - 1
  const float self_coef =
      add(mul(static_cast<float>((i == 1) + (i == ni - 2)), dx2_inv),
          mul(static_cast<float>((j == 1) + (j == nj - 2)), dy2_inv));
  const float t = tgt[c];
  const float nb =
      add(add(mul(add(other[c - njc], other[c + njc]), dx2_inv),
              mul(add(other[row + kn], other[row + kn - 1]), dy2_inv)),
          mul(t, self_coef));
  tgt[c] = add(mul(one_minus_omega, t), mul(coef, sub(nb, rhs[c])));
}

}  // namespace

// n_sweeps red-black sweeps, in place on red and black (ni x nj/2 each,
// row-major f32, 0 on entry) with rhs_red / rhs_black the compacted rhs.
// Returns cudaGetLastError() after the launches.
extern "C" int nsp_sor_compressed_sweeps(float* red, float* black,
                                         const float* rhs_red,
                                         const float* rhs_black, int ni,
                                         int nj, int n_sweeps,
                                         float one_minus_omega, float coef,
                                         float dx2_inv, float dy2_inv,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nj % 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockK, kBlockI);
  const dim3 grid((nj / 2 + kBlockK - 1) / kBlockK,
                  (ni + kBlockI - 1) / kBlockI);
  for (int n = 0; n < n_sweeps; ++n) {
    compressed_half_sweep<<<grid, block, 0, s>>>(
        red, black, rhs_red, ni, nj, 1, one_minus_omega, coef, dx2_inv,
        dy2_inv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    compressed_half_sweep<<<grid, block, 0, s>>>(
        black, red, rhs_black, ni, nj, 0, one_minus_omega, coef, dx2_inv,
        dy2_inv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
