// Red-black SOR sweeps: the SOR route's inner stage (B1) and the multigrid
// smoother (B3).
//
// nsp_sor_sweeps replaces the Pallas TPU kernel navierstokes_parallel_tpu/
// ops/pallas/sor_kernel.py::_make_kernel (called through _sweeps_call /
// inner_sweeps): n red-black sweeps on the correction equation
// A delta = rhs_neg from delta = 0, the inner stage of the mixed-precision
// refinement solver (ops/sor.py), which owns the f64 master pressure and the
// convergence test.
//
// nsp_sor_warm_sweeps replaces the same body built with warm_start=True
// (_warm_sweeps_call / warm_sweeps): n red-black sweeps from a given p0,
// with omega and the level's dx^2 / dy^2 passed per call.  It is the
// smoother of every level of the multigrid V-cycle (ops/mg.py), from the
// finest padded grid (2050^2 for configs/4.in) down to 10^2.
//
// What bounds them on an H100: memory traffic and launches.  At the SOR
// main path's 258 x 258 padded grid a half-sweep reads 8 B (delta and rhs)
// and writes 4 B per updated cell, about 0.4 MB in all, while delta + rhs
// (0.53 MB) exceed the 227 KB of shared memory one block may use, so the
// TPU kernel's whole-grid residency does not carry over.  This first design
// therefore keeps the data in device memory, where it stays resident in the
// 50 MB L2 cache across launches (2050^2 p + rhs, 33.6 MB, still fits):
//   - one launch per half-sweep over a 2D grid of blocks, one thread per
//     cell (threads of the other colour and of the ghost ring return at
//     once); neighbours are read from global memory, i.e. from L2;
//   - the C entry point loops the 2 n launches itself on the caller's
//     stream, so Python pays one call per n sweeps, not one per launch;
//   - the update is in place and race-free: a red cell reads only black
//     neighbours and itself, and a black cell the reverse;
//   - the warm start's first half-sweep is out of place: it reads p0 and
//     writes every cell of the output, updated or copied, so the copy of p0
//     costs no launch of its own.
// The multigrid smoother runs 2 sweeps per call (32 on the coarsest level),
// so on the small levels it is bound by the launch rate alone: a level of
// 10^2 cells has one block per launch.  Fusing the short smoothers, or a
// CUDA graph of the whole cycle, is later work.
// The Neumann boundary is folded into a per-cell self coefficient as in the
// Pallas kernel, so the ghost ring is read as given and never written: it
// stays 0 for nsp_sor_sweeps (the caller passes delta = 0), and it is
// p0's ring for nsp_sor_warm_sweeps (multigrid keeps its rings at 0 too).
// Temporal blocking in shared memory (the 2K halo of sor_kernel.py:188-201)
// is sor_tiled.cu's, on the route of the grids beyond the JAX whole-grid
// budget; TMA is later work.
//
// The cell update and its arithmetic order are nsp_sor.cuh's.

#include <cuda_runtime.h>

#include "nsp_sor.cuh"

namespace {

constexpr int kBlockJ = 32;  // threads along j, the contiguous axis
constexpr int kBlockI = 8;   // threads along i

// One half-sweep in place on d.
__global__ void rb_half_sweep(float* d, const float* __restrict__ rhs, int ni,
                              int nj, int parity, float one_minus_omega,
                              float coef, float dx2_inv, float dy2_inv) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (!nsp::rb_updates(i, j, ni, nj, parity)) return;
  const size_t c = static_cast<size_t>(i) * nj + j;
  d[c] = nsp::rb_update(d, rhs[c], c, nj, i, j, ni, nj, one_minus_omega, coef,
                        dx2_inv, dy2_inv);
}

// One half-sweep out of place: every cell of dst, ghost ring included, gets
// src's value, updated where it is an interior cell of colour `parity`
// (kNoColour updates none: a plain copy).
constexpr int kNoColour = 2;

__global__ void rb_half_sweep_from(const float* __restrict__ src,
                                   float* __restrict__ dst,
                                   const float* __restrict__ rhs, int ni,
                                   int nj, int parity, float one_minus_omega,
                                   float coef, float dx2_inv, float dy2_inv) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ni || j >= nj) return;
  const size_t c = static_cast<size_t>(i) * nj + j;
  dst[c] = nsp::rb_updates(i, j, ni, nj, parity)
               ? nsp::rb_update(src, rhs[c], c, nj, i, j, ni, nj,
                                one_minus_omega, coef, dx2_inv, dy2_inv)
               : src[c];
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

// n_sweeps red-black sweeps from p0 into d (both ni x nj, row-major f32,
// distinct buffers); d's ghost ring is p0's.  Returns cudaGetLastError()
// after the launches.
extern "C" int nsp_sor_warm_sweeps(float* d, const float* p0, const float* rhs,
                                   int ni, int nj, int n_sweeps,
                                   float one_minus_omega, float coef,
                                   float dx2_inv, float dy2_inv, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockJ, kBlockI);
  const dim3 grid((nj + kBlockJ - 1) / kBlockJ, (ni + kBlockI - 1) / kBlockI);
  // The first (red) half-sweep reads p0 and fills d.
  rb_half_sweep_from<<<grid, block, 0, s>>>(
      p0, d, rhs, ni, nj, n_sweeps > 0 ? 0 : kNoColour, one_minus_omega, coef,
      dx2_inv, dy2_inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 0; k < n_sweeps; ++k) {
    for (int parity = (k == 0) ? 1 : 0; parity < 2; ++parity) {
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
