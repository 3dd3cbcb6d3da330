// Red-black SOR sweeps over a whole padded grid from a given p0, the
// multigrid smoother (B3), and the first, launch-per-half-sweep kernels of
// the whole-grid sweeps (B1) and of the smoother, kept as independent
// yardsticks.
//
// The Pallas TPU kernel navierstokes_parallel_tpu/ops/pallas/sor_kernel.py::
// _make_kernel does n red-black sweeps on one grid held in VMEM.  Called
// through _sweeps_call / inner_sweeps (B1) it solves the correction equation
// A delta = rhs_neg from delta = 0, the inner stage of the mixed-precision
// refinement solver (ops/sor.py); built with warm_start=True and called
// through _warm_sweeps_call / warm_sweeps (B3) it sweeps from a given p0,
// with omega and the level's dx^2 / dy^2 passed per call, the smoother of
// the multigrid V-cycle (ops/mg.py).
//
// What bounds them on an H100: launches and instruction issue, not bytes.
// delta + rhs at the SOR main path's 258 x 258 padded grid (0.53 MB) exceed
// the 227 KB of shared memory one block may use, so the grid is cut into
// tiles (nsp_sor_tile.cuh): a block loads its tile with a halo of 2 ns
// cells, sweeps it ns times in shared memory and writes its centre back, so
// one launch does ns sweeps and delta and rhs cross L2 once per ns sweeps
// instead of once per half-sweep.
//   - B1 is sor_tiled.cu's nsp_sor_tiled_sweeps with a tile and K picked
//     from the grid's size (ops/cuda/sor_kernel.py::whole_grid_tile): a
//     258^2 grid in 64 x 64 tiles is 25 blocks for 132 SMs, so small grids
//     take 32 x 32 tiles.
//   - nsp_sor_warm_sweeps (B3) runs its n sweeps in launches of at most
//     sweeps_per_launch, each with a halo of twice its sweeps: the two
//     sweeps of a multigrid level are one launch of 32 x 64 tiles with a
//     4-deep halo (1.15 cell updates per written cell).  Cells outside the
//     interior keep their input, so the output's ghost ring is p0's.  The
//     V-cycle calls it on the levels above its coarse tail, which
//     mg_cycle.cu runs in one launch.
// Every cell goes through nsp_sor.cuh's rb_update on the same neighbour
// values in the same order, so all of them give the same bits.
//
// The first design of both, kept under nsp_sor_sweeps_simple and
// nsp_sor_warm_sweeps_simple, leaves the data in device memory (L2) and
// launches one kernel per half-sweep, one thread per cell: 2 n launches per
// call, bound by the launch rate (PERF.md).  No path calls them; the smoke
// test and the GPU tests hold every other sweep kernel against them, so that
// the tile is never only compared with itself.
// The Neumann boundary is folded into a per-cell self coefficient as in the
// Pallas kernel, so the ghost ring is read as given and never updated.

#include <cuda_runtime.h>

#include "nsp_sor.cuh"
#include "nsp_sor_tile.cuh"

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

// n_sweeps red-black sweeps from p0 into out (ni x nj, row-major f32) in
// launches of at most sweeps_per_launch sweeps, tiles of tile_rows x
// tile_cols cells with a halo of twice the launch's sweeps; out's ghost
// ring is p0's.  With more than one launch, out and scratch (same shape,
// contents ignored; unused otherwise) take turns so that the last writes
// out.  n_sweeps = 0 is one launch that copies.  Returns cudaGetLastError()
// after the launches.
extern "C" int nsp_sor_warm_sweeps(float* out, float* scratch, const float* p0,
                                   const float* rhs, int ni, int nj,
                                   int n_sweeps, int tile_rows, int tile_cols,
                                   int sweeps_per_launch,
                                   float one_minus_omega, float coef,
                                   float dx2_inv, float dy2_inv, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sweeps_per_launch < 1 || n_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int launches =
      n_sweeps > 0 ? (n_sweeps + sweeps_per_launch - 1) / sweeps_per_launch : 1;
  nsp::TileChunk t{p0,        (launches & 1) ? out : scratch,
                   rhs,       {ni, nj, 0, 0, ni, nj, 0, ni, 0, nj},
                   tile_rows, tile_cols,
                   0,         0,
                   0,         one_minus_omega,
                   coef,      dx2_inv,
                   dy2_inv};
  int done = 0;
  for (int l = 0; l < launches; ++l) {
    t.ns = n_sweeps - done < sweeps_per_launch ? n_sweeps - done
                                               : sweeps_per_launch;
    t.halo = 2 * t.ns;
    err = nsp::launch_tile_chunk(t, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    done += t.ns;
    t.src = t.dst;
    t.dst = t.dst == out ? scratch : out;
  }
  return static_cast<int>(cudaGetLastError());
}

// The first design of the sweeps from delta = 0 (B1; now
// nsp_sor_tiled_sweeps): n_sweeps red-black sweeps, in place on
// d (ni x nj, row-major f32; zero on entry, its ghost ring stays 0), one
// launch per half-sweep.  Returns cudaGetLastError() after the launches.
extern "C" int nsp_sor_sweeps_simple(float* d, const float* rhs, int ni,
                                     int nj, int n_sweeps,
                                     float one_minus_omega, float coef,
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

// The first design of nsp_sor_warm_sweeps: n_sweeps red-black sweeps from p0
// into d (both ni x nj, row-major f32, distinct buffers), one launch per
// half-sweep; d's ghost ring is p0's.  Returns cudaGetLastError() after the
// launches.
extern "C" int nsp_sor_warm_sweeps_simple(float* d, const float* p0,
                                          const float* rhs, int ni, int nj,
                                          int n_sweeps, float one_minus_omega,
                                          float coef, float dx2_inv,
                                          float dy2_inv, int device,
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
