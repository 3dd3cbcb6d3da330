// Red-black SOR sweeps with temporal blocking in shared memory (B4).
//
// nsp_sor_tiled_sweeps replaces the Pallas TPU kernel navierstokes_parallel_
// tpu/ops/pallas/sor_kernel.py::_make_tiled_kernel and its double-buffered
// twin _make_tiled_kernel_db (called through _tiled_chunk_call /
// inner_sweeps_tiled): n red-black sweeps on A delta = rhs_neg from
// delta = 0, for the grids beyond the JAX package's whole-grid budget
// (2048^2 and up: configs/4.in).  It computes what nsp_sor_sweeps
// (sor.cu) computes, bit for bit: every written cell goes through
// nsp_sor.cuh's rb_update on the same neighbour values.
//
// The TPU kernel cuts the grid into full-width row strips of B rows plus a
// 2K-deep halo above and below, DMAs each strip into VMEM once per chunk of
// K sweeps, sweeps it K times and writes the B rows back.  Stale values at
// the strip's edge travel one cell per half-sweep, so after 2K half-sweeps
// the B rows are still exact and the strips of a chunk are independent:
// they all read the pre-chunk snapshot.  This kernel keeps that argument and
// changes the cut: a full-width strip of 2050 columns does not fit the
// 227 KB of shared memory one block may use, so it tiles both axes.
//   - One launch per chunk of K sweeps, out of place: it reads the
//     pre-chunk delta (src) and writes the next (dst); the C entry point
//     loops the chunks and swaps the two buffers.  Neither buffer's ghost
//     ring is ever written: both stay 0 (B1's contract).
//   - One block per tile of TI x TJ interior cells.  It loads delta and rhs
//     for (TI + 2H) x (TJ + 2H) cells, H = 2K, into dynamic shared memory
//     (cells outside the padded grid load as 0), runs the chunk's 2 ns
//     half-sweeps there with a __syncthreads() after each, and writes back
//     the interior cells of its TI x TJ centre.  The outermost ring of the
//     shared tile has no neighbours in it and is never updated; its error,
//     like the halo's, stops H cells short of the centre.
//   - Each half-sweep visits only the cells of its colour: thread x takes
//     every second column of a row, starting on the row's first cell of
//     that colour.  Interior masks, parity and self_coef come from each
//     cell's global (i, j).  The tile body is nsp_sor_tile.cuh's
//     sweep_tile, shared with the extended-block kernel (sor_ext.cu).
//
// What bounds it on an H100: not device memory.  A chunk reads
// (TI + 2H)(TJ + 2H) cells of delta and rhs per tile and writes TI * TJ,
// about 3 passes of the grid per K sweeps instead of B1's 2 to 3 passes per
// half-sweep; it pays instead the redundant updates of the halo,
// (TI + 2H)(TJ + 2H) / (TI * TJ) cell-updates per written cell: 2.25 at the
// default TI = TJ = 64 with K = 8 (H = 16), 1.69 at TI = 256.  On an H100
// (700 W) a chunk at 2050^2 takes ~208 us, twice the arithmetic's estimate,
// and 64 sweeps 1.71 ms against B1's 2.15 ms; how the time splits between
// the loads, the __syncthreads() of each half-sweep and the index
// arithmetic is not measured yet.  The default tile takes 73,728 B of
// shared memory (three blocks per SM; 256-row tiles, one per SM, ran
// slower); TI is the CLI's tile-size positional, and a tile beyond
// 232,448 B is refused by the Python wrapper, never clamped.  cp.async /
// TMA loads, register tiling of rhs and tuning of the tile are later work.

#include <cuda_runtime.h>

#include "nsp_sor_tile.cuh"

namespace {

constexpr int kThreadsJ = 16;  // threads along j (each takes every 2nd cell)
constexpr int kThreadsI = 32;  // threads along i

// One chunk of ns <= halo / 2 sweeps over the padded grid: src (pre-chunk)
// -> dst, both ni x nj; only interior cells are written.
__global__ void __launch_bounds__(kThreadsJ * kThreadsI)
    tiled_chunk(const float* __restrict__ src, float* __restrict__ dst,
                const float* __restrict__ rhs, int ni, int nj, int ti, int tj,
                int halo, int ns, float one_minus_omega, float coef,
                float dx2_inv, float dy2_inv) {
  const nsp::TileDomain dom{ni, nj, 0, 0, ni, nj, 1, ni - 1, 1, nj - 1};
  nsp::sweep_tile(src, dst, rhs, dom, ti, tj, halo, ns, one_minus_omega, coef,
                  dx2_inv, dy2_inv);
}

}  // namespace

// n_sweeps red-black sweeps from d = 0 in chunks of sweeps_per_chunk, tiles
// of tile_rows x tile_cols cells: d and scratch (ni x nj, row-major f32, both
// 0 on entry) take turns as the chunk's input and output, so the result is
// in scratch when the number of chunks is odd, else in d.  Returns
// cudaGetLastError() after the launches.
extern "C" int nsp_sor_tiled_sweeps(float* d, float* scratch, const float* rhs,
                                    int ni, int nj, int n_sweeps,
                                    int tile_rows, int tile_cols,
                                    int sweeps_per_chunk,
                                    float one_minus_omega, float coef,
                                    float dx2_inv, float dy2_inv, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile_rows < 1 || tile_cols < 1 || sweeps_per_chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int halo = 2 * sweeps_per_chunk;
  const size_t smem = 2 * sizeof(float) *
                      static_cast<size_t>(tile_rows + 2 * halo) *
                      static_cast<size_t>(tile_cols + 2 * halo);
  err = cudaFuncSetAttribute(tiled_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreadsJ, kThreadsI);
  const dim3 grid((nj + tile_cols - 1) / tile_cols,
                  (ni + tile_rows - 1) / tile_rows);
  float* src = d;
  float* dst = scratch;
  for (int done = 0; done < n_sweeps; done += sweeps_per_chunk) {
    const int ns = n_sweeps - done < sweeps_per_chunk ? n_sweeps - done
                                                      : sweeps_per_chunk;
    tiled_chunk<<<grid, block, smem, s>>>(src, dst, rhs, ni, nj, tile_rows,
                                          tile_cols, halo, ns,
                                          one_minus_omega, coef, dx2_inv,
                                          dy2_inv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float* t = src;
    src = dst;
    dst = t;
  }
  return static_cast<int>(cudaGetLastError());
}
