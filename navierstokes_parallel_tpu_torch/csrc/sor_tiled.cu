// Red-black SOR sweeps from delta = 0 with temporal blocking in shared
// memory (B4, and B1 with a tile picked from the grid's size).
//
// nsp_sor_tiled_sweeps replaces the Pallas TPU kernel navierstokes_parallel_
// tpu/ops/pallas/sor_kernel.py::_make_tiled_kernel and its double-buffered
// twin _make_tiled_kernel_db (called through _tiled_chunk_call /
// inner_sweeps_tiled): n red-black sweeps on A delta = rhs_neg from
// delta = 0, for the grids beyond the JAX package's whole-grid budget
// (2048^2 and up: configs/4.in).  It computes what nsp_sor_sweeps_simple
// (sor.cu) computes, bit for bit: every written cell goes through
// nsp_sor.cuh's rb_update on the same neighbour values.  The whole-grid
// sweeps of the smaller grids (B1, the TPU kernel _make_kernel through
// _sweeps_call) are this entry point too, with 32 x 32 tiles where 64 x 64
// ones would leave most of the card idle
// (ops/cuda/sor_kernel.py::whole_grid_tile).
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
//     pre-chunk delta (src) and writes the next (dst); the chunks' loop
//     (tile_sweeps_from_zero) swaps the two buffers.  The first chunk reads
//     no delta (it is 0), and every chunk writes every cell of dst, the ghost
//     ring's zeros included (they are never updated), so the caller may
//     pass uninitialised buffers.
//   - One block per tile of TI x TJ interior cells, loaded with an H-deep
//     halo, H = 2K, swept 2 ns times in shared memory and written back:
//     nsp_sor_tile.cuh's tile, shared with the extended-block kernel
//     (sor_ext.cu), which says how it lays the tile out.
//
// What bounds it on an H100: a 64-sweep call at 2050^2 must read rhs and
// write delta once (34 MB, 10 us at 3.35 TB/s) and do 11 f32 operations
// per cell update (2.95 GFLOP, 44 us at 67 TFLOP/s, a rate that counts an
// FMA as two operations; rounding each operation alone, which bit-equality
// with the twins needs, leaves half of it), so operations bound it.
// The first tile took 213 us a chunk: ablations on the card gave
// 38 us to the loads and stores, 80 us to the per-update masks and
// self_coef, ~90 us to the rest of the updates and 4 us to the barriers.
// The current tile keeps the per-chunk invariants of each cell (rhs,
// colour, mask) out of the update, skips the cells that cannot reach the
// centre, and keeps only delta in shared memory: 64 sweeps take ~0.70 ms
// instead of 1.70 ms (PERF.md has the numbers and what did not pay).  TI
// is the CLI's tile-size positional; a tile whose delta exceeds 232,448 B
// of shared memory is refused by the Python wrapper, never clamped.

#include <cuda_runtime.h>

#include "nsp_sor_tile.cuh"

// n_sweeps red-black sweeps from d = 0 in chunks of sweeps_per_chunk, tiles
// of tile_rows x tile_cols cells, on `batch` independent grids (an
// ensemble's members; 1 for one grid) in one launch per chunk: d, scratch
// and rhs (batch x ni x nj, row-major f32; d and scratch's contents
// ignored) take turns as the chunk's output and input, scratch first, so
// the result is in scratch when the number of chunks is odd, else in d;
// n_sweeps = 0 runs one chunk of no sweeps, which writes zeros to scratch.
// Returns cudaGetLastError() after the launches.
extern "C" int nsp_sor_tiled_sweeps(float* d, float* scratch, const float* rhs,
                                    int batch, int ni, int nj, int n_sweeps,
                                    int tile_rows, int tile_cols,
                                    int sweeps_per_chunk,
                                    float one_minus_omega, float coef,
                                    float dx2_inv, float dy2_inv, int device,
                                    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nsp::tile_sweeps_from_zero(
      d, scratch, rhs, batch, ni, nj, n_sweeps, tile_rows, tile_cols,
      sweeps_per_chunk, one_minus_omega, coef, dx2_inv, dy2_inv,
      static_cast<cudaStream_t>(stream)));
}

// The tile's geometry on this card for a tile_rows x tile_cols centre with
// a halo of `halo` cells (out[0..6]: shared rows and columns, rows per
// thread (0: rhs read from device memory), threads per block, shared
// bytes, resident blocks per SM, registers per thread).
extern "C" int nsp_sor_tile_report(int tile_rows, int tile_cols, int halo,
                                   int* out, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nsp::tile_report(tile_rows, tile_cols, halo, out));
}
