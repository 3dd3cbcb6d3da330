// Red-black SOR sweeps on one shard's extended block (B6).
//
// nsp_sor_ext_sweeps replaces the Pallas TPU kernel navierstokes_parallel_
// tpu/parallel/deep_halo.py::_make_ext_kernel (called through
// _ext_sweeps_call by make_deep_inner): the communication-avoiding sharded
// SOR inner.  Each shard holds an li x lj block of the interior; one deep
// exchange builds its extended (li + 2H) x (lj + 2H) block, whose H-deep
// ring holds the neighbours' edge strips, and ns <= H / 2 red-black sweeps
// on it then leave the central li x lj core exactly as a sweep of the whole
// grid would, with no communication in between.  Extended cell (a, b) is
// global padded cell (ox - H + 1 + a, oy - H + 1 + b), (ox, oy) the shard's
// global interior origin; interior mask, parity and self_coef come from that
// index (nsp_sor.cuh), so the core equals B1 / B4 on the whole grid bit for
// bit.
//
// The TPU kernel holds the whole block in VMEM and rebuilds its masks from
// (ox, oy) in SMEM scalars.  A 2080^2 block (configs/4.in on one card) does
// not fit one block's 227 KB of shared memory, so this kernel runs B4's
// temporal-blocked tile (nsp_sor_tile.cuh) over the extended block as its
// whole domain: one launch per call, out of place, tiles of TI x TJ cells
// with a halo of 2 ns cells, cells outside the extended block loaded as 0.
// Every cell of the block is written: cells outside the global interior
// keep their input value, as the Pallas kernel's where() keeps them.  The
// TPU kernel's rolls wrap around at the block's edge and this kernel reads
// zeros there; either pollutes only cells within 2 ns of the edge, which
// never reach the core because H >= 2 ns.
//
// What bounds it on an H100: the least time for one call of 8 sweeps at
// 2080^2 is set by device memory, delta and rhs read once and delta written
// once (3 x 17.3 MB, ~15.5 us at 3.35 TB/s), against 11 flops per cell
// update (0.38 GFLOP, ~5.7 us at 67 TFLOP/s f32, half of that rate without
// FMA).  The first tile took 200 us a call, most of it in issuing the
// per-update index and mask arithmetic; the current one (~89 us) is
// described in nsp_sor_tile.cuh and measured in PERF.md.

#include <cuda_runtime.h>

#include "nsp_sor_tile.cuh"

// n_sweeps red-black sweeps on the rows x cols extended block d0 (row-major
// f32) with right-hand side rhs, into out (same shape; every cell written).
// The block's cell (0, 0) is global padded cell (ox - H + 1, oy - H + 1) of
// the (i_max + 2) x (j_max + 2) grid.  One launch; tiles of tile_rows x
// tile_cols cells with a 2 n_sweeps halo.  Returns cudaGetLastError() after
// the launch.
extern "C" int nsp_sor_ext_sweeps(float* out, const float* d0,
                                  const float* rhs, int rows, int cols,
                                  int n_sweeps, int ox, int oy, int H,
                                  int i_max, int j_max, int tile_rows,
                                  int tile_cols, float one_minus_omega,
                                  float coef, float dx2_inv, float dy2_inv,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || cols < 1 || n_sweeps < 0 || 2 * n_sweeps > H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const nsp::TileChunk t{d0,
                         out,
                         rhs,
                         {rows, cols, ox - H + 1, oy - H + 1, i_max + 2,
                          j_max + 2, 0, rows, 0, cols},
                         tile_rows,
                         tile_cols,
                         2 * n_sweeps,
                         n_sweeps,
                         0,
                         one_minus_omega,
                         coef,
                         dx2_inv,
                         dy2_inv};
  return static_cast<int>(
      nsp::launch_tile_chunk(t, static_cast<cudaStream_t>(stream)));
}
