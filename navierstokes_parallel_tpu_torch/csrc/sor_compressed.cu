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
// Index algebra (b = i & 1, the row parity; JAX sor_kernel.py:751-757):
//   red[i, k]   = d[i, 2k + b]       black[i, k] = d[i, 2k + 1 - b]
//   red W/E neighbours  = black[i -/+ 1, k]
//   red N = black[i, k + b],   red S = black[i, k + b - 1]
//   black N = red[i, k + 1 - b], black S = red[i, k - b]
//
// What bounds it on an H100: as B1 at 258^2, the operations of 64 sweeps
// (0.7 us at 67 TFLOP/s), far below what a launch costs.  The first version
// (nsp_sor_compressed_sweeps_simple below, kept as the yardstick on no
// path) made one launch per half-sweep, 128 for 64 sweeps, ~0.4-0.6 ms at
// 258^2 against B1's 0.07 ms: halving the threads of a launch does not
// lift the launch rate, which bound it.  The current version runs B1's
// temporal-blocked tile (nsp_sor_tile.cuh), whose shared memory already
// holds delta compacted by colour, over the compacted arrays in device
// memory: one launch per chunk of 8 sweeps, the tile picked by the
// wrapper's whole_grid_tile rule, ping-pong between two pairs of arrays.
// A tile's first column is even, so the pair of cells a thread owns is
// red[a][k] and black[a][k] on every row: the load stage reads one float
// per colour per pair (coalesced 4-byte loads, no colour select) and the
// store stage writes them back the same way.  Everything between is B1's
// tile, so every cell takes nsp_sor.cuh's update on the same neighbour
// values, and the result equals B1 and nsp_sor_sweeps_simple (sor.cu) bit
// for bit.
//
// On an H100 80GB HBM3 at a 700 W power limit (chip_smoke.py), 64 sweeps
// at 258^2: the kernel's 8 launches take 56.5-58.0 us of device time
// against B1's 59.9-61.5 us (the compacted loads need no select), and a
// call with the wrapper's compaction and expansion 0.094-0.102 ms against
// the first version's 0.44-0.48 ms.

#include <cuda_runtime.h>

#include "nsp_round.cuh"
#include "nsp_sor_tile.cuh"

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

// n_sweeps red-black sweeps from delta = 0 on the compacted arrays (each
// ni x nj/2, row-major f32, contents ignored) in chunks of
// sweeps_per_chunk, tiles of tile_rows x tile_cols cells of the full grid:
// (red, black) and (scratch_red, scratch_black) take turns as a chunk's
// output and input, the scratch pair first, so the result is in the scratch
// pair when the number of chunks is odd, else in (red, black); n_sweeps = 0
// runs one chunk of no sweeps, which writes zeros.  Returns
// cudaGetLastError() after the launches.
extern "C" int nsp_sor_compressed_sweeps(
    float* red, float* black, float* scratch_red, float* scratch_black,
    const float* rhs_red, const float* rhs_black, int ni, int nj,
    int n_sweeps, int tile_rows, int tile_cols, int sweeps_per_chunk,
    float one_minus_omega, float coef, float dx2_inv, float dy2_inv,
    int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nsp::TileChunk t{red,       scratch_red, rhs_red,
                   {ni, nj, 0, 0, ni, nj, 0, ni, 0, nj},
                   tile_rows, tile_cols,   0,
                   0,         1,           one_minus_omega,
                   coef,      dx2_inv,     dy2_inv};
  t.src1 = black;
  t.dst1 = scratch_black;
  t.rhs1 = rhs_black;
  return static_cast<int>(nsp::tile_chunks_from_zero<true>(
      t, n_sweeps, sweeps_per_chunk, static_cast<cudaStream_t>(stream)));
}

// nsp_sor_tile_report (sor_tiled.cu) of the compacted layout's kernel.
extern "C" int nsp_sor_compressed_tile_report(int tile_rows, int tile_cols,
                                              int halo, int* out,
                                              int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      nsp::tile_report<true>(tile_rows, tile_cols, halo, out));
}

// The first version, on no path: n_sweeps red-black sweeps, in place on red
// and black (ni x nj/2 each, row-major f32, 0 on entry) with rhs_red /
// rhs_black the compacted rhs, one launch per half-sweep.  The update is
// nsp_sor.cuh's expression with the Pallas kernel's order of the y
// neighbours, (W + E) * dx2_inv + (N + S) * dy2_inv + d * self_coef; IEEE
// addition commutes, so it equals the other sweep kernels bit for bit.
// Returns cudaGetLastError() after the launches.
extern "C" int nsp_sor_compressed_sweeps_simple(
    float* red, float* black, const float* rhs_red, const float* rhs_black,
    int ni, int nj, int n_sweeps, float one_minus_omega, float coef,
    float dx2_inv, float dy2_inv, int device, void* stream) {
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
