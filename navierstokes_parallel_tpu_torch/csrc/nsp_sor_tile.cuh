// The temporal-blocked tile body shared by the tiled sweep kernel (B4,
// sor_tiled.cu) and the extended-block sweep kernel (B6, sor_ext.cu).
//
// A block sweeps one tile of the array it is given: it loads delta and rhs
// for its TI x TJ centre and a halo of `halo` cells on each side into
// dynamic shared memory (cells outside the array load as 0), runs 2 ns
// half-sweeps there with a __syncthreads() after each, and writes back the
// cells of its centre that lie in the write window.  Stale values at the
// tile's edge travel one cell per half-sweep, so with halo >= 2 ns the
// centre equals the same sweeps over the whole array, and the tiles of one
// launch are independent.  The outermost ring of the shared tile has no
// neighbours in it and is never updated.
//
// Array cell (a, b) is global padded cell (off_i + a, off_j + b) of an
// ni x nj padded grid: interior mask, parity and self_coef come from the
// global index (nsp_sor.cuh), so an array cut out of a larger grid (B6's
// extended block of one shard) sweeps exactly as the grid would.  B4 passes
// the grid itself (offset 0).
#pragma once

#include "nsp_sor.cuh"

namespace nsp {

struct TileDomain {
  int rows, cols;      // the array swept, row-major
  int off_i, off_j;    // global padded index of its cell (0, 0)
  int ni, nj;          // the padded global grid
  int w_lo_i, w_hi_i;  // rows [w_lo_i, w_hi_i) of the array are written
  int w_lo_j, w_hi_j;  // columns [w_lo_j, w_hi_j)
};

// One chunk of ns <= halo / 2 sweeps of one tile: src -> dst (both of the
// domain's shape).  Block (blockIdx.x, blockIdx.y) takes the tile of
// columns blockIdx.x * tj and rows blockIdx.y * ti.
__device__ __forceinline__ void sweep_tile(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ rhs, const TileDomain& dom, int ti, int tj,
    int halo, int ns, float one_minus_omega, float coef, float dx2_inv,
    float dy2_inv) {
  extern __shared__ float smem[];
  const int ei = ti + 2 * halo;  // rows of the shared tile
  const int ej = tj + 2 * halo;  // its columns
  float* sd = smem;
  float* sr = smem + static_cast<size_t>(ei) * ej;
  const int a0 = static_cast<int>(blockIdx.y) * ti - halo;  // row of sd row 0
  const int b0 = static_cast<int>(blockIdx.x) * tj - halo;  // column of col 0

  for (int r = threadIdx.y; r < ei; r += blockDim.y) {
    const int a = a0 + r;
    for (int c = threadIdx.x; c < ej; c += blockDim.x) {
      const int b = b0 + c;
      const bool in = a >= 0 && a < dom.rows && b >= 0 && b < dom.cols;
      const size_t g = in ? static_cast<size_t>(a) * dom.cols + b : 0;
      sd[r * ej + c] = in ? src[g] : 0.0f;
      sr[r * ej + c] = in ? rhs[g] : 0.0f;
    }
  }
  __syncthreads();

  const int i0 = a0 + dom.off_i;  // global row of sd row 0
  const int j0 = b0 + dom.off_j;  // global column of sd column 0
  for (int h = 0; h < 2 * ns; ++h) {
    const int parity = h & 1;
    for (int r = 1 + threadIdx.y; r < ei - 1; r += blockDim.y) {
      const int i = i0 + r;
      // (i + j0 + c) & 1 == parity on the columns c this row updates.
      const int first = (parity - i - j0) & 1;
      for (int c = first + 2 * threadIdx.x; c < ej - 1; c += 2 * blockDim.x) {
        const int j = j0 + c;
        if (c == 0 || !rb_updates(i, j, dom.ni, dom.nj, parity)) continue;
        const int e = r * ej + c;
        sd[e] = rb_update(sd, sr[e], e, ej, i, j, dom.ni, dom.nj,
                          one_minus_omega, coef, dx2_inv, dy2_inv);
      }
    }
    __syncthreads();
  }

  for (int r = halo + threadIdx.y; r < halo + ti; r += blockDim.y) {
    const int a = a0 + r;
    if (a < dom.w_lo_i || a >= dom.w_hi_i) continue;
    for (int c = halo + threadIdx.x; c < halo + tj; c += blockDim.x) {
      const int b = b0 + c;
      if (b >= dom.w_lo_j && b < dom.w_hi_j) {
        dst[static_cast<size_t>(a) * dom.cols + b] = sd[r * ej + c];
      }
    }
  }
}

}  // namespace nsp
