// The red-black SOR cell update shared by the sweep kernels (sor.cu,
// sor_tiled.cu, sor_ext.cu), so that every kernel computes each cell with
// the same expression and they agree bit for bit.
//
// Arithmetic order and constants follow the Pallas kernel
// (navierstokes_parallel_tpu/ops/pallas/sor_kernel.py::_make_kernel):
//   nb    = (d_W + d_E) * dx2_inv + (d_S + d_N) * dy2_inv + d * self_coef
//   d_new = (1 - omega) * d + coef * (nb - rhs)
// with every constant rounded to f32 once on the host.  With omega = 1 the
// first term is still computed, as 0 * d, as the Pallas body does.  The
// Neumann boundary is folded into self_coef: the ghost neighbour is read as
// given (0) and self_coef * d adds the mirrored one.
#pragma once

#include <cstddef>

#include "nsp_round.cuh"

namespace nsp {

// Interior cell (i, j) of the padded ni x nj grid, of colour `parity`:
// (i + j) & 1 on the padded (= 1-based interior) indices, red = 0 first.
__device__ __forceinline__ bool rb_updates(int i, int j, int ni, int nj,
                                           int parity) {
  return i >= 1 && i <= ni - 2 && j >= 1 && j <= nj - 2 &&
         ((i + j) & 1) == parity;
}

// The new value of interior cell (i, j) of the padded ni x nj grid: d[c] is
// the cell, d[c -/+ row] its neighbours along i (x), d[c -/+ 1] along j (y).
__device__ __forceinline__ float rb_update(const float* d, float rhs, size_t c,
                                           size_t row, int i, int j, int ni,
                                           int nj, float one_minus_omega,
                                           float coef, float dx2_inv,
                                           float dy2_inv) {
  const float self_coef =
      add(mul(static_cast<float>((i == 1) + (i == ni - 2)), dx2_inv),
          mul(static_cast<float>((j == 1) + (j == nj - 2)), dy2_inv));
  const float dc = d[c];
  const float nb = add(add(mul(add(d[c - row], d[c + row]), dx2_inv),
                           mul(add(d[c - 1], d[c + 1]), dy2_inv)),
                       mul(dc, self_coef));
  return add(mul(one_minus_omega, dc), mul(coef, sub(nb, rhs)));
}

}  // namespace nsp
