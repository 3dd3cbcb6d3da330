// Momentum kernels: tentative velocities F, G and the Poisson RHS.
//
// Replaces the Pallas TPU kernel navierstokes_parallel_tpu/ops/pallas/
// momentum_kernel.py::_make_kernel (called through _momentum_call /
// momentum_rhs): donor-cell convection, diffusion and body force on the
// guarded domains of the reference loops (integration.c:73-96), F = u and
// G = v on the walls, 0 elsewhere, and rhs = div(F, G) / dt on the interior
// (main.c:116-120).  dt and gamma come in as a 2-element f32 device array,
// the counterpart of the TPU kernel's SMEM scalars, so a time step needs no
// host round trip for them.
//
// What bounds it on an H100: memory and launches.  It reads u and v (8 B per
// cell) and writes F, G and rhs (12 B per cell) with ~100 flops per cell;
// at the main path's 258 x 258 grid that is ~1.3 MB, well under the time of
// the two launches.  The design is two kernels, one thread per cell:
// fg_kernel computes F and G, rhs_kernel then reads F at i-1 and G at j-1.
// Fusing them into one pass (the TPU kernel's single VMEM pass) is later
// work.
//
// Arithmetic order and constants follow the Pallas kernel: inv_dx, inv_dy,
// inv_re and inv_dx2 = inv_dx * inv_dx, inv_dy2 are rounded to f32 once on
// the host; every operation rounds once (nsp_round.cuh).

#include <cuda_runtime.h>

#include "nsp_round.cuh"

namespace {

constexpr int kBlockJ = 32;
constexpr int kBlockI = 8;

struct Consts {
  int ni, nj, i_max, j_max;
  float inv_dx, inv_dy, inv_re, inv_dx2, inv_dy2, g_x, g_y;
};

__global__ void fg_kernel(const float* __restrict__ scal,
                          const float* __restrict__ u,
                          const float* __restrict__ v, float* __restrict__ F,
                          float* __restrict__ G, Consts k) {
  using namespace nsp;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= k.ni || j >= k.nj) return;
  const int nj = k.nj;
  const size_t c = static_cast<size_t>(i) * nj + j;
  const float dt = scal[0];
  const float gamma = scal[1];
  const float g_dx = mul(gamma, k.inv_dx);
  const float g_dy = mul(gamma, k.inv_dy);
  const bool i_int = i >= 1 && i <= k.i_max;
  const bool j_int = j >= 1 && j <= k.j_max;

  // --- F (u-momentum), integration.c:73-83 --------------------------------
  float f = 0.0f;
  if (i >= 1 && i <= k.i_max - 1 && j_int) {
    const float uc = u[c], ue = u[c + nj], uw = u[c - nj];
    const float un = u[c + 1], us = u[c - 1];
    const float vc = v[c], ve = v[c + nj], vs = v[c - 1], vse = v[c + nj - 1];
    const float ae = mul(0.5f, add(uc, ue));
    const float aw = mul(0.5f, add(uw, uc));
    const float du2dx =
        add(mul(sub(mul(ae, ae), mul(aw, aw)), k.inv_dx),
            mul(g_dx, sub(mul(mul(fabsf(ae), 0.5f), sub(uc, ue)),
                          mul(mul(fabsf(aw), 0.5f), sub(uw, uc)))));
    const float vn_ = mul(0.5f, add(vc, ve));
    const float vs_ = mul(0.5f, add(vs, vse));
    const float duvdy =
        add(mul(sub(mul(mul(vn_, 0.5f), add(uc, un)),
                    mul(mul(vs_, 0.5f), add(us, uc))),
                k.inv_dy),
            mul(g_dy, sub(mul(mul(fabsf(vn_), 0.5f), sub(uc, un)),
                          mul(mul(fabsf(vs_), 0.5f), sub(us, uc)))));
    const float lap = add(mul(add(sub(ue, mul(2.0f, uc)), uw), k.inv_dx2),
                          mul(add(sub(un, mul(2.0f, uc)), us), k.inv_dy2));
    f = add(uc, mul(dt, add(sub(sub(mul(k.inv_re, lap), du2dx), duvdy),
                            k.g_x)));
  } else if ((i == 0 || i == k.i_max) && j_int) {
    f = u[c];
  }

  // --- G (v-momentum), integration.c:85-91 --------------------------------
  float g = 0.0f;
  if (j >= 1 && j <= k.j_max - 1 && i_int) {
    const float vc = v[c], ve = v[c + nj], vw = v[c - nj];
    const float vn = v[c + 1], vs = v[c - 1];
    const float uc = u[c], un = u[c + 1], uw = u[c - nj], unw = u[c - nj + 1];
    const float an = mul(0.5f, add(vc, vn));
    const float as = mul(0.5f, add(vs, vc));
    const float dv2dy =
        add(mul(sub(mul(an, an), mul(as, as)), k.inv_dy),
            mul(g_dy, sub(mul(mul(fabsf(an), 0.5f), sub(vc, vn)),
                          mul(mul(fabsf(as), 0.5f), sub(vs, vc)))));
    const float ue_ = mul(0.5f, add(uc, un));
    const float uw_ = mul(0.5f, add(uw, unw));
    const float duvdx =
        add(mul(sub(mul(mul(ue_, 0.5f), add(vc, ve)),
                    mul(mul(uw_, 0.5f), add(vw, vc))),
                k.inv_dx),
            mul(g_dx, sub(mul(mul(fabsf(ue_), 0.5f), sub(vc, ve)),
                          mul(mul(fabsf(uw_), 0.5f), sub(vw, vc)))));
    const float lap = add(mul(add(sub(ve, mul(2.0f, vc)), vw), k.inv_dx2),
                          mul(add(sub(vn, mul(2.0f, vc)), vs), k.inv_dy2));
    g = add(vc, mul(dt, add(sub(sub(mul(k.inv_re, lap), duvdx), dv2dy),
                            k.g_y)));
  } else if ((j == 0 || j == k.j_max) && i_int) {
    g = v[c];
  }

  F[c] = f;
  G[c] = g;
}

// rhs = ((F - F_w) * inv_dx + (G - G_s) * inv_dy) / dt on the interior.
__global__ void rhs_kernel(const float* __restrict__ scal,
                           const float* __restrict__ F,
                           const float* __restrict__ G,
                           float* __restrict__ rhs, Consts k) {
  using namespace nsp;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= k.ni || j >= k.nj) return;
  const size_t c = static_cast<size_t>(i) * k.nj + j;
  float r = 0.0f;
  if (i >= 1 && i <= k.i_max && j >= 1 && j <= k.j_max) {
    r = ratio(add(mul(sub(F[c], F[c - k.nj]), k.inv_dx),
                  mul(sub(G[c], G[c - 1]), k.inv_dy)),
              scal[0]);
  }
  rhs[c] = r;
}

}  // namespace

// F, G, rhs (each ni x nj, row-major f32) from u, v; scal = {dt, gamma} on
// the device.  Returns cudaGetLastError() after the launches.
extern "C" int nsp_momentum_rhs(const float* scal, const float* u,
                                const float* v, float* F, float* G, float* rhs,
                                int ni, int nj, int i_max, int j_max,
                                float inv_dx, float inv_dy, float inv_re,
                                float inv_dx2, float inv_dy2, float g_x,
                                float g_y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts k{ni, nj, i_max, j_max, inv_dx, inv_dy, inv_re,
                 inv_dx2, inv_dy2, g_x, g_y};
  const dim3 block(kBlockJ, kBlockI);
  const dim3 grid((nj + kBlockJ - 1) / kBlockJ, (ni + kBlockI - 1) / kBlockI);
  fg_kernel<<<grid, block, 0, s>>>(scal, u, v, F, G, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rhs_kernel<<<grid, block, 0, s>>>(scal, F, G, rhs, k);
  return static_cast<int>(cudaGetLastError());
}
