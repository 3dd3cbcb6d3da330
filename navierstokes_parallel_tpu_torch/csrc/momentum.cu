// Momentum kernel: tentative velocities F, G and the Poisson RHS (B2).
//
// nsp_momentum_rhs replaces the Pallas TPU kernel navierstokes_parallel_tpu/
// ops/pallas/momentum_kernel.py::_make_kernel (called through _momentum_call
// / momentum_rhs): donor-cell convection, diffusion and body force on the
// guarded domains of the reference loops (integration.c:73-96), F = u and
// G = v on the walls, 0 elsewhere, and rhs = div(F, G) / dt on the interior
// (main.c:116-120).  dt and gamma come in as device pointers (the 0-d
// tensors the time step computes, the counterpart of the TPU kernel's SMEM
// scalars: no host round trip) or, where the caller has Python floats, by
// value.
//
// What bounds it on an H100: device memory.  It must read u and v (8 B per
// cell) and write F, G and rhs (12 B per cell) against ~122 f32 operations
// per cell: 84 MB and 25 us at 2050^2 (the mg path's grid), 1.3 MB and
// 0.4 us at 258^2 (configs/1.in), where the call is set by the host's
// launch, not the card.  The first version (nsp_momentum_rhs_simple below,
// kept as the yardstick on no path) ran two kernels, one thread per cell:
// fg_kernel wrote F and G to device memory and rhs_kernel read them back,
// 28 B per cell instead of 20, and every neighbour load went through L1.
//
// The fused kernel makes one launch per call.  A block owns kTileI x kTileJ
// output cells.  It stages u and v of the tile plus a halo, two cells on
// the low side of each axis and one on the high side, in shared memory
// (cells outside the grid as 0, read by no formula); computes F over rows
// i0 - 1 .. i0 + kTileI - 1 and G over columns j0 - 1 .. j0 + kTileJ - 1
// into shared memory, so that rhs finds F(i - 1, j) and G(i, j - 1) there;
// and writes F, G and rhs once each, two adjacent cells per thread with
// 8-byte stores where the rows are 8-byte aligned.  The recomputed row of F
// and column of G cost 1/kTileI and 1/kTileJ of the flops.
//
// On an H100 80GB HBM3 at a 700 W power limit (chip_smoke.py, device time
// of calls in a CUDA graph): 46.3-46.4 us per call at 2050^2, 54 % of the
// bound, against the first version's 58.8-58.9 us; 3.6-3.7 us at 258^2
// against 5.1 us, where a call costs 0.035-0.043 ms on the host's clock.
//
// Arithmetic order and constants follow the Pallas kernel, through the
// functions below, which both versions call: inv_dx, inv_dy, inv_re and
// inv_dx2 = inv_dx * inv_dx, inv_dy2 are rounded to f32 once on the host;
// every operation rounds once (nsp_round.cuh).  So the two versions and the
// plain PyTorch twin give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "nsp_round.cuh"

namespace {

struct Consts {
  int ni, nj, i_max, j_max;
  float inv_dx, inv_dy, inv_re, inv_dx2, inv_dy2, g_x, g_y;
};

// F at an interior cell (integration.c:73-83) from u at the cell (c) and
// its four neighbours (e = i + 1, w = i - 1, n = j + 1, s = j - 1) and v at
// the cell, at i + 1, at j - 1 and at (i + 1, j - 1).
__device__ __forceinline__ float f_interior(float uc, float ue, float uw,
                                            float un, float us, float vc,
                                            float ve, float vs, float vse,
                                            float dt, float g_dx, float g_dy,
                                            const Consts& k) {
  using namespace nsp;
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
  return add(uc, mul(dt, add(sub(sub(mul(k.inv_re, lap), du2dx), duvdy),
                             k.g_x)));
}

// G at an interior cell (integration.c:85-91) from v at the cell and its
// four neighbours and u at the cell, at j + 1, at i - 1 and at
// (i - 1, j + 1).
__device__ __forceinline__ float g_interior(float vc, float ve, float vw,
                                            float vn, float vs, float uc,
                                            float un, float uw, float unw,
                                            float dt, float g_dx, float g_dy,
                                            const Consts& k) {
  using namespace nsp;
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
  return add(vc, mul(dt, add(sub(sub(mul(k.inv_re, lap), duvdx), dv2dy),
                             k.g_y)));
}

// rhs = ((F - F_w) * inv_dx + (G - G_s) * inv_dy) / dt on the interior.
__device__ __forceinline__ float rhs_value(int i, int j, float f, float f_w,
                                           float g, float g_s, float dt,
                                           const Consts& k) {
  using namespace nsp;
  if (i < 1 || i > k.i_max || j < 1 || j > k.j_max) return 0.0f;
  return ratio(add(mul(sub(f, f_w), k.inv_dx), mul(sub(g, g_s), k.inv_dy)),
               dt);
}

// --- the fused kernel ------------------------------------------------------

constexpr int kTileI = 16;     // output rows (i, x) of a block
constexpr int kTileJ = 64;     // output columns (j, y, contiguous)
constexpr int kThreadsJ = 32;  // blockDim.x
constexpr int kThreadsI = 8;   // blockDim.y
constexpr int kThreads = kThreadsJ * kThreadsI;
static_assert(kTileI % kThreadsI == 0 && kTileJ == 2 * kThreadsJ,
              "each thread computes and stores 2 columns of whole rows");
static_assert(kTileJ + kTileI <= kThreads, "one thread per edge cell");
// Shared u and v: rows i0 - 2 .. i0 + kTileI, columns j0 - 2 .. j0 + kTileJ.
constexpr int kSI = kTileI + 3;
constexpr int kSJ = kTileJ + 3;

// 8-byte aligned: the stores read F and G of two cells as one float2.
struct alignas(8) Tile {
  float u[kSI][kSJ], v[kSI][kSJ];
  float f[kTileI + 1][kTileJ];  // F(i0 - 1 + fr, j0 + c) at [fr][c]
  float g[kTileI][kTileJ + 2];  // G(i0 + r, j0 + c) at [r][c + 2]: even
                                // c starts an 8-byte pair
};

// F of cell (i0 - 1 + fr, j0 + c) into the tile: u and v at (fr + 1, c + 2).
__device__ __forceinline__ void tile_f(Tile& t, int i0, int j0, int fr,
                                       int c, float dt, float g_dx,
                                       float g_dy, const Consts& k) {
  const int i = i0 - 1 + fr, j = j0 + c, r = fr + 1, s = c + 2;
  float f = 0.0f;
  if (j >= 1 && j <= k.j_max) {
    if (i >= 1 && i <= k.i_max - 1) {
      f = f_interior(t.u[r][s], t.u[r + 1][s], t.u[r - 1][s], t.u[r][s + 1],
                     t.u[r][s - 1], t.v[r][s], t.v[r + 1][s], t.v[r][s - 1],
                     t.v[r + 1][s - 1], dt, g_dx, g_dy, k);
    } else if (i == 0 || i == k.i_max) {
      f = t.u[r][s];
    }
  }
  t.f[fr][c] = f;
}

// G of cell (i0 + gr, j0 - 1 + gc) into the tile: u and v at (gr + 2,
// gc + 1).
__device__ __forceinline__ void tile_g(Tile& t, int i0, int j0, int gr,
                                       int gc, float dt, float g_dx,
                                       float g_dy, const Consts& k) {
  const int i = i0 + gr, j = j0 - 1 + gc, r = gr + 2, s = gc + 1;
  float g = 0.0f;
  if (i >= 1 && i <= k.i_max) {
    if (j >= 1 && j <= k.j_max - 1) {
      g = g_interior(t.v[r][s], t.v[r + 1][s], t.v[r - 1][s], t.v[r][s + 1],
                     t.v[r][s - 1], t.u[r][s], t.u[r][s + 1], t.u[r - 1][s],
                     t.u[r - 1][s + 1], dt, g_dx, g_dy, k);
    } else if (j == 0 || j == k.j_max) {
      g = t.v[r][s];
    }
  }
  t.g[gr][gc + 1] = g;
}

// Block (blockIdx.x, blockIdx.y) writes the cells of rows blockIdx.y *
// kTileI and columns blockIdx.x * kTileJ of member blockIdx.z, whose fields
// start blockIdx.z ni nj floats in and whose dt and gamma are dt_p[z] and
// gamma_p[z] (a batch of independent grids: an ensemble's members; one grid
// is member 0); blockDim = (kThreadsJ, kThreadsI).
__global__ void __launch_bounds__(kThreads)
    momentum_fused(const float* __restrict__ dt_p,
                   const float* __restrict__ gamma_p, float dt_v,
                   float gamma_v, const float* __restrict__ u,
                   const float* __restrict__ v, float* __restrict__ F,
                   float* __restrict__ G, float* __restrict__ rhs, Consts k) {
  using namespace nsp;
  __shared__ Tile t;
  const int z = static_cast<int>(blockIdx.z);
  const size_t member = static_cast<size_t>(z) * k.ni * k.nj;
  u += member;
  v += member;
  F += member;
  G += member;
  rhs += member;
  const int tx = static_cast<int>(threadIdx.x);
  const int ty = static_cast<int>(threadIdx.y);
  const int tid = ty * kThreadsJ + tx;
  const int i0 = static_cast<int>(blockIdx.y) * kTileI;
  const int j0 = static_cast<int>(blockIdx.x) * kTileJ;

  for (int idx = tid; idx < kSI * kSJ; idx += kThreads) {
    const int r = idx / kSJ, c = idx - r * kSJ;
    const int i = i0 - 2 + r, j = j0 - 2 + c;
    float a = 0.0f, b = 0.0f;
    if (i >= 0 && i < k.ni && j >= 0 && j < k.nj) {
      const size_t o = static_cast<size_t>(i) * k.nj + j;
      a = u[o];
      b = v[o];
    }
    t.u[r][c] = a;
    t.v[r][c] = b;
  }
  const float dt = dt_p ? dt_p[z] : dt_v;
  const float gamma = gamma_p ? gamma_p[z] : gamma_v;
  const float g_dx = mul(gamma, k.inv_dx);
  const float g_dy = mul(gamma, k.inv_dy);
  __syncthreads();

  // F and G of the block's own cells, consecutive columns across a warp
  // (no bank conflicts); then the row of F above the tile and the column
  // of G left of it, one cell per thread.
#pragma unroll
  for (int m = 0; m < kTileI / kThreadsI; ++m) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int r = ty + m * kThreadsI, c = tx + n * kThreadsJ;
      tile_f(t, i0, j0, r + 1, c, dt, g_dx, g_dy, k);
      tile_g(t, i0, j0, r, c + 1, dt, g_dx, g_dy, k);
    }
  }
  if (tid < kTileJ) {
    tile_f(t, i0, j0, 0, tid, dt, g_dx, g_dy, k);
  } else if (tid < kTileJ + kTileI) {
    tile_g(t, i0, j0, tid - kTileJ, 0, dt, g_dx, g_dy, k);
  }
  __syncthreads();

  // rhs and the stores: cells (i0 + r, j0 + c) and (.., j0 + c + 1), c even.
  const int c = 2 * tx;
  const int j = j0 + c;
  if (j >= k.nj) return;
  const bool pair = j + 1 < k.nj;
  const bool vec = pair && (k.nj & 1) == 0 &&
                   ((reinterpret_cast<uintptr_t>(F) |
                     reinterpret_cast<uintptr_t>(G) |
                     reinterpret_cast<uintptr_t>(rhs)) &
                    7) == 0;
#pragma unroll
  for (int m = 0; m < kTileI / kThreadsI; ++m) {
    const int r = ty + m * kThreadsI, i = i0 + r;
    if (i >= k.ni) break;
    const float2 f = *reinterpret_cast<const float2*>(&t.f[r + 1][c]);
    const float2 f_w = *reinterpret_cast<const float2*>(&t.f[r][c]);
    const float2 g = *reinterpret_cast<const float2*>(&t.g[r][c + 2]);
    const float g_s = t.g[r][c + 1];
    const float r0 = rhs_value(i, j, f.x, f_w.x, g.x, g_s, dt, k);
    const float r1 = rhs_value(i, j + 1, f.y, f_w.y, g.y, g.x, dt, k);
    const size_t o = static_cast<size_t>(i) * k.nj + j;
    if (vec) {
      *reinterpret_cast<float2*>(F + o) = f;
      *reinterpret_cast<float2*>(G + o) = g;
      *reinterpret_cast<float2*>(rhs + o) = make_float2(r0, r1);
    } else {
      F[o] = f.x;
      G[o] = g.x;
      rhs[o] = r0;
      if (pair) {
        F[o + 1] = f.y;
        G[o + 1] = g.y;
        rhs[o + 1] = r1;
      }
    }
  }
}

// --- the first version: two kernels, one thread per cell -----------------

constexpr int kBlockJ = 32;
constexpr int kBlockI = 8;

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

  float f = 0.0f;
  if (i >= 1 && i <= k.i_max - 1 && j_int) {
    f = f_interior(u[c], u[c + nj], u[c - nj], u[c + 1], u[c - 1], v[c],
                   v[c + nj], v[c - 1], v[c + nj - 1], dt, g_dx, g_dy, k);
  } else if ((i == 0 || i == k.i_max) && j_int) {
    f = u[c];
  }
  float g = 0.0f;
  if (j >= 1 && j <= k.j_max - 1 && i_int) {
    g = g_interior(v[c], v[c + nj], v[c - nj], v[c + 1], v[c - 1], u[c],
                   u[c + 1], u[c - nj], u[c - nj + 1], dt, g_dx, g_dy, k);
  } else if ((j == 0 || j == k.j_max) && i_int) {
    g = v[c];
  }
  F[c] = f;
  G[c] = g;
}

__global__ void rhs_kernel(const float* __restrict__ scal,
                           const float* __restrict__ F,
                           const float* __restrict__ G,
                           float* __restrict__ rhs, Consts k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= k.ni || j >= k.nj) return;
  const size_t c = static_cast<size_t>(i) * k.nj + j;
  const bool inner = i >= 1 && j >= 1;  // F[c - nj], G[c - 1] exist
  rhs[c] = inner ? rhs_value(i, j, F[c], F[c - k.nj], G[c], G[c - 1], scal[0],
                             k)
                 : 0.0f;
}

}  // namespace

// F, G, rhs (each batch x ni x nj, row-major f32) from u, v in one launch;
// dt and gamma from dt_p / gamma_p on the device (batch floats each), or
// dt_v / gamma_v where the pointer is null.  Returns cudaGetLastError()
// after the launch.
extern "C" int nsp_momentum_rhs(const float* dt_p, const float* gamma_p,
                                float dt_v, float gamma_v, const float* u,
                                const float* v, float* F, float* G, float* rhs,
                                int batch, int ni, int nj, int i_max, int j_max,
                                float inv_dx, float inv_dy, float inv_re,
                                float inv_dx2, float inv_dy2, float g_x,
                                float g_y, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Consts k{ni, nj, i_max, j_max, inv_dx, inv_dy, inv_re,
                 inv_dx2, inv_dy2, g_x, g_y};
  const dim3 grid((nj + kTileJ - 1) / kTileJ, (ni + kTileI - 1) / kTileI,
                  batch);
  momentum_fused<<<grid, dim3(kThreadsJ, kThreadsI), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      dt_p, gamma_p, dt_v, gamma_v, u, v, F, G, rhs, k);
  return static_cast<int>(cudaGetLastError());
}

// The first version, on no path: F and G by fg_kernel, then rhs by
// rhs_kernel; scal = {dt, gamma} on the device.  Returns cudaGetLastError()
// after the launches.
extern "C" int nsp_momentum_rhs_simple(const float* scal, const float* u,
                                       const float* v, float* F, float* G,
                                       float* rhs, int ni, int nj, int i_max,
                                       int j_max, float inv_dx, float inv_dy,
                                       float inv_re, float inv_dx2,
                                       float inv_dy2, float g_x, float g_y,
                                       int device, void* stream) {
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
