// The coarse tail of the multigrid V-cycle in one launch.
//
// nsp_mg_coarse_cycle replaces the Pallas TPU kernel navierstokes_parallel_
// tpu/ops/pallas/sor_kernel.py::_make_kernel built with warm_start=True
// (called through _warm_sweeps_call / warm_sweeps by ops/mg.py::_smooth), as
// the V-cycle runs it on its coarse levels: n red-black sweeps from a given
// p0 with a level's omega, dx^2 and dy^2.  The TPU kernel holds the level in
// VMEM for all its sweeps; on an H100 a level of up to 29,056 cells (130^2
// and below for the cavity) does fit one block's 232,448 B of shared
// memory, p and rhs together, so here the TPU kernel's residency carries
// over, and further: from the first level whose whole sub-hierarchy fits
// (130^2, 66^2, 34^2, 18^2, 10^2: 182,688 B), one block runs the whole
// sub-cycle: nu1 sweeps, r = rhs - A p, 2x2 restriction, recursion down to
// the coarse sweeps, injection, p += e, nu2 sweeps, on every level it holds,
// with a __syncthreads() between half-sweeps.  It replaces ops/mg.py::
// v_cycle from that depth on: per cycle of configs/4.in, the smoother calls
// of five levels (2 n launches each in the first design, sor.cu's
// nsp_sor_warm_sweeps_simple: 64 on the coarsest level) and ~120 small
// PyTorch launches of their transfers.  With one level it is a one-block
// Gauss-Seidel smoother.
//
// What bounds it: latency, not bytes or operations.  A level of 130^2 cells
// is 135 KB and 0.37 MFLOP per sweep; one block of 1024 threads has no
// other block to hide behind, so each half-sweep costs its barrier and the
// shared-memory latency of a few updates per thread.  What it saves is
// launches: the V-cycle is bound by the host's launch rate (PERF.md).
//
// Same bits as the plain PyTorch functions, in their order (a V-cycle of
// configs/4.in ends within 4e-4 of its threshold, so a changed rounding
// would move the cycle count): the sweeps are nsp_sor.cuh's rb_update;
//   A p   = ((W + E) dx2 + (N + S) dy2 + p self_coef) - s2 p
//   r     = rhs - A p
//   r_c   = 0.25 ((r00 + r01) + (r10 + r11)),  ghost ring 0
//   e_c   = 0 before its sweeps, ghost ring 0
//   p    += e_c of the coarse cell that covers it (+ 0 on the ghost ring)
// with every constant rounded to f32 once on the host and every operation
// rounded alone (nsp_round.cuh).

#include <cuda_runtime.h>

#include <cstddef>

#include "nsp_sor.cuh"

namespace {

constexpr int kBlockJ = 32;  // threads along j, the contiguous axis
constexpr int kBlockI = 32;  // threads along i
constexpr int kMaxLevels = 8;
// Dynamic shared memory a kernel may use without asking for more.
constexpr size_t kDefaultSharedBytes = 48 * 1024;

// One level of the hierarchy: its padded shape and the f32 constants of its
// sweeps and its Laplacian (s2 = 2 (dx2_inv + dy2_inv)).
struct Level {
  int ni, nj;
  float one_minus_omega, coef, dx2_inv, dy2_inv, s2;
};

struct Cycle {
  int n_levels, nu1, nu2, coarse_sweeps;
  Level lv[kMaxLevels];
};

// One half-sweep of colour `parity` on a level held in shared memory; the
// block's threads stride over the interior cells of that colour.
__device__ __forceinline__ void level_half_sweep(float* p, const float* rhs,
                                                 const Level& L, int parity) {
  for (int i = 1 + threadIdx.y; i <= L.ni - 2; i += blockDim.y) {
    const int j0 = 1 + ((i + 1 + parity) & 1);
    for (int j = j0 + 2 * threadIdx.x; j <= L.nj - 2; j += 2 * blockDim.x) {
      const size_t c = static_cast<size_t>(i) * L.nj + j;
      p[c] = nsp::rb_update(p, rhs[c], c, L.nj, i, j, L.ni, L.nj,
                            L.one_minus_omega, L.coef, L.dx2_inv, L.dy2_inv);
    }
  }
}

// n sweeps; the block is in step on entry and on return.
__device__ __forceinline__ void level_sweeps(float* p, const float* rhs,
                                             const Level& L, int n) {
  for (int k = 0; k < n; ++k) {
    level_half_sweep(p, rhs, L, 0);
    __syncthreads();
    level_half_sweep(p, rhs, L, 1);
    __syncthreads();
  }
}

// rhs - A p at interior cell (i, j).
__device__ __forceinline__ float level_residual(const float* p,
                                                const float* rhs,
                                                const Level& L, int i, int j) {
  using nsp::add;
  using nsp::mul;
  using nsp::sub;
  const size_t c = static_cast<size_t>(i) * L.nj + j;
  const float self_coef =
      add(mul(static_cast<float>((i == 1) + (i == L.ni - 2)), L.dx2_inv),
          mul(static_cast<float>((j == 1) + (j == L.nj - 2)), L.dy2_inv));
  const float pc = p[c];
  const float nb = add(add(mul(add(p[c - L.nj], p[c + L.nj]), L.dx2_inv),
                           mul(add(p[c - 1], p[c + 1]), L.dy2_inv)),
                       mul(pc, self_coef));
  return sub(rhs[c], sub(nb, mul(L.s2, pc)));
}

__device__ __forceinline__ int block_thread() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int block_threads() {
  return blockDim.x * blockDim.y;
}

__global__ void __launch_bounds__(kBlockJ* kBlockI, 1)
    coarse_cycle(float* __restrict__ out, const float* __restrict__ p0,
                 const float* __restrict__ rhs0, const Cycle cy) {
  extern __shared__ float smem[];
  // Level l: p at smem + off[l], rhs right behind it.
  int off[kMaxLevels];
  int at = 0;
  for (int l = 0; l < cy.n_levels; ++l) {
    off[l] = at;
    at += 2 * cy.lv[l].ni * cy.lv[l].nj;
  }
  const int tid = block_thread(), nt = block_threads();
  {
    const int cells = cy.lv[0].ni * cy.lv[0].nj;
    for (int c = tid; c < cells; c += nt) {
      smem[c] = p0[c];
      smem[cells + c] = rhs0[c];
    }
  }
  __syncthreads();

  // Down: smooth, then restrict the residual into the next level's rhs and
  // start its correction at 0.
  for (int l = 0; l + 1 < cy.n_levels; ++l) {
    const Level& F = cy.lv[l];
    const Level& C = cy.lv[l + 1];
    float* p = smem + off[l];
    const float* rhs = p + F.ni * F.nj;
    float* e = smem + off[l + 1];
    float* r_c = e + C.ni * C.nj;
    level_sweeps(p, rhs, F, cy.nu1);
    for (int c = tid; c < C.ni * C.nj; c += nt) {
      const int ci = c / C.nj, cj = c % C.nj;
      float avg = 0.0f;
      if (ci >= 1 && ci <= C.ni - 2 && cj >= 1 && cj <= C.nj - 2) {
        const int i = 2 * ci - 1, j = 2 * cj - 1;
        avg = nsp::mul(
            0.25f, nsp::add(nsp::add(level_residual(p, rhs, F, i, j),
                                     level_residual(p, rhs, F, i, j + 1)),
                            nsp::add(level_residual(p, rhs, F, i + 1, j),
                                     level_residual(p, rhs, F, i + 1, j + 1))));
      }
      e[c] = 0.0f;
      r_c[c] = avg;
    }
    __syncthreads();
  }

  {
    const Level& L = cy.lv[cy.n_levels - 1];
    float* p = smem + off[cy.n_levels - 1];
    level_sweeps(p, p + L.ni * L.nj, L, cy.coarse_sweeps);
  }

  // Up: add the injected correction (0 on the ghost ring), then smooth.
  for (int l = cy.n_levels - 2; l >= 0; --l) {
    const Level& F = cy.lv[l];
    const Level& C = cy.lv[l + 1];
    float* p = smem + off[l];
    const float* e = smem + off[l + 1];
    for (int c = tid; c < F.ni * F.nj; c += nt) {
      const int i = c / F.nj, j = c % F.nj;
      const bool interior = i >= 1 && i <= F.ni - 2 && j >= 1 && j <= F.nj - 2;
      const float up =
          interior ? e[((i - 1) / 2 + 1) * C.nj + (j - 1) / 2 + 1] : 0.0f;
      p[c] = nsp::add(p[c], up);
    }
    __syncthreads();
    level_sweeps(p, p + F.ni * F.nj, F, cy.nu2);
  }

  const int cells = cy.lv[0].ni * cy.lv[0].nj;
  for (int c = tid; c < cells; c += nt) out[c] = smem[c];
}

cudaError_t allow_shared(const void* fn, size_t bytes) {
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// One V(nu1, nu2) cycle on the n_levels levels given, finest first, from p0
// into out (both of level 0's shape, row-major f32), with coarse_sweeps
// sweeps on the last level.  shapes: ni, nj per level (each level's
// interior half the one before); consts: one_minus_omega, coef, dx2_inv,
// dy2_inv, s2 per level (host arrays).  One block holds p and rhs of every
// level in shared memory (the caller has checked the sum against the
// card's limit).  Returns cudaGetLastError() after the launch.
extern "C" int nsp_mg_coarse_cycle(float* out, const float* p0,
                                   const float* rhs, const int* shapes,
                                   const float* consts, int n_levels, int nu1,
                                   int nu2, int coarse_sweeps, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_levels < 1 || n_levels > kMaxLevels || nu1 < 0 || nu2 < 0 ||
      coarse_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cycle cy{n_levels, nu1, nu2, coarse_sweeps, {}};
  size_t bytes = 0;
  for (int l = 0; l < n_levels; ++l) {
    const float* c = consts + 5 * l;
    cy.lv[l] = Level{shapes[2 * l], shapes[2 * l + 1], c[0], c[1], c[2],
                     c[3],          c[4]};
    if (cy.lv[l].ni < 3 || cy.lv[l].nj < 3 ||
        (l > 0 && (cy.lv[l - 1].ni - 2 != 2 * (cy.lv[l].ni - 2) ||
                   cy.lv[l - 1].nj - 2 != 2 * (cy.lv[l].nj - 2)))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    bytes += 2 * sizeof(float) * static_cast<size_t>(cy.lv[l].ni) *
             cy.lv[l].nj;
  }
  err = allow_shared(reinterpret_cast<const void*>(coarse_cycle), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  coarse_cycle<<<1, dim3(kBlockJ, kBlockI), bytes,
                 static_cast<cudaStream_t>(stream)>>>(out, p0, rhs, cy);
  return static_cast<int>(cudaGetLastError());
}
