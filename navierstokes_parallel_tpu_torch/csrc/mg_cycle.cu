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
//
// The grid transfers of the levels above that tail, where a level is in
// device memory and the smoother is B3 (csrc/sor.cu), take one launch each
// way, with the same device functions as the one-block cycle:
//  * nsp_mg_restrict: r_c and the zeroed e_c of the next level from the
//    fine p and rhs, one thread a coarse cell reading its 2x2 fine block
//    and the block's ring (no intermediate residual array);
//  * nsp_mg_prolong: p + e_c of the covering coarse cell into a new array
//    (+ 0 on the ghost ring, which turns -0.0 into +0.0 as the plain add
//    does), one thread a fine cell.
// They replace no TPU kernel: the JAX package runs these transfers in jnp
// (ops/mg.py::_lap, _restrict, _prolong), and the port ran them as ~26
// PyTorch launches a level.  They are bound by bytes: at 2050^2 the
// restriction reads p and rhs and writes r_c and e_c (~42 MB, 12.5 us at
// 3.35 TB/s), the prolongation reads p and e_c and writes p (~38 MB,
// 11 us).  What they buy is launches: a fine level takes 4 (two smoother
// calls and these two) instead of 28.

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

// rhs - A p at interior cell (i, j); p and rhs in shared memory (the
// one-block cycle) or in device memory (nsp_mg_restrict).
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

// r_c at interior coarse cell (ci, cj) of fine level F:
// 0.25 ((r00 + r01) + (r10 + r11)) over the 2x2 fine block it covers.
__device__ __forceinline__ float restricted_residual(const float* p,
                                                    const float* rhs,
                                                    const Level& F, int ci,
                                                    int cj) {
  const int i = 2 * ci - 1, j = 2 * cj - 1;
  return nsp::mul(
      0.25f, nsp::add(nsp::add(level_residual(p, rhs, F, i, j),
                               level_residual(p, rhs, F, i, j + 1)),
                      nsp::add(level_residual(p, rhs, F, i + 1, j),
                               level_residual(p, rhs, F, i + 1, j + 1))));
}

// p + e_c of the coarse cell that covers cell (i, j) of fine level F, + 0
// on F's ghost ring; e is the coarse level's padded array, nj_c wide.
__device__ __forceinline__ float prolonged(const float* p, const float* e,
                                           const Level& F, int nj_c, int i,
                                           int j) {
  const bool interior = i >= 1 && i <= F.ni - 2 && j >= 1 && j <= F.nj - 2;
  const size_t k =
      static_cast<size_t>((i - 1) / 2 + 1) * nj_c + (j - 1) / 2 + 1;
  const float up = interior ? e[k] : 0.0f;
  return nsp::add(p[static_cast<size_t>(i) * F.nj + j], up);
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
      const bool interior =
          ci >= 1 && ci <= C.ni - 2 && cj >= 1 && cj <= C.nj - 2;
      e[c] = 0.0f;
      r_c[c] = interior ? restricted_residual(p, rhs, F, ci, cj) : 0.0f;
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
      p[c] = prolonged(p, e, F, C.nj, c / F.nj, c % F.nj);
    }
    __syncthreads();
    level_sweeps(p, p + F.ni * F.nj, F, cy.nu2);
  }

  const int cells = cy.lv[0].ni * cy.lv[0].nj;
  for (int c = tid; c < cells; c += nt) out[c] = smem[c];
}

// The transfers of a level in device memory: one thread a coarse cell
// (restriction) or a fine cell (prolongation), blocks of kGridJ x kGridI
// threads, j the contiguous axis.
constexpr int kGridJ = 32;
constexpr int kGridI = 8;

__global__ void __launch_bounds__(kGridJ* kGridI)
    restrict_kernel(float* __restrict__ r_c, float* __restrict__ e_c,
                    const float* __restrict__ p,
                    const float* __restrict__ rhs, const Level F, int nci,
                    int ncj) {
  const int cj = blockIdx.x * blockDim.x + threadIdx.x;
  const int ci = blockIdx.y * blockDim.y + threadIdx.y;
  if (ci >= nci || cj >= ncj) return;
  const size_t c = static_cast<size_t>(ci) * ncj + cj;
  const bool interior = ci >= 1 && ci <= nci - 2 && cj >= 1 && cj <= ncj - 2;
  r_c[c] = interior ? restricted_residual(p, rhs, F, ci, cj) : 0.0f;
  e_c[c] = 0.0f;
}

__global__ void __launch_bounds__(kGridJ* kGridI)
    prolong_kernel(float* __restrict__ out, const float* __restrict__ p,
                   const float* __restrict__ e_c, const Level F, int ncj) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= F.ni || j >= F.nj) return;
  out[static_cast<size_t>(i) * F.nj + j] = prolonged(p, e_c, F, ncj, i, j);
}

// A padded fine level of ni x nj whose interior halves: even, at least 2.
bool halves(int ni, int nj) {
  return ni >= 4 && nj >= 4 && (ni - 2) % 2 == 0 && (nj - 2) % 2 == 0;
}

dim3 grid_of(int ni, int nj) {
  return dim3((nj + kGridJ - 1) / kGridJ, (ni + kGridI - 1) / kGridI);
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

// The transfer down from a fine level of padded shape ni x nj (interior
// even): r_c = the 2x2 restriction of rhs - A p, ghost ring 0, and e_c = 0,
// both of the coarse padded shape (ni / 2 + 1) x (nj / 2 + 1), row-major
// f32.  dx2_inv, dy2_inv and s2 = 2 (dx2_inv + dy2_inv) are the level's
// constants rounded to f32.  Returns cudaGetLastError() after the launch.
extern "C" int nsp_mg_restrict(float* r_c, float* e_c, const float* p,
                               const float* rhs, int ni, int nj,
                               float dx2_inv, float dy2_inv, float s2,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!halves(ni, nj)) return static_cast<int>(cudaErrorInvalidValue);
  const Level F{ni, nj, 0.0f, 0.0f, dx2_inv, dy2_inv, s2};
  const int nci = (ni - 2) / 2 + 2, ncj = (nj - 2) / 2 + 2;
  restrict_kernel<<<grid_of(nci, ncj), dim3(kGridJ, kGridI), 0,
                    static_cast<cudaStream_t>(stream)>>>(r_c, e_c, p, rhs, F,
                                                         nci, ncj);
  return static_cast<int>(cudaGetLastError());
}

// The transfer up onto a fine level of padded shape ni x nj (interior
// even): out = p + e_c of the covering coarse cell, + 0 on the ghost ring;
// e_c of the coarse padded shape.  out must not alias p or e_c.  Returns
// cudaGetLastError() after the launch.
extern "C" int nsp_mg_prolong(float* out, const float* p, const float* e_c,
                              int ni, int nj, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!halves(ni, nj)) return static_cast<int>(cudaErrorInvalidValue);
  const Level F{ni, nj, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  prolong_kernel<<<grid_of(ni, nj), dim3(kGridJ, kGridI), 0,
                   static_cast<cudaStream_t>(stream)>>>(out, p, e_c, F,
                                                        (nj - 2) / 2 + 2);
  return static_cast<int>(cudaGetLastError());
}
