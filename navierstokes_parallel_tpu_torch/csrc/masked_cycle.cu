// The masked multigrid's V-cycle (obstacle domains) on the card.
//
// These kernels replace no TPU kernel: the JAX package runs its masked
// solvers (navierstokes_parallel_tpu/ops/masked.py) in jnp alone.  They were
// added because the port's plain V-cycle (ops/masked.py::_v_cycle_masked) is
// bound by the host's launch rate: each masked half-sweep is ~13 small
// PyTorch launches, and at 440 x 82 (two levels) a V(2,2) cycle with 32
// coarse sweeps is ~970 launches for well under a millisecond of device work.
//
// The operator has per-cell weights (the cut-cell closure):
//   nb      = ((p_E w_E + p_W w_W) + p_N w_N) + p_S w_S
//   p_new   = (1 - omega) p + (omega / diag) (nb - rhs)   on fluid cells of
//                                                          the colour
//   -r      = -(fluid ? (nb - diag p) - rhs : 0)
//   r_c     = coarse fluid ? 0.25 ((r00 + r01) + (r10 + r11)) : 0
//   p      += fine fluid ? e_c of the covering coarse cell : 0
// each operation rounded alone (nsp_round.cuh), in ops/masked.py's order, so
// the kernels give the plain functions' bits.  (1 - omega) p is computed
// even at omega = 1, and omega / diag is the f32 quotient of the f32 diagonal.
// A red half-sweep reads only black neighbours, so the update is in place.
//
// A level's arrays (ops/cuda/masked_kernel.py::pack_level): p padded
// (ni + 2) x (nj + 2); rhs, diag and the fluid byte interior ni x nj; the
// east and north couplings we and wn padded, 0 on the ghost ring: padded
// cell c couples to c + row with we[c] and to c + 1 with wn[c], so its west
// and south couplings are we[c - row] and wn[c - 1] (equal to the plain
// w_w and w_s bit for bit; the packing checks it).
//
// Two ways to run a level:
//  * nsp_masked_cycle: from the first level whose arrays, with those of
//    every coarser level, fit one block's 232,448 B of shared memory, one
//    block runs the rest of the cycle (nu1 sweeps, residual, restriction,
//    the coarser levels down to the coarse sweeps, prolongation, nu2
//    sweeps) with a __syncthreads() between half-sweeps, as csrc/
//    mg_cycle.cu does for the cavity.  A level takes 4 (3 P + 2 I) + I
//    bytes (P padded cells, I interior): 195,732 B for 220 x 41.  The
//    coarsest level's diag slot holds omega / diag, formed once: it takes
//    32 sweeps and no residual.
//  * Above it, each half-sweep is one grid-wide launch (nsp_masked_
//    half_sweeps), the residual with its restriction one
//    (nsp_masked_restrict), the prolongation one (nsp_masked_prolong),
//    every array in device memory.
// At 440 x 82 that is 4 + 1 + 1 + 1 + 4 = 11 launches a cycle.
//
// What bounds them: neither bytes nor operations.  The one-block launch
// does 32 sweeps of 9,020 cells on one SM (0.07 us at the card's bound,
// 0.176 ms measured on an H100): instruction issue and a barrier per
// half-sweep, ~5 updates a thread between barriers.  A half-sweep launch at
// 440 x 82 moves under 1 MB.  The gain is the ~960 launches a cycle that
// the host no longer issues.

#include <cuda_runtime.h>

#include <cstddef>

#include "nsp_round.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kCycleThreads = 1024;
constexpr int kGridThreads = 256;
// Dynamic shared memory a kernel may use without asking for more.
constexpr size_t kDefaultSharedBytes = 48 * 1024;

// One level's arrays (global or shared memory) and its interior shape.
struct Level {
  float* p;
  float* rhs;
  const float* we;
  const float* wn;
  const float* diag;
  const unsigned char* fluid;
  int ni, nj;
};

struct Cycle {
  int n_levels, nu1, nu2, coarse_sweeps;
  float omega, one_minus_omega;
  Level lv[kMaxLevels];  // global arrays; p and rhs of the first level only
};

// ((p_E w_E + p_W w_W) + p_N w_N) + p_S w_S at padded cell c.
__device__ __forceinline__ float neighbour_sum(const Level& L, int c,
                                              int row) {
  using nsp::add;
  using nsp::mul;
  return add(add(add(mul(L.p[c + row], L.we[c]),
                     mul(L.p[c - row], L.we[c - row])),
                 mul(L.p[c + 1], L.wn[c])),
             mul(L.p[c - 1], L.wn[c - 1]));
}

// The new p of fluid interior cell (i, j) (0-based); with kQuotient the
// level's diag array holds omega / diag, formed once (the coarsest level of
// the one-block cycle, which never forms a residual).
template <bool kQuotient>
__device__ __forceinline__ void relax_cell(const Level& L, int i, int j,
                                          float omega,
                                          float one_minus_omega) {
  const int k = i * L.nj + j;
  if (!L.fluid[k]) return;
  const int row = L.nj + 2;
  const int c = (i + 1) * row + j + 1;
  const float q = kQuotient ? L.diag[k] : nsp::ratio(omega, L.diag[k]);
  L.p[c] = nsp::add(nsp::mul(one_minus_omega, L.p[c]),
                    nsp::mul(q, nsp::sub(neighbour_sum(L, c, row), L.rhs[k])));
}

// The half-sweep of colour `parity` in slots: slot m is interior row
// i = m / hw, column j = 2 (m % hw) + ((i + parity) & 1), hw = ceil(nj / 2);
// slots past the row's end and solid cells keep p.
__device__ __forceinline__ void relax_slot(const Level& L, int parity,
                                          float omega, float one_minus_omega,
                                          int m) {
  const int hw = (L.nj + 1) / 2;
  const int i = m / hw;
  const int j = 2 * (m - i * hw) + ((i + parity) & 1);
  if (i < L.ni && j < L.nj) {
    relax_cell<false>(L, i, j, omega, one_minus_omega);
  }
}

__device__ __forceinline__ int colour_slots(const Level& L) {
  return L.ni * ((L.nj + 1) / 2);
}

// -(fluid ? (nb - diag p) - rhs : 0) at interior cell (i, j).
__device__ __forceinline__ float neg_residual(const Level& L, int i, int j) {
  const int row = L.nj + 2;
  const int c = (i + 1) * row + j + 1;
  const int k = i * L.nj + j;
  const float r = nsp::sub(
      nsp::sub(neighbour_sum(L, c, row), nsp::mul(L.diag[k], L.p[c])),
      L.rhs[k]);
  return -(L.fluid[k] ? r : 0.0f);
}

// Padded cell c of the coarse level C: its correction starts at 0 and, on
// the interior, its rhs is the fine level's negated residual restricted.
__device__ __forceinline__ void restrict_cell(const Level& F, const Level& C,
                                              int c) {
  const int row = C.nj + 2;
  const int ci = c / row - 1, cj = c % row - 1;
  C.p[c] = 0.0f;
  if (ci < 0 || ci >= C.ni || cj < 0 || cj >= C.nj) return;
  const int i = 2 * ci, j = 2 * cj;
  const float avg = nsp::mul(
      0.25f, nsp::add(nsp::add(neg_residual(F, i, j), neg_residual(F, i, j + 1)),
                      nsp::add(neg_residual(F, i + 1, j),
                               neg_residual(F, i + 1, j + 1))));
  const int k = ci * C.nj + cj;
  C.rhs[k] = C.fluid[k] ? avg : 0.0f;
}

// Interior cell k of the fine level F gains the coarse correction e of the
// cell that covers it on fluid cells, +0 on solid ones.
__device__ __forceinline__ void prolong_cell(const Level& F, const Level& C,
                                             int k) {
  const int i = k / F.nj, j = k % F.nj;
  const float up = C.p[(i / 2 + 1) * (C.nj + 2) + j / 2 + 1];
  const int c = (i + 1) * (F.nj + 2) + j + 1;
  F.p[c] = nsp::add(F.p[c], F.fluid[k] ? up : 0.0f);
}

__global__ void __launch_bounds__(kGridThreads)
    half_sweep_kernel(const Level L, int parity, float omega,
                      float one_minus_omega) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < colour_slots(L)) relax_slot(L, parity, omega, one_minus_omega, m);
}

__global__ void __launch_bounds__(kGridThreads)
    restrict_kernel(const Level F, const Level C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < (C.ni + 2) * (C.nj + 2)) restrict_cell(F, C, c);
}

__global__ void __launch_bounds__(kGridThreads)
    prolong_kernel(const Level F, const Level C) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < F.ni * F.nj) prolong_cell(F, C, k);
}

// n sweeps by the whole block; in step on entry and on return.  L by
// value: its pointers stay in registers across the stores.  Each thread
// walks the slots tid, tid + nt, ... (relax_slot's order) with the row and
// column advanced, not divided.
template <bool kQuotient>
__device__ __forceinline__ void block_sweeps(const Level L, int n,
                                             float omega,
                                             float one_minus_omega) {
  const int hw = (L.nj + 1) / 2;
  const int nt = blockDim.x;
  const int di = nt / hw, dj = nt % hw;
  for (int s = 0; s < n; ++s) {
    for (int parity = 0; parity < 2; ++parity) {
      int i = threadIdx.x / hw, jj = threadIdx.x % hw;
      while (i < L.ni) {
        const int j = 2 * jj + ((i + parity) & 1);
        if (j < L.nj) {
          relax_cell<kQuotient>(L, i, j, omega, one_minus_omega);
        }
        i += di;
        jj += dj;
        if (jj >= hw) {
          jj -= hw;
          ++i;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ size_t padded_cells(const Level& L) {
  return static_cast<size_t>(L.ni + 2) * (L.nj + 2);
}

__device__ __forceinline__ size_t interior_cells(const Level& L) {
  return static_cast<size_t>(L.ni) * L.nj;
}

__global__ void __launch_bounds__(kCycleThreads, 1)
    cycle_kernel(const Cycle cy) {
  extern __shared__ float smem[];
  // Level l's floats p, rhs, we, wn, diag in turn, every level's; then the
  // fluid bytes of each level.
  Level lv[kMaxLevels];
  {
    float* at = smem;
    for (int l = 0; l < cy.n_levels; ++l) {
      lv[l] = cy.lv[l];
      const size_t P = padded_cells(lv[l]), I = interior_cells(lv[l]);
      lv[l].p = at;
      lv[l].rhs = at + P;
      lv[l].we = at + P + I;
      lv[l].wn = at + 2 * P + I;
      lv[l].diag = at + 3 * P + I;
      at += 3 * P + 2 * I;
    }
    unsigned char* bytes = reinterpret_cast<unsigned char*>(at);
    for (int l = 0; l < cy.n_levels; ++l) {
      lv[l].fluid = bytes;
      bytes += interior_cells(lv[l]);
    }
  }
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = 0; l < cy.n_levels; ++l) {
    const Level& G = cy.lv[l];
    const Level& S = lv[l];
    const int P = static_cast<int>(padded_cells(S));
    const int I = static_cast<int>(interior_cells(S));
    for (int c = tid; c < P; c += nt) {
      const_cast<float*>(S.we)[c] = G.we[c];
      const_cast<float*>(S.wn)[c] = G.wn[c];
      if (l == 0) S.p[c] = G.p[c];
    }
    // The coarsest level keeps omega / diag (relax_cell<true>).
    const bool quotient = l == cy.n_levels - 1;
    for (int k = tid; k < I; k += nt) {
      const_cast<float*>(S.diag)[k] =
          quotient ? nsp::ratio(cy.omega, G.diag[k]) : G.diag[k];
      const_cast<unsigned char*>(S.fluid)[k] = G.fluid[k];
      if (l == 0) S.rhs[k] = G.rhs[k];
    }
  }
  __syncthreads();

  for (int l = 0; l + 1 < cy.n_levels; ++l) {
    block_sweeps<false>(lv[l], cy.nu1, cy.omega, cy.one_minus_omega);
    const Level F = lv[l], C = lv[l + 1];
    const int P = static_cast<int>(padded_cells(C));
    for (int c = tid; c < P; c += nt) restrict_cell(F, C, c);
    __syncthreads();
  }
  block_sweeps<true>(lv[cy.n_levels - 1], cy.coarse_sweeps, cy.omega,
                     cy.one_minus_omega);
  for (int l = cy.n_levels - 2; l >= 0; --l) {
    const Level F = lv[l], C = lv[l + 1];
    const int I = static_cast<int>(interior_cells(F));
    for (int k = tid; k < I; k += nt) prolong_cell(F, C, k);
    __syncthreads();
    block_sweeps<false>(F, cy.nu2, cy.omega, cy.one_minus_omega);
  }

  const int P = static_cast<int>(padded_cells(lv[0]));
  for (int c = tid; c < P; c += nt) cy.lv[0].p[c] = lv[0].p[c];
}

Level level_of(float* p, float* rhs, const float* we, const float* wn,
               const float* diag, const unsigned char* fluid, int ni, int nj) {
  return Level{p, rhs, we, wn, diag, fluid, ni, nj};
}

int blocks_for(long long n) {
  return static_cast<int>((n + kGridThreads - 1) / kGridThreads);
}

}  // namespace

// n_sweeps red-black sweeps of the masked operator, in place on p (padded
// (ni + 2) x (nj + 2)), two launches a sweep (red, then black).  rhs, diag,
// fluid interior; we, wn padded (see above).  Returns cudaGetLastError().
extern "C" int nsp_masked_half_sweeps(float* p, const float* rhs,
                                      const float* we, const float* wn,
                                      const float* diag,
                                      const unsigned char* fluid, int ni,
                                      int nj, int n_sweeps, float omega,
                                      float one_minus_omega, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ni < 1 || nj < 1 || n_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Level L = level_of(p, const_cast<float*>(rhs), we, wn, diag, fluid,
                           ni, nj);
  const int blocks = blocks_for(static_cast<long long>(ni) * ((nj + 1) / 2));
  for (int s = 0; s < n_sweeps; ++s) {
    for (int parity = 0; parity < 2; ++parity) {
      half_sweep_kernel<<<blocks, kGridThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
          L, parity, omega, one_minus_omega);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The fine level's (ni x nj interior) negated residual, restricted onto the
// coarse level (ni / 2 x nj / 2) and zeroed on coarse-solid cells, into r_c
// (interior); e_c (padded coarse) set to 0.  One launch.
extern "C" int nsp_masked_restrict(float* e_c, float* r_c, const float* p,
                                   const float* rhs, const float* we,
                                   const float* wn, const float* diag,
                                   const unsigned char* fluid,
                                   const unsigned char* coarse_fluid, int ni,
                                   int nj, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ni < 2 || nj < 2 || ni % 2 || nj % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Level F = level_of(const_cast<float*>(p), const_cast<float*>(rhs), we,
                           wn, diag, fluid, ni, nj);
  const Level C = level_of(e_c, r_c, nullptr, nullptr, nullptr, coarse_fluid,
                           ni / 2, nj / 2);
  restrict_kernel<<<blocks_for(static_cast<long long>(ni / 2 + 2) *
                               (nj / 2 + 2)),
                    kGridThreads, 0, static_cast<cudaStream_t>(stream)>>>(F,
                                                                          C);
  return static_cast<int>(cudaGetLastError());
}

// p (fine, ni x nj interior, padded) += the coarse correction e_c (padded
// ni / 2 x nj / 2) of the covering cell on fluid cells, + 0 on solid ones.
// One launch.
extern "C" int nsp_masked_prolong(float* p, const float* e_c,
                                  const unsigned char* fluid, int ni, int nj,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ni < 2 || nj < 2 || ni % 2 || nj % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Level F = level_of(p, nullptr, nullptr, nullptr, nullptr, fluid, ni,
                           nj);
  const Level C = level_of(const_cast<float*>(e_c), nullptr, nullptr, nullptr,
                           nullptr, nullptr, ni / 2, nj / 2);
  prolong_kernel<<<blocks_for(static_cast<long long>(ni) * nj), kGridThreads,
                   0, static_cast<cudaStream_t>(stream)>>>(F, C);
  return static_cast<int>(cudaGetLastError());
}

// One masked V(nu1, nu2) cycle over n_levels levels, finest first, with
// coarse_sweeps sweeps on the last, in place on p (the first level's padded
// array; rhs its interior), in one block.  arrays: we, wn, diag, fluid per
// level (host array of device pointers); shapes: ni, nj per level (host),
// each interior half the one before.  The caller has checked that the
// levels fit one block's shared memory.  Returns cudaGetLastError().
extern "C" int nsp_masked_cycle(float* p, const float* rhs,
                                const void* const* arrays, const int* shapes,
                                int n_levels, int nu1, int nu2,
                                int coarse_sweeps, float omega,
                                float one_minus_omega, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_levels < 1 || n_levels > kMaxLevels || nu1 < 0 || nu2 < 0 ||
      coarse_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cycle cy{n_levels, nu1, nu2, coarse_sweeps, omega, one_minus_omega, {}};
  size_t bytes = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int ni = shapes[2 * l], nj = shapes[2 * l + 1];
    if (ni < 1 || nj < 1 ||
        (l > 0 && (cy.lv[l - 1].ni != 2 * ni || cy.lv[l - 1].nj != 2 * nj))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* const* a = arrays + 4 * l;
    cy.lv[l] = level_of(l == 0 ? p : nullptr,
                        l == 0 ? const_cast<float*>(rhs) : nullptr,
                        static_cast<const float*>(a[0]),
                        static_cast<const float*>(a[1]),
                        static_cast<const float*>(a[2]),
                        static_cast<const unsigned char*>(a[3]), ni, nj);
    const size_t P = static_cast<size_t>(ni + 2) * (nj + 2);
    const size_t I = static_cast<size_t>(ni) * nj;
    bytes += sizeof(float) * (3 * P + 2 * I) + I;
  }
  if (bytes > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(cycle_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cycle_kernel<<<1, kCycleThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      cy);
  return static_cast<int>(cudaGetLastError());
}
